"""Device time of the fleet layer a chunk: the operations launched inside
the program's own ``fleet`` span (`core.simulator._simulate_stream`
around `kernels.fleet_scan.ops.fleet_scan`: the replica-up mask from the
outage windows and the MTBF/MTTR chain, one launch a chunk, and the
windows' clock), over the chunks of the traced window.  Nothing to read
where no replica can fail or be scaled."""

UNIT = "ms/chunk"
LAYER = "fleet"


def read(view):
    t = sum(op.seconds for op in view.ops if op.layer == LAYER)
    return 1e3 * t / view.chunks if t > 0 and view.chunks else None
