"""Device time of routing and compaction a chunk: the kernels launched
inside `core.simulator._compact` / `_routing_assign` (stable sort, segment
flags, counts) and every ``aten::gather`` of the engine outside a queue
level (the replica-order permutation of arrivals, services and flags,
the carries read off the segment ends), over the chunks of the traced
window.  Nothing to read where no query is routed (r = 1)."""

UNIT = "ms/chunk"
SPAN = "portbench.route"
GATHER = "aten::gather"


def read(view):
    if SPAN not in view.spans_seen:
        return None
    t = sum(op.seconds for op in view.ops
            if op.span == SPAN or (op.span is None and op.aten == GATHER))
    return 1e3 * t / view.chunks if t > 0 else None
