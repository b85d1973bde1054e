"""Device time of service sampling a chunk: the kernels launched inside
the program's draw functions (`core.simulator.chunk_random_draws`, which
calls `sample_service_times_batch`, and `chunk_side_draws`), over the
chunks of the traced window."""

UNIT = "ms/chunk"
SPAN = "portbench.sampling"


def read(view):
    if SPAN not in view.spans_seen:
        return None
    t = sum(op.seconds for op in view.ops if op.span == SPAN)
    return 1e3 * t / view.chunks if t > 0 else None
