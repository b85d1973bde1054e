"""Device time of the fork-join merge a chunk: the operations launched
inside the program's own ``join`` span (`core.simulator._simulate_stream`'s
``quorum_join``: the slowest server's completion, an ``amax`` over p, and
with a broker timeout the k-th completion, ``kthvalue``, the deadline
and the merge), over the chunks of the traced window.  The merge is a
closure of the chunk loop, which the benchmark cannot wrap, so this
reads the program's span (`repro_torch.obs.profile`); nothing to read
where the program opens none."""

UNIT = "ms/chunk"
LAYER = "join"


def read(view):
    t = sum(op.seconds for op in view.ops if op.layer == LAYER)
    return 1e3 * t / view.chunks if t > 0 and view.chunks else None
