"""Kernels the device ran a chunk: every kernel of the traced window over
the chunks it held (layer: the chunk loop, `core.simulator._simulate_stream`).
"""

UNIT = "launches/chunk"


def read(view):
    n = len(view.kernels())
    return n / view.chunks if n and view.chunks else None
