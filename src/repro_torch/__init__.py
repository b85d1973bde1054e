"""repro_torch: the capacity-planning framework ported to PyTorch and CUDA.

A second package beside the JAX reference ``repro``, mirroring its module
paths (``repro_torch.core.simulator`` <-> ``repro.core.simulator``).  It
imports torch and numpy only.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; every FCFS queue of the streaming engine
goes through the hand-written CUDA (max,+) scan in
``repro_torch.kernels.maxplus_scan`` when its tensors live on the card.
"""

__version__ = "0.1.0"
