"""repro_torch: the capacity-planning framework ported to PyTorch and CUDA.

A second package beside the JAX reference ``repro``, mirroring its module
paths (``repro_torch.core.simulator`` <-> ``repro.core.simulator``).  It
imports torch and numpy only.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.  On the card, every FCFS queue of the
streaming engine goes through the hand-written CUDA (max,+) scans in
``repro_torch.kernels.maxplus_scan``, and the LM serving path
(``repro_torch.serving.engine.LMServer``) through the hand-written flash-
and decode-attention kernels.  LM training (``repro_torch.train``,
``repro_torch.ckpt``, ``repro_torch.data.pipeline``) runs the
reference's plain attention under autograd.
"""

__version__ = "0.1.0"
