"""The fused xDeepFM CIN layer: hand-written CUDA kernel (`kernel`), plain
PyTorch version (`ref`), and the dispatching wrapper (`ops`)."""
