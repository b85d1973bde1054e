"""Causal GQA flash attention: hand-written CUDA kernel (`kernel`), plain
PyTorch version (`ref`), and the dispatching wrapper (`ops`)."""
