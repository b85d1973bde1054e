"""Join-shortest-queue routing: hand-written CUDA kernel (`kernel`), plain
PyTorch loop (`ref`), and the dispatching wrapper (`ops`)."""
