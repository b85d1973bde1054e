"""EmbeddingBag (multi-hot gather + masked mean): hand-written CUDA kernel
(`kernel`), plain PyTorch version (`ref`), and the dispatching wrapper
(`ops`)."""
