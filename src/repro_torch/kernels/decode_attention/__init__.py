"""One-token GQA decode attention: hand-written CUDA kernel (`kernel`),
plain PyTorch version (`ref`), and the dispatching wrapper (`ops`)."""
