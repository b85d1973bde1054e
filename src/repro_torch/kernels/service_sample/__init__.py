"""Service sampling: the simulator's (S, p, n) service times of one chunk.
Hand-written CUDA kernel that makes torch's own Philox variates in
registers (`kernel`), plain PyTorch draws (`ref`), and the dispatching
wrapper (`ops`)."""
