"""The fleet scan: replica-up masks (outage windows and the MTBF/MTTR
chain) and the autoscaler's active count, one query at a time.  Hand-
written CUDA kernel (`kernel`), plain PyTorch loop (`ref`), and the
dispatching wrapper (`ops`)."""
