"""Checkpoints of training state: atomic, async, restored onto any
device (`checkpoint`)."""
