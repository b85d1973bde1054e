"""LM serving: the fixed-slot decode server (`engine`) and the
continuous-batching scheduler (`scheduler`)."""
