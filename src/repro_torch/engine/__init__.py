"""The vertical search engine substrate (paper Sec 3): corpus, inverted
index, partitioning, scoring, broker, caches, and single-device
distributed execution.  The port of `repro.engine`: index construction
and the cache replays run on the host in numpy, as there; scoring and the
broker merge run in torch on the index's device (``cuda`` by default)."""
