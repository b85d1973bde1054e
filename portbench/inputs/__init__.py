"""Frozen inputs of the benchmark: the Table 6 arithmetic that makes the
scenarios, copied so that no change to the program moves the yardstick."""
