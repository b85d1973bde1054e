"""The plain reference of the benchmark: plain PyTorch, no kernel of the
program, nothing imported from it."""
