"""Traffic generators of the benchmark: copies of the repository's root
generators, and the one generator that reads a cell's parameters."""
