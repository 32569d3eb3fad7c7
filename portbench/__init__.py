"""The port's benchmark: one command runs one cell of BENCHMARK.json once."""
