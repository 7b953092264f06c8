"""Microbenchmarks of the port (ports of `benchmarks/`)."""
