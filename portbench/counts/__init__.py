"""Operation and byte counts of the program's kernels, and the card's
published peaks, frozen with the benchmark."""
