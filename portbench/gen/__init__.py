"""Input synthesis from the seed, frozen: it imports nothing of the program."""
