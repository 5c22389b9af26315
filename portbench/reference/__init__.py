"""Plain PyTorch references of what the benchmark's cells run: they import
nothing of the program."""
