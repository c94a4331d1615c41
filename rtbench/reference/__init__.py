"""The plain reference: PyTorch tensor operations that work out again,
from the benchmark's own inputs, what the program renders and fits.  It
imports nothing of the program."""
