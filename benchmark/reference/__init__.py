"""The plain reference of the benchmark: float32 PyTorch, TF32 off, written
from the published equations. It imports nothing of the program under test
and takes nothing the program made: the harness hands it the same weights
and inputs it hands the program."""
