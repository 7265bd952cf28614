"""The program's parameter layout of each family (``<family>.py``), built
from the benchmark's weights as a checkpoint loader would hand them over:
the same tensors, arranged as the program's ``init`` arranges its own."""
