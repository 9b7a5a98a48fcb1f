"""Plain references of what the benchmark's cells run: PyTorch and NumPy
only, importing nothing of the program.  They decide ``correct`` and
count the cells' operations and bytes."""
