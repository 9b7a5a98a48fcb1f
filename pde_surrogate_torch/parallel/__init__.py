"""Data parallelism (``mesh``, ``launch``) and the domain-decomposed Darcy
solve (``spatial``) over torch.distributed."""
