"""PyTorch/CUDA port of pde_surrogate_tpu for NVIDIA Hopper.

Layout mirrors the JAX package (ops/, ops/kernels/, solvers/, data/,
models/, train/, uq/, utils/, viz/, cli/) so each module's counterpart is
easy to find; tools/ holds the card checks shared by chip_smoke.py and the
card tests.  Tensors are NCHW, like the HDF5 datasets.  Hand-written CUDA
kernels live in ``csrc/`` and are built on first use into ``_build/``.
"""

__all__: list[str] = []
