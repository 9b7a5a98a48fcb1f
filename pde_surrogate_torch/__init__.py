"""PyTorch/CUDA port of pde_surrogate_tpu for NVIDIA Hopper.

Layout mirrors the JAX package (ops/, ops/kernels/, solvers/, data/,
models/, train/, utils/, cli/) so each module's counterpart is easy to
find.  Tensors are NCHW, like the HDF5 datasets.  Hand-written CUDA
kernels live in ``csrc/`` and are built on first use into ``_build/``.
"""

__all__: list[str] = []
