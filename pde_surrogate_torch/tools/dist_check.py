"""Data-parallel and spatially sharded runs for the parity checks, shared by
``tests/test_torch_parallel.py`` (ranks spawned on the CPU with gloo),
``tests/test_torch_gpu.py`` and ``chip_smoke.py``'s ``[dist]`` phase (one
NCCL rank on the card).

Each ``*_run`` takes the rank's mesh (None: one plain process), weights as
a state dict and the global batch, and returns CPU tensors, so that
spawned ranks can hand them back.  The step builders give a closure that
takes one training step, for timing.

The rules the callers hold them to are the JAX package's DP tests':
the codec's loss within 1e-5 relative and every parameter and BatchNorm
buffer within 2e-5 after 3 steps (``tests/test_training.py``); the cGlow's
losses within 2e-5 relative over 3 steps (``tests/test_glow_training.py``).
The cGlow's parameters are not compared, as in that test: its encoder's
``in_conv`` bias feeds a BatchNorm, so its gradient is zero in exact
arithmetic and Adam turns the rounding into moves of a fraction of lr.
The three-step comparisons run in float64.  In float32 they are
ill-conditioned: from the JAX package's test weights and batch, the plain
one-process codec itself lands up to 5.8e-5 away after three steps when
its input moves by 1e-7 relative (Adam's second update amplifies the
rounding of the gradient), so any reordering of the sums, a split batch
or another BatchNorm kernel, may do the same
(``tools/dp_f32_sensitivity_probe.py``).  In float32 the callers hold the
first step.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import replicate, shard_batch

CODEC_LOSS_RTOL = 1e-5
CODEC_STATE_ATOL = 2e-5
GLOW_LOSS_RTOL = 2e-5


def _device(mesh, device):
    return mesh.device if mesh is not None else torch.device(device)


def codec_step(mesh, state_dict: dict, x: torch.Tensor, model_kw: dict,
               device="cpu", lr: float = 1e-3, total_steps: int = 10,
               dtype=torch.float32):
    """``(step, model)``: a Sobel mixed-residual step (weight bound 10,
    Adam + OneCycle) of a DenseED(**model_kw) holding ``state_dict`` on
    this rank's rows of the batch ``x``, in ``dtype``."""
    from ..models.codec import DenseED
    from ..ops.filters import SobelFilter
    from ..train.codec_trainer import create_state, make_mixed_residual_step
    device = _device(mesh, device)
    model = DenseED(**model_kw).to(device, dtype)
    model.load_state_dict(state_dict)
    state = create_state(model, lr_max=lr, total_steps=total_steps, mesh=mesh)
    x = x.to(device, dtype)
    if mesh is not None:
        replicate(model, mesh)
        x = shard_batch(x, mesh)
    step = make_mixed_residual_step(state, SobelFilter(x.shape[-1]), 10.0)
    return (lambda: step(x)), model


def codec_run(mesh, state_dict: dict, x: torch.Tensor, model_kw: dict,
              n_steps: int = 3, device="cpu", dtype=torch.float32) -> dict:
    """The losses of ``n_steps`` codec steps and the state dicts after the
    first step and after the last."""
    step, model = codec_step(mesh, state_dict, x, model_kw, device,
                             dtype=dtype)
    losses, states = [], []
    for _ in range(n_steps):
        losses.append(step()["loss"])
        states.append({k: v.detach().cpu().clone()
                       for k, v in model.state_dict().items()})
    return {"losses": torch.stack(losses).cpu(), "first": states[0],
            "state": states[-1]}


def glow_step(mesh, state_dict: dict, x: torch.Tensor, model_kw: dict,
              device="cpu", lr: float = 1e-3, total_steps: int = 20,
              seed: int = 0, dtype=torch.float32):
    """``(step, model)``: a reverse-KL step (Sobel, beta 150, weight bound
    50, NaN guard) of a MultiScaleCondGlow(**model_kw) holding
    ``state_dict`` on this rank's rows of ``x``; ``step(eps_list=None)``
    draws the global batch's noise from (seed, step) unless given."""
    from ..models.glow import MultiScaleCondGlow
    from ..ops.filters import SobelFilter
    from ..train.glow_trainer import create_glow_state, make_reverse_kl_step
    device = _device(mesh, device)
    model = MultiScaleCondGlow(**model_kw).to(device, dtype)
    model.load_state_dict(state_dict)
    state = create_glow_state(model, lr_max=lr, total_steps=total_steps,
                              seed=seed, mesh=mesh)
    x = x.to(device, dtype)
    if mesh is not None:
        replicate(model, mesh)
        x = shard_batch(x, mesh)
    n = x.shape[-1]
    step = make_reverse_kl_step(state, SobelFilter(n), 150.0, 50.0, 3 * n * n)
    return (lambda eps_list=None: step(x, eps_list=eps_list)), model


def glow_run(mesh, state_dict: dict, x: torch.Tensor, model_kw: dict,
             n_steps: int = 3, first_eps=None, device="cpu",
             dtype=torch.float32) -> dict:
    """The losses of ``n_steps`` reverse-KL steps and the state dict after
    them; ``first_eps`` (the global batch's eps_list) replaces the first
    step's noise."""
    step, model = glow_step(mesh, state_dict, x, model_kw, device,
                            dtype=dtype)
    losses = [step(None if i or first_eps is None
                   else [e.to(_device(mesh, device), dtype)
                         for e in first_eps])["loss"]
              for i in range(n_steps)]
    return {"losses": torch.stack(losses).cpu(),
            "state": {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}}


def calls(mesh, todo) -> list:
    """``fn(mesh, *args)`` for each ``(fn, args)`` of ``todo``, in order:
    several checks in one start of the ranks."""
    return [fn(mesh, *args) for fn, args in todo]


def spatial_runs(mesh, cases) -> list[list[torch.Tensor]]:
    """For each ``(K, iters)`` of ``cases``, the sharded solve of ``K``
    after each count in ``iters``, assembled from every rank's rows."""
    from ..parallel.spatial import gather_rows, solve_darcy_spatial
    return [[gather_rows(solve_darcy_spatial(K, mesh, n_iter=it), mesh).cpu()
             for it in iters] for K, iters in cases]
