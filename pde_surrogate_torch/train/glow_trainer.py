"""Training and eval steps of the conditional Glow (reverse-KL training).

Counterpart of pde_surrogate_tpu/train/glow_trainer.py: draw y ~ p(y|x)
through the reverse flow, evaluate the physics residual on the sample, add
the predictive entropy (bits per pixel), backprop through the whole flow.

* The NaN guard is optax's ``apply_if_finite(tx, 100)``: a step whose
  gradient holds a NaN or Inf takes no optimizer step, so the parameters,
  Adam's moments and count and the OneCycle position stay as they were;
  only after more than 100 consecutive such steps is the update applied.
  The noise counter ``step`` advances on every step and the BatchNorm
  running stats update on every train-mode forward, skipped or not.  The
  guard reads one flag from the device per step.
* The eps of step s come from a ``torch.Generator`` seeded by (seed, s),
  so a resumed run draws what an uninterrupted run draws.
* An epoch is a Python loop over the step (the JAX package scans it);
  ActNorm data-init is sequential (Gauss-Seidel): one forward per ActNorm
  in density-execution order, each normalising its true input under the
  already initialised prefix.
* Under a data mesh (``state.mesh``) each rank steps on its shard of the
  global batch.  The noise is the global batch's, drawn on every rank from
  the same generator and sliced (the JAX package's replicated key), the
  BatchNorm moments are global, the gradients are averaged over the ranks
  before the NaN guard reads them (so every rank skips the same steps),
  and the returned metrics are the global batch's.
* Under a data x space mesh each rank holds its rows of its samples
  (``parallel.mesh.batch_space_sharding`` with rows a multiple of
  2^(scales - 1)) and the rows of the global noise; the physics terms are
  this rank's partial sums (``ops/darcy.py``), and so is each sample's
  log-likelihood, so the entropy term, linear in it, sums over the space
  ranks to the data shard's.  ActNorm's data init reads the moments of
  the whole group.
"""

from __future__ import annotations

import math

import torch

from ..models.flow import actnorm_init_from_input, actnorm_module_paths
from ..ops.darcy import (conv_boundary_condition, fv_cg_anchors,
                         mixed_residual_loss)
from ..ops.filters import SobelFilter
from ..parallel.mesh import (DataSpaceMesh, batch_space_sharding, row_shard,
                             shard_batch)
from ..utils.config import make_generator
from ..utils.metrics import relative_l2, squared_error_sum
from ..utils.observability import count, span
from .codec_trainer import _adam_l2, _backward, global_metrics
from .schedules import one_cycle_schedule

__all__ = ["GlowState", "create_glow_state", "glow_lr",
           "reverse_kl_objective", "make_reverse_kl_step",
           "make_forward_kl_step",
           "make_glow_eval_step", "data_init_actnorm"]

LN2 = math.log(2.0)
MAX_CONSECUTIVE_ERRORS = 100


class GlowState:
    """The model, Adam, the update -> lr schedule, the base seed and three
    counters: ``step`` (steps taken; seeds each step's noise), ``updates``
    (updates applied; optax's count, which drives the lr) and
    ``notfinite_count`` (consecutive non-finite gradients).  All three are
    checkpointed.  ``mesh``: the data mesh (None: one process)."""

    COUNTERS = ("step", "updates", "notfinite_count")

    def __init__(self, model, optimizer, schedule, seed: int = 0,
                 mesh=None):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.seed = seed
        self.mesh = mesh
        self.step = 0
        self.updates = 0
        self.notfinite_count = 0


def create_glow_state(model, lr_max: float, total_steps: int,
                      div_factor: float = 2.0, pct_start: float = 0.3,
                      weight_decay: float = 0.0, seed: int = 0,
                      mesh=None) -> GlowState:
    """Adam (coupled L2) + OneCycle around ``model`` (JAX
    glow_trainer.py:53-70, whose CLIs all keep the NaN guard on);
    ``seed`` is the base of the per-step noise; ``mesh`` makes the steps
    data-parallel (the caller replicates the model)."""
    schedule = one_cycle_schedule(lr_max, total_steps, div_factor, pct_start)
    optimizer = _adam_l2(model.parameters(), schedule(0), weight_decay)
    return GlowState(model, optimizer, schedule, seed, mesh)


def glow_lr(state: GlowState) -> float:
    """The lr of the latest applied update (schedule(0) before any)."""
    return state.schedule(max(state.updates - 1, 0))


def _all_finite(tensors) -> torch.Tensor:
    """0-dim bool on the device: every element of ``tensors`` finite (0 *
    x is 0 for finite x and NaN otherwise; no overflow as a norm of x
    could)."""
    zeros = torch._foreach_mul(tensors, 0.0)
    return torch.isfinite(torch.stack(torch._foreach_norm(zeros)).sum())


def _guarded_update(state: GlowState, loss: torch.Tensor) -> None:
    """Backward, then Adam at the lr of the applied-update count, unless
    the NaN guard rejects the gradient."""
    opt = state.optimizer
    _backward(state, loss)
    with span("train.guard"):
        grads = [p.grad for group in opt.param_groups
                 for p in group["params"] if p.grad is not None]
        count("sync.guard")
        finite = bool(_all_finite(grads))
    state.notfinite_count = 0 if finite else state.notfinite_count + 1
    if finite or state.notfinite_count > MAX_CONSECUTIVE_ERRORS:
        with span("train.optimizer"):
            lr = state.schedule(state.updates)
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
        state.updates += 1
    state.step += 1


def reverse_kl_objective(x, output, log_likelihood, sobel: SobelFilter,
                         beta: float, weight_bound: float, n_out_pixels: int,
                         physics: str = "sobel", fvcg_weight: float = 100.0,
                         fvcg_flux_weight: float = 0.0,
                         fvcg_iters: int | None = None) -> dict:
    """The reverse-KL loss of generated ``output`` (B, 3, H, W) with its
    log-likelihood, and its parts (JAX glow_trainer.py:123-156):

    * ``sobel``: beta * (Sobel residual + weight_bound * (dirichlet +
      neumann)) + neg_entropy;
    * ``sobel_fvcg``: adds fvcg_weight * err_u + fvcg_flux_weight *
      err_flux of ``fv_cg_anchors`` to the residual;
    * ``fvcg``: residual = err_u + err_flux, boundary = dirichlet only.

    neg_entropy = mean log-likelihood / ln 2 / ``n_out_pixels`` (the whole
    field's count).  On a row block (``sobel.rows``) ``output`` and the
    log-likelihood are this rank's and every part is its partial sum.
    """
    if physics not in ("sobel", "sobel_fvcg", "fvcg"):
        raise ValueError(f"unknown glow physics loss: {physics}")
    rows = sobel.rows
    extra = {}
    with span("train.loss"):
        if physics == "fvcg":
            diri, neum = conv_boundary_condition(output, rows)
            err_u, err_flux = fv_cg_anchors(x, output, fvcg_iters, rows)
            residual = err_u + err_flux
            loss_pde = residual + diri * weight_bound
            boundary = diri
            extra = {"anchor_u": err_u, "anchor_flux": err_flux}
        else:
            loss_pde, (residual, diri, neum) = mixed_residual_loss(
                x, output, sobel, weight_bound)
            boundary = diri + neum
            if physics == "sobel_fvcg":
                err_u, err_flux = fv_cg_anchors(x, output, fvcg_iters, rows)
                anchor = fvcg_weight * err_u + fvcg_flux_weight * err_flux
                loss_pde = loss_pde + anchor
                residual = residual + anchor
                extra = {"anchor_u": err_u, "anchor_flux": err_flux}
        neg_entropy = log_likelihood.mean() / LN2 / n_out_pixels
        return {"loss": loss_pde * beta + neg_entropy, "residual": residual,
                "boundary": boundary, "neg_entropy": neg_entropy, **extra}


def make_reverse_kl_step(state: GlowState, sobel: SobelFilter, beta: float,
                         weight_bound: float, n_out_pixels: int,
                         physics: str = "sobel", fvcg_weight: float = 100.0,
                         fvcg_flux_weight: float = 0.0,
                         fvcg_iters: int | None = None):
    """Label-free reverse-KL step on a batch of K (B, 1, H, W) (JAX
    glow_trainer.py:89-170): ``generate`` in train mode with the step's
    noise, ``reverse_kl_objective``, then the guarded Adam update.
    ``eps_list`` (optional, per call) replaces the drawn noise; under a
    mesh it is the global batch's, as the drawn noise is, and ``x`` is
    this rank's part of the batch (``sobel`` the whole fields' filter)."""
    if physics not in ("sobel", "sobel_fvcg", "fvcg"):
        raise ValueError(f"unknown glow physics loss: {physics}")
    model = state.model
    sobel = _on_rows(sobel, state.mesh)

    def step(x: torch.Tensor, eps_list=None) -> dict:
        with span("train.step"):
            with span("train.noise"):
                gen = None if eps_list is not None else make_generator(
                    x.device, state.seed, state.step)
                if state.mesh is not None:
                    eps_list = _rank_noise(model, state.mesh, x, gen,
                                           eps_list)
            with span("train.forward"):
                model.train()
                output, log_likelihood = model.generate(
                    x, eps_list=eps_list, generator=gen)
            metrics = reverse_kl_objective(
                x, output, log_likelihood, sobel, beta, weight_bound,
                n_out_pixels, physics, fvcg_weight, fvcg_flux_weight,
                fvcg_iters)
            _guarded_update(state, metrics["loss"])
            return global_metrics(metrics, state.mesh)

    return step


def _on_rows(sobel: SobelFilter, mesh) -> SobelFilter:
    rows = row_shard(mesh)
    return sobel if rows is None else sobel.on_rows(rows)


def _shard(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's samples (and on a data x space mesh its rows) of a
    global NCHW tensor."""
    if isinstance(mesh, DataSpaceMesh):
        return batch_space_sharding(mesh, multiple=1)(t)
    return shard_batch(t, mesh)


def _rank_noise(model, mesh, x, generator, eps_list=None, n_samples=None):
    """This rank's part of the global batch's noise: ``eps_list`` (the
    global batch's), or drawn from ``generator`` for ``n_data`` times the
    samples of ``x``, as one process draws it for the whole batch; its
    samples, and on a data x space mesh its rows of every latent.  With
    ``n_samples`` the entries are (n_samples, B, ...), sliced on B."""
    if eps_list is None:
        draw = model.create_noise(generator, n_samples or 1,
                                  x.shape[0] * mesh.n_data)
        eps_list = draw if n_samples else [e[0] for e in draw]
    if n_samples:
        return [torch.stack([_shard(s, mesh) for s in e]) for e in eps_list]
    return [_shard(e, mesh) for e in eps_list]


def make_forward_kl_step(state: GlowState, n_out_pixels: int):
    """Maximum-likelihood step on labelled (x, y) through the density path
    (JAX glow_trainer.py:173-202): bits per pixel -log p / ln 2 / pixels.
    Build the model with ``train_sampling=False`` so that this path
    inverts no matrix.  Under a mesh ``x`` and ``y`` are this rank's part
    of the batch and the returned metrics the global batch's."""
    model = state.model

    def step(x: torch.Tensor, y: torch.Tensor) -> dict:
        with span("train.step"):
            with span("train.forward"):
                model.train()
                _, logp, _ = model(y, x)
            with span("train.loss"):
                bits_per_pixel = -logp.mean() / LN2 / n_out_pixels
            _guarded_update(state, bits_per_pixel)
            loss = global_metrics({"loss": bits_per_pixel},
                                  state.mesh)["loss"]
            return {"loss": loss, "bits_per_pixel": loss}

    return step


def make_glow_eval_step(state: GlowState, sobel: SobelFilter, beta: float,
                        weight_bound: float, n_out_pixels: int,
                        n_samples: int = 0):
    """Test step in eval mode (JAX glow_trainer.py:205-244).

    ``n_samples=0``: one generated sample; ``n_samples>0``: the mean of
    that many samples, with the entropy term from one more ``generate``.
    The entropy comes from the test batch's own log-likelihood.  Noise is
    drawn from ``generator``, or given as ``eps`` (the eps_list of
    ``generate``; with ``n_samples`` a pair (sample eps_list, generate
    eps_list)).  Under a mesh ``x`` and ``y`` are this rank's part of the
    test batch, the noise is the global batch's (drawn or given) sliced,
    ``output`` is this rank's, the scalar terms are the global batch's
    (``global_metrics``) and ``rel_l2`` and ``sse`` this data shard's
    (summed over the space group on a data x space mesh).
    """
    model = state.model
    mesh = state.mesh
    rows = row_shard(mesh)
    sobel = _on_rows(sobel, mesh)

    @torch.no_grad()
    def step(x, y, generator: torch.Generator | None = None, eps=None):
        model.eval()
        if mesh is not None:
            if n_samples > 0:
                s_eps, g_eps = eps if eps is not None else (None, None)
                s_eps = _rank_noise(model, mesh, x, generator, s_eps,
                                    n_samples)
                eps = (s_eps, _rank_noise(model, mesh, x, generator, g_eps))
            else:
                eps = _rank_noise(model, mesh, x, generator, eps)
        if n_samples > 0:
            s_eps, g_eps = eps if eps is not None else (None, None)
            samples = model.sample(x, n_samples, generator=generator,
                                   eps_list=s_eps, temperature=1.0)
            output = samples.mean(dim=0)
            _, log_likelihood = model.generate(x, eps_list=g_eps,
                                               generator=generator)
        else:
            output, log_likelihood = model.generate(x, eps_list=eps,
                                                    generator=generator)
        loss_pde, (residual, diri, neum) = mixed_residual_loss(
            x, output, sobel, weight_bound)
        neg_entropy = log_likelihood.mean() / LN2 / n_out_pixels
        return {**global_metrics(
                    {"loss": loss_pde * beta + neg_entropy,
                     "residual": residual, "boundary": diri + neum,
                     "neg_entropy": neg_entropy}, mesh),
                "output": output, "rel_l2": relative_l2(output, y, rows),
                "sse": squared_error_sum(output, y, rows)}

    return step


class _Captured(Exception):
    pass


@torch.no_grad()
def data_init_actnorm(state: GlowState, y: torch.Tensor,
                      x: torch.Tensor) -> GlowState:
    """One-batch ActNorm data init (JAX glow_trainer.py:281-311), in eval
    mode: for each ActNorm in density-execution order, run the density
    path up to that ActNorm and set weight = 1/std, bias = -mean/std from
    its input.  Each layer thus sees the already initialised ones before
    it (Gauss-Seidel), as the reference's lazy init does; the Jacobi sweep
    (all layers from one pass) diverges on deep stacks.  On a replica
    (``parallel.mesh.replicate``) ``y`` and ``x`` are this rank's part of
    the batch and the moments the whole group's."""
    model = state.model
    model.eval()
    for name in actnorm_module_paths(model):
        norm = model.get_submodule(name)

        def capture(module, args):
            actnorm_init_from_input(module, args[0])
            raise _Captured

        handle = norm.register_forward_pre_hook(capture)
        try:
            model(y, x)
        except _Captured:
            pass
        finally:
            handle.remove()
    return state
