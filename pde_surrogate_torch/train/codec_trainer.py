"""Training and eval steps for the DenseED codec drivers.

Counterpart of pde_surrogate_tpu/train/codec_trainer.py: the label-free
physics step (the reference's mixed residual,
train_codec_mixed_residual.py:224-239, or one of the finite-volume
objectives) and the supervised MSE step
(train_codec_max_likelihood.py:201-213), both with Adam + OneCycle, and
the test step with rel-L2, SSE and the flux-pressure consistency.  The JAX
package scans an epoch as one device program; here an epoch is a Python
loop over these steps, which return device tensors and never synchronise.

Under a data mesh (``state.mesh``) each rank steps on its shard of the
global batch: the BatchNorm moments are the global batch's (the model was
``parallel.mesh.replicate``-d), the gradients are averaged over the ranks
before Adam (where XLA puts its ``psum``), and the returned losses are the
global batch's.  Every loss term is a mean over equal shards, so the mean
of the ranks' losses is the global loss.

Under a data x space mesh (``parallel.mesh.dp_sp_mesh``) each rank holds a
row block of its data shard: the model's convs exchange halo rows, every
objective (Sobel, ``fv``, ``fvcg``, ``sobel_fvcg``, the supervised MSE) is
this rank's partial sum (``ops/darcy.py``; the in-loss PCG exchanges one
halo row per matvec and all-reduces its dots over the space group), so a
data shard's loss is the sum over its space ranks and the global loss the
mean of those over the data ranks.  The eval step's per-sample metrics are
summed over the space group.  As in the JAX package this path is reached
through the API, not a CLI flag.

Dropout draws its masks from a generator of (``dropout_seed``, the step
counter), ``models.codec.dropout_masks``: the masks of the global batch,
of which each rank keeps its samples and rows, as JAX's
``fold_in(key(seed), step)``; a resumed run draws what an uninterrupted
one draws.
"""

from __future__ import annotations

import torch

from ..models.codec import dropout_masks
from ..ops.darcy import (_mean, flux_pressure_consistency, fv_cg_anchors,
                         fv_cg_error_loss, fv_mixed_residual_loss,
                         mixed_residual_loss)
from ..ops.filters import SobelFilter
from ..parallel.mesh import all_reduce_grads, all_reduce_sum, row_shard
from ..utils.metrics import relative_l2, squared_error_sum
from ..utils.observability import span
from .schedules import one_cycle_schedule

__all__ = ["CodecState", "create_state", "make_mixed_residual_step",
           "make_mle_step", "make_eval_step", "current_lr", "global_metrics"]


class CodecState:
    """The model, its optimizer, the step -> lr schedule, the number of
    updates taken so far and the data mesh (None: one process)."""

    def __init__(self, model, optimizer, schedule, step: int = 0,
                 mesh=None):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = step
        self.mesh = mesh


def _adam_l2(params, lr: float, weight_decay: float = 0.0):
    """Adam with coupled L2: torch's ``weight_decay`` adds wd * p to the
    gradient before the moments, as the JAX package's optax chain does."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def create_state(model, lr_max: float, total_steps: int,
                 div_factor: float = 2.0, pct_start: float = 0.3,
                 weight_decay: float = 0.0, schedule=None,
                 mesh=None) -> CodecState:
    """Adam + OneCycle around ``model`` (reference optimizer:
    train_codec_mixed_residual.py:151-154).  ``schedule`` overrides the
    OneCycle step -> lr function (the --find-lr range test); ``mesh`` makes
    the steps data-parallel (the caller replicates the model)."""
    if schedule is None:
        schedule = one_cycle_schedule(lr_max, total_steps, div_factor,
                                      pct_start)
    optimizer = _adam_l2(model.parameters(), schedule(0), weight_decay)
    return CodecState(model, optimizer, schedule, mesh=mesh)


def current_lr(state: CodecState) -> float:
    """The lr of the latest update (for logging)."""
    return state.schedule(max(state.step - 1, 0))


def _physics_loss(physics: str, x, output, sobel, weight_bound,
                  nonlinear=None, fvcg_weight: float = 100.0,
                  fvcg_flux_weight: float = 0.0,
                  fvcg_iters: int | None = None):
    """The label-free objectives, each ``(loss, (pde, dirichlet, neumann))``:

    * ``sobel``: the reference's Sobel mixed residual (models/darcy.py
      :162-233);
    * ``fv``: the exactly identifiable finite-volume residual
      (``fv_mixed_residual_loss``; ill-conditioned);
    * ``fvcg``: the CG-preconditioned error objective
      (``fv_cg_error_loss``);
    * ``sobel_fvcg``: the Sobel mixed residual + ``fvcg_weight`` x the
      CG-recovered pressure-error norm + ``fvcg_flux_weight`` x the flux
      anchor against the CG-corrected pressure (``fv_cg_anchors``).

    ``fvcg_iters=None`` scales the CG depth with the grid size.
    ``nonlinear`` ("poly" or "exp", beta1 = beta2 = 1) picks the law of
    the Sobel objective; the FV objectives take the linear law only, as in
    the JAX package.  On a row block (``sobel.rows``) every objective is
    this rank's partial sum.
    """
    rows = sobel.rows
    with span("train.loss"):
        if physics == "sobel":
            return mixed_residual_loss(x, output, sobel, weight_bound,
                                       nonlinear)
        if physics == "sobel_fvcg":
            if nonlinear is not None:
                raise ValueError("physics='sobel_fvcg' supports the linear "
                                 "law only")
            loss, (pde, diri, neum) = mixed_residual_loss(x, output, sobel,
                                                          weight_bound)
            err_u, err_flux = fv_cg_anchors(x, output, fvcg_iters, rows)
            anchor = fvcg_weight * err_u + fvcg_flux_weight * err_flux
            return loss + anchor, (pde + anchor, diri, neum)
        if physics in ("fv", "fvcg"):
            if nonlinear is not None:
                raise ValueError(f"physics='{physics}' supports the linear "
                                 f"law only")
            if physics == "fv":
                return fv_mixed_residual_loss(x, output, weight_bound, rows)
            return fv_cg_error_loss(x, output, weight_bound, fvcg_iters,
                                    rows)
        raise ValueError(f"unknown physics loss: {physics}")


def _train_forward(state: CodecState, x: torch.Tensor, dropout_seed: int):
    """The train-mode forward of this step, its dropout masks drawn from
    (``dropout_seed``, ``state.step``)."""
    with span("train.forward"):
        state.model.train()
        with dropout_masks(state.model, dropout_seed, state.step,
                           state.mesh):
            return state.model(x)


def _apply_update(state: CodecState, loss: torch.Tensor):
    """Backward, the gradient of the global loss from every rank's
    (``all_reduce_grads``: the sum over ranks over the data ranks), then
    Adam at the scheduled lr of this update."""
    opt = state.optimizer
    _backward(state, loss)
    with span("train.optimizer"):
        lr = state.schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    state.step += 1


def _backward(state, loss: torch.Tensor) -> None:
    """The gradients of ``loss`` into the parameters' ``grad``, summed over
    the ranks of ``state.mesh`` (``all_reduce_grads``)."""
    with span("train.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if state.mesh is not None:
            all_reduce_grads(state.model.parameters(), state.mesh)


def global_metrics(metrics: dict, mesh) -> dict:
    """Scalar metrics detached, and the global batch's from every rank's
    in one all-reduce: the sum over the ranks over the data ranks (a data
    shard's metric, or on a 2-D mesh a space rank's partial sum of it)."""
    if mesh is None:
        return {k: v.detach() for k, v in metrics.items()}
    names = list(metrics)
    vals = all_reduce_sum(torch.stack([metrics[k].detach() for k in names]),
                          mesh.group) / mesh.n_data
    return dict(zip(names, vals.unbind()))


def make_mixed_residual_step(state: CodecState, sobel: SobelFilter,
                             weight_bound: float = 10.0,
                             physics: str = "sobel",
                             fvcg_weight: float = 100.0,
                             fvcg_flux_weight: float = 0.0,
                             fvcg_iters: int | None = None,
                             dropout_seed: int = 0):
    """Label-free physics step on a batch of K images (B, 1, H, W):
    train-mode forward (BN running stats update; dropout from
    (``dropout_seed``, step)), the ``physics`` objective
    (``_physics_loss``), backward, Adam at the scheduled lr of this
    update.  Under a data x space mesh the batch is this rank's block
    (``parallel.mesh.batch_space_sharding``) and ``sobel`` the whole
    fields' filter."""
    rows = row_shard(state.mesh)
    if rows is not None:
        sobel = sobel.on_rows(rows)

    def step(x: torch.Tensor) -> dict:
        with span("train.step"):
            output = _train_forward(state, x, dropout_seed)
            loss, (pde, diri, neum) = _physics_loss(
                physics, x, output, sobel, weight_bound, None, fvcg_weight,
                fvcg_flux_weight, fvcg_iters)
            _apply_update(state, loss)
            return global_metrics({"loss": loss, "loss_pde": pde,
                                   "loss_dirichlet": diri,
                                   "loss_neumann": neum}, state.mesh)

    return step


def make_mle_step(state: CodecState, dropout_seed: int = 0):
    """Supervised MSE step on (K, labels) batches
    (train_codec_max_likelihood.py:201-213): train-mode forward, mean
    squared error against the labels (on a row block this rank's partial
    sum over the global count), backward, Adam."""
    rows = row_shard(state.mesh)

    def step(x: torch.Tensor, y: torch.Tensor) -> dict:
        with span("train.step"):
            output = _train_forward(state, x, dropout_seed)
            with span("train.loss"):
                loss = _mean((output - y) ** 2, rows)
            _apply_update(state, loss)
            return global_metrics({"loss": loss}, state.mesh)

    return step


def make_eval_step(state: CodecState, sobel: SobelFilter,
                   weight_bound: float = 10.0, physics: str = "sobel",
                   fvcg_weight: float = 100.0,
                   fvcg_flux_weight: float = 0.0,
                   fvcg_iters: int | None = None):
    """Test step (reference train_codec_mixed_residual.py:166-206): BN in
    eval mode, the ``physics`` loss, per-sample (rel_l2, sse) against the
    labels, and the label-free flux-pressure consistency.

    Under a mesh the loss is the global batch's (``global_metrics``), the
    per-sample metrics and the consistency are this data shard's (on a
    data x space mesh summed over the space group), and ``output`` is this
    rank's block."""
    model = state.model
    rows = row_shard(state.mesh)
    if rows is not None:
        sobel = sobel.on_rows(rows)

    @torch.no_grad()
    def step(x: torch.Tensor, y: torch.Tensor) -> dict:
        model.eval()
        output = model(x)
        loss, _ = _physics_loss(physics, x, output, sobel, weight_bound,
                                None, fvcg_weight, fvcg_flux_weight,
                                fvcg_iters)
        return {"loss": global_metrics({"loss": loss}, state.mesh)["loss"],
                "rel_l2": relative_l2(output, y, rows),
                "sse": squared_error_sum(output, y, rows),
                "consistency": flux_pressure_consistency(x, output, rows),
                "output": output}

    return step
