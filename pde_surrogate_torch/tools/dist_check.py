"""Data-parallel and spatially sharded runs for the parity checks, shared by
``tests/test_torch_parallel.py`` and ``tests/test_torch_parallel_space.py``
(ranks spawned on the CPU with gloo), ``tests/test_torch_gpu.py`` and
``chip_smoke.py``'s ``[dist]`` and ``[dpsp]`` phases (NCCL on the card).

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

from ..parallel.mesh import (DataSpaceMesh, batch_space_sharding,
                             dp_sp_mesh, replicate, shard_batch)

CODEC_LOSS_RTOL = 1e-5
CODEC_STATE_ATOL = 2e-5
GLOW_LOSS_RTOL = 2e-5


def _device(mesh, device):
    return mesh.device if mesh is not None else torch.device(device)


def _shard(t, mesh, multiple: int = 4):
    """This rank's part of a global batch tensor (None passes): its block
    on a data x space mesh, its samples on a data mesh."""
    if t is None or mesh is None:
        return t
    if isinstance(mesh, DataSpaceMesh):
        return batch_space_sharding(mesh, multiple)(t)
    return shard_batch(t, mesh)


def _codec_setup(mesh, state_dict, x, model_kw, device, dtype, y=None,
                 lr=1e-3, total_steps=10):
    """A DenseED(**model_kw) holding ``state_dict`` in ``dtype``, its Adam
    + OneCycle state and this rank's part of ``x`` (and ``y``)."""
    from ..models.codec import DenseED
    from ..train.codec_trainer import create_state
    device = _device(mesh, device)
    model = DenseED(**model_kw).to(device, dtype)
    model.load_state_dict(state_dict)
    state = create_state(model, lr_max=lr, total_steps=total_steps,
                         mesh=mesh)
    if mesh is not None:
        replicate(model, mesh)
    x, y = (None if t is None else _shard(t.to(device, dtype), mesh)
            for t in (x, y))
    return model, state, x, y


def codec_step(mesh, state_dict: dict, x: torch.Tensor, model_kw: dict,
               device="cpu", lr: float = 1e-3, total_steps: int = 10,
               dtype=torch.float32, physics: str = "sobel", y=None,
               n_cg: int | None = None):
    """``(step, model)``: a training step (Adam + OneCycle) of a
    DenseED(**model_kw) holding ``state_dict`` on this rank's part of the
    batch ``x`` (its samples, or on a data x space mesh its block of
    them), in ``dtype``: the ``physics`` objective at weight bound 10
    (``n_cg`` CG iterations for the fvcg family), or with ``physics``
    "mle" the supervised step against the labels ``y``."""
    from ..ops.filters import SobelFilter
    from ..train.codec_trainer import make_mixed_residual_step, make_mle_step
    model, state, x, y = _codec_setup(mesh, state_dict, x, model_kw, device,
                                      dtype, y, lr, total_steps)
    if physics == "mle":
        step = make_mle_step(state)
        return (lambda: step(x, y)), model
    step = make_mixed_residual_step(state, SobelFilter(x.shape[-1]), 10.0,
                                    physics=physics, fvcg_iters=n_cg)
    return (lambda: step(x)), model


def codec_run(mesh, state_dict: dict, x: torch.Tensor, model_kw: dict,
              n_steps: int = 3, device="cpu", dtype=torch.float32,
              **step_kw) -> dict:
    """The losses of ``n_steps`` codec steps (``codec_step``'s
    ``step_kw``) and the state dicts after the first step and after the
    last."""
    step, model = codec_step(mesh, state_dict, x, model_kw, device,
                             dtype=dtype, **step_kw)
    losses, states = [], []
    for _ in range(n_steps):
        losses.append(step()["loss"])
        states.append({k: v.detach().cpu().clone()
                       for k, v in model.state_dict().items()})
    return {"losses": torch.stack(losses).cpu(), "first": states[0],
            "state": states[-1]}


def _on_mesh(mesh, shape):
    """The (n_data, n_space) data x space mesh over ``mesh``'s process
    group (every rank calls it), or ``mesh`` itself for ``shape`` None."""
    return mesh if shape is None else dp_sp_mesh(*shape, mesh.device)


def codec_dpsp_run(mesh, shape: tuple[int, int], state_dict: dict,
                   x: torch.Tensor, model_kw: dict, n_steps: int = 3,
                   device="cpu", dtype=torch.float32, **step_kw) -> dict:
    """``codec_run`` on the ``shape`` = (n_data, n_space) data x space
    mesh over ``mesh``'s process group (every rank calls it): each rank
    steps on its block of ``x`` (``batch_space_sharding``)."""
    return codec_run(_on_mesh(mesh, shape), state_dict, x, model_kw,
                     n_steps, device, dtype, **step_kw)


def codec_eval_run(mesh, shape, state_dict: dict, x: torch.Tensor,
                   y: torch.Tensor, model_kw: dict, physics: str = "sobel",
                   n_cg: int | None = None, device="cpu",
                   dtype=torch.float32) -> dict:
    """The eval step's outputs (``train.codec_trainer.make_eval_step``,
    weight bound 10) on this rank's part of the test batch ``(x, y)``,
    under the ``shape`` data x space mesh over ``mesh``'s group (``mesh``
    None: one process; ``shape`` None: ``mesh`` itself)."""
    from ..ops.filters import SobelFilter
    from ..train.codec_trainer import make_eval_step
    m = None if mesh is None else _on_mesh(mesh, shape)
    _, state, x, y = _codec_setup(m, state_dict, x, model_kw, device, dtype,
                                  y)
    out = make_eval_step(state, SobelFilter(x.shape[-1]), 10.0, physics,
                         fvcg_iters=n_cg)(x, y)
    return {k: v.cpu() for k, v in out.items()}


def codec_dropout_run(mesh, shape, state_dict: dict, x: torch.Tensor,
                      model_kw: dict, n_steps: int = 3, device="cpu",
                      dtype=torch.float64) -> dict:
    """A DenseED with dropout under the ``shape`` data x space mesh over
    ``mesh``'s group (``shape`` None: ``mesh`` itself, a data mesh;
    ``mesh`` None: one process): the masks that step 0 draws (``models.
    codec.dropout_masks``, seed 0; from a forward whose BatchNorm buffers
    are put back), then ``codec_run``'s losses and states of ``n_steps``
    Sobel steps, whose dropout draws from (0, step)."""
    from ..models.codec import dropout_masks
    m = None if mesh is None else _on_mesh(mesh, shape)
    model, _, xl, _ = _codec_setup(m, state_dict, x, model_kw, device, dtype)
    buffers = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    with torch.no_grad(), dropout_masks(model, 0, 0, m, record=True) as src:
        model(xl)
    model.load_state_dict(buffers)
    return {"masks": [k.cpu() for k in src.drawn],
            **codec_run(m, state_dict, x, model_kw, n_steps, device, dtype)}


def _glow_setup(mesh, state_dict, x, model_kw, device, dtype, y=None,
                init_y=None, lr=1e-3, total_steps=20, seed=0):
    """A MultiScaleCondGlow(**model_kw) holding ``state_dict``, its
    guarded Adam state, and this rank's part of ``x`` (and ``y``); with
    ``init_y``, the ActNorms data-initialised from (``init_y``, ``x``),
    on a mesh from this rank's part of both."""
    from ..models.glow import MultiScaleCondGlow
    from ..train.glow_trainer import create_glow_state, data_init_actnorm
    device = _device(mesh, device)
    model = MultiScaleCondGlow(**model_kw).to(device, dtype)
    model.load_state_dict(state_dict)
    state = create_glow_state(model, lr_max=lr, total_steps=total_steps,
                              seed=seed, mesh=mesh)
    multiple = 2 ** (len(model_kw["flow_blocks"]) - 1)
    if mesh is not None:
        replicate(model, mesh)
    x, y, init_y = (None if t is None
                    else _shard(t.to(device, dtype), mesh, multiple)
                    for t in (x, y, init_y))
    if init_y is not None:
        data_init_actnorm(state, init_y, x)
    return model, state, x, y


def glow_step(mesh, state_dict: dict, x: torch.Tensor, model_kw: dict,
              device="cpu", lr: float = 1e-3, total_steps: int = 20,
              seed: int = 0, dtype=torch.float32, init_y=None,
              physics: str = "sobel", n_cg: int | None = None):
    """``(step, model)``: a reverse-KL step (``physics``, beta 150, weight
    bound 50, NaN guard) of a MultiScaleCondGlow(**model_kw) holding
    ``state_dict`` (ActNorms data-initialised from ``init_y`` when given)
    on this rank's part of ``x``; ``step(eps_list=None)`` draws the
    global batch's noise from (seed, step) unless given."""
    from ..ops.filters import SobelFilter
    from ..train.glow_trainer import make_reverse_kl_step
    model, state, x, _ = _glow_setup(mesh, state_dict, x, model_kw, device,
                                     dtype, init_y=init_y, lr=lr,
                                     total_steps=total_steps, seed=seed)
    n = x.shape[-1]
    step = make_reverse_kl_step(state, SobelFilter(n), 150.0, 50.0,
                                3 * n * n, physics, fvcg_iters=n_cg)
    return (lambda eps_list=None: step(x, eps_list=eps_list)), model


def glow_run(mesh, state_dict: dict, x: torch.Tensor, model_kw: dict,
             n_steps: int = 3, first_eps=None, device="cpu",
             dtype=torch.float32, **step_kw) -> dict:
    """The losses of ``n_steps`` reverse-KL steps (``glow_step``'s
    ``step_kw``), the state dict before them (after any data init) and
    after them; ``first_eps`` (the global batch's eps_list) replaces the
    first step's noise."""
    step, model = glow_step(mesh, state_dict, x, model_kw, device,
                            dtype=dtype, **step_kw)
    init = {k: v.detach().cpu().clone()
            for k, v in model.state_dict().items()}
    losses = [step(None if i or first_eps is None
                   else [e.to(_device(mesh, device), dtype)
                         for e in first_eps])["loss"]
              for i in range(n_steps)]
    return {"losses": torch.stack(losses).cpu(), "init": init,
            "state": {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}}


def glow_dpsp_run(mesh, shape: tuple[int, int], state_dict: dict,
                  x: torch.Tensor, model_kw: dict, n_steps: int = 3,
                  first_eps=None, device="cpu", dtype=torch.float32,
                  **step_kw) -> dict:
    """``glow_run`` on the ``shape`` data x space mesh over ``mesh``'s
    process group: each rank on its rows of its samples."""
    return glow_run(_on_mesh(mesh, shape), state_dict, x, model_kw, n_steps,
                    first_eps, device, dtype, **step_kw)


def glow_eval_fkl_run(mesh, shape, state_dict: dict, x: torch.Tensor,
                      y: torch.Tensor, model_kw: dict, eps, device="cpu",
                      dtype=torch.float32) -> dict:
    """Under the ``shape`` data x space mesh over ``mesh``'s group
    (``mesh`` None: one process): the eval step's outputs (one sample on
    the global batch's noise ``eps``, beta 150, weight bound 50), then the
    loss of one forward-KL step on ``(x, y)``."""
    from ..ops.filters import SobelFilter
    from ..train.glow_trainer import make_forward_kl_step, make_glow_eval_step
    m = None if mesh is None else _on_mesh(mesh, shape)
    model, state, xl, yl = _glow_setup(m, state_dict, x, model_kw, device,
                                       dtype, y)
    n = x.shape[-1]
    eps = [e.to(_device(m, device), dtype) for e in eps]
    out = make_glow_eval_step(state, SobelFilter(n), 150.0, 50.0,
                              3 * n * n)(xl, yl, eps=eps)
    fkl = make_forward_kl_step(state, 3 * n * n)(xl, yl)
    return {"eval": {k: v.cpu() for k, v in out.items()},
            "fkl_loss": fkl["loss"].cpu()}


def calls(mesh, todo) -> list:
    """``fn(mesh, *args, **kwargs)`` for each ``(fn, args)`` or ``(fn,
    args, kwargs)`` of ``todo``, in order: several checks in one start of
    the ranks."""
    return [t[0](mesh, *t[1], **(t[2] if len(t) > 2 else {})) for t in todo]


def spatial_runs(mesh, cases) -> list[list[torch.Tensor]]:
    """For each ``(K, iters)`` of ``cases``, the sharded solve of ``K``
    after each count in ``iters``, assembled from every rank's rows."""
    from ..parallel.spatial import gather_rows, solve_darcy_spatial
    return [[gather_rows(solve_darcy_spatial(K, mesh, n_iter=it), mesh).cpu()
             for it in iters] for K, iters in cases]


# --- the data x space mesh's row blocks ------------------------------------

ROW_BLOCK_RTOL_F64 = 1e-12   # block arithmetic against the whole field
ROW_BLOCK_RTOL_F32 = 1e-5    # the same on the card in float32 (of max|y|)


def row_block_cases(full: bool) -> list[tuple]:
    """``(name, kind, args)`` of every conv kind of the DenseED and of the
    Sobel stencils: ``kind`` "conv" ``(k, stride, padding, cin, cout,
    n_in)``, "up" ``(mode, cin, cout, n_in)`` (x2 upsampling, then a 3x3
    conv), "sobel" ``(filter_size, correct, n)``.  ``full``: the channels
    and grids of DenseED [6,8,6]/16/48 at 64^2 (the widest input of each
    kind); else 3 in, 4 out on 16^2."""
    def ch(cin, cout):
        return (cin, cout) if full else (3, 4)
    n = 64 if full else 16
    return [
        ("In_conv 7x7/s2/p3", "conv", (7, 2, 3, *ch(1, 48), n)),
        ("dense 3x3/p1", "conv", (3, 1, 1, *ch(128, 16), n // 2)),
        ("down 1x1", "conv", (1, 1, 0, *ch(144, 72), n // 2)),
        ("down 3x3/s2/p1", "conv", (3, 2, 1, *ch(72, 72), n // 2)),
        ("up nearest + 3x3/p1", "up", ("nearest", *ch(100, 100), n // 4)),
        ("up bilinear + 3x3/p1", "up", ("bilinear", *ch(100, 100), n // 4)),
        ("LastDecoding upsample + 3x3/p1", "up",
         ("nearest", *ch(98, 49), n // 2)),
        ("LastDecoding conv3 5x5/p2", "conv", (5, 1, 2, *ch(49, 3), n)),
    ] + [(f"sobel {fs}x{fs} correct={c}", "sobel", (fs, c, n))
         for fs in (3, 5) for c in (True, False)]


def _cut(x: torch.Tensor, n_blocks: int, a: int, b: int) -> list[tuple]:
    """``(block, above, below)`` of each row block of ``x``, the halos cut
    from the neighbouring blocks (zeros at a wall), as the transport
    would give them."""
    h = x.shape[-2] // n_blocks
    out = []
    for j in range(n_blocks):
        r0, r1 = j * h, (j + 1) * h
        above = (x[..., r0 - a:r0, :] if j
                 else x.new_zeros(*x.shape[:-2], a, x.shape[-1]))
        below = (x[..., r1:r1 + b, :] if j < n_blocks - 1
                 else x.new_zeros(*x.shape[:-2], b, x.shape[-1]))
        out.append((x[..., r0:r1, :], above, below))
    return out


def row_block_case(kind: str, args: tuple, n_blocks: int, t) -> tuple:
    """``(inputs, run, halo)`` of one case of ``row_block_cases`` in
    ``n_blocks`` blocks: ``t(*shape)`` draws its tensors, the input and
    the conv weight (none for Sobel), and ``run(*inputs)`` gives the whole
    field's result and the blocks' one, computed one after the other in
    this process."""
    import torch.nn.functional as F
    from ..models.codec import upsample_bilinear, upsample_nearest
    from ..ops.filters import SobelFilter
    from ..parallel.halo import (RowShard, block_operator, conv_halo,
                                 conv_rows, upsample_conv_rows,
                                 upsample_matrix, with_halo)
    if kind == "sobel":
        fs, correct, n = args
        x = t(None, 1, n, n)
        whole = SobelFilter(n, correct, fs)
        blocks = [whole.on_rows(RowShard(None, j, n_blocks))
                  for j in range(n_blocks)]
        halo = blocks[0].halo()

        def run(x):
            parts = [(f.grad_h(with_halo(*p)), f.grad_v(with_halo(*p)))
                     for f, p in zip(blocks, _cut(x, n_blocks, *halo))]
            return (torch.cat([whole.grad_h(x), whole.grad_v(x)], 1),
                    torch.cat([torch.cat([p[0] for p in parts], -2),
                               torch.cat([p[1] for p in parts], -2)], 1))
        return [x], run, halo
    if kind == "conv":
        k, s, p, cin, cout, n = args
        halo = conv_halo(k, s, p)

        def run(x, w):
            return (F.conv2d(x, w, None, s, p), torch.cat(
                [conv_rows(*blk, w, s, p)
                 for blk in _cut(x, n_blocks, *halo)], -2))
        return [t(None, cin, n, n), t(cout, cin, k, k)], run, halo
    mode, cin, cout, n = args
    up = {"nearest": upsample_nearest, "bilinear": upsample_bilinear}[mode]
    ops = [block_operator(upsample_matrix(n, mode), j, n_blocks, 1)
           for j in range(n_blocks)]
    halo = ops[0][1:]

    def run(x, w):
        return (F.conv2d(up(x), w, None, 1, 1), torch.cat(
            [upsample_conv_rows(*blk, torch.from_numpy(op).to(x), w, mode)
             for blk, (op, _, _) in zip(_cut(x, n_blocks, *halo), ops)],
            -2))
    return [t(None, cin, n, n), t(cout, cin, 3, 3)], run, halo


def row_block_errors(cases, n_blocks: int, device, dtype, batch: int = 2,
                     seed: int = 0) -> dict:
    """For each case of ``row_block_cases``: the largest distance of the
    block arithmetic from the whole field, relative to the whole field's
    largest value, over the output and the gradients of a random
    cotangent with respect to the input and the conv weight; the blocks
    computed one after the other in this process.  Below float64 also
    the distances of both from the whole field in float64."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def t(*shape):
        shape = tuple(batch if d is None else d for d in shape)
        return torch.from_numpy(rng.standard_normal(shape)).to(device, dtype)

    def leaves(vs):
        return [v.detach().requires_grad_(True) for v in vs]

    errs = {}
    for name, kind, args in cases:
        inputs, run, halo = row_block_case(kind, args, n_blocks, t)
        inputs = leaves(inputs)
        y_whole, y_blocks = run(*inputs)
        g = t(*y_whole.shape)
        whole = [y_whole.detach(), *torch.autograd.grad(y_whole, inputs, g)]
        blocks = [y_blocks.detach(),
                  *torch.autograd.grad(y_blocks, inputs, g)]
        keys = ["out", "grad_x", "grad_w"][:len(whole)]

        def rel(got, want):
            return {k: float((a_ - b_).abs().max() / b_.abs().max())
                    for k, a_, b_ in zip(keys, got, want)}

        errs[name] = {"halo": halo, "grad_w": None, **rel(blocks, whole)}
        if dtype != torch.float64:
            # the exact answer's stand-in: the whole field in float64
            ref = leaves([v.double() for v in inputs])
            y64 = run(*ref)[0]
            exact = [y64.detach(), *torch.autograd.grad(y64, ref, g.double())]
            errs[name]["whole_vs_f64"] = rel(whole, exact)
            errs[name]["blocks_vs_f64"] = rel(blocks, exact)
    return errs


def halo_runs(mesh, x: torch.Tensor, cases) -> list[dict]:
    """For each ``(a, b, g_above, g_below)`` of ``cases``: this rank's
    halo of ``x``'s rows (H split over every rank of ``mesh``) from
    ``exchange_rows``, and the gradient with respect to its block of
    ``sum(above * g_above[rank]) + sum(below * g_below[rank])``."""
    from ..parallel.halo import RowShard, exchange_rows
    rows = RowShard(mesh.group, mesh.rank, mesh.world_size)
    h = x.shape[-2] // mesh.world_size
    out = []
    for a, b, g_above, g_below in cases:
        block = x[..., mesh.rank * h:(mesh.rank + 1) * h, :].clone()
        block.requires_grad_(True)
        above, below = exchange_rows(block, a, b, rows)
        ((above * g_above[mesh.rank]).sum()
         + (below * g_below[mesh.rank]).sum()).backward()
        out.append({"above": above.detach(), "below": below.detach(),
                    "grad": block.grad})
    return out


def pcg_rows_runs(mesh, cases) -> list[dict]:
    """For each ``(K, out, n_cg, g)`` of ``cases`` (whole fields, H split
    over every rank of ``mesh``): this rank's rows of the in-loss PCG's
    error e (``ops.darcy._cg_pressure_errors`` on row blocks) and the
    gradient of ``sum(e * g)`` with respect to its block of ``out``."""
    from ..ops.darcy import _cg_pressure_errors
    from ..parallel.halo import RowShard
    rows = RowShard(mesh.group, mesh.rank, mesh.world_size)
    results = []
    for K, out, n_cg, g in cases:
        h = K.shape[-2] // mesh.world_size
        sl = slice(mesh.rank * h, (mesh.rank + 1) * h)
        block = out[..., sl, :].clone().requires_grad_(True)
        e = _cg_pressure_errors(K[..., sl, :], block, n_cg, rows)
        (e * g[..., sl, :]).sum().backward()
        results.append({"e": e.detach(), "grad": block.grad})
    return results
