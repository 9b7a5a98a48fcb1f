"""L-BFGS and the Adam warmup of the per-instance solver nets.

Counterpart of pde_surrogate_tpu/train/lbfgs.py, which runs optax 0.2.6's
``lbfgs``; this module ports that algorithm (not ``torch.optim.LBFGS``,
whose first-step damping and strong-Wolfe search differ from the first
iterate):

* ``scale_by_lbfgs``: the two-loop recursion over a fixed memory of
  (memory_size, P) parameter and gradient differences.  The first step
  scales the identity by the capped reciprocal gradient norm
  min(1, 1/||g||), later steps by <s, y> / <y, y>;
* then either a fixed ``-lr`` step, or optax's zoom linesearch
  (``scale_by_zoom_linesearch``: ``_cubicmin``, ``_quadmin``, the interval
  search and the zoom, ``max_linesearch_steps=20``,
  ``initial_guess_strategy="one"``), whose last value and gradient are
  reused by the next step (``value_and_grad_from_state``).

Everything works on one flat parameter vector (``FlatParams``).  The zoom's
branches depend on the data, so its scalar state lives on the host as
float64 numpy scalars (NaN and inf behave as in JAX) and each loss
evaluation of the linesearch costs one host sync (value and slope); the
vectors stay on the device.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

__all__ = ["FlatParams", "LBFGSState", "lbfgs_optimizer", "make_lbfgs_epoch",
           "run_adam_warmup", "value_and_grad"]


class FlatParams:
    """A module's parameters as one flat vector, and back: ``unflatten``
    returns views (``torch.split``) for ``torch.func.functional_call``, so
    a loss of the flat vector has its gradient as one flat vector."""

    def __init__(self, module: torch.nn.Module):
        named = list(module.named_parameters())
        self.names = [n for n, _ in named]
        self.shapes = [p.shape for _, p in named]
        self.sizes = [p.numel() for _, p in named]
        self.module = module

    def vector(self) -> torch.Tensor:
        return torch.cat([p.detach().reshape(-1)
                          for p in self.module.parameters()])

    def unflatten(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        return {n: c.view(s) for n, c, s in
                zip(self.names, torch.split(flat, self.sizes), self.shapes)}

    def load(self, flat: torch.Tensor) -> None:
        """Copy ``flat`` into the module's parameters."""
        with torch.no_grad():
            for p, c in zip(self.module.parameters(),
                            torch.split(flat, self.sizes)):
                p.copy_(c.view(p.shape))


def value_and_grad(loss_fn: Callable, x: torch.Tensor):
    """(loss, d loss / d x) of a scalar loss of the flat vector ``x``, both
    detached."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        value = loss_fn(x)
        (grad,) = torch.autograd.grad(value, x)
    return value.detach(), grad


def run_adam_warmup(loss_fn: Callable, params: torch.Tensor, n_steps: int,
                    learning_rate: float):
    """``n_steps`` Adam steps (optax ``adam(lr)``: betas 0.9 / 0.999,
    eps 1e-8 outside the square root, the formula of ``torch.optim.Adam``)
    on the flat vector ``params``.  Returns ``(params, loss(params))``: the
    loss of the returned parameters, with one host sync at the end."""
    x = params.detach().clone().requires_grad_(True)
    if n_steps > 0:
        opt = torch.optim.Adam([x], lr=learning_rate, betas=(0.9, 0.999),
                               eps=1e-8)
        for _ in range(n_steps):
            opt.zero_grad(set_to_none=True)
            loss_fn(x).backward()
            opt.step()
    x = x.detach()
    with torch.no_grad():
        return x, float(loss_fn(x))


class LBFGSState:
    """The optimizer's state: ``scale_by_lbfgs``'s memory (count, the last
    params and gradient, the (memory_size, P) difference buffers and their
    weights), the linesearch's cached value and gradient (value inf: none
    cached), and ``evals``, the loss evaluations of the last epoch."""

    def __init__(self, params: torch.Tensor, memory_size: int):
        p = params.detach()
        self.count = 0
        self.params = torch.zeros_like(p)
        self.updates = torch.zeros_like(p)
        self.diff_params = p.new_zeros(memory_size, p.numel())
        self.diff_updates = p.new_zeros(memory_size, p.numel())
        self.weights = p.new_zeros(memory_size)
        self.value = math.inf
        self.grad = torch.zeros_like(p)
        self.stepsize = 1.0
        self.linesearch_steps = 0
        self.evals = 0


class _LBFGS:
    """optax ``lbfgs(learning_rate, memory_size, linesearch)`` on a flat
    vector: ``init(params)`` and ``update(grad, state, params, value,
    value_fn) -> updates``."""

    def __init__(self, memory_size: int, learning_rate: float | None):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.memory_size = memory_size
        self.learning_rate = learning_rate

    def init(self, params: torch.Tensor) -> LBFGSState:
        return LBFGSState(params, self.memory_size)

    def _precondition(self, g: torch.Tensor, state: LBFGSState,
                      params: torch.Tensor) -> torch.Tensor:
        """``scale_by_lbfgs``: store the newest differences, then the
        two-loop product of the inverse-Hessian estimate with g."""
        m = self.memory_size
        c = state.count
        mem_idx = c % m
        if c > 0:
            prev = (c - 1) % m
            dw = params - state.params
            du = g - state.updates
            vd = torch.dot(du, dw)
            state.diff_params[prev] = dw
            state.diff_updates[prev] = du
            state.weights[prev] = torch.where(vd == 0.0, 0.0, 1.0 / vd)
            den = torch.dot(du, du)
            gamma = torch.where(den > 0.0, vd / den, 1.0)
        else:
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)
        # optax scans all memory_size slots; the ones never written hold
        # zeros and weight 0 and leave the vector exactly as it is
        order = [(mem_idx + j) % m for j in range(m)]
        filled = [i for i in order if i < min(c, m)]
        rho, dws, dus = state.weights, state.diff_params, state.diff_updates
        vec = g
        alphas = {}
        for i in reversed(filled):
            alphas[i] = rho[i] * torch.dot(dws[i], vec)
            vec = vec - alphas[i] * dus[i]
        vec = gamma * vec
        for i in filled:
            beta = rho[i] * torch.dot(dus[i], vec)
            vec = vec + (alphas[i] - beta) * dws[i]
        state.count = c + 1
        state.params = params
        state.updates = g
        return vec

    def update(self, grad: torch.Tensor, state: LBFGSState,
               params: torch.Tensor, value: torch.Tensor,
               value_fn: Callable) -> torch.Tensor:
        direction = -self._precondition(grad, state, params)
        if self.learning_rate is not None:
            return self.learning_rate * direction
        stepsize, state.value, state.grad, state.linesearch_steps = (
            _zoom_linesearch(value_fn, params, direction, float(value), grad,
                             MAX_LINESEARCH_STEPS))
        state.stepsize = stepsize
        return stepsize * direction


def lbfgs_optimizer(memory_size: int = 50,
                    learning_rate: float | None = 0.5) -> _LBFGS:
    """L-BFGS as the JAX package configures optax's: a fixed ``lr`` step
    (the reference's torch ``LBFGS(lr=0.5, history_size=50)`` semantics,
    not its trajectory), or with ``learning_rate=None`` the zoom
    linesearch (max 20 steps, each search from the unit step)."""
    return _LBFGS(memory_size, learning_rate)


def make_lbfgs_epoch(loss_fn: Callable, opt: _LBFGS,
                     iters_per_epoch: int = 20,
                     with_linesearch: bool = True):
    """``epoch(params, state) -> (params, state, loss)``: ``iters_per_epoch``
    L-BFGS steps on the flat vector, then the loss of the RETURNED params
    (a blowup inside the last update must not pair a good loss with
    garbage params).  ``with_linesearch`` reuses the value and gradient the
    linesearch cached (recomputed when none is cached or it is not
    finite); without it every step evaluates afresh.  ``state.evals``
    counts the loss evaluations of the epoch, the final one included."""

    def epoch(params: torch.Tensor, state: LBFGSState):
        evals = 0

        def counted(x):
            nonlocal evals
            evals += 1
            return loss_fn(x)

        for _ in range(iters_per_epoch):
            if with_linesearch and math.isfinite(state.value):
                value, grad = state.value, state.grad
            else:
                value, grad = value_and_grad(counted, params)
            updates = opt.update(grad, state, params, value, counted)
            params = params + updates
        with torch.no_grad():
            loss = counted(params)
        state.evals = evals
        return params, state, loss

    return epoch


# ---------------------------------------------------------------------------
# optax's zoom linesearch (optax/_src/linesearch.py, version 0.2.6)
# ---------------------------------------------------------------------------

_F = np.float64
# the JAX package's setting, and optax's defaults for the rest: the
# sufficient-decrease and curvature constants of the strong Wolfe
# conditions, the approximate-decrease tolerance, the interval growth and
# the interval length below which the zoom gives up
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
INCREASE_FACTOR, INTERVAL_THRESHOLD = 2.0, 1e-5


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Minimizer of the cubic through (a, fa) with slope fpa, (b, fb) and
    (c, fc); NaN or inf where it has none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r1 = fb - fa - C * db
    r2 = fc - fa - C * dc
    A = (dc ** 2 * r1 - db ** 2 * r2) / denom
    B = (-(dc ** 3) * r1 + db ** 3 * r2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Minimizer of the quadratic through (a, fa) with slope fpa and
    (b, fb)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _zoom_linesearch(value_and_grad_fn, params: torch.Tensor,
                     updates: torch.Tensor, value: float, grad: torch.Tensor,
                     max_steps: int):
    """optax's ``zoom_linesearch`` with ``initial_guess_strategy="one"``,
    tolerance 0 and no maximal stepsize: a step satisfying the strong
    Wolfe conditions (sufficient decrease, with the approximate-decrease
    variant, and curvature) along ``updates``, in at most ``max_steps``
    loss evaluations.  Returns ``(stepsize, value, grad, steps)`` at the
    accepted step."""
    with np.errstate(all="ignore"):
        return _zoom(value_and_grad_fn, params, updates, _F(value), grad,
                     max_steps)


def _zoom(fn, params, updates, value, grad, max_steps):
    inf = _F(np.inf)
    tol = 0.0

    def on_line(stepsize):
        v, g = value_and_grad(fn, params + float(stepsize) * updates)
        v_s = torch.stack([v.to(g.dtype), torch.dot(g, updates)]).tolist()
        return _F(v_s[0]), g, _F(v_s[1])

    def decrease_error(stepsize, value_step, slope_step):
        err = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
        approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
        delta = value_step - value_init - APPROX_DEC_RTOL * np.abs(value_init)
        err = np.minimum(np.maximum(approx, delta), err)
        err = np.maximum(err, 0.0)
        return inf if np.isnan(err) else err

    def curvature_error(slope_step):
        err = np.maximum(np.abs(slope_step) - CURV_RTOL * np.abs(slope_init),
                         0.0)
        return inf if np.isnan(err) else err

    slope = _F(torch.dot(updates, grad).item())
    value_init, slope_init = value, slope
    s = dict(count=0, stepsize=_F(0.0), value=value, grad=grad, slope=slope,
             decrease_error=inf, interval_found=False, done=False,
             failed=False, low=_F(0.0), value_low=value, slope_low=slope,
             high=_F(0.0), value_high=value, slope_high=slope,
             cubic_ref=_F(0.0), value_cubic_ref=value,
             safe_stepsize=_F(0.0), safe_value=value, safe_grad=grad)

    def search_interval():
        it = s["count"]
        prev_step, prev_value, prev_slope = (s["stepsize"], s["value"],
                                             s["slope"])
        new = _F(1.0) if it == 0 else INCREASE_FACTOR * prev_step
        new_value, new_grad, new_slope = on_line(new)
        dec = decrease_error(new, new_value, new_slope)
        error = np.maximum(dec, curvature_error(new_slope))
        if dec <= tol:
            s.update(safe_stepsize=new, safe_value=new_value,
                     safe_grad=new_grad)
        set_high_to_new = (dec > 0.0) or (new_value >= prev_value and it > 0)
        set_low_to_new = (new_slope >= 0.0) and not set_high_to_new
        lo = (new, new_value, new_slope)
        hi = (prev_step, prev_value, prev_slope)
        if not set_low_to_new:
            lo, hi = hi, lo
        done = bool(error <= tol)
        s.update(count=it + 1, stepsize=new, value=new_value, grad=new_grad,
                 slope=new_slope, decrease_error=dec,
                 interval_found=set_high_to_new or set_low_to_new or done,
                 done=done, failed=(it + 1 >= max_steps) and not done,
                 low=lo[0], value_low=lo[1], slope_low=lo[2],
                 high=hi[0], value_high=hi[1], slope_high=hi[2],
                 cubic_ref=lo[0], value_cubic_ref=lo[1])

    def zoom_into_interval():
        it = s["count"]
        low, value_low, slope_low = s["low"], s["value_low"], s["slope_low"]
        high, value_high, slope_high = (s["high"], s["value_high"],
                                        s["slope_high"])
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        middle_cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                                 s["cubic_ref"], s["value_cubic_ref"])
        middle_quad = _quadmin(low, value_low, slope_low, high, value_high)
        if left + 0.2 * delta < middle_cubic < right - 0.2 * delta:
            middle = middle_cubic
        elif left + 0.1 * delta < middle_quad < right - 0.1 * delta:
            middle = middle_quad
        else:
            middle = (low + high) / 2.0
        value_mid, grad_mid, slope_mid = on_line(middle)
        dec = decrease_error(middle, value_mid, slope_mid)
        error = np.maximum(dec, curvature_error(slope_mid))
        if dec <= tol and value_mid < s["safe_value"]:
            s.update(safe_stepsize=middle, safe_value=value_mid,
                     safe_grad=grad_mid)
        done = bool(error <= tol)
        set_high_to_middle = (dec > 0.0) or (value_mid >= value_low)
        set_high_to_low = (slope_mid * (high - low) >= 0.0
                           and not set_high_to_middle)
        new_hi = (high, value_high, slope_high)
        if set_high_to_middle:
            new_hi = (middle, value_mid, slope_mid)
        if set_high_to_low:
            new_hi = (low, value_low, slope_low)
        new_lo = (low, value_low, slope_low)
        if not set_high_to_middle:
            new_lo = (middle, value_mid, slope_mid)
        ref = ((high, value_high) if set_high_to_middle or set_high_to_low
               else (low, value_low))
        failed = ((it + 1 >= max_steps
                   or (delta <= INTERVAL_THRESHOLD
                       and s["safe_stepsize"] > 0.0)) and not done)
        s.update(count=it + 1, stepsize=middle, value=value_mid,
                 grad=grad_mid, slope=slope_mid, decrease_error=dec,
                 done=done, failed=failed,
                 low=new_lo[0], value_low=new_lo[1], slope_low=new_lo[2],
                 high=new_hi[0], value_high=new_hi[1], slope_high=new_hi[2],
                 cubic_ref=ref[0], value_cubic_ref=ref[1])

    while not (s["done"] or s["failed"]):
        if s["interval_found"]:
            zoom_into_interval()
        else:
            search_interval()
        if s["failed"] and (s["safe_stepsize"] > 0.0
                            or np.isinf(s["decrease_error"])):
            # _try_safe_step: fall back to the best step with sufficient
            # decrease (or to none if even a step gives inf or NaN)
            s.update(stepsize=s["safe_stepsize"], value=s["safe_value"],
                     grad=s["safe_grad"])
    return float(s["stepsize"]), float(s["value"]), s["grad"], s["count"]
