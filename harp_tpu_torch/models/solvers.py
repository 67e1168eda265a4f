"""Distributed optimization solvers: the daal_optimization_solvers family.

Port of ``harp_tpu/models/solvers.py``. Reference parity (SURVEY §2.7):
daal_optimization_solvers/{SGDDenseBatch, SGDMiniDenseBatch,
SGDMomentDenseBatch, AdaGradient, LBFGSDenseBatch, MSEDenseBatch}. Each
step computes the objective's gradient on every worker's data shard and
averages loss and gradient with one allreduce (the AVG combiner, the JAX
package's ``pmean``).

An objective is a torch callable ``objective(theta, x_block, y_block) ->
scalar mean loss``, differentiated with ``torch.autograd``; ``theta`` is a
flat parameter vector. Each worker row's gradient is its own (one call a
row against a leaf of its own), so the allreduce's ``tree_combine`` is the
only place the rows meet and a P-process run is bitwise the stacked run.
The iteration loops are Python loops over eager tensor ops that keep every
value on the device, L-BFGS's history masks too (``torch.where``, no host
sync in a step); the losses are fetched once at the end. The products run
in float32 with TF32 off (``ops/precision.full_f32_matmul``).

The JAX ``Solver._objective_key`` keys a cache of compiled programs so that
re-created but identical objectives share one; the eager port compiles
nothing and has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from harp_tpu_torch import combiner as combiner_lib
from harp_tpu_torch.collectives import lax_ops
from harp_tpu_torch.ops.precision import full_f32_matmul
from harp_tpu_torch.session import HarpSession


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    lr: float = 0.1
    iterations: int = 100
    momentum: float = 0.9        # sgd_momentum
    batch_size: int = 0          # sgd_minibatch: per-worker batch (0 = full)
    history: int = 10            # lbfgs memory
    eps: float = 1e-8            # adagrad


def mse_objective(theta: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """DAAL MSEDenseBatch: mean squared error of the linear model x @ theta."""
    pred = x @ theta
    return torch.mean((pred - y) ** 2)


def _dist_grad(objective, theta, x, y):
    """(loss, gradient) averaged over the workers: each row's against a leaf
    of its own, then one AVG allreduce of each."""
    rows = x.shape[0]
    leaves = [theta.detach().requires_grad_(True) for _ in range(rows)]
    losses = [objective(leaves[r], x[r], y[r]) for r in range(rows)]
    grads = torch.autograd.grad(sum(losses), leaves)
    avg = combiner_lib.AVG
    loss = lax_ops.allreduce(torch.stack([t.detach() for t in losses]), avg)
    return loss, lax_ops.allreduce(torch.stack(grads), avg)


def _sgd(objective, x, y, theta0, cfg):
    theta, losses = theta0, []
    for _ in range(cfg.iterations):
        loss, g = _dist_grad(objective, theta, x, y)
        theta = theta - cfg.lr * g
        losses.append(loss)
    return theta, losses


def _sgd_momentum(objective, x, y, theta0, cfg):
    theta, vel, losses = theta0, torch.zeros_like(theta0), []
    for _ in range(cfg.iterations):
        loss, g = _dist_grad(objective, theta, x, y)
        vel = cfg.momentum * vel - cfg.lr * g
        theta = theta + vel
        losses.append(loss)
    return theta, losses


def _sgd_minibatch(objective, x, y, theta0, cfg):
    rows, n_local = x.shape[0], x.shape[1]
    bs = min(cfg.batch_size or n_local, n_local)   # batch_size is per-worker
    nb = -(-n_local // bs)
    # wrap-around padding so no tail sample is dropped (the last batch
    # reuses rows from the front; every sample takes part each sweep)
    sel = torch.arange(nb * bs, device=x.device) % n_local
    xb = x[:, sel].reshape((rows, nb, bs) + tuple(x.shape[2:]))
    yb = y[:, sel].reshape((rows, nb, bs) + tuple(y.shape[2:]))
    theta, losses = theta0, []
    for t in range(cfg.iterations):
        b = t % nb
        loss, g = _dist_grad(objective, theta, xb[:, b], yb[:, b])
        theta = theta - cfg.lr * g
        losses.append(loss)
    return theta, losses


def _adagrad(objective, x, y, theta0, cfg):
    theta, acc, losses = theta0, torch.zeros_like(theta0), []
    for _ in range(cfg.iterations):
        loss, g = _dist_grad(objective, theta, x, y)
        acc = acc + g * g
        theta = theta - cfg.lr * g / torch.sqrt(acc + cfg.eps)
        losses.append(loss)
    return theta, losses


def _at(t: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``t[j]`` for a 0-d device index ``j``, without reading it on the
    host."""
    return torch.index_select(t, 0, j[None])[0]


def _lbfgs_direction(g, s_hist, y_hist, rho, head, m):
    """Two-loop recursion over the circular history, newest to oldest; the
    slot indices are device tensors (``%`` follows Python's sign, as
    ``jnp`` does, for ``head - 1 - i`` and ``head - m + i`` below 0)."""
    q, alphas = g, torch.zeros(m, dtype=g.dtype, device=g.device)
    for i in range(m):
        j = (head - 1 - i) % m
        a = _at(rho, j) * torch.dot(_at(s_hist, j), q)
        q = q - a * _at(y_hist, j)
        alphas = alphas.index_put((j[None],), a[None])
    newest = (head - 1) % m
    ynewest, snewest = _at(y_hist, newest), _at(s_hist, newest)
    denom = torch.dot(ynewest, ynewest)
    gamma = torch.where(denom > 0, torch.dot(snewest, ynewest) / denom,
                        torch.ones_like(denom))
    r = gamma * q
    for i in range(m):
        j = (head - m + i) % m
        beta = _at(rho, j) * torch.dot(_at(y_hist, j), r)
        r = r + _at(s_hist, j) * (_at(alphas, j) - beta)
    return -r


def _lbfgs(objective, x, y, theta0, cfg):
    """L-BFGS with fixed memory, two-loop recursion, no line search (step =
    lr scaled by the standard initial Hessian gamma = s.y / y.y). A pair
    (s, y) enters the history only when s.y > 1e-10, decided on the device
    with ``torch.where``."""
    m, p = cfg.history, theta0.shape[0]
    dt, dev = theta0.dtype, theta0.device
    theta, theta_prev = theta0, theta0
    g_prev = torch.zeros(p, dtype=dt, device=dev)
    s_hist = torch.zeros((m, p), dtype=dt, device=dev)
    y_hist = torch.zeros((m, p), dtype=dt, device=dev)
    rho = torch.zeros(m, dtype=dt, device=dev)
    head = torch.zeros((), dtype=torch.int64, device=dev)
    losses = []
    for t in range(cfg.iterations):
        loss, g = _dist_grad(objective, theta, x, y)
        s = theta - theta_prev
        y_vec = g - g_prev
        sy = torch.dot(s, y_vec)
        valid = (sy > 1e-10) & (t > 0)
        idx = (head % m)[None]
        s_hist = torch.where(valid, s_hist.index_put((idx,), s[None]),
                             s_hist)
        y_hist = torch.where(valid, y_hist.index_put((idx,), y_vec[None]),
                             y_hist)
        rho = torch.where(valid, rho.index_put(
            (idx,), (1.0 / torch.clamp(sy, min=1e-10))[None]), rho)
        head = head + valid.to(torch.int64)
        d = torch.where(head > 0,
                        _lbfgs_direction(g, s_hist, y_hist, rho, head, m),
                        -g)
        theta, theta_prev, g_prev = theta + cfg.lr * d, theta, g
        losses.append(loss)
    return theta, losses


_SOLVERS = {
    "sgd": _sgd,
    "sgd_minibatch": _sgd_minibatch,
    "sgd_momentum": _sgd_momentum,
    "adagrad": _adagrad,
    "lbfgs": _lbfgs,
}


class Solver:
    """Front end: ``Solver(sess, "lbfgs", cfg).minimize(objective, x, y,
    theta0)``."""

    def __init__(self, session: HarpSession, kind: str,
                 config: SolverConfig = SolverConfig()):
        if kind not in _SOLVERS:
            raise ValueError(f"kind must be one of {sorted(_SOLVERS)}")
        self.session = session
        self.kind = kind
        self.config = config

    def minimize(self, objective: Callable, x, y, theta0
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Run ``config.iterations`` steps from ``theta0``: (theta,
        per-step losses), on the host. ``x`` (N, ...) and ``y`` (N, ...)
        are host arrays (taken as float32, as the JAX package does) or
        tensors already placed by ``session.scatter`` (taken as they are,
        so a float64 run is placed float64 data away); ``theta0`` takes
        ``x``'s dtype."""
        sess, cfg = self.session, self.config
        if not isinstance(x, torch.Tensor):
            x = sess.scatter(np.asarray(x, np.float32))
        if not isinstance(y, torch.Tensor):
            y = sess.scatter(np.asarray(y, np.float32))
        t0 = torch.as_tensor(np.asarray(theta0) if not isinstance(
            theta0, torch.Tensor) else theta0).to(sess.device, x.dtype)
        impl = _SOLVERS[self.kind]

        def run(a, b, th):
            with full_f32_matmul():
                theta, losses = impl(objective, a, b, th, cfg)
            return theta, torch.stack(losses)

        theta, losses = sess.run(
            run, x, y, t0, in_specs=(sess.shard(), sess.shard(),
                                     sess.replicate()),
            out_specs=(sess.replicate(), sess.replicate()))
        return theta.detach().cpu().numpy(), losses.cpu().numpy()
