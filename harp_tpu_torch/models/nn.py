"""Mini-batch neural network training: data-parallel gradient allreduce.

Port of ``harp_tpu/models/nn.py``. Reference parity: daal_nn
(NNDaalCollectiveMapper.java:47, mini-batch MLP training on DAAL NN layers;
gather of partial results :218, broadcast of weights :250), BASELINE's
"harp-daal NN (mini-batch allreduce)" workload.

A ReLU MLP with a ``log_softmax`` cross-entropy loss, trained by momentum
SGD (``v = momentum * v - lr * g``, then ``p = p + v``). Every minibatch
each worker computes the loss and gradient of its own batch, and one
allreduce with the AVG combiner (``collectives/lax_ops.allreduce``, the
JAX package's ``pmean``) averages both: the reference's gather and
broadcast in one collective.

Each worker row keeps a parameter copy of its own (the rows are stacked,
``(W, P)`` over one flat buffer of the P parameters), its forward pass is
one call a row and ``torch.autograd`` differentiates the sum of the rows'
losses against the rows' own leaves, so a row's gradient depends on its
batch alone and the allreduce's ``tree_combine`` is the only place the
rows meet: a P-process fit is bitwise the stacked fit at the same W. The
epoch and minibatch loops are Python loops over eager tensor ops (the JAX
package scans them in one compiled program); the losses stay device
tensors until the fit returns. The GEMMs run in float32 with TF32 off
(``ops/precision.full_f32_matmul``), the CPU reference's arithmetic.

``ablate_allreduce=True`` drops the gradient and loss allreduce (a timing
ablation: under W > 1 the rows diverge and the result is wrong); the fit
then returns worker 0's parameters and losses, which is what the JAX
package's replicated out-spec hands back. With telemetry on
(``harp_tpu_torch.telemetry``) a fit records one step event an epoch at the
fetch of its losses.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from harp_tpu_torch import combiner as combiner_lib
from harp_tpu_torch import telemetry
from harp_tpu_torch.collectives import lax_ops
from harp_tpu_torch.ops.precision import full_f32_matmul
from harp_tpu_torch.session import HarpSession

Params = List[Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class NNConfig:
    layers: Tuple[int, ...] = (64, 32)   # hidden sizes
    num_classes: int = 2
    lr: float = 0.1
    momentum: float = 0.9
    batch_size: int = 32                 # per worker
    epochs: int = 10
    ablate_allreduce: bool = False       # timing ablation only (module doc)


def init_params(dims: Sequence[int], seed: int = 0) -> Params:
    """He-normal weights and zero biases, drawn with numpy so both packages
    start from the same bits: ``[(w (d_in, d_out), b (d_out,)), ...]``
    float32 CPU tensors."""
    rng = np.random.default_rng(seed)
    params = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        w = (rng.standard_normal((d_in, d_out)) *
             np.sqrt(2.0 / d_in)).astype(np.float32)
        params.append((torch.from_numpy(w),
                       torch.zeros((d_out,), dtype=torch.float32)))
    return params


def forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits of the ReLU MLP: ``relu(h @ w + b)`` a hidden layer, the last
    layer linear. Its callers hold ``full_f32_matmul`` open."""
    h = x
    for w, b in params[:-1]:
        h = torch.relu(h @ w + b)
    w, b = params[-1]
    return h @ w + b


def _loss(params: Params, x: torch.Tensor, y: torch.Tensor,
          num_classes: int) -> torch.Tensor:
    """Mean cross-entropy of one batch (a label outside the classes has an
    all-zero one-hot row, as ``jax.nn.one_hot`` gives)."""
    logits = forward(params, x)
    onehot = (y[:, None] == torch.arange(num_classes, device=y.device)).to(
        logits.dtype)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(onehot * logp, dim=-1))


def _shapes(params: Params):
    return [(tuple(w.shape), tuple(b.shape)) for w, b in params]


def _flatten(params: Params) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for wb in params for t in wb])


def _unflatten(flat: torch.Tensor, shapes) -> Params:
    """Views of a flat parameter vector ``(P,)`` as ``[(w, b), ...]``."""
    out, off = [], 0
    for sw, sb in shapes:
        nw, nb = int(np.prod(sw)), int(np.prod(sb))
        out.append((flat[off:off + nw].view(sw),
                    flat[off + nw:off + nw + nb].view(sb)))
        off += nw + nb
    return out


def _train(x: torch.Tensor, y: torch.Tensor, params0: Params,
           cfg: NNConfig):
    """The fit inside ``HarpSession.spmd``: ``x`` (W, n, D) and ``y`` (W,
    n) stacked, ``params0`` held once. Returns (params held once, per-epoch
    losses (epochs,)), each epoch's loss the mean of its minibatches'."""
    rows, n_local = x.shape[0], x.shape[1]
    bs = min(cfg.batch_size, n_local)
    nb = -(-n_local // bs)
    # wrap-around padding: the last partial batch is filled from the front
    # so every sample trains each epoch (no silent tail drop)
    sel = torch.arange(nb * bs, device=x.device) % n_local
    xb = x[:, sel].reshape(rows, nb, bs, -1)
    yb = y[:, sel].reshape(rows, nb, bs).long()
    shapes = _shapes(params0)
    flat = _flatten(params0).to(x.dtype)
    params = flat.expand(rows, -1).clone()                 # (rows, P)
    vel = torch.zeros_like(params)
    avg = combiner_lib.AVG
    epoch_losses = []
    with full_f32_matmul():
        for _ in range(cfg.epochs):
            losses = []
            for j in range(nb):
                leaves = [params[r].detach().requires_grad_(True)
                          for r in range(rows)]
                row_loss = [_loss(_unflatten(leaves[r], shapes), xb[r, j],
                                  yb[r, j], cfg.num_classes)
                            for r in range(rows)]
                grads = torch.autograd.grad(sum(row_loss), leaves)
                g = torch.stack(grads)                      # (rows, P)
                loss = torch.stack([t.detach() for t in row_loss])
                if not cfg.ablate_allreduce:
                    loss = lax_ops.allreduce(loss, avg)     # the allreduce
                    g = lax_ops.allreduce(g, avg)
                vel = cfg.momentum * vel - cfg.lr * g
                params = params + vel
                losses.append(loss)
            epoch_losses.append(torch.mean(torch.stack(losses), dim=0))
    losses = torch.stack(epoch_losses)          # (epochs,) or (epochs, rows)
    if cfg.ablate_allreduce:
        # the rows diverged: worker 0's, as the replicated out-spec gives
        return (_unflatten(lax_ops.broadcast(params, 0), shapes),
                lax_ops.broadcast(losses.t().contiguous(), 0))
    return _unflatten(params[0], shapes), losses


class MLPClassifier:
    """daal_nn parity: distributed mini-batch MLP with momentum SGD."""

    def __init__(self, session: HarpSession, config: NNConfig):
        self.session = session
        self.config = config
        self.params = None
        self._fn = None

    def fit(self, x, y, seed: int = 0) -> np.ndarray:
        """Train from :func:`init_params` (``seed``); returns the per-epoch
        losses. ``x`` (N, D) and ``y`` (N,) are host arrays (x taken as
        float32), or tensors already placed by ``session.scatter`` (taken
        in their floating dtype, so a float64 fit is one placed float64
        ``x`` away). ``self.params`` holds the trained ``[(w, b), ...]`` on
        the session's device."""
        sess, cfg = self.session, self.config
        if not isinstance(x, torch.Tensor):
            x = sess.scatter(np.asarray(x, np.float32))
        if not isinstance(y, torch.Tensor):
            y = sess.scatter(np.asarray(y, np.int32))
        dims = (x.shape[1],) + tuple(cfg.layers) + (cfg.num_classes,)
        params0 = [(w.to(sess.device, x.dtype), b.to(sess.device, x.dtype))
                   for w, b in init_params(dims, seed)]
        if self._fn is None:
            self._fn = sess.spmd(
                lambda a, t, p: _train(a, t, p, cfg),
                in_specs=(sess.shard(), sess.shard(), sess.replicate()),
                out_specs=(sess.replicate(), sess.replicate()))
        t0 = time.perf_counter()
        params, losses = self._fn(x, y, params0)
        self.params = params
        losses = losses.cpu().numpy()
        # telemetry at the loss fetch that is here anyway (an event an
        # epoch, the wall amortized over the epochs)
        telemetry.record_chunk("nn", start=0, losses=losses.tolist(),
                               wall_s=time.perf_counter() - t0,
                               ledger=telemetry.ledger_for("nn"))
        return losses

    def predict(self, x) -> np.ndarray:
        """Class of each row of ``x`` (N, D): int32, on the host."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        x = x.to(self.session.device, self.params[0][0].dtype)
        with full_f32_matmul():
            logits = forward(self.params, x)
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
