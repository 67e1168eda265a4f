"""Combiner operations — element-wise merge semantics for table partitions.

Port of ``harp_tpu/combiner.py``. A combiner is a reduction algebra: an
identity element, a binary element-wise op, and a reduction over the worker
axis. In the stacked worker model every cross-worker reduction is
:meth:`Combiner.tree_combine` over axis 0 of a ``(W, ...)`` tensor, taken
left to right in worker order — one fixed order, so every collective that
sums the same contributions gives the same bits.

MINUS and AVG are defined deterministically, as in the reference:
MINUS(a, b...) = a - (sum of all - a) and AVG = SUM / contributor count.
:meth:`Combiner.psum_like` is the combine over the bound group's worker
axis, the one ``collectives/lax_ops.allreduce`` runs.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import torch


class Op(enum.Enum):
    """Combine operations (reference: combiner/Operation.java:9)."""

    SUM = "sum"
    MULTIPLY = "multiply"
    MINUS = "minus"
    MAX = "max"
    MIN = "min"
    AVG = "avg"


def _fold(x: torch.Tensor, fn) -> torch.Tensor:
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = fn(acc, x[i])
    return acc


@dataclasses.dataclass(frozen=True)
class Combiner:
    """A reduction algebra used by Table collectives.

    Attributes:
      op: the logical operation.
      fn: associative binary element-wise op used for pairwise combines.
      identity: identity element for ``fn`` (pads ragged partitions so
        padding never perturbs a reduction).
    """

    op: Op
    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    identity: float

    def tree_combine(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Reduce ``axis`` with this combiner's semantics, element by element
        in index order (a fixed order: the result never depends on the
        device's reduction kernels)."""
        x = x.movedim(axis, 0)
        if self.op in (Op.SUM, Op.MULTIPLY, Op.MAX, Op.MIN):
            return _fold(x, self.fn).clone()
        total = _fold(x, torch.add)
        if self.op is Op.AVG:
            return total / x.shape[0]
        if self.op is Op.MINUS:
            first = x[0]
            return first - (total - first)
        raise ValueError(f"unknown op {self.op}")

    def psum_like(self, x: torch.Tensor) -> torch.Tensor:
        """Combine a stacked ``(W, ...)`` tensor over the worker axis of the
        group bound by ``HarpSession.spmd``, held once: the function
        ``lax_ops.allreduce`` computes (the rows gathered from every process
        in a process group, then :meth:`tree_combine` in worker order)."""
        from harp_tpu_torch.collectives import lax_ops  # lax_ops imports us

        return lax_ops.allreduce(x, self)


_COMBINERS = {
    Op.SUM: Combiner(Op.SUM, torch.add, 0.0),
    Op.MULTIPLY: Combiner(Op.MULTIPLY, torch.mul, 1.0),
    Op.MINUS: Combiner(Op.MINUS, torch.sub, 0.0),
    Op.MAX: Combiner(Op.MAX, torch.maximum, float("-inf")),
    Op.MIN: Combiner(Op.MIN, torch.minimum, float("inf")),
    Op.AVG: Combiner(Op.AVG, torch.add, 0.0),
}


def get(op: Op | str) -> Combiner:
    """Look up the combiner for an operation (accepts Op or its string name)."""
    if isinstance(op, str):
        op = Op(op.lower())
    return _COMBINERS[op]


SUM = _COMBINERS[Op.SUM]
MULTIPLY = _COMBINERS[Op.MULTIPLY]
MINUS = _COMBINERS[Op.MINUS]
MAX = _COMBINERS[Op.MAX]
MIN = _COMBINERS[Op.MIN]
AVG = _COMBINERS[Op.AVG]
