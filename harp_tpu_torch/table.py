"""Table — the partitioned distributed-dataset abstraction, on a stacked group.

Port of ``harp_tpu/table.py``. A table is ONE tensor of fixed-shape
partitions in one of three distribution states; every Harp collective is a
transition between them (``collectives/table_ops.py``):

  - ``LOCAL``      — every worker holds a full-shape per-worker contribution
                     (e.g. partial centroid sums). Stacked: ``(W, P, ...)``.
  - ``SHARDED``    — each partition exists once, on its owner (BLOCK layout).
                     Stacked: ``(W, P/W, ...)``, worker w's block at ``[w]``.
  - ``REPLICATED`` — all workers hold identical combined values, held once:
                     ``(P, ...)``.

The JAX package sees one worker's block inside ``shard_map``; here one
tensor holds every worker's block along a leading worker axis (the stacked
worker group, ``parallel/mesh.py``), so LOCAL and SHARDED data carry that
axis and REPLICATED data does not (in a process group that axis holds
this process's workers). Ragged partition counts are padded with
the combiner's identity so padding never perturbs a reduction. A Table is a
plain frozen dataclass.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import torch

from harp_tpu_torch import combiner as combiner_lib
from harp_tpu_torch.parallel import mesh as mesh_lib


class Dist(enum.Enum):
    LOCAL = "local"
    SHARDED = "sharded"
    REPLICATED = "replicated"


def round_up(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def _pad_partitions(data: torch.Tensor, axis: int, num_workers: int,
                    identity: float) -> torch.Tensor:
    p = data.shape[axis]
    padded = round_up(p, num_workers)
    if padded == p:
        return data
    shape = list(data.shape)
    shape[axis] = padded - p
    pad = torch.full(shape, identity, dtype=data.dtype, device=data.device)
    return torch.cat([data, pad], dim=axis)


@dataclasses.dataclass(frozen=True)
class Table:
    """A distributed table of fixed-shape partitions.

    Attributes:
      data: the partition payloads (layout per ``dist``, module docstring).
      combiner: reduction algebra for combine-on-collision semantics.
      dist: distribution state.
      num_partitions: global partition count (P), including padding rows.
      valid: number of real (non-padding) partitions, <= num_partitions.
      name: debug name.
    """

    data: torch.Tensor
    combiner: combiner_lib.Combiner = combiner_lib.SUM
    dist: Dist = Dist.LOCAL
    num_partitions: int = 0
    valid: int = 0
    name: str = "table"

    @classmethod
    def local(cls, data: torch.Tensor, *,
              combiner: combiner_lib.Combiner = combiner_lib.SUM,
              num_workers: int, valid: Optional[int] = None,
              name: str = "table") -> "Table":
        """Wrap stacked per-worker contributions ``(W, P, ...)`` as a LOCAL
        table, padding the partition axis up to a multiple of
        ``num_workers`` with the combiner's identity element."""
        rows = mesh_lib.stacked_rows(num_workers)
        if data.dim() < 2 or data.shape[0] != rows:
            raise ValueError(
                f"a LOCAL table holds one contribution per worker: expected "
                f"a stacked (W={rows}, P, ...) tensor, got shape "
                f"{tuple(data.shape)}")
        p = data.shape[1]
        data = _pad_partitions(data, 1, num_workers, combiner.identity)
        return cls(data, combiner, Dist.LOCAL, data.shape[1],
                   valid if valid is not None else p, name)

    @classmethod
    def replicated(cls, data: torch.Tensor, *,
                   combiner: combiner_lib.Combiner = combiner_lib.SUM,
                   num_workers: int, valid: Optional[int] = None,
                   name: str = "table") -> "Table":
        """Wrap a value every worker holds, ``(P, ...)``, held once."""
        p = data.shape[0]
        data = _pad_partitions(data, 0, num_workers, combiner.identity)
        return cls(data, combiner, Dist.REPLICATED, data.shape[0],
                   valid if valid is not None else p, name)

    @classmethod
    def sharded(cls, blocks: torch.Tensor, *,
                combiner: combiner_lib.Combiner = combiner_lib.SUM,
                num_workers: int, valid: Optional[int] = None,
                name: str = "table") -> "Table":
        """Wrap every worker's owned block, stacked ``(W, P/W, ...)``, as a
        SHARDED table."""
        rows = mesh_lib.stacked_rows(num_workers)
        if blocks.dim() < 2 or blocks.shape[0] != rows:
            raise ValueError(
                f"a SHARDED table holds one block per worker: expected a "
                f"stacked (W={rows}, P/W, ...) tensor, got shape "
                f"{tuple(blocks.shape)}")
        p = blocks.shape[1] * num_workers
        return cls(blocks, combiner, Dist.SHARDED, p,
                   valid if valid is not None else p, name)

    @property
    def partition_shape(self) -> Tuple[int, ...]:
        lead = 1 if self.dist is Dist.REPLICATED else 2
        return tuple(self.data.shape[lead:])

    def block_size(self, num_workers: int) -> int:
        return self.num_partitions // num_workers

    def with_data(self, data: torch.Tensor,
                  dist: Optional[Dist] = None) -> "Table":
        return dataclasses.replace(self, data=data, dist=dist or self.dist)

    def trim(self) -> torch.Tensor:
        """Drop padding rows (only meaningful for LOCAL/REPLICATED)."""
        if self.dist is Dist.REPLICATED:
            return self.data[: self.valid]
        return self.data[:, : self.valid]


def key_value_table(keys: torch.Tensor, values: torch.Tensor, *,
                    combiner: combiner_lib.Combiner = combiner_lib.SUM,
                    num_workers: int, name: str = "kv") -> Table:
    """Key-value table (reference: ``keyval/`` Key2ValKVTable:88 etc.): a
    LOCAL table whose partition is a (key, value...) record, stacked keys
    ``(W, n)`` and values ``(W, n, ...)`` as ``(W, n, 1 + F)``. Equal keys
    are combined by ``collectives.table_ops.group_by_key``.

    The keys are cast to the values' dtype, as in the JAX package: for
    float32 values that is exact only for keys up to 2^24."""
    data = torch.cat([keys.to(values.dtype)[..., None],
                      values.reshape(values.shape[0], values.shape[1], -1)],
                     dim=2)
    return Table.local(data, combiner=combiner, num_workers=num_workers,
                       name=name)
