"""Live resharding on the device: array redistribution by collective rounds.

Port of ``harp_tpu/collectives/reshard.py``, the device twin of
:mod:`collectives.repartition` (arXiv:2112.01075, memory-efficient array
redistribution, PAPERS.md). A resume at another world size moves every row
of a sharded leaf between two block layouts ON the worker group instead of
gathering the table to the host: the (old bin/slot -> new bin/slot)
permutation is cut host-side (numpy planners, copies of the JAX package's)
into a bounded sequence of ``all_to_all`` or ring ``rotate`` rounds whose
payload never exceeds ``chunk_bytes``.

Contract:

* **bitwise**: rows are copied verbatim (gather -> collective -> scatter, no
  arithmetic), so the result equals ``repartition.repartition_factor`` /
  ``rematch_tokens`` on the same maps; the numpy path stays the parity
  oracle and the one-worker fallback.
* **bounded**: each round's collective carries at most ``chunk_bytes`` of
  row payload a worker (the ``all_to_all`` operand for the default
  schedule, each ``rotate`` for the ring schedule).
* **on the device**: the program never copies a sharded source or its
  result to the host; a saved numpy leaf goes up once (the upload any resume
  pays). In a process group the rounds run through ``lax_ops``' gloo
  branches, staged through the host as every non-fused collective there is.

The programs are eager loops over the planned rounds (the JAX package's
``lax.scan``). ``comm`` on the ring schedule takes the quantized wire
(``collectives/quantize.py``, trading the bitwise contract for volume); one
card has no slow link, so a ring round is never cut into link chunks.

Layout vocabulary: a row-sharded leaf lives in *device order*, worker ``w``
holding ``local_rows`` consecutive rows of the flattened global array. A
:class:`RowLayout` maps canonical ids into that order through the model's
(bin, slot) assignment plus the bin -> (worker, base) placement (1-slice:
bin b on worker b at base 0; 2-slice: bin b on worker ``b % W`` at base
``(b // W) * rows_per_bin``, the worker-major half-slice stacking of
``sgd_mf._place_h0`` and LDA's 2-slice wt).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# One round of foreign rows per worker: 1 MiB by default — small enough that
# even a GB-scale table reshards in bounded memory, large enough that the
# round count stays in the hundreds.
DEFAULT_CHUNK_BYTES = 1 << 20


def resolve_mode(mode: str, num_workers: int) -> str:
    """The ONE resume-reshard mode resolution every model shares
    (``SGDMFConfig.reshard`` / ``LDAConfig.reshard``): validates
    ``auto|device|ring|host`` and resolves ``auto`` to the device schedule
    on a multi-worker mesh, to the host oracle on a 1-worker mesh (the
    small-world fallback — nothing to redistribute over)."""
    if mode not in ("auto", "device", "ring", "host"):
        raise ValueError(f"reshard must be auto|device|ring|host, "
                         f"got {mode!r}")
    if mode == "auto":
        return "host" if num_workers == 1 else "device"
    return mode


# --------------------------------------------------------------------------- #
# Layouts
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Where each canonical id's row lives on a ``num_workers`` mesh."""

    bins: np.ndarray          # (n_ids,) bin of canonical id i
    slots: np.ndarray         # (n_ids,) slot within the bin
    rows_per_bin: int
    num_bins: int
    bin_owner: np.ndarray     # (num_bins,) worker holding each bin
    bin_base: np.ndarray      # (num_bins,) local row offset of the bin
    local_rows: int           # device rows per worker

    @property
    def total_rows(self) -> int:
        return self.num_bins * self.rows_per_bin

    def device_positions(self, n_valid: int) -> np.ndarray:
        """Flat device-order position of each of the first ``n_valid`` ids:
        ``owner * local_rows + base + slot``."""
        b = np.asarray(self.bins[:n_valid], np.int64)
        s = np.asarray(self.slots[:n_valid], np.int64)
        if len(b) and (b.min() < 0 or b.max() >= self.num_bins
                       or s.min() < 0 or s.max() >= self.rows_per_bin):
            raise ValueError(
                f"assignment maps address (bin, slot) outside the layout "
                f"({self.num_bins} bins x {self.rows_per_bin} rows) — the "
                f"maps do not describe this layout")
        return (np.asarray(self.bin_owner, np.int64)[b] * self.local_rows
                + np.asarray(self.bin_base, np.int64)[b] + s)


def block_layout(assign: Tuple[np.ndarray, np.ndarray], rows_per_bin: int,
                 num_workers: int, num_slices: int = 1) -> RowLayout:
    """Layout of a (bin, slot)-assigned factor table.

    ``num_slices=1``: bin b lives whole on worker b (the W factor, 1-slice H,
    1-slice LDA wt).  ``num_slices=2``: bins are worker-major half-slices —
    bin b on worker ``b % W`` at base ``(b // W) * rows_per_bin`` (the
    ``_place_h0`` / 2-slice wt stacking)."""
    num_bins = num_slices * num_workers
    b = np.arange(num_bins)
    return RowLayout(
        bins=np.asarray(assign[0]), slots=np.asarray(assign[1]),
        rows_per_bin=int(rows_per_bin), num_bins=num_bins,
        bin_owner=(b % num_workers).astype(np.int64),
        bin_base=((b // num_workers) * rows_per_bin).astype(np.int64),
        local_rows=num_slices * int(rows_per_bin))


def contiguous_split(positions: np.ndarray, total_rows: int,
                     num_workers: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """(worker, slot, padded_total) of flat positions under an even
    contiguous split over ``num_workers`` — how a flat host leaf (or a live
    device array) shards over the mesh."""
    per = -(-max(int(total_rows), 1) // num_workers)
    p = np.asarray(positions, np.int64)
    if len(p) and (p.min() < 0 or p.max() >= total_rows):
        raise ValueError(
            f"positions address rows outside the flat leaf "
            f"({total_rows} rows, max {p.max() if len(p) else 0})")
    return p // per, p % per, per * num_workers


# --------------------------------------------------------------------------- #
# Plans
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """Host-computed move schedule: which local row each worker ships to
    each peer in each bounded round, and where received rows land."""

    num_workers: int
    schedule: str             # "alltoall" | "ring"
    chunk_rows: int           # rows per (peer, round) — the byte bound
    src_rows: int             # padded flat source rows (divides num_workers)
    dst_rows: int             # flat destination rows (divides num_workers)
    rounds: int               # alltoall rounds (ring: sum over shifts)
    # alltoall: (W, rounds, W, C) send local-slots / recv local-positions,
    # -1 = pad.  ring: per shift s in 0..W-1, (W, rounds_s, C) pairs; shift 0
    # is the local (no-wire) copy.
    send_idx: Optional[np.ndarray]
    recv_pos: Optional[np.ndarray]
    ring_rounds: Optional[Tuple[Tuple[np.ndarray, np.ndarray], ...]]
    moved_rows: int           # rows that cross a worker boundary
    local_rows_moved: int     # rows that stay on their worker
    row_bytes: int

    @property
    def bytes_moved(self) -> int:
        """Payload bytes that cross a worker boundary (the wire volume the
        bench rows report; the host path gathers ``src_rows * row_bytes`` to
        EVERY worker instead)."""
        return self.moved_rows * self.row_bytes


def plan_moves(src_pos: np.ndarray, dst_pos: np.ndarray, src_rows: int,
               dst_rows: int, num_workers: int, row_bytes: int,
               chunk_bytes: int = DEFAULT_CHUNK_BYTES,
               schedule: str = "alltoall") -> ReshardPlan:
    """Decompose a flat-position permutation into bounded collective rounds.

    ``src_pos[i]`` / ``dst_pos[i]`` are the flat device-order positions of
    moved row i in the source and destination leaves.  The source is (or is
    placed as) an even contiguous split of ``src_rows`` over the mesh; the
    destination layout's ``dst_rows`` must already divide the mesh."""
    if schedule not in ("alltoall", "ring"):
        raise ValueError(f"schedule must be alltoall|ring, got {schedule!r}")
    w = int(num_workers)
    src_pos = np.asarray(src_pos, np.int64)
    dst_pos = np.asarray(dst_pos, np.int64)
    if len(src_pos) != len(dst_pos):
        raise ValueError(f"{len(src_pos)} source positions vs "
                         f"{len(dst_pos)} destinations")
    sw, ss, src_pad = contiguous_split(src_pos, src_rows, w)
    if dst_rows % w:
        raise ValueError(f"destination rows {dst_rows} must divide the "
                         f"{w}-worker mesh")
    dst_local = dst_rows // w
    if len(dst_pos) and (dst_pos.min() < 0 or dst_pos.max() >= dst_rows):
        raise ValueError(
            f"destination positions address rows outside the new layout "
            f"({dst_rows} rows, max {dst_pos.max()})")
    dw, ds = dst_pos // dst_local, dst_pos % dst_local
    if len(dst_pos) != len(np.unique(dst_pos)):
        raise ValueError("destination positions collide — the new layout "
                         "maps two ids onto one row")
    row_bytes = max(int(row_bytes), 1)
    n = len(src_pos)
    cross = sw != dw
    if schedule == "alltoall":
        # foreign footprint per round = the all_to_all operand: W chunks of
        # C rows -> C = chunk_bytes / (W * row_bytes)
        chunk = max(1, int(chunk_bytes) // (w * row_bytes))
        pair = sw * w + dw
        order = np.argsort(pair, kind="stable")
        counts = np.bincount(pair, minlength=w * w)
        rounds = max(1, -(-int(counts.max(initial=0)) // chunk))
        starts = np.concatenate([[0], np.cumsum(counts)])
        rank = np.arange(n) - starts[pair[order]]
        r, c = np.divmod(rank, chunk)
        send = np.full((w, rounds, w, chunk), -1, np.int32)
        recv = np.full((w, rounds, w, chunk), -1, np.int32)
        send[sw[order], r, dw[order], c] = ss[order].astype(np.int32)
        recv[dw[order], r, sw[order], c] = ds[order].astype(np.int32)
        return ReshardPlan(w, schedule, chunk, src_pad, dst_rows, rounds,
                           send, recv, None, int(cross.sum()),
                           int(n - cross.sum()), row_bytes)
    # ring: one ppermute per shift, chunked into rounds of C rows each so a
    # single hop never carries more than chunk_bytes
    chunk = max(1, int(chunk_bytes) // row_bytes)
    shift = (dw - sw) % w
    per_shift = []
    total_rounds = 0
    for s in range(w):
        m = shift == s
        ssw, sss, sds = sw[m], ss[m], ds[m]
        counts = np.bincount(ssw, minlength=w)
        rounds_s = max(1, -(-int(counts.max(initial=0)) // chunk)) \
            if m.any() else 0
        if rounds_s == 0:
            per_shift.append((np.full((w, 0, chunk), -1, np.int32),
                              np.full((w, 0, chunk), -1, np.int32)))
            continue
        order = np.argsort(ssw, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)])
        rank = np.arange(m.sum()) - starts[ssw[order]]
        r, c = np.divmod(rank, chunk)
        send = np.full((w, rounds_s, chunk), -1, np.int32)
        recv = np.full((w, rounds_s, chunk), -1, np.int32)
        send[ssw[order], r, c] = sss[order].astype(np.int32)
        # the receiver of shift s from sender ssw is (ssw + s) % w; entry c
        # of the sender's chunk lands at entry c on the receiver
        recv[(ssw[order] + s) % w, r, c] = sds[order].astype(np.int32)
        per_shift.append((send, recv))
        total_rounds += rounds_s
    return ReshardPlan(w, schedule, chunk, src_pad, dst_rows, total_rounds,
                       None, None, tuple(per_shift), int(cross.sum()),
                       int(n - cross.sum()), row_bytes)


def plan_factor_reshard(old: RowLayout, old_world: int, new: RowLayout,
                        num_workers: int, n_valid: int, row_bytes: int,
                        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                        schedule: str = "alltoall") -> ReshardPlan:
    """Plan moving a (bin, slot)-sharded factor table saved by an
    ``old_world`` gang onto this ``num_workers`` mesh's ``new`` layout.
    The saved flat leaf (old device order) is placed as a contiguous split;
    every id the data references moves to its new (bin, slot) row."""
    src_pos = old.device_positions(n_valid)
    dst_pos = new.device_positions(n_valid)
    return plan_moves(src_pos, dst_pos, old_world * old.local_rows,
                      num_workers * new.local_rows, num_workers, row_bytes,
                      chunk_bytes, schedule)


def plan_coo_regroup(rows: np.ndarray, num_rows: int, num_workers: int,
                     row_bytes: int = 20,
                     chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                     schedule: str = "alltoall"
                     ) -> Tuple[ReshardPlan, np.ndarray, int]:
    """Plan routing COO nonzeros to the worker owning their row block — the
    ingestion regroup (HarpDAALDataSource.regroupCOOList) as a bounded
    reshard instead of a whole-table host shuffle.

    Record i sits at flat source position i (parse order, contiguous split
    over the mesh); its destination is ``owner * capacity + rank`` where
    ``owner`` follows the SAME ceil-block ownership rule as the host oracle
    (``loaders.regroup_coo_by_row``) and ``rank`` is the record's order
    among its owner's records in GLOBAL parse order — so each worker's
    received slice is exactly the oracle's boolean-mask slice, nnz for nnz.

    ``row_bytes`` defaults to the packed (row i64, col i64, val f32) record:
    5 int32 lanes = 20 B (io/pipeline.pack_coo).  Returns
    ``(plan, per-worker counts, per-worker slot capacity)``.
    """
    rows = np.asarray(rows, np.int64)
    n = len(rows)
    w = int(num_workers)
    block = -(-max(int(num_rows), 1) // w)
    owner = np.minimum(rows // block, w - 1)
    counts = np.bincount(owner, minlength=w).astype(np.int64)
    cap = max(1, int(counts.max(initial=0)))
    starts = np.concatenate([[0], np.cumsum(counts)])
    order = np.argsort(owner, kind="stable")
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - starts[owner[order]]
    dst_pos = owner * cap + rank
    plan = plan_moves(np.arange(n, dtype=np.int64), dst_pos, max(n, 1),
                      w * cap, w, row_bytes, chunk_bytes, schedule)
    return plan, counts, cap


# --------------------------------------------------------------------------- #
# Device programs
# --------------------------------------------------------------------------- #

def _row_meta(shape: Sequence[int], rows: int) -> Tuple[int, ...]:
    """Per-row trailing shape of a flat leaf of ``rows`` rows (validates
    that its element count divides)."""
    elems = 1
    for s in shape:
        elems *= int(s)
    if rows <= 0 or elems % rows:
        raise ValueError(f"leaf of {elems} elements does not hold "
                         f"{rows} rows")
    return (elems // rows,)


def prepare_reshard(session, src, plan: ReshardPlan, fill, *, comm=None,
                    link_class: Optional[str] = None):
    """Build the reshard program and its placed arguments.

    ``src``: the saved leaf, a host ndarray in the OLD world's flat device
    order (padded and scattered contiguously here), or a tensor already
    sharded over this session. ``fill``: the tensor supplying every row the
    plan does not write (fresh init for padded slots). Returns ``(fn,
    args)``; ``fn(*args)`` yields the resharded leaf in ``fill``'s shape.
    ``link_class`` is accepted for the JAX package's signature: one card
    has no slow link."""
    from harp_tpu_torch.collectives import lax_ops

    w = plan.num_workers
    if session.num_workers != w:
        raise ValueError(f"plan was made for {w} workers; session has "
                         f"{session.num_workers}")
    row_elems = _row_meta(session.workers.global_shape(fill),
                          plan.dst_rows)[0]
    if isinstance(src, torch.Tensor):
        src_row_elems = _row_meta(session.workers.global_shape(src),
                                  plan.src_rows)[0]
        if src_row_elems != row_elems:
            raise ValueError(
                f"source rows ({src_row_elems} elems) and destination rows "
                f"({row_elems} elems) disagree")
        src_dev = src
    else:
        # a host leaf from the checkpoint: pad the flat device-order payload
        # to the contiguous split and place it (the one upload of a resume)
        flat = np.asarray(src).reshape(-1, row_elems)
        if len(flat) > plan.src_rows:
            raise ValueError(f"saved leaf has {len(flat)} rows; plan "
                             f"expects at most {plan.src_rows}")
        if len(flat) < plan.src_rows:
            pad = np.zeros((plan.src_rows - len(flat), row_elems),
                           flat.dtype)
            flat = np.concatenate([flat, pad], axis=0)
        src_dev = session.scatter(flat)
    dst_local = plan.dst_rows // w
    src_local = plan.src_rows // w

    def rows_of(x, rows):
        return x.reshape(x.shape[0], rows, row_elems)

    def scatter_rows(dst, pos, payload):
        # pads (pos < 0) land on a discarded row past the block
        pos = torch.where(pos >= 0, pos, torch.full_like(pos, dst_local))
        dst[torch.arange(dst.shape[0], device=dst.device)[:, None],
            pos.long()] = payload

    def start(src_a, fill_a):
        src_l = rows_of(src_a, src_local)
        dst = rows_of(fill_a, dst_local)
        dst = torch.cat([dst, dst.new_zeros((dst.shape[0], 1, row_elems))],
                        dim=1)
        return src_l, dst

    def gather_rows(src_l, si):
        rows = torch.arange(src_l.shape[0], device=src_l.device)[:, None]
        return src_l[rows, si.clamp(min=0).long()]

    if plan.schedule == "alltoall":
        send = session.scatter(plan.send_idx)
        recv = session.scatter(plan.recv_pos)

        def prog(src_a, fill_a, send_a, recv_a):
            src_l, dst = start(src_a, fill_a)
            nl = src_l.shape[0]
            for r in range(plan.rounds):
                si = send_a[:, 0, r].reshape(nl, -1)       # (Wl, W*C)
                moved = lax_ops.all_to_all(gather_rows(src_l, si))
                scatter_rows(dst, recv_a[:, 0, r].reshape(nl, -1), moved)
            return dst[:, :dst_local].reshape(fill_a.shape)

        fn = session.spmd(prog, in_specs=(session.shard(),) * 4,
                          out_specs=session.shard())
        return fn, (src_dev, fill, send, recv)

    placed = [(session.scatter(s), session.scatter(r))
              for s, r in plan.ring_rounds]

    def prog(src_a, fill_a, *rounds_args):
        src_l, dst = start(src_a, fill_a)
        for s in range(w):
            send_a, recv_a = rounds_args[2 * s], rounds_args[2 * s + 1]
            for r in range(send_a.shape[2]):
                payload = gather_rows(src_l, send_a[:, 0, r])   # (Wl, C, E)
                if s:
                    payload = lax_ops.rotate(payload, s, comm=comm)
                scatter_rows(dst, recv_a[:, 0, r], payload)
        return dst[:, :dst_local].reshape(fill_a.shape)

    fn = session.spmd(prog,
                      in_specs=(session.shard(),) * (2 + 2 * len(placed)),
                      out_specs=session.shard())
    args = (src_dev, fill) + tuple(a for pair in placed for a in pair)
    return fn, args


def reshard(session, src, plan: ReshardPlan, fill, *, comm=None,
            link_class: Optional[str] = None):
    """Run the bounded-round device reshard; returns the new leaf, shaped
    and sharded like ``fill`` (see :func:`prepare_reshard`)."""
    fn, args = prepare_reshard(session, src, plan, fill, comm=comm,
                               link_class=link_class)
    return fn(*args)


def reshard_factor(session, saved, old: RowLayout, old_world: int,
                   new: RowLayout, n_valid: int, fill, *,
                   chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                   schedule: str = "alltoall", comm=None,
                   link_class: Optional[str] = None):
    """Device twin of :func:`collectives.repartition.repartition_factor`:
    moves a (bin, slot)-sharded factor table from the layout it was SAVED
    under onto this session's layout, bitwise, in chunk-bounded rounds."""
    row_elems = _row_meta(session.workers.global_shape(fill),
                          session.num_workers * new.local_rows)[0]
    row_bytes = row_elems * fill.element_size()
    plan = plan_factor_reshard(old, old_world, new, session.num_workers,
                               n_valid, row_bytes, chunk_bytes, schedule)
    return reshard(session, saved, plan, fill, comm=comm,
                   link_class=link_class)
