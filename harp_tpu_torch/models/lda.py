"""LDA by collapsed Gibbs sampling (CGS) or CVB0, with model rotation.

Port of ``harp_tpu/models/lda.py`` (reference: ml/java lda,
LDAMPCollectiveMapper.java:51, SparseLDA CGS with the word-topic table
ring-rotating through Rotator:257 and local doc-topic tables; contrib/lda
for CVB0; BASELINE's "harp-java CGS-LDA").

Documents are sharded over the workers; the word-topic count table is cut
into W vocab blocks (2W half-blocks with ``num_model_slices=2``) that
ring-rotate through the stacked worker group (``collectives/rotation``:
``rotate_scan``, or ``pipelined_rotation`` for two slices). Words are dealt
to blocks by balanced (serpentine-LPT) corpus frequency. Sampling is
blocked, as in the JAX package: during a hop every resident-block token of
a doc group draws its topic from the CURRENT counts at once, the groups of
a hop run in turn (``minibatches_per_hop``), and the topic totals are
refreshed by an allreduce once a hop. Each (worker, hop, group) step is the
JAX package's ``group_update``: p(z=k) proportional to (n_dk + alpha)(n_wk +
beta)/(n_k + V beta) with the token's own count removed, then

* ``method="cgs"``: an inverse-CDF draw. The uniforms are ``jax.random``'s
  stream (``ops/threefry.py``: ``fold_in(PRNGKey(0), seed + worker_id)``,
  then ``split`` and ``uniform`` per group) and the CDF is summed in XLA's
  order on the CPU (16-wide blocks summed left to right, block totals
  carried in front: :func:`xla_cumsum`), so a CGS epoch draws what the JAX
  package draws;
* ``method="cvb0"``: the normalised probabilities as soft assignments.

Count writes (``wt_access``): ``"gemm_scatter"`` (CGS: the one-hot-GEMM
scatter of ``ops/lane_pack``, bf16 one-hots and +-1 deltas with float32
sums, so counts stay exact), its vocab-sub-block form (``vocab_sub_block``:
the one-hot is ``vocab_sub_block`` wide), ``"gemm"`` (float32 one-hot
products for the read and the write) or ``"gather"`` (a row gather and an
``index_add_``); ``"auto"`` resolves as the JAX package does, with its
``wt_gemm_scatter_max_vpb`` guard.

``fused_dma=True`` moves the word-topic blocks by the ring-DMA engine
(``ops/ring_dma.hop``: the hand-written kernel on the card, one launch a
rotation step), bitwise the unfused fit. ``quant`` quantizes the per-hop
topic-total allreduce (error feedback through the epochs), ``quant_wt``
also the circulating block (taking precedence over ``fused_dma``).
``ablate_rotation`` and ``ablate_stage`` are the JAX package's timing
ablations (results wrong by design).

Local work is one call a worker row (the JAX package's ``shard_map``
body), so a process group (``HarpSession(distributed=True)``) fits
bitwise as the stacked group at the same W. :meth:`LDA.fit_checkpointed`
saves the chain state every ``save_every`` epochs and resumes, also at
another world size (``LDAConfig.reshard``: the token assignments and the
word-topic rows move on the device by ``collectives/reshard.py``, or
through the numpy oracle). With telemetry on (``harp_tpu_torch.telemetry``)
both fits record one step event an epoch, with its log-likelihood, at the
fetch they make anyway. The ``faults.fire`` hook waits for its module's
port (ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from harp_tpu_torch import telemetry
from harp_tpu_torch.collectives import lax_ops, quantize, rotation
from harp_tpu_torch.ops import lane_pack, threefry
from harp_tpu_torch.ops.precision import full_f32_matmul
from harp_tpu_torch.parallel import mesh as mesh_lib
from harp_tpu_torch.parallel.mesh import fetch
from harp_tpu_torch.session import HarpSession


@dataclasses.dataclass(frozen=True)
class LDAConfig:
    """Reference CLI parity (numTopics, alpha, beta, numIterations); every
    field of the JAX package's config, with its meaning there."""

    num_topics: int = 10
    vocab: int = 100
    alpha: float = 0.1
    beta: float = 0.01
    epochs: int = 20
    method: str = "cgs"          # "cgs" (ml/java lda) or "cvb0" (contrib/lda)
    balance: bool = True         # serpentine-LPT word -> block assignment
    wt_access: str = "auto"      # auto | gemm_scatter | gemm | gather
    wt_gemm_scatter_max_vpb: int = 65536   # auto's width guard
    vocab_sub_block: int = 0     # 0 = off; else the sub-block token layout
    num_model_slices: int = 1    # 1 = rotate_scan; 2 = pipelined_rotation
    ablate_rotation: bool = False  # timing ablation: blocks never move
    ablate_stage: str = ""       # timing ablation: "gather" | "scatter" |
    #                              "sample" | "gather+scatter"
    minibatches_per_hop: int = 4  # sequential doc-group sub-steps a hop
    quant: Optional[str] = None  # None | "int8" | "bf16": topic-total wire
    quant_wt: bool = False       # also quantize the circulating block
    fused_dma: bool = False      # wt-block hops through the ring-DMA engine
    reshard: str = "auto"        # resume across world sizes: auto|device|
    #                              ring|host
    reshard_chunk_bytes: int = 0  # 0 = collectives.reshard's 1 MiB


# --------------------------------------------------------------------------- #
# Host-side token layout (numpy; the JAX package's)
# --------------------------------------------------------------------------- #

def bucketize_tokens(docs: np.ndarray, num_blocks: int, vpb: int,
                     word_block: Optional[np.ndarray] = None,
                     word_slot: Optional[np.ndarray] = None,
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(D, L) tokens -> (D, NB, Lb) grouped by home vocab block, padded to
    the largest per-(doc, block) count Lb; stored ids are block-local slots
    (padding holds slot 0 with mask 0). ``word_block``/``word_slot``:
    optional id maps (default contiguous ranges)."""
    d, l = docs.shape
    rows = np.arange(d)[:, None]
    if word_block is None:
        block = np.minimum(docs // vpb, num_blocks - 1)
        slot = docs - block * vpb
    else:
        block = word_block[docs]
        slot = word_slot[docs]
    counts = np.zeros((d, num_blocks), np.int64)
    np.add.at(counts, (rows, block), 1)
    lb = max(int(counts.max()), 1)
    docs_b = np.zeros((d, num_blocks, lb), docs.dtype)
    mask_b = np.zeros((d, num_blocks, lb), np.float32)
    order = np.argsort(block, axis=1, kind="stable")
    sorted_block = np.take_along_axis(block, order, axis=1)
    sorted_slot = np.take_along_axis(slot, order, axis=1)
    bucket_starts = np.concatenate(
        [np.zeros((d, 1), np.int64), np.cumsum(counts, axis=1)[:, :-1]],
        axis=1)
    pos = np.arange(l)[None, :] - bucket_starts[rows, sorted_block]
    docs_b[rows, sorted_block, pos] = sorted_slot
    mask_b[rows, sorted_block, pos] = 1.0
    return docs_b, mask_b, lb


def bucketize_tokens_subblock(docs: np.ndarray, num_blocks: int, vpb: int,
                              sub: int, word_block: np.ndarray,
                              word_slot: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Vocab-sub-block layout: tokens bucketed per (vocab block, ``sub``-wide
    sub-block of block-local slots), padded to the largest per-(doc,
    sub-block) count Lbs. Returns ``(docs_b (D, NB, NS*Lbs), mask_b, lb,
    lbs)``, NS = vpb // sub; ids stay full block-local slots."""
    if vpb % sub:
        raise ValueError(f"vpb {vpb} must be a multiple of sub {sub}")
    ns = vpb // sub
    sub_of, _ = lane_pack.sub_block_split(word_slot, sub)
    fine_block = (word_block * ns + sub_of).astype(word_block.dtype)
    docs_f, mask_f, lbs = bucketize_tokens(
        docs, num_blocks * ns, vpb, fine_block, word_slot)
    d = docs.shape[0]
    docs_b = docs_f.reshape(d, num_blocks, ns * lbs)
    mask_b = mask_f.reshape(d, num_blocks, ns * lbs)
    return docs_b, mask_b, ns * lbs, lbs


# --------------------------------------------------------------------------- #
# Device helpers
# --------------------------------------------------------------------------- #

_SCAN_BLOCK = 16


def _sequential_cumsum(p: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(p)
    acc = p[..., 0]
    out[..., 0] = acc
    for i in range(1, p.shape[-1]):
        acc = acc + p[..., i]
        out[..., i] = acc
    return out


def xla_cumsum(p: torch.Tensor) -> torch.Tensor:
    """float32 cumulative sum along the last axis in the order XLA's CPU
    backend sums ``jnp.cumsum``: up to 16 entries left to right; past 16,
    16-wide blocks summed left to right, each offset by the sum (in the
    same order, recursively) of the block totals before it. Elementwise
    adds only, so the card's bits equal the CPU's."""
    k = p.shape[-1]
    if k <= _SCAN_BLOCK:
        return _sequential_cumsum(p)
    nb = -(-k // _SCAN_BLOCK)
    pad = nb * _SCAN_BLOCK - k
    if pad:
        p = torch.cat([p, p.new_zeros(p.shape[:-1] + (pad,))], dim=-1)
    s = _sequential_cumsum(p.reshape(p.shape[:-1] + (nb, _SCAN_BLOCK)))
    before = xla_cumsum(s[..., -1])
    before = torch.cat([before.new_zeros(before.shape[:-1] + (1,)),
                        before[..., :-1]], dim=-1)
    out = s + before[..., None]
    return out.reshape(out.shape[:-2] + (nb * _SCAN_BLOCK,))[..., :k]


def _one_hot(z: torch.Tensor, k: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(z.long(), k).to(torch.float32)


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


class LDA:
    """Distributed CGS/CVB0 LDA over a HarpSession's stacked worker group."""

    def __init__(self, session: HarpSession, config: LDAConfig):
        if config.method not in ("cgs", "cvb0"):
            raise ValueError(f"method must be 'cgs' or 'cvb0', got "
                             f"{config.method!r}")
        if config.num_model_slices not in (1, 2):
            raise ValueError(f"num_model_slices must be 1 or 2, got "
                             f"{config.num_model_slices}")
        if config.ablate_stage not in ("", "gather", "scatter", "sample",
                                       "gather+scatter"):
            raise ValueError(
                f"ablate_stage must be ''|gather|scatter|sample|"
                f"gather+scatter, got {config.ablate_stage!r}")
        if config.ablate_stage == "sample" and config.method == "cvb0":
            raise ValueError(
                "ablate_stage='sample' only supports method='cgs' (the "
                "cheap-shift replacement needs integer topic assignments)")
        if config.wt_access == "gemm_scatter" and config.method != "cgs":
            raise ValueError(
                "wt_access='gemm_scatter' requires method='cgs' (CVB0's "
                "soft deltas are not bf16-exact)")
        if config.quant_wt and config.quant is None:
            raise ValueError(
                "quant_wt=True requires quant='int8'|'bf16' (it selects "
                "WHICH payloads ride the quantized wire, not the codec)")
        if config.vocab_sub_block:
            if config.vocab_sub_block < 1:
                raise ValueError(
                    f"vocab_sub_block must be positive, got "
                    f"{config.vocab_sub_block}")
            if config.method != "cgs" or config.wt_access not in (
                    "auto", "gemm_scatter"):
                raise ValueError(
                    "vocab_sub_block requires method='cgs' with "
                    "wt_access='auto'/'gemm_scatter' (the sub-block layout "
                    "exists to narrow the gemm_scatter one-hot)")
        self.session = session
        self.config = config
        self._fns = {}
        self.last_layout_stats: dict = {}

    def _effective_minibatches(self, d_local: int) -> int:
        """Largest divisor of docs-per-worker within the configured budget:
        the sub-step count a hop runs."""
        return max(g for g in range(1, min(self.config.minibatches_per_hop,
                                           d_local) + 1) if d_local % g == 0)

    def _build(self, w: int, v_pad: int, lb: int, d_local: int,
               lbs: int = 0):
        cfg = self.config
        k = cfg.num_topics
        ns = cfg.num_model_slices
        nb = w * ns
        vpb = v_pad // nb
        shift = 0 if cfg.ablate_rotation else 1
        comm = (quantize.CommConfig(quant=cfg.quant)
                if cfg.quant is not None else None)
        nmb = self._effective_minibatches(d_local)
        dg = d_local // nmb
        if cfg.wt_access not in ("auto", "gemm_scatter", "gemm", "gather"):
            raise ValueError(f"wt_access must be auto|gemm_scatter|gemm|"
                             f"gather, got {cfg.wt_access!r}")
        onehot_bytes = dg * lb * vpb * 4
        use_gemm = (cfg.wt_access == "gemm"
                    or (cfg.wt_access == "auto" and cfg.method == "cvb0"
                        and vpb <= 8192
                        and onehot_bytes <= 256 * 1024 * 1024))
        use_gemm_scatter = (cfg.wt_access == "gemm_scatter"
                            or (cfg.wt_access == "auto"
                                and cfg.method == "cgs"
                                and (bool(cfg.vocab_sub_block)
                                     or vpb <= cfg.wt_gemm_scatter_max_vpb)))
        sub_w = cfg.vocab_sub_block
        use_sub = bool(sub_w) and use_gemm_scatter
        if use_sub:
            if not lbs or lb % lbs or vpb % sub_w:
                raise ValueError(
                    f"sub-block build needs lb {lb} = NS*lbs ({lbs}) and "
                    f"sub {sub_w} | vpb {vpb} (prepare() sets these)")
            ns_sub = vpb // sub_w
            scatter_chunk = lane_pack.scatter_chunk(dg * lbs, sub_w,
                                                    batch=ns_sub)
        else:
            ns_sub = 1
            scatter_chunk = lane_pack.scatter_chunk(dg * lb, vpb)
        self.last_layout_stats["wt_path"] = (
            "gemm" if use_gemm
            else "gemm_scatter_subblock" if use_sub
            else "gemm_scatter" if use_gemm_scatter
            else "gather")
        soft = cfg.method == "cvb0"
        no_gather = "gather" in cfg.ablate_stage
        no_scatter = "scatter" in cfg.ablate_stage
        quant_wt = comm is not None and cfg.quant_wt
        wt_comm = comm if quant_wt else None

        def group_update(wt_block, tt_local, key, wl_g, ms_g, zs_g, dt_g):
            """One worker's doc group, resampled from the CURRENT counts:
            p(z=k) ~ (n_dk-cur+a)(n_wk-cur+b)/(n_k-cur+Vb). ``wt_block``
            (vpb, K), ``tt_local`` (K,), ``key`` (2,), ``wl_g``/``ms_g``
            (dg, Lb), ``zs_g`` (dg, Lb[, K]), ``dt_g`` (dg, K)."""
            dev = wt_block.device
            if soft:
                cur = zs_g * ms_g[..., None]
            else:
                cur = _one_hot(zs_g, k) * ms_g[..., None]
            nd = dt_g[:, None, :] - cur
            oh = None

            def apply_scatter(wt_b, delta):
                if use_gemm:
                    with full_f32_matmul():
                        return wt_b + oh.t() @ delta.reshape(-1, k)
                if use_sub:
                    # tokens arrive grouped (dg, NS, Lbs): key the one-hot
                    # on the within-sub slot, one batched sub-wide GEMM
                    _, sub_slot = lane_pack.sub_block_split(
                        wl_g.reshape(dg, ns_sub, lbs), sub_w)
                    ids_s = sub_slot.permute(1, 0, 2).reshape(ns_sub,
                                                              dg * lbs)
                    d_s = delta.reshape(dg, ns_sub, lbs, k).permute(
                        1, 0, 2, 3).reshape(ns_sub, dg * lbs, k)
                    upd = lane_pack.gemm_scatter(
                        ids_s, d_s, sub_w, chunk=scatter_chunk,
                        policy="exact_pm1")
                    return wt_b + upd.reshape(vpb, k)
                if use_gemm_scatter:
                    return wt_b + lane_pack.gemm_scatter(
                        wl_g.reshape(-1), delta.reshape(-1, k), vpb,
                        chunk=scatter_chunk, policy="exact_pm1")
                seg = torch.zeros((vpb, k), dtype=torch.float32, device=dev)
                return wt_b + seg.index_add_(0, wl_g.reshape(-1).long(),
                                             delta.reshape(-1, k))

            if use_gemm and not (no_gather and no_scatter):
                oh = _one_hot(wl_g.reshape(-1), vpb)            # (dg*Lb, vpb)
            if no_gather:
                nw = 1.0 - cur
            elif use_gemm:
                with full_f32_matmul():
                    nw = (oh @ wt_block).reshape(cur.shape) - cur
            else:
                nw = wt_block[wl_g.long()] - cur
            nk = tt_local[None, None, :] - cur
            if cfg.ablate_stage == "sample":
                gate = (nw.sum(-1) > 1e30).to(zs_g.dtype)
                zs_cheap = (zs_g + 1 + gate) % k
                new = _one_hot(zs_cheap, k) * ms_g[..., None]
                delta = new - cur
                if not no_scatter:
                    wt_block = apply_scatter(wt_block, delta)
                d_k = delta.sum(dim=(0, 1))
                return (wt_block, tt_local + d_k, d_k, key, zs_cheap,
                        dt_g + delta.sum(dim=1))
            p = (torch.clamp(nd + cfg.alpha, min=0.0)
                 * torch.clamp(nw + cfg.beta, min=0.0)
                 / torch.clamp(nk + cfg.vocab * cfg.beta, min=1e-10))
            if soft:
                zs_new = (p / torch.clamp(p.sum(-1, keepdim=True),
                                          min=1e-30)) * ms_g[..., None]
                new = zs_new
            else:
                pair = threefry.split(key)
                key, sub = pair[0], pair[1]
                cdf = xla_cumsum(p)
                u = threefry.uniform(sub, tuple(p.shape[:-1]) + (1,)) \
                    * cdf[..., -1:]
                zs_new = torch.clamp((cdf < u).sum(-1), 0, k - 1).to(
                    zs_g.dtype)
                new = _one_hot(zs_new, k) * ms_g[..., None]
            delta = new - cur
            if not no_scatter:
                wt_block = apply_scatter(wt_block, delta)
            d_k = delta.sum(dim=(0, 1))
            return (wt_block, tt_local + d_k, d_k, key, zs_new,
                    dt_g + delta.sum(dim=1))

        def fit_fn(docs_b, mask_b, z0, wt_block0, seed):
            """Stacked (Wl, D_local, NB, Lb[, K]) tokens, masks and
            assignments, (Wl, NS*vpb, K) word-topic blocks, an int seed."""
            group = mesh_lib.current_group()
            wl = docs_b.shape[0]
            wids = list(range(group.first_worker, group.first_worker + wl))
            dev = docs_b.device
            keys = threefry.fold_in(threefry.prng_key(0, dev),
                                    torch.tensor(wids, device=dev)
                                    + int(seed))
            z = z0.clone()
            if soft:
                doc_topic = torch.stack([(z[r] * mask_b[r][..., None]).sum(
                    dim=(1, 2)) for r in range(wl)])
            else:
                doc_topic = torch.stack([(_one_hot(z[r], k)
                                          * mask_b[r][..., None]).sum(
                    dim=(1, 2)) for r in range(wl)])
            topic_tot = lax_ops.allreduce(doc_topic.sum(dim=1))

            def sample_resident(carry, wt_block, srcs):
                """Sample every token whose home block ``srcs[r]`` is
                resident on row r."""
                if comm is None:
                    doc_topic, z, topic_tot, keys = carry
                else:
                    doc_topic, z, topic_tot, keys, qres = carry
                blocks, dts, hop_d, new_keys = [], [], [], []
                for r, src in enumerate(srcs):
                    w_local = docs_b[r, :, src]
                    mask_s = mask_b[r, :, src]
                    z_s = z[r, :, src]
                    wt_b, tt_loc, key = wt_block[r], topic_tot, keys[r]
                    acc = torch.zeros(k, dtype=torch.float32, device=dev)
                    zs_out, dt_out = [], []
                    for g in range(nmb):
                        sl = slice(g * dg, (g + 1) * dg)
                        wt_b, tt_loc, d_k, key, zs_new, dt_new = \
                            group_update(wt_b, tt_loc, key, w_local[sl],
                                         mask_s[sl], z_s[sl],
                                         doc_topic[r, sl])
                        acc = acc + d_k
                        zs_out.append(zs_new)
                        dt_out.append(dt_new)
                    z[r, :, src] = torch.cat(zs_out)
                    blocks.append(wt_b)
                    dts.append(torch.cat(dt_out))
                    hop_d.append(acc)
                    new_keys.append(key)
                doc_topic = torch.stack(dts)
                keys = torch.stack(new_keys)
                hop_d = torch.stack(hop_d)
                wt_block = torch.stack(blocks)
                # bounded-staleness topic totals: one allreduce a hop
                if comm is None:
                    topic_tot = topic_tot + lax_ops.allreduce(hop_d)
                    return (doc_topic, z, topic_tot, keys), wt_block
                delta_sum, qres = lax_ops.allreduce(hop_d, comm=comm,
                                                    residual=qres)
                return ((doc_topic, z, topic_tot + delta_sum, keys, qres),
                        wt_block)

            def hop_body(carry, wt_block, t):
                # one slice: at hop t the resident block's home is wid - t
                return sample_resident(carry, wt_block,
                                       [(i - t) % w for i in wids])

            def micro_body(carry, wt_half, t):
                # two slices: even micro-steps an a-half (ids [0, w)), odd
                # ones a b-half (ids [w, 2w)), each advancing every second
                # micro-step
                return sample_resident(
                    carry, wt_half,
                    [(t % 2) * w + (i - t // 2) % w for i in wids])

            lgamma = torch.lgamma
            beta32 = _f32(cfg.beta, dev)
            v_beta32 = _f32(cfg.vocab * cfg.beta, dev)
            const = k * lgamma(v_beta32)

            def ref_ll(wt, topic_tot):
                # the reference's likelihood (CalcLikelihoodTask.run:56 +
                # printLikelihood:731-748): nonzero word-topic cells, then
                # the topic-sum completion terms
                part = torch.stack([torch.where(
                    wt[r] > 0.5, lgamma(wt[r] + beta32) - lgamma(beta32),
                    torch.zeros((), device=dev)).sum() for r in range(wl)])
                ll_w = lax_ops.allreduce(part)
                return ll_w - lgamma(topic_tot + v_beta32).sum() + const

            wt = wt_block0
            qres = (torch.zeros((wl, k), dtype=torch.float32, device=dev)
                    if comm is not None else None)
            wt_res = None
            if quant_wt:
                wt_res = (rotation.ef_zero(wt) if ns == 1 else
                          (rotation.ef_zero(wt[:, :vpb]),
                           rotation.ef_zero(wt[:, vpb:])))
            lls = []
            for _ in range(cfg.epochs):
                carry = ((doc_topic, z, topic_tot, keys) if comm is None
                         else (doc_topic, z, topic_tot, keys, qres))
                if ns == 1:
                    if quant_wt:
                        carry, wt, wt_res = rotation.rotate_scan(
                            hop_body, carry, wt, w, shift=shift,
                            comm=wt_comm, ef_state=wt_res,
                            fused_dma=cfg.fused_dma)
                    else:
                        carry, wt = rotation.rotate_scan(
                            hop_body, carry, wt, w, shift=shift,
                            fused_dma=cfg.fused_dma)
                else:
                    # local (2 vpb, K) block = [a-half; b-half]; 2W
                    # micro-steps bring both halves home again
                    a, b = wt[:, :vpb].contiguous(), wt[:, vpb:].contiguous()
                    if quant_wt:
                        carry, a, b, wt_res = rotation.pipelined_rotation(
                            micro_body, carry, a, b, 2 * w, shift=shift,
                            comm=wt_comm, ef_state=wt_res,
                            fused_dma=cfg.fused_dma)
                    else:
                        carry, a, b = rotation.pipelined_rotation(
                            micro_body, carry, a, b, 2 * w, shift=shift,
                            fused_dma=cfg.fused_dma)
                    wt = torch.cat([a, b], dim=1)
                if comm is None:
                    doc_topic, z, topic_tot, keys = carry
                else:
                    doc_topic, z, topic_tot, keys, qres = carry
                lls.append(ref_ll(wt, topic_tot))
            return doc_topic, wt, z, torch.stack(lls)

        sess = self.session
        return sess.spmd(
            fit_fn,
            in_specs=(sess.shard(), sess.shard(), sess.shard(), sess.shard(),
                      sess.replicate()),
            out_specs=(sess.shard(), sess.shard(), sess.shard(),
                       sess.replicate()),
        )

    def prepare(self, docs: np.ndarray, seed: int = 0):
        """Bucketize the tokens and place them, the initial assignments and
        the word-topic counts on the device ONCE; returns the state
        :meth:`fit_prepared` takes. z0 comes from
        ``np.random.default_rng(seed)`` as in the JAX package, so both
        packages start from the same chain."""
        sess, cfg = self.session, self.config
        w = sess.num_workers
        nb = w * cfg.num_model_slices
        vpb = -(-cfg.vocab // nb)
        if cfg.vocab_sub_block:
            vpb = lane_pack.round_up(vpb, cfg.vocab_sub_block)
        v_pad = vpb * nb
        num_docs = docs.shape[0]
        if num_docs % w:
            raise ValueError(f"num_docs {num_docs} must divide over {w} "
                             f"workers")
        if docs.size and (docs.min() < 0 or docs.max() >= cfg.vocab):
            raise ValueError(
                f"token ids must be in [0, {cfg.vocab}); got "
                f"[{docs.min()}, {docs.max()}]")

        from harp_tpu_torch.models.sgd_mf import (identity_assign,
                                                  serpentine_assign)

        if cfg.balance:
            word_block, word_slot = serpentine_assign(
                np.bincount(docs.reshape(-1), minlength=cfg.vocab), nb)
        else:
            word_block, word_slot = identity_assign(cfg.vocab, nb)
        if cfg.vocab_sub_block:
            docs_b, mask_b, lb, lbs = bucketize_tokens_subblock(
                docs, nb, vpb, cfg.vocab_sub_block, word_block, word_slot)
        else:
            docs_b, mask_b, lb = bucketize_tokens(docs, nb, vpb, word_block,
                                                  word_slot)
            lbs = 0
        d_local = num_docs // w
        nmb_eff = self._effective_minibatches(d_local)
        if nmb_eff == 1 and cfg.minibatches_per_hop > 1:
            warnings.warn(
                f"LDA sub-stepping degraded to 1 (fully-parallel draws): "
                f"docs-per-worker {d_local} has no divisor <= "
                f"minibatches_per_hop={cfg.minibatches_per_hop}. Mixing "
                f"will be poor — pad num_docs so docs/worker gains a small "
                f"divisor (e.g. a multiple of "
                f"{cfg.minibatches_per_hop * w}).",
                RuntimeWarning, stacklevel=3)
        self.last_layout_stats = {
            "padded": int(docs_b.size), "tokens": int(docs.size),
            "overhead": docs_b.size / max(docs.size, 1),
            "minibatches_per_hop": nmb_eff,
            "sub_block": cfg.vocab_sub_block,
            "sub_blocks_per_block": (vpb // cfg.vocab_sub_block
                                     if cfg.vocab_sub_block else 0),
        }
        rng = np.random.default_rng(seed)
        z0 = rng.integers(0, cfg.num_topics, docs_b.shape).astype(np.int32)
        # initial word-topic counts: NB stacked blocks of block-local slots
        # (integer counts, so adding 1 a real token equals the JAX
        # package's one-hot rows over every slot, bit for bit)
        wt = np.zeros((nb, vpb, cfg.num_topics), np.float32)
        real = mask_b > 0
        blk = np.broadcast_to(np.arange(nb)[None, :, None], docs_b.shape)
        np.add.at(wt, (blk[real], docs_b[real], z0[real]), 1.0)
        if cfg.num_model_slices == 2:
            # worker i's shard = [a-block i; b-block w+i]
            wt = wt.reshape(2, w, vpb, cfg.num_topics).transpose(1, 0, 2, 3)
        wt = wt.reshape(v_pad, cfg.num_topics)
        if cfg.method == "cvb0":
            z0 = (np.eye(cfg.num_topics, dtype=np.float32)[z0]
                  * mask_b[..., None])
        key = (w, v_pad, lb, num_docs, cfg.method, cfg.num_model_slices, lbs)
        if key not in self._fns:
            self._fns[key] = self._build(w, v_pad, lb, num_docs // w, lbs)
        return (key,
                (sess.scatter(docs_b.astype(np.int32)),
                 sess.scatter(mask_b.astype(np.float32)),
                 sess.scatter(z0), sess.scatter(np.ascontiguousarray(wt))),
                int(seed), (word_block, word_slot, vpb))

    def _out_rows(self, w: int, word_block: np.ndarray,
                  word_slot: np.ndarray, vpb: int) -> np.ndarray:
        """Row of each vocab id in the gathered wt output: block b lives on
        worker b % w; with 2 slices the shard stacks [a; b]."""
        ns = self.config.num_model_slices
        owner = (word_block % w).astype(np.int64)
        sl = word_block // w
        return (owner * ns + sl) * vpb + word_slot

    def fit_prepared(self, state
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Run training on already-placed data: (doc_topic (D, K),
        word_topic (V, K), log-likelihood per epoch), numpy."""
        key, data, seed, (word_block, word_slot, vpb) = state
        group = self.session.workers
        t0 = time.perf_counter()
        doc_topic, wt_out, _, ll = self._fns[key](*data, seed)
        ll = fetch(ll)
        # telemetry at the ll fetch that is here anyway (an event an epoch,
        # the wall amortized over the epochs)
        telemetry.record_chunk(
            "lda", start=0, losses=ll.tolist(),
            wall_s=time.perf_counter() - t0,
            ledger=telemetry.ledger_for(
                "lda", quant=self.config.quant,
                sub_block=bool(self.config.vocab_sub_block)))
        wt_out = fetch(wt_out, group)
        wt_final = wt_out[self._out_rows(key[0], word_block, word_slot, vpb)]
        return fetch(doc_topic, group), wt_final, ll

    def fit(self, docs: np.ndarray, seed: int = 0
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Train on a (num_docs, doc_len) token matrix."""
        return self.fit_prepared(self.prepare(docs, seed))

    def fit_checkpointed(self, state, checkpointer, save_every: int = 1,
                         epochs: Optional[int] = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Train with periodic chain checkpoints and automatic resume.

        Every ``save_every`` epochs the chain state (assignments ``z`` and
        word-topic counts ``wt``, the model the reference dumped with
        ``printModel``) is saved with the blocked corpus layout (token
        slots, mask, vocab id maps) and a meta naming the writing world; a
        populated directory resumes from the newest valid epoch. Chunks stay
        on the ``save_every`` grid and each chunk's key derives from
        ``seed + start_epoch``, so an interrupted and resumed run is bitwise
        an uninterrupted ``fit_checkpointed`` run. A step written at another
        world size is re-matched onto this session's blocking
        (:meth:`_repartition_chain`). Returns (doc_topic, word_topic, ll of
        the epochs run here, start epoch)."""
        from harp_tpu_torch.utils import checkpoint as ckpt_lib

        sess, cfg = self.session, self.config
        key, data, seed, (word_block, word_slot, vpb) = state
        docs_b, mask_b, z_cur, wt_cur = data
        group = sess.workers
        w, v_pad, lb, num_docs = key[:4]
        lbs = key[6] if len(key) > 6 else 0
        total = epochs if epochs is not None else cfg.epochs
        start = 0
        # the layout leaves ride in every step so another world can recover
        # (doc, vocab-id) per token (the corpus is static: fetched once)
        layout_leaves = {
            "docs": fetch(docs_b, group),
            "mask": fetch(mask_b, group).astype(np.uint8),
            "word_block": np.asarray(word_block, np.int32),
            "word_slot": np.asarray(word_slot, np.int32),
        }
        legacy_like = {"z": np.zeros(group.global_shape(z_cur),
                                     fetch(z_cur[:0]).dtype),
                       "wt": np.zeros(group.global_shape(wt_cur),
                                      np.float32)}
        resume, saved, ck_meta = checkpointer.restore_latest_valid(
            like_from_meta=lambda m: (ckpt_lib.meta_like(m) if m
                                      else legacy_like),
            return_meta=True)
        if resume is not None:
            start = resume
            if ck_meta is not None and ck_meta.get("model") not in (None,
                                                                    "lda"):
                raise ValueError(
                    f"checkpoint in this work dir was written by model "
                    f"{ck_meta['model']!r}, not lda — wrong work dir?")
            if start > total:
                raise ValueError(
                    f"checkpoint at epoch {start} exceeds the requested "
                    f"{total} epochs (pass a fresh directory or a larger "
                    f"budget)")
            if (int(ck_meta["world"]) != w if ck_meta and "world" in ck_meta
                    else np.shape(saved["z"]) != group.global_shape(z_cur)):
                saved = self._repartition_chain(saved, ck_meta,
                                                layout_leaves, vpb,
                                                group.global_shape(z_cur))
            z_cur = (saved["z"] if isinstance(saved["z"], torch.Tensor)
                     else sess.scatter(saved["z"]))
            wt_cur = (saved["wt"] if isinstance(saved["wt"], torch.Tensor)
                      else sess.scatter(saved["wt"]))
        chunk_fns = {}
        lls = []
        doc_topic = None
        # telemetry: step events at the chunk boundaries' ll fetch
        ledger = telemetry.ledger_for(
            "lda", quant=cfg.quant, sub_block=bool(cfg.vocab_sub_block))
        ep = start
        while ep < total:
            chunk = min(save_every - ep % save_every, total - ep)
            if chunk not in chunk_fns:
                sub = LDA(sess, dataclasses.replace(cfg, epochs=chunk))
                chunk_fns[chunk] = sub._build(w, v_pad, lb, num_docs // w,
                                              lbs)
            t0 = time.perf_counter()
            doc_topic, wt_cur, z_cur, ll = chunk_fns[chunk](
                docs_b, mask_b, z_cur, wt_cur, int(seed) + ep)
            chunk_lls = fetch(ll).tolist()
            wall = time.perf_counter() - t0
            lls.extend(chunk_lls)
            telemetry.record_chunk("lda", start=ep, losses=chunk_lls,
                                   wall_s=wall, ledger=ledger)
            ep += chunk
            with telemetry.phase("lda.checkpoint"):
                save_state = {"z": fetch(z_cur, group),
                              "wt": fetch(wt_cur, group), **layout_leaves}
                checkpointer.save(ep, save_state, meta=ckpt_lib.state_meta(
                    save_state, model="lda", world=w,
                    num_model_slices=cfg.num_model_slices, vpb=vpb,
                    vocab=cfg.vocab, method=cfg.method))
        if hasattr(checkpointer, "wait"):
            checkpointer.wait()       # surface a failed async final write
        wt_out = fetch(wt_cur, group)
        wt_final = wt_out[self._out_rows(w, word_block, word_slot, vpb)]
        if doc_topic is not None:
            dt = fetch(doc_topic, group)
        else:
            # every epoch was covered by the checkpoint: rebuild doc_topic
            # from the restored assignments
            z_h = fetch(z_cur, group)
            m_h = layout_leaves["mask"].astype(np.float32)
            if cfg.method == "cvb0":
                dt = (z_h * m_h[..., None]).sum(axis=(1, 2))
            else:
                dt = np.zeros((z_h.shape[0], cfg.num_topics), np.float32)
                d_idx = np.broadcast_to(
                    np.arange(z_h.shape[0])[:, None, None], z_h.shape)
                real = m_h > 0
                np.add.at(dt, (d_idx[real], z_h[real]), 1.0)
        return dt, wt_final, np.asarray(lls, np.float32), start

    def _reshard_mode(self) -> str:
        from harp_tpu_torch.collectives import reshard as rs

        return rs.resolve_mode(self.config.reshard,
                               self.session.num_workers)

    def _repartition_chain(self, saved: dict, ck_meta, new_layout: dict,
                           vpb: int, new_z_shape: tuple) -> dict:
        """Chain state written at another world size -> this session's
        blocked layout. Every token's assignment is re-matched onto the new
        blocking by its (doc, vocab-id) key (exact up to the exchangeable
        order of same-word same-doc occurrences); word-topic rows follow
        their (word_block, word_slot) maps. ``"device"``/``"ring"``: the
        match is computed on the index arrays only, then z rows and wt rows
        move in chunk-bounded rounds on the worker group
        (``collectives/reshard.py``); ``"host"``: the numpy oracle
        (``rematch_tokens`` and a count rebuild)."""
        from harp_tpu_torch.collectives import repartition as rep
        from harp_tpu_torch.collectives import reshard as rs

        cfg = self.config
        sess = self.session
        if ck_meta is None or "world" not in ck_meta:
            raise ValueError(
                "checkpoint does not match this session's chain shapes and "
                "carries no world metadata (written by a pre-elastic "
                "version?) — resume at the original worker count")
        if int(ck_meta.get("vocab", cfg.vocab)) != cfg.vocab \
                or str(ck_meta.get("method", cfg.method)) != cfg.method:
            raise ValueError(
                f"checkpoint chain (vocab={ck_meta.get('vocab')}, "
                f"method={ck_meta.get('method')}) does not describe this "
                f"model (vocab={cfg.vocab}, method={cfg.method})")
        old_world = int(ck_meta["world"])
        old_ns = int(ck_meta.get("num_model_slices", 1))
        new_ns = cfg.num_model_slices
        w = sess.num_workers
        saved_z = np.asarray(saved["z"])
        nb_old = saved_z.shape[1]
        vpb_old = int(ck_meta["vpb"])
        nb_new = int(new_z_shape[1])

        def inverse(wb, ws, nb, width):
            inv = np.full((nb, width), -1, np.int64)
            inv[np.asarray(wb, np.int64),
                np.asarray(ws, np.int64)] = np.arange(len(wb))
            return inv

        inv_old = inverse(saved["word_block"], saved["word_slot"], nb_old,
                          vpb_old)
        inv_new = inverse(new_layout["word_block"], new_layout["word_slot"],
                          nb_new, vpb)
        od, ob, op = np.nonzero(np.asarray(saved["mask"]) > 0)
        v_old = inv_old[ob, np.asarray(saved["docs"])[od, ob, op]]
        nd, nb_i, np_i = np.nonzero(np.asarray(new_layout["mask"]) > 0)
        slots_new = np.asarray(new_layout["docs"])[nd, nb_i, np_i]
        v_new = inv_new[nb_i, slots_new]
        if len(v_old) and v_old.min() < 0 or len(v_new) and v_new.min() < 0:
            raise ValueError(
                "blocked corpus references slots outside its vocab id maps "
                "— the checkpoint layout leaves are inconsistent")
        k = cfg.num_topics
        mode = self._reshard_mode()
        if mode in ("device", "ring"):
            schedule = "alltoall" if mode == "device" else "ring"
            chunk = cfg.reshard_chunk_bytes or rs.DEFAULT_CHUNK_BYTES
            # the k-th (doc, vocab) occurrence on the old side pairs with
            # the k-th on the new side (rematch_tokens' lexsort, no payload)
            old_order = np.lexsort((v_old, od))
            new_order = np.lexsort((v_new, nd))
            if not (np.array_equal(od[old_order], nd[new_order])
                    and np.array_equal(v_old[old_order], v_new[new_order])):
                raise ValueError(
                    "checkpoint token multiset does not match the prepared "
                    "corpus — the resumed run was prepared on different "
                    "data than the checkpoint was written from")
            lb_old, lb_new = saved_z.shape[2], int(new_z_shape[2])
            src_pos = ((od * nb_old + ob) * lb_old + op)[old_order]
            dst_pos = ((nd * nb_new + nb_i) * lb_new + np_i)[new_order]
            row_elems = k if cfg.method == "cvb0" else 1
            plan = rs.plan_moves(
                src_pos, dst_pos, saved_z.shape[0] * nb_old * lb_old,
                int(new_z_shape[0]) * nb_new * lb_new, w,
                row_elems * saved_z.dtype.itemsize, chunk, schedule)
            z_new = rs.reshard(
                sess, saved_z, plan,
                sess.scatter(np.zeros(new_z_shape, saved_z.dtype)))
            # wt rows follow their word: moving row v verbatim IS the
            # rebuild (counts per (word, topic) do not depend on blocking)
            old_wt_lay = rs.block_layout(
                (np.asarray(saved["word_block"]),
                 np.asarray(saved["word_slot"])), vpb_old, old_world,
                old_ns)
            new_wt_lay = rs.block_layout(
                (np.asarray(new_layout["word_block"]),
                 np.asarray(new_layout["word_slot"])), vpb, w, new_ns)
            wt_new = rs.reshard_factor(
                sess, np.asarray(saved["wt"]), old_wt_lay, old_world,
                new_wt_lay, cfg.vocab,
                sess.scatter(np.zeros((nb_new * vpb, k), np.float32)),
                chunk_bytes=chunk, schedule=schedule)
            return {**saved, "z": z_new, "wt": wt_new}
        matched = rep.rematch_tokens(
            od, v_old, saved_z[od, ob, op], nd, v_new)
        z_new = np.zeros(new_z_shape, saved_z.dtype)
        z_new[nd, nb_i, np_i] = matched
        # rebuild word-topic counts at the new blocking (prepare's formula)
        wt = np.zeros((nb_new, vpb, k), np.float32)
        if cfg.method == "cvb0":
            np.add.at(wt, (nb_i, slots_new), matched)
        else:
            np.add.at(wt, (nb_i, slots_new, matched), 1.0)
        if new_ns == 2:
            wt = wt.reshape(2, nb_new // 2, vpb, k).transpose(1, 0, 2, 3)
        return {**saved, "z": z_new,
                "wt": np.ascontiguousarray(wt.reshape(nb_new * vpb, k))}


# --------------------------------------------------------------------------- #
# Oracles (host)
# --------------------------------------------------------------------------- #

def reference_log_likelihood(word_topic: np.ndarray, beta: float,
                             vocab: int) -> float:
    """The reference's likelihood formula on host counts
    (CalcLikelihoodTask + printLikelihood's completion)."""
    return _ref_ll_np(word_topic, beta, vocab)


def _lgamma(x):
    try:
        from scipy.special import gammaln
        return gammaln(x)
    except ImportError:
        from math import lgamma
        return np.vectorize(lgamma)(x)


def _ref_ll_np(word_topic: np.ndarray, beta: float, vocab: int) -> float:
    k = word_topic.shape[1]
    nz = word_topic > 0.5
    ll = float(np.sum(np.where(nz, _lgamma(word_topic + beta)
                               - _lgamma(beta), 0.0)))
    topic_tot = word_topic.sum(axis=0)
    ll -= float(np.sum(_lgamma(topic_tot + vocab * beta)))
    ll += k * float(_lgamma(np.asarray(vocab * beta)))
    return ll


def full_model_log_likelihood(doc_topic: np.ndarray, word_topic: np.ndarray,
                              alpha: float, beta: float, vocab: int) -> float:
    """Full MALLET model log-likelihood: the reference's word part plus the
    doc-topic term it omits (ParallelTopicModel.modelLogLikelihood)."""
    k = doc_topic.shape[1]
    ll = _ref_ll_np(word_topic, beta, vocab)
    nz = doc_topic > 0.5
    ll += float(np.sum(np.where(nz, _lgamma(doc_topic + alpha)
                                - _lgamma(alpha), 0.0)))
    ll -= float(np.sum(_lgamma(doc_topic.sum(axis=1) + k * alpha)))
    ll += doc_topic.shape[0] * float(_lgamma(np.asarray(k * alpha)))
    return ll


def sequential_cgs_reference(docs: np.ndarray, cfg: LDAConfig, seed: int = 0
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Single-device token-sequential CGS, the convergence-parity oracle:
    (doc_topic, word_topic, per-epoch reference log-likelihood)."""
    rng = np.random.default_rng(seed)
    d, l = docs.shape
    k, v = cfg.num_topics, cfg.vocab
    z = rng.integers(0, k, (d, l))
    ndk = np.zeros((d, k))
    nwk = np.zeros((v, k))
    nk = np.zeros(k)
    for di in range(d):
        for li in range(l):
            t = z[di, li]
            ndk[di, t] += 1
            nwk[docs[di, li], t] += 1
            nk[t] += 1
    lls = []
    for _ in range(cfg.epochs):
        for di in range(d):
            for li in range(l):
                wi, t = docs[di, li], z[di, li]
                ndk[di, t] -= 1
                nwk[wi, t] -= 1
                nk[t] -= 1
                p = ((ndk[di] + cfg.alpha) * (nwk[wi] + cfg.beta)
                     / (nk + v * cfg.beta))
                t = rng.choice(k, p=p / p.sum())
                z[di, li] = t
                ndk[di, t] += 1
                nwk[wi, t] += 1
                nk[t] += 1
        lls.append(_ref_ll_np(nwk, cfg.beta, v))
    return ndk, nwk, np.asarray(lls)
