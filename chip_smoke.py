"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Builds every CUDA kernel of the port from ``harp_tpu_torch/csrc/`` with nvcc
(one nvcc per source, all at once), holds each kernel against its plain
PyTorch version on the card, and drives the main paths with the
launch counters set to 0 just before each and read just after:

  * K-means regroupallgather through ``HarpSession`` and ``KMeans.fit`` at
    the flagship n=1,000,000, k=100, d=100, 10 iterations, and the five comm
    variants bitwise equal;
  * dense SGD-MF rotation through ``SGDMF.prepare``/``fit_prepared`` at the
    flagship 32768 x 32768 ratings, 1%, rank 32, 8 minibatches a hop, 10
    epochs, against the same fit through the plain hop; then the stacked
    W=4 variants (1 and 2 slices, dense and sparse) at 4096 x 4096, 5%;
  * implicit ALS through ``ALS.prepare``/``fit_prepared`` at the flagship
    8192 x 8192, 0.5%, rank 32, 10 iterations (dense layout, two SPD-solve
    launches an iteration), against the same fit through the "cholesky"
    solver; explicit ALS (sparse layout) at the same size, ``run als``, and
    the stacked W=4 variants (dense and sparse, implicit and explicit) at
    2048 x 2048 against the "cholesky" fit and the port's CPU fit, each
    with a float64-solve fit as the yardstick. The SPD solve is held against
    its plain version and a float64 solve on the flagship's own normal
    equations and at K = 10 (N odd), 33 and 64;
  * attention: the flash kernel against its plain version and a float64
    reference on sampled query rows at the flagship (causal L=16384, H=8,
    Dh=64, f32), at H=4, Dh=128, ragged L=8209, Dv=96, bf16 and a stacked
    W=4 input; ``blocked_attention`` at both flagship shapes (one launch a
    call, tokens/s two-point), ``ring_attention_mha`` on 4 workers at
    L=32768 causal and not (4 launches a call) and ``ulysses_attention``
    on 4 workers at L=16384 (one stacked launch a call), held against
    blocked attention and the float64 reference; the streamed torch loop
    against the kernel at L = 2048, 4096 and 8192;
  * ring DMA: the hop (shifts 1, -1, 3; f32, bf16, int32 and a ragged
    uint8 block), ``hop_tree`` and ``ring_allgather`` on 4 stacked workers
    against their plain versions; the SGD-MF flagship at W=4 with
    ``fused_dma=True``, bitwise the unfused fit; ring attention with fused
    hops; then, through the port's launcher, 4 processes on the card
    (``chip_smoke.py --mp-child``): hop and allgather between processes
    against the gloo plain version, 200 hops with one rank held back, and
    the fused SGD-MF flagship bitwise the stacked fit, its factors pulled
    with ``table_ops.pull(fused=True)`` (the allgather kernel's path; the
    fit itself launches no allgather); and ``parallel/mp_smoke.py`` as 2
    processes x 2 workers.

It prints:

  * the card's name and power limit (nvidia-smi);
  * a ``{"kernels": [...]}`` line: per kernel its launches on its path,
    its error against the plain version, its time, the plain version's
    time, the bound for the same work and a PyTorch yardstick's time;
  * last, ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero. It imports nothing of
JAX. Without CUDA, or without the port beside it, it fails before printing a
result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

# the card's published peaks (NVIDIA H100 SXM data sheet): float32 on the
# CUDA cores, bf16 on the tensor cores (dense) and device-memory bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BYTES_S = 3.35e12
FLAGSHIP = dict(n=1_000_000, k=100, d=100, iterations=10)
TIE_EPS = 1e-5        # near tie: best two scores within 1e-5 of the row's scale
# README.md's SGD-MF row: sparse_ratings(32768, 32768, rank=16, density=0.01,
# seed=5), SGDMFConfig(rank=32, lam=0.01, lr=0.05, minibatches_per_hop=8)
MF_FLAGSHIP = dict(users=32768, items=32768, data_rank=16, density=0.01,
                   seed=5, rank=32, lam=0.01, lr=0.05, nmb=8, epochs=10)
# a column block that is not a multiple of the kernel's tile, K padded to 32
MF_RAGGED = dict(users=8192, items=30000, rank=20, nmb=4)
MF_VARIANTS = dict(n=4096, workers=4, epochs=3)
CARD = "cuda"
# README.md:112 and bench.py:260-288: implicit ALS, sparse_ratings(8192,
# 8192, rank=16, density=0.005, seed=9) as counts, rank 32, lam 0.1, alpha 40
ALS_FLAGSHIP = dict(users=8192, items=8192, data_rank=16, density=0.005,
                    seed=9, rank=32, lam=0.1, alpha=40.0, iterations=10)
# explicit ALS (tests/test_als_nn_solvers.py:11-19) at the flagship size:
# signed ratings, so layout auto picks the sparse capped chunks
ALS_EXPLICIT = dict(users=8192, items=8192, data_rank=16, density=0.005,
                    seed=9, rank=32, lam=0.05, iterations=10)
# bench.py --small's ALS size (bench.py:1350), both layouts and modes, W=4
ALS_VARIANTS = dict(n=2048, workers=4, density=0.01, rank=32, iterations=3)
# bench.py:1455-1497 (tpu_attention, the shape behind README.md:126): blocked
# causal attention on one card, L=16384, H=8, Dh=64, and H=4, Dh=128
ATTN_FLAGSHIP = dict(l=16384, h=8, dh=64)
ATTN_DH128 = dict(l=16384, h=4, dh=128)
# the smallest ring whose local block (8192) meets the dispatch rule
ATTN_RING = dict(l=32768, workers=4, h=8, dh=64)
ATTN_ULYSSES = dict(l=16384, workers=4, h=8, dh=64)
ATTN_CROSSOVER = (2048, 4096, 8192)
# ring DMA: W=4 workers, the SGD-MF flagship's H block at W=4 (rank 32 x
# 8192 columns, f32: 1 MiB a worker); across 4 processes at 4 KiB, 1 MiB and
# 64 MiB a worker; 200 hops of the credit test; two-point epochs of the
# fused SGD-MF flagship at W=4
RING_W = 4
RING_BLOCK = (32, 8192)
RING_MP_BYTES = (4096, 1 << 20, 64 << 20)
CREDIT_HOPS = 200
MF_FUSED_EPOCHS = (5, 20)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    log(f"  ok: {what}")


def ptxas_usage(build_log: str):
    """(kernel, registers, spills) for every entry function in an ``nvcc
    -Xptxas -v`` log, kernel names demangled where ``c++filt`` exists."""
    rows, fn, spill = [], "?", ""
    for line in build_log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            spill = line
        elif "Used" in line and "registers" in line:
            rows.append([fn, line.split(":", 1)[1].strip(), spill])
            spill = ""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, check=True)
        for r, name in zip(rows, out.stdout.splitlines()):
            r[0] = name.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0]
    except (OSError, subprocess.CalledProcessError):
        pass                       # keep the mangled names
    return rows


def device_profile(fn):
    """One call of ``fn`` (ending in a device sync) under torch.profiler:
    (ms of device time per kernel name, device busy share of the span from
    the first kernel's start to the last one's end). ``({}, None)`` if the
    profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        fn()
        torch.cuda.synchronize()
    per, lo, hi = {}, float("inf"), 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.replace("(anonymous namespace)::", "").replace(
            "void ", "").split("(")[0][:80]
        per[name] = per.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
        lo, hi = min(lo, e.time_range.start), max(hi, e.time_range.end)
    if not per:
        return per, None
    return per, sum(per.values()) / ((hi - lo) / 1e3)


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------- #
# K-means E-step: kernel against plain
# --------------------------------------------------------------------------- #

def library_estep(x, c, valid_k):
    """Yardstick only (never called by the port): the E-step as
    torch.matmul + argmin + index_add_ on the same inputs."""
    xf = x.float()
    cm = c.to(x.dtype).float()
    s = (c * c).sum(1)[None, :] - 2.0 * torch.matmul(xf, cm.t())
    s[:, valid_k:] = float("inf")
    a = torch.argmin(s, dim=1)
    sums = torch.zeros(c.shape, device=x.device).index_add_(0, a, xf)
    counts = torch.zeros(c.shape[0], device=x.device).index_add_(
        0, a, torch.ones_like(a, dtype=torch.float32))
    cost = s.gather(1, a[:, None]).sum() + (xf * xf).sum()
    return sums, counts, cost


def estep_bound(n, k, valid_k, d, x_bytes):
    """Least time for the same work: each input read once and each output
    written once, against the operations (score GEMM, norms, sums) at the
    float32 CUDA-core peak."""
    moved = n * d * x_bytes + k * d * 4 + (k * d + k + 1) * 4
    ops = 2 * n * valid_k * d + 2 * n * d + n * d
    t_bytes, t_ops = moved / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def near_ties(x, c, valid_k):
    from harp_tpu_torch.ops import distance

    cdtype = None if x.dtype == torch.float32 else x.dtype
    s = distance.pairwise_scores(x, c, cdtype)[:, :valid_k]
    top2 = torch.topk(s, 2, dim=1, largest=False).values
    return int(((top2[:, 1] - top2[:, 0])
                <= TIE_EPS * s.abs().amax(dim=1)).sum())


def estep_case(name, n, k, d, valid_k, dtype, timed):
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.ops import pallas_kernels as pk

    log(f"[estep:{name}] n={n} k={k} valid_k={valid_k} d={d} "
        f"x={str(dtype).split('.')[-1]}")
    pts = datagen.dense_points(n, d, seed=11, num_clusters=valid_k)
    x = torch.from_numpy(pts).to("cuda", dtype)
    c = torch.zeros(k, d, device="cuda")
    c[:valid_k] = torch.from_numpy(datagen.initial_centroids(pts, valid_k,
                                                             seed=12)).cuda()
    sums, counts, cost = pk.kmeans_stats_cuda(x, c, valid_k)
    torch.cuda.synchronize()
    ps, pc, pq = pk.kmeans_stats_plain(x, c, valid_k)
    ties = near_ties(x, c, valid_k)
    moved = float((counts - pc).abs().sum())
    log(f"  near-tie rows {ties}, count moves {moved:.0f}")
    check(moved <= 2 * ties, f"counts equal up to near ties "
          f"({moved:.0f} <= 2 x {ties})")
    check(float(counts.sum()) == n and float(counts[valid_k:].sum()) == 0.0,
          "every point counted once, none in phantom rows")
    same = counts == pc
    rtol = 1e-4 if dtype == torch.float32 else 2e-2
    scale = float(ps.abs().max())
    err = (sums - ps).abs()[same]
    rel = float((err / (ps.abs()[same] + 1e-3 * scale)).max())
    max_abs = float(err.max())
    check(rel <= rtol, f"sums within rtol {rtol:g} on rows with equal counts "
          f"(max rel {rel:.3g}, max abs {max_abs:.3g})")
    cost_rel = abs(float(cost) - float(pq)) / abs(float(pq))
    check(cost_rel <= 1e-4, f"cost within rtol 1e-4 (rel {cost_rel:.3g})")
    again = pk.kmeans_stats_cuda(x, c, valid_k)
    check(all(torch.equal(a, b) for a, b in zip((sums, counts, cost), again)),
          "two kernel runs bitwise equal")
    out = {"max_abs_err": max_abs, "near_ties": ties, "count_moves": moved}
    if timed:
        out["ms"] = cuda_time_ms(lambda: pk.kmeans_stats_cuda(x, c, valid_k))
        out["plain_ms"] = cuda_time_ms(
            lambda: pk.kmeans_stats_plain(x, c, valid_k))
        out["library_ms"] = cuda_time_ms(lambda: library_estep(x, c, valid_k))
        out["bound_ms"], out["bound_by"] = estep_bound(
            n, k, valid_k, d, x.element_size())
        log(f"  kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
            f"library {out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} "
            f"ms ({out['bound_by']})")
    return out


# --------------------------------------------------------------------------- #
# Main path: the flagship fit
# --------------------------------------------------------------------------- #

def lockstep_fit(x, cen0, iterations):
    """Lloyd iterations through the kernel, each E-step also run through the
    plain version from the SAME centroids: per iteration the two M-steps
    must agree within rtol 1e-4 on rows with equal counts, and the rows that
    differ are bounded by near ties. (Run freely, the two trajectories fork
    at the first near-tie flip, so whole fits are compared by cost only.)
    Returns the kernel's trajectory end and the worst per-iteration error."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    cen, worst = cen0.clone(), 0.0
    for _ in range(iterations):
        s1, n1, _ = pk.kmeans_stats_cuda(x, cen)
        s2, n2, _ = pk.kmeans_stats_plain(x, cen)
        moved = float((n1 - n2).abs().sum())
        ties = near_ties(x, cen, cen.shape[0])
        check(moved <= 2 * ties, f"lock-step counts equal up to near ties "
              f"({moved:.0f} <= 2 x {ties})")
        c1 = s1 / torch.clamp(n1[:, None], min=1.0)
        c2 = s2 / torch.clamp(n2[:, None], min=1.0)
        same = n1 == n2
        err = ((c1 - c2).abs()[same]
               / (c2.abs()[same] + 1e-3 * float(c2.abs().max())))
        worst = max(worst, float(err.max()))
        cen = c1
    check(worst <= 1e-4, f"lock-step centroids within rtol 1e-4 of the plain "
          f"E-step at every iteration (max rel {worst:.3g})")
    return cen, worst


def plain_fit(x, cen0, iterations):
    """The same Lloyd iterations through the plain E-step only, on the card."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    cen, costs = cen0.clone(), []
    for _ in range(iterations):
        sums, counts, cost = pk.kmeans_stats_plain(x, cen)
        cen = sums / torch.clamp(counts[:, None], min=1.0)
        costs.append(cost)
    return cen, torch.stack(costs)


def flagship_fit():
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.benchmark import timing
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import kmeans as km
    from harp_tpu_torch.ops import pallas_kernels as pk

    f = FLAGSHIP
    log(f"[fit] regroupallgather n={f['n']} k={f['k']} d={f['d']} "
        f"iterations={f['iterations']}, W=1")
    pts = datagen.dense_points(f["n"], f["d"], seed=0, num_clusters=f["k"])
    cen0 = datagen.initial_centroids(pts, f["k"], seed=1)
    sess = HarpSession(num_workers=1)
    check(sess.device.type == "cuda", "HarpSession() runs on cuda")
    cfg = km.KMeansConfig(num_centroids=f["k"], dim=f["d"],
                          iterations=f["iterations"], comm="regroupallgather")
    model = km.KMeans(sess, cfg)
    for name in pk.launches:
        pk.launches[name] = 0
    t0 = time.perf_counter()
    cen, costs = model.fit(pts, cen0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pk.launches)
    log(f"  fit wall {wall:.3f} s (incl. host->device copy), launches "
        f"{launches}")
    check(launches["kmeans_stats"] == f["iterations"],
          f"kmeans_stats launched once per iteration "
          f"({launches['kmeans_stats']})")
    c = costs.cpu().numpy().astype(np.float64)
    log(f"  costs {c.tolist()}")
    check(cen.shape == (f["k"], f["d"]) and bool(torch.isfinite(cen).all())
          and np.all(np.isfinite(c)), "finite centroids and costs")
    # Lloyd iterations never raise the cost; 1e-6 relative covers the f32
    # rounding of a sum over 1e6 points
    check(bool(np.all(np.diff(c) <= 1e-6 * c[:-1])), "costs non-increasing")
    x = torch.from_numpy(pts).cuda()
    c0 = torch.from_numpy(cen0).cuda()
    lcen, rel = lockstep_fit(x, c0, f["iterations"])
    check(torch.equal(cen, lcen), "the model's fit is bitwise the kernel's "
          "Lloyd trajectory")
    pcen, pcosts = plain_fit(x, c0, f["iterations"])
    cost_rel = abs(float(costs[-1]) - float(pcosts[-1])) / float(pcosts[-1])
    log(f"  free-running plain fit: final cost rel diff {cost_rel:.3g}, "
        f"centroid max abs diff {float((cen - pcen).abs().max()):.3g}")
    check(cost_rel <= 1e-4, "final cost within rtol 1e-4 of the plain fit's")

    def build(iters):
        m = km.KMeans(sess, km.KMeansConfig(f["k"], f["d"], iters))
        p, c0 = m.prepare(pts, cen0)
        m.fit_prepared(p, c0)
        return lambda: m.fit_prepared(p, c0)

    tp = timing.two_point(build, 10, 40, 1.0)
    log(f"  two-point: {tp['rate']:.2f} iters/s, {tp['per_iter_ms']:.4f} "
        f"ms/iter, fixed {tp['fixed_dispatch_s']:.4f} s, spread "
        f"{tp['spread_pct']:.1f}%")
    return {"launches": launches, "iters_per_s": tp["rate"],
            "per_iter_ms": tp["per_iter_ms"], "centroid_rel_vs_plain": rel}


def small_fit_vs_numpy():
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import kmeans as km

    log("[fit-small] n=4096 k=8 d=16 W=2 against the numpy Lloyd reference")
    pts = datagen.dense_points(4096, 16, seed=5, num_clusters=8)
    cen0 = datagen.initial_centroids(pts, 8, seed=6)
    cen, _ = km.KMeans(HarpSession(num_workers=2),
                       km.KMeansConfig(8, 16, 5)).fit(pts, cen0)
    ref = km.numpy_reference(pts.astype(np.float64), cen0.astype(np.float64), 5)
    err = float(np.abs(cen.cpu().numpy() - ref).max())
    check(err <= 1e-4, f"agrees with numpy_reference (max abs {err:.3g})")


def variants_bitwise():
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import kmeans as km

    log("[variants] all five comm variants, W=4, n=65536 k=32 d=64, 10 iters")
    pts = datagen.dense_points(65536, 64, seed=3, num_clusters=32)
    cen0 = datagen.initial_centroids(pts, 32, seed=4)
    sess = HarpSession(num_workers=4)
    outs = {}
    for comm in km.COMM_VARIANTS:
        outs[comm] = km.KMeans(sess, km.KMeansConfig(32, 64, 10, comm)).fit(
            pts, cen0)
    base = outs["regroupallgather"]
    for comm, (cen, costs) in outs.items():
        check(torch.equal(cen, base[0]) and torch.equal(costs, base[1]),
              f"{comm} bitwise equal to regroupallgather")


# --------------------------------------------------------------------------- #
# Dense SGD-MF hop: kernel against plain
# --------------------------------------------------------------------------- #

def max_rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def plain64_hop(slab, buckets, w, h, rc, cc, nmb, lr, lam):
    """The plain hop with float64 factors (exact sums of the same bf16
    products), its outputs back in float32: how far rounding alone moves a
    hop, the yardstick the kernel's distance is held to."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    out = pk.dense_mf_hop_plain(slab, buckets, w.double(), h.double(),
                                rc.double(), cc.double(), nmb, lr, lam)
    return tuple(t.float() for t in out)


def library_hop(slab, buckets, w, h, rc, cc, nmb, lr, lam):
    """Yardstick only (never called by the port): the stripe loop with
    cuBLAS bf16 ``torch.matmul`` (bf16 outputs) on the same inputs."""
    bf = torch.bfloat16
    _, _, rpw, cpb = slab.shape
    s = rpw // nmb
    b = int(buckets[0])
    vb, rcb = slab[0, b], rc[0, b]
    ccb = cc[0, b].reshape(nmb, -1, cpb).sum(dim=1)
    hb, w_out, sse = h[0], torch.empty_like(w[0]), 0.0
    for i in range(nmb):
        rows = slice(i * s, (i + 1) * s)
        w_s = w[0, rows]
        wb, hbb = w_s.to(bf), hb.to(bf)
        v = vb[rows].float()
        g = torch.where(torch.isnan(v), 0.0,
                        v - torch.matmul(wb, hbb.t()).float()).to(bf)
        dw = torch.matmul(g, hbb).float()
        dh = torch.matmul(g.t(), wb).float()
        w_out[rows] = w_s + lr * (dw - lam * rcb[rows, None] * w_s)
        hb = hb + lr * (dh - lam * ccb[i][:, None] * hb)
        sse = sse + (g.float() ** 2).sum()
    return w_out, hb, sse


def mf_hop_bound(nw, rpw, cpb, k, nmb_fine):
    """Least time for one hop: every worker's slab bucket (bf16), W, H and
    the counts read once and W, H, SSE written once, against 6 rpw cpb K
    operations at the bf16 tensor-core peak."""
    moved = nw * (rpw * cpb * 2 + 2 * rpw * k * 4 + 2 * cpb * k * 4
                  + rpw * 4 + nmb_fine * cpb * 4 + 4)
    ops = 6 * nw * rpw * cpb * k
    t_bytes, t_ops = moved / PEAK_BYTES_S, ops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def mfhop_case(name, slab, buckets, w, h, rc, cc, nmb, lr, lam, timed):
    from harp_tpu_torch.ops import pallas_kernels as pk

    nw, _, rpw, cpb = slab.shape
    k = w.shape[-1]
    log(f"[mfhop:{name}] W={nw} rpw={rpw} cpb={cpb} K={k} nmb={nmb}")
    args = (slab, buckets, w, h, rc, cc, nmb, lr, lam)
    w1, h1, sse1 = pk.dense_mf_hop_cuda(*args)
    torch.cuda.synchronize()
    w2, h2, sse2 = pk.dense_mf_hop_plain(*args)
    w3, h3, _ = plain64_hop(*args)
    out = {"max_abs_err": max(float((w1 - w2).abs().max()),
                              float((h1 - h2).abs().max()))}
    for tag, got, plain, exact in (("W", w1, w2, w3), ("H", h1, h2, h3)):
        err, ref = max_rel(got, exact), max_rel(plain, exact)
        tol = max(1e-4, 4 * ref)
        log(f"  {tag}: kernel vs float64 plain {err:.3g}, float32 plain vs "
            f"float64 plain {ref:.3g}, kernel vs float32 plain "
            f"{max_rel(got, plain):.3g}")
        check(err <= tol, f"{tag} within {tol:.3g} of the float64 plain hop "
              f"(1e-4 or 4x the float32 plain version's distance)")
        out[f"{tag}_rel_vs_plain"] = max_rel(got, plain)
    sse_rel = float(((sse1 - sse2).abs() / sse2.abs()).max())
    check(sse_rel <= 1e-5, f"SSE within rtol 1e-5 of the plain hop "
          f"(rel {sse_rel:.3g})")
    again = pk.dense_mf_hop_cuda(*args)
    check(all(torch.equal(a, b) for a, b in zip((w1, h1, sse1), again)),
          "two kernel runs bitwise equal")
    if timed:
        out["ms"] = cuda_time_ms(lambda: pk.dense_mf_hop_cuda(*args),
                                 reps=10, warmup=2)
        out["plain_ms"] = cuda_time_ms(lambda: pk.dense_mf_hop_plain(*args),
                                       reps=3, warmup=1)
        out["library_ms"] = (cuda_time_ms(lambda: library_hop(*args), reps=3,
                                          warmup=1) if nw == 1 else None)
        out["bound_ms"], out["bound_by"] = mf_hop_bound(
            nw, rpw, cpb, k, cc.shape[2])
        log(f"  kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
            f"library {out['library_ms']:.4f} ms, bound "
            f"{out['bound_ms']:.4f} ms ({out['bound_by']})")
        kp = next(r for r in pk.MF_RANKS if k <= r)
        lib = pk._mf_lib()
        n_ct = -(-cpb // lib.dense_mf_hop_col_tile(kp))
        ws_gb = nw * n_ct * rpw * kp * 4 / 1e9
        per, _ = device_profile(lambda: pk.dense_mf_hop_cuda(*args))
        log(f"  one launch under the profiler: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in per.items()) +
            f"; dW workspace {n_ct} tiles, {ws_gb:.3f} GB written and read; "
            f"{lib.dense_mf_hop_smem_bytes(kp)} B of shared memory a block")
        out["split_ms"] = per
    return out


def mf_hop_args(state):
    """The hop operands of a prepared W=1 dense state, as the model's
    stacked views (no copy)."""
    _, (v_slab, row_cnt, col_cnt), w0, h0, meta = state
    rpw, cpb = meta[4], meta[5]
    nw = v_slab.shape[0]
    buckets = torch.zeros(nw, dtype=torch.int32, device=v_slab.device)
    return (v_slab, buckets, w0.view(nw, rpw, -1), h0.view(nw, cpb, -1),
            row_cnt, col_cnt)


# --------------------------------------------------------------------------- #
# Main path: the flagship SGD-MF fit and the stacked variants
# --------------------------------------------------------------------------- #

def mf_plain_models(sess, cfg):
    """The same model twice more: through the plain hop, and through the
    plain hop in float64 (the rounding yardstick)."""
    from harp_tpu_torch.models import sgd_mf
    from harp_tpu_torch.ops import pallas_kernels as pk

    plain = sgd_mf.SGDMF(sess, cfg)
    plain.dense_hop = pk.dense_mf_hop_plain
    exact = sgd_mf.SGDMF(sess, cfg)
    exact.dense_hop = plain64_hop
    return plain, exact


def check_fit_vs_plain(fit, plain_fit, exact_fit, rmse_rtol=1e-4):
    (w1, h1, r1), (w2, h2, r2), (w3, h3, _) = fit, plain_fit, exact_fit
    r_rel = float(np.abs(r1 / r2 - 1).max())
    check(r_rel <= rmse_rtol, f"every epoch's RMSE within rtol {rmse_rtol:g} "
          f"of the plain fit's (max rel {r_rel:.3g})")
    worst = 0.0
    for tag, a, b, c in (("W", w1, w2, w3), ("H", h1, h2, h3)):
        a, b, c = (torch.from_numpy(x) for x in (a, b, c))
        err, ref = max_rel(a, b), max_rel(b, c)
        tol = max(1e-3, 4 * ref)
        log(f"  {tag}: kernel fit vs plain fit {err:.3g}; plain fit vs "
            f"float64-hop fit {ref:.3g}")
        check(err <= tol, f"final {tag} within {tol:.3g} of the plain fit "
              f"(1e-3 or 4x the float64-hop fit's distance)")
        worst = max(worst, err)
    return r_rel, worst


def mf_flagship(cfg, state, nnz):
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.benchmark import timing
    from harp_tpu_torch.models import sgd_mf
    from harp_tpu_torch.ops import pallas_kernels as pk

    f = MF_FLAGSHIP
    log(f"[sgd_mf] dense rotation {f['users']}x{f['items']}, {f['density']:g}"
        f", rank {f['rank']}, {f['nmb']} minibatches a hop, {f['epochs']} "
        f"epochs, W=1, nnz={nnz}")
    sess = HarpSession(num_workers=1)
    check(sess.device.type == "cuda", "HarpSession() runs on cuda")
    model = sgd_mf.SGDMF(sess, cfg)
    for name in pk.launches:
        pk.launches[name] = 0
    t0 = time.perf_counter()
    fit = model.fit_prepared(state)
    wall = time.perf_counter() - t0
    launches = dict(pk.launches)
    log(f"  fit wall {wall:.3f} s (first call, includes the factor fetch), "
        f"launches {launches}")
    check(state[0] == "dense", "auto layout picked dense")
    check(launches["dense_mf_hop"] == f["epochs"],
          f"dense_mf_hop launched once per epoch ({launches['dense_mf_hop']})")
    rmse = fit[2]
    log(f"  rmse {rmse.tolist()}")
    check(bool(np.all(np.isfinite(rmse))) and np.isfinite(fit[0]).all()
          and np.isfinite(fit[1]).all(), "finite RMSEs and factors")
    check(rmse[-1] < rmse[0], "RMSE falls over the fit")
    plain, exact = mf_plain_models(sess, cfg)
    r_rel, f_rel = check_fit_vs_plain(fit, plain.fit_prepared(state),
                                      exact.fit_prepared(state))

    def build(epochs):
        m = sgd_mf.SGDMF(sess, dataclasses.replace(cfg, epochs=epochs))
        m.train_prepared(state)
        return lambda: m.train_prepared(state)

    tp = timing.two_point(build, 10, 40, float(nnz))
    log(f"  two-point: {tp['rate']:.6g} ratings/s, {tp['per_iter_ms']:.4f} "
        f"ms/epoch, fixed {tp['fixed_dispatch_s']:.4f} s, spread "
        f"{tp['spread_pct']:.1f}%")

    epochs = 5
    per, busy = device_profile(build(epochs))
    prof = {"hop_kernel_ms": None, "w_reduce_ms": None, "busy_share": busy}
    if busy is None:
        log("  profile: the profiler saw no device activity (not measured)")
    else:
        for name, ms in sorted(per.items(), key=lambda kv: -kv[1]):
            log(f"  profile, {epochs} epochs: {name} {ms / epochs:.4f} ms an "
                f"epoch")
            if name.startswith("dense_mf_hop_kernel"):
                prof["hop_kernel_ms"] = ms / epochs
            elif name.startswith("dense_mf_w_kernel"):
                prof["w_reduce_ms"] = ms / epochs
        log(f"  profile: device busy {100 * busy:.2f}% of the span from the "
            f"first kernel's start to the last one's end")
    return {"launches": launches, "ratings_per_s": tp["rate"],
            "per_epoch_ms": tp["per_iter_ms"], "rmse_rel_vs_plain": r_rel,
            "factor_rel_vs_plain": f_rel, **prof}


def mf_variants():
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import sgd_mf
    from harp_tpu_torch.ops import pallas_kernels as pk

    n, w, epochs = (MF_VARIANTS[k] for k in ("n", "workers", "epochs"))
    log(f"[sgd_mf variants] W={w} stacked, {n}x{n}, 5%, rank 32, {epochs} "
        f"epochs")
    rows, cols, vals = datagen.sparse_ratings(n, n, rank=16, density=0.05,
                                              seed=9)
    sess = HarpSession(num_workers=w)
    for ns in (1, 2):
        cfg = sgd_mf.SGDMFConfig(rank=32, lam=0.01, lr=0.05, epochs=epochs,
                                 minibatches_per_hop=8, num_slices=ns,
                                 layout="dense")
        model = sgd_mf.SGDMF(sess, cfg)
        state = model.prepare(rows, cols, vals, n, n, seed=2)
        for name in pk.launches:
            pk.launches[name] = 0
        fit = model.fit_prepared(state)
        got = pk.launches["dense_mf_hop"]
        log(f"  dense, {ns} slice(s): rmse {fit[2].tolist()}")
        check(got == epochs * w * ns, f"dense, {ns} slice(s): one launch per "
              f"rotation step ({got} = {epochs} x {w} x {ns})")
        plain, exact = mf_plain_models(sess, cfg)
        check_fit_vs_plain(fit, plain.fit_prepared(state),
                           exact.fit_prepared(state))
        again = model.fit_prepared(state)
        check(all(np.array_equal(a, b) for a, b in zip(fit, again)),
              f"dense, {ns} slice(s): two fits bitwise equal")

        cfg = dataclasses.replace(cfg, layout="sparse")
        fit = sgd_mf.SGDMF(sess, cfg).fit(rows, cols, vals, n, n, seed=2)
        cpu = sgd_mf.SGDMF(HarpSession(num_workers=w, device="cpu"),
                           cfg).fit(rows, cols, vals, n, n, seed=2)
        r, rc = fit[2], cpu[2]
        log(f"  sparse, {ns} slice(s): rmse {r.tolist()}, on the CPU "
            f"{rc.tolist()}")
        check(bool(np.all(np.isfinite(r))) and bool(np.all(np.diff(r) < 0)),
              f"sparse, {ns} slice(s): finite, falling RMSEs")
        rel = float(np.abs(r / rc - 1).max())
        check(rel <= 1e-3, f"sparse, {ns} slice(s): RMSEs within rtol 1e-3 of "
              f"the CPU fit's (max rel {rel:.3g})")


def mf_phases():
    """Every SGD-MF phase; returns the kernels-line entry of dense_mf_hop."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import sgd_mf

    f = MF_FLAGSHIP
    t0 = time.perf_counter()
    rows, cols, vals = datagen.sparse_ratings(
        f["users"], f["items"], rank=f["data_rank"], density=f["density"],
        seed=f["seed"])
    cfg = sgd_mf.SGDMFConfig(rank=f["rank"], lam=f["lam"], lr=f["lr"],
                             epochs=f["epochs"], minibatches_per_hop=f["nmb"])
    model = sgd_mf.SGDMF(HarpSession(num_workers=1), cfg)
    state = model.prepare(rows, cols, vals, f["users"], f["items"], seed=0)
    nnz = model.last_layout_stats["nnz"]
    log(f"[mf:prepare] {time.perf_counter() - t0:.2f} s: {len(vals)} ratings "
        f"drawn, {nnz} after dedupe, layout {state[0]}")
    args = mf_hop_args(state)
    flag = mfhop_case("flagship", *args, f["nmb"], f["lr"], f["lam"],
                      timed=True)

    g = MF_RAGGED
    rows_r, cols_r, vals_r = datagen.sparse_ratings(
        g["users"], g["items"], rank=16, density=0.01, seed=7)
    rstate = sgd_mf.SGDMF(HarpSession(num_workers=1), dataclasses.replace(
        cfg, rank=g["rank"], minibatches_per_hop=g["nmb"])).prepare(
        rows_r, cols_r, vals_r, g["users"], g["items"], seed=3)
    mfhop_case("ragged", *mf_hop_args(rstate), g["nmb"], f["lr"], f["lam"],
               timed=False)
    del rstate

    rng = np.random.default_rng(128)
    slab, buckets, w32, h32, rc, cc = args
    w128, h128 = (torch.from_numpy((rng.standard_normal(
        t.shape[:2] + (128,)) / 128 ** 0.5).astype(np.float32)).to(t.device)
        for t in (w32, h32))
    r128 = mfhop_case("rank128", slab, buckets, w128, h128, rc, cc, f["nmb"],
                      f["lr"], f["lam"], timed=True)
    del w128, h128

    fit = mf_flagship(cfg, state, nnz)
    log(f"  kernel {flag['ms']:.4f} ms per hop (one hop an epoch) against a "
        f"bound of {flag['bound_ms']:.4f} ms ({flag['bound_by']}); fit "
        f"{fit['per_epoch_ms']:.4f} ms per epoch")
    del state, args, slab
    torch.cuda.empty_cache()
    mf_variants()
    return {
        "name": "dense_mf_hop", "route": "cuda",
        "source": "harp_tpu_torch/csrc/dense_mf_hop.cu",
        "replaces": "harp_tpu/ops/pallas_kernels.py:250",
        "launches": fit["launches"]["dense_mf_hop"],
        "max_abs_err": flag["max_abs_err"], "ms": flag["ms"],
        "plain_ms": flag["plain_ms"], "bound_ms": flag["bound_ms"],
        "bound_by": flag["bound_by"], "library_ms": flag["library_ms"],
        "W_rel_vs_plain": flag["W_rel_vs_plain"],
        "H_rel_vs_plain": flag["H_rel_vs_plain"],
        "rank128_ms": r128["ms"], "rank128_plain_ms": r128["plain_ms"],
        "rank128_bound_ms": r128["bound_ms"],
        "rank128_library_ms": r128["library_ms"],
        "split_ms": flag["split_ms"], "rank128_split_ms": r128["split_ms"],
        "fit_ratings_per_s": fit["ratings_per_s"],
        "fit_per_epoch_ms": fit["per_epoch_ms"],
        "fit_rmse_rel_vs_plain": fit["rmse_rel_vs_plain"],
        "fit_factor_rel_vs_plain": fit["factor_rel_vs_plain"],
        "fit_hop_kernel_ms": fit["hop_kernel_ms"],
        "fit_w_reduce_ms": fit["w_reduce_ms"],
        "fit_device_busy_share": fit["busy_share"],
    }


# --------------------------------------------------------------------------- #
# Batched SPD solve: kernel against plain and float64
# --------------------------------------------------------------------------- #

def lower_triangle_sectors(n, k):
    """32-byte sectors of an (n, K, K) row-major float32 tensor that hold an
    entry of a lower triangle: the only entries of A the solve reads. Row i
    of a system covers sectors first..last; rows lie in address order, so a
    sector that ends one row and starts the next counts once."""
    i = np.arange(k, dtype=np.int64)
    start = np.arange(n, dtype=np.int64)[:, None] * (k * k) + i * k
    first, last = (start * 4 // 32).ravel(), ((start + i) * 4 // 32).ravel()
    return int((last - first + 1).sum() - (first[1:] == last[:-1]).sum())


def spd_bound(n, k):
    """Least time for n K×K solves: the sectors of A's lower triangle and b
    read once and x written once, against (2K³/3 + 4K²) operations a system
    (Cholesky and the two substitutions) at the float32 CUDA-core peak."""
    moved = lower_triangle_sectors(n, k) * 32 + 2 * n * k * 4
    ops = (2 * k ** 3 / 3 + 4 * k * k) * n
    t_bytes, t_ops = moved / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_spd(a, b):
    """Yardstick only: the "cholesky" solver's route, cuSOLVER's batched
    Cholesky then ``cholesky_solve``."""
    return torch.cholesky_solve(b[..., None],
                                torch.linalg.cholesky_ex(a).L)[..., 0]


def random_spd(n, k, seed):
    """ALS-shaped systems made on the card from a seed: V'V over 4k rows
    plus 0.1 I, and right-hand sides."""
    g = torch.Generator(device=CARD).manual_seed(seed)
    v = torch.randn(n, 4 * k, k, generator=g, device=CARD) / k ** 0.5
    a = torch.bmm(v.transpose(1, 2), v) + 0.1 * torch.eye(k, device=CARD)
    return a.contiguous(), torch.randn(n, k, generator=g, device=CARD)


def spd_case(name, a, b, timed):
    from harp_tpu_torch.ops import pallas_kernels as pk

    n, k = b.shape
    log(f"[spd:{name}] N={n} K={k}")
    x = pk.spd_solve_cuda(a, b)
    torch.cuda.synchronize()
    plain = pk.spd_solve_plain(a, b)
    exact = torch.linalg.solve(a.double(), b.double())
    err, ref = max_rel(x, exact), max_rel(plain, exact)
    tol = max(1e-5, 4 * ref)
    log(f"  kernel vs float64 {err:.3g}, plain vs float64 {ref:.3g}, kernel "
        f"vs plain {max_rel(x, plain):.3g}")
    check(bool(torch.isfinite(x).all()) and err <= tol,
          f"x within {tol:.3g} of the float64 solve (1e-5 or 4x the plain "
          f"version's distance)")
    check(torch.equal(x, pk.spd_solve_cuda(a, b)),
          "two kernel runs bitwise equal")
    out = {"max_abs_err": float((x - plain).abs().max()),
           "rel_vs_float64": err, "plain_rel_vs_float64": ref}
    if timed:
        out["ms"] = cuda_time_ms(lambda: pk.spd_solve_cuda(a, b))
        out["plain_ms"] = cuda_time_ms(lambda: pk.spd_solve_plain(a, b),
                                       reps=3, warmup=1)
        out["library_ms"] = cuda_time_ms(lambda: library_spd(a, b))
        out["bound_ms"], out["bound_by"] = spd_bound(n, k)
        log(f"  kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
            f"library {out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} "
            f"ms ({out['bound_by']})")
    return out


def flagship_normal_equations(state, cfg):
    """(A, b) of the first implicit dense half-step at the ALS flagship:
    the users' systems from the initial item factor, through the model's
    own half-step; and the A GEMM's relative distance from a float32 GEMM
    of the same bf16 operands, with both GEMMs' times."""
    from harp_tpu_torch.models import als

    _, (u_plane, _, _, v0), _, _ = state
    got = {}

    def capture(a, b, _cfg):
        got["a"], got["b"] = a.contiguous(), b.contiguous()
        return b

    with mock.patch.object(als, "_spd_solve", capture):
        als._half_step_dense(v0, u_plane[None], cfg)
    vz = torch.where(torch.isfinite(u_plane), u_plane, 0.0)
    f_b = v0.to(torch.bfloat16)
    k = cfg.rank
    vv = (f_b[:, :, None] * f_b[:, None, :]).reshape(-1, k * k)
    conf = vz * torch.tensor(cfg.alpha, dtype=torch.bfloat16, device=CARD)
    fast = als._mm_f32(conf, vv)
    slow = torch.mm(conf.float(), vv.float())
    gemm = {"rel_vs_f32_gemm": max_rel(fast, slow),
            "bf16_out_f32_ms": cuda_time_ms(lambda: als._mm_f32(conf, vv)),
            "f32_ms": cuda_time_ms(
                lambda: torch.mm(conf.float(), vv.float()), reps=5)}
    return got["a"], got["b"], gemm


def spd_phases(state, cfg):
    f = ALS_FLAGSHIP
    a, b, gemm = flagship_normal_equations(state, cfg)
    log(f"[als:gemm] A = conf @ VV, ({f['users']}, {f['items']}) @ "
        f"({f['items']}, {cfg.rank ** 2}) bf16 with float32 output: "
        f"{gemm['bf16_out_f32_ms']:.4f} ms; float32 GEMM of the same "
        f"operands {gemm['f32_ms']:.4f} ms; relative distance "
        f"{gemm['rel_vs_f32_gemm']:.3g}")
    check(gemm["rel_vs_f32_gemm"] <= 1e-5, "the bf16 GEMM keeps float32 "
          "results (within 1e-5 of a float32 GEMM, relative to the largest "
          "entry)")
    flag = spd_case("flagship", a, b, timed=True)
    del a, b
    spd_case("ragged", *random_spd(8191, 10, seed=10), timed=False)
    spd_case("k33", *random_spd(8192, 33, seed=33), timed=False)
    k64 = spd_case("k64", *random_spd(8192, 64, seed=64), timed=True)
    return flag, k64, gemm


# --------------------------------------------------------------------------- #
# Main path: ALS fits
# --------------------------------------------------------------------------- #

def f64_solve(a, b, _cfg):
    """The same systems solved in float64: the rounding yardstick."""
    return torch.linalg.solve(a.double(), b.double()).float()


def plain_solve(a, b, _cfg):
    """The kernel's plain version, on the card."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    return pk.spd_solve_plain(a, b)


def reference_fits(sess, cfg, data):
    """The same fit through the "cholesky" solver on the card (the
    reference), and the rounding yardstick: how far a float32 solve's
    rounding alone moves this fit, the larger distance from a fit whose
    solve is float64 of two fits with float32 solves of their own
    (cuSOLVER's Cholesky, the kernel's plain version). Returns (reference
    fit, {"RMSE": rtol, "U": d, "V": d})."""
    from harp_tpu_torch.models import als

    chol = als.ALS(sess, dataclasses.replace(cfg, solver="cholesky"))
    ref = chol.fit(*data)
    with mock.patch.object(als, "_spd_solve", plain_solve):
        plain = chol.fit(*data)
    with mock.patch.object(als, "_spd_solve", f64_solve):
        exact = chol.fit(*data)
    yard = {"RMSE": max(float(np.abs(f[2] / exact[2] - 1).max())
                        for f in (ref, plain))}
    for i, tag in enumerate("UV"):
        yard[tag] = max(max_rel(torch.from_numpy(f[i]),
                                torch.from_numpy(exact[i]))
                        for f in (ref, plain))
    return ref, yard


def check_als_fit(fit, other, yard, name):
    """A fit against ``other`` (the cholesky fit on the card, or the CPU
    fit), with the rounding yardstick d of :func:`reference_fits` (the rule
    of the hop checks): every iteration's RMSE within rtol max(1e-4, 4 d),
    final factors within max(1e-3, 4 d) of their largest entry. Returns
    (RMSE distance, factor distance)."""
    r_rel = float(np.abs(fit[2] / other[2] - 1).max())
    rtol = max(1e-4, 4 * yard["RMSE"])
    log(f"  RMSE: kernel fit vs {name} {r_rel:.3g}; float32-solve fits vs "
        f"float64-solve fit up to {yard['RMSE']:.3g}")
    check(r_rel <= rtol, f"every iteration's RMSE within rtol {rtol:.3g} of "
          f"the {name}'s")
    worst = 0.0
    for i, tag in enumerate("UV"):
        err = max_rel(torch.from_numpy(fit[i]), torch.from_numpy(other[i]))
        tol = max(1e-3, 4 * yard[tag])
        log(f"  {tag}: kernel fit vs {name} {err:.3g}; float32-solve fits vs "
            f"float64-solve fit up to {yard[tag]:.3g}")
        check(err <= tol, f"final {tag} within {tol:.3g} of the {name}")
        worst = max(worst, err)
    return r_rel, worst


def als_fit_checked(sess, cfg, data, layout):
    """Fit ``data`` through the kernel, counting launches, and hold it
    against the cholesky and float64-solve fits. Returns (launches, fit,
    RMSE distance, factor distance)."""
    from harp_tpu_torch.models import als
    from harp_tpu_torch.ops import pallas_kernels as pk

    model = als.ALS(sess, cfg)
    state = model.prepare(*data)
    check(model.last_layout_stats["layout"] == layout,
          f"layout {model.last_layout_stats['layout']}")
    for name in pk.launches:
        pk.launches[name] = 0
    t0 = time.perf_counter()
    fit = model.fit_prepared(state)
    wall = time.perf_counter() - t0
    launches = dict(pk.launches)
    log(f"  fit wall {wall:.3f} s (first call, includes the factor fetch), "
        f"launches {launches}")
    check(launches["spd_solve"] == 2 * cfg.iterations,
          f"spd_solve launched twice an iteration ({launches['spd_solve']})")
    log(f"  rmse {fit[2].tolist()}")
    check(bool(np.all(np.isfinite(fit[2]))) and np.isfinite(fit[0]).all()
          and np.isfinite(fit[1]).all(), "finite RMSEs and factors")
    ref, yard = reference_fits(sess, cfg, data)
    r_rel, f_rel = check_als_fit(fit, ref, yard, "cholesky fit")
    return launches, fit, r_rel, f_rel


def als_two_point(sess, cfg, data):
    from harp_tpu_torch.benchmark import timing
    from harp_tpu_torch.models import als

    def build(iters):
        m = als.ALS(sess, dataclasses.replace(cfg, iterations=iters))
        s = m.prepare(*data)
        m.train_prepared(s)
        return lambda: m.train_prepared(s)

    return timing.two_point(build, 10, 40, 1.0)


def gemm_kernel(name: str) -> bool:
    return bool(re.search("gemm|nvjet|xmma|cutlass|cublas", name, re.I))


def als_flagship(data, cfg):
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.models import als

    f = ALS_FLAGSHIP
    log(f"[als:flagship] implicit {f['users']}x{f['items']}, "
        f"{f['density']:g}, rank {f['rank']}, lam {f['lam']}, alpha "
        f"{f['alpha']}, {f['iterations']} iterations, W=1")
    sess = HarpSession(num_workers=1)
    check(sess.device.type == "cuda", "HarpSession() runs on cuda")
    launches, fit, r_rel, f_rel = als_fit_checked(sess, cfg, data, "dense")
    tp = als_two_point(sess, cfg, data)
    ab = als_two_point(sess, dataclasses.replace(cfg, ablate_solve=True),
                       data)
    share = (tp["per_iter_ms"] - ab["per_iter_ms"]) / tp["per_iter_ms"]
    log(f"  two-point: {tp['rate']:.2f} iters/s, {tp['per_iter_ms']:.4f} "
        f"ms/iter, fixed {tp['fixed_dispatch_s']:.4f} s, spread "
        f"{tp['spread_pct']:.1f}%; solve ablated {ab['per_iter_ms']:.4f} "
        f"ms/iter, so the solve is {100 * share:.2f}% of an iteration")
    model = als.ALS(sess, cfg)
    s = model.prepare(*data)
    model.train_prepared(s)
    per, busy = device_profile(lambda: model.train_prepared(s))
    split = {"solve_kernel_ms": 0.0, "gemm_ms": 0.0, "other_ms": 0.0}
    if busy is None:
        log("  profile: the profiler saw no device activity (not measured)")
    else:
        n = cfg.iterations
        for name, ms in sorted(per.items(), key=lambda kv: -kv[1]):
            log(f"  profile, {n} iterations: {name} {ms / n:.4f} ms an "
                f"iteration")
            key = ("solve_kernel_ms" if name.startswith("spd_solve_kernel")
                   else "gemm_ms" if gemm_kernel(name) else "other_ms")
            split[key] += ms / n
        log(f"  profile: an iteration is {split['solve_kernel_ms']:.4f} ms "
            f"in the solve kernel, {split['gemm_ms']:.4f} ms in GEMMs, "
            f"{split['other_ms']:.4f} ms in other kernels; device busy "
            f"{100 * busy:.2f}% of the span")
    return {"launches": launches, "iters_per_s": tp["rate"],
            "per_iter_ms": tp["per_iter_ms"],
            "ablated_per_iter_ms": ab["per_iter_ms"], "solve_share": share,
            "rmse_rel_vs_cholesky": r_rel, "factor_rel_vs_cholesky": f_rel,
            "busy_share": busy, **split}


def als_explicit():
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import als

    e = ALS_EXPLICIT
    log(f"[als:explicit] {e['users']}x{e['items']}, {e['density']:g}, signed "
        f"ratings, rank {e['rank']}, lam {e['lam']}, {e['iterations']} "
        f"iterations, W=1")
    rows, cols, vals = datagen.sparse_ratings(
        e["users"], e["items"], rank=e["data_rank"], density=e["density"],
        seed=e["seed"])
    data = (rows, cols, vals, e["users"], e["items"], 0)
    cfg = als.ALSConfig(rank=e["rank"], lam=e["lam"],
                        iterations=e["iterations"], implicit=False)
    sess = HarpSession(num_workers=1)
    launches, fit, r_rel, f_rel = als_fit_checked(sess, cfg, data, "sparse")
    tp = als_two_point(sess, cfg, data)
    log(f"  two-point: {tp['rate']:.2f} iters/s, {tp['per_iter_ms']:.4f} "
        f"ms/iter, spread {tp['spread_pct']:.1f}%")
    proc = subprocess.run(
        [sys.executable, "-m", "harp_tpu_torch.run", "als", "--ratings-file",
         "datasets/als"], capture_output=True, text=True, timeout=300)
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    log(f"  run als --ratings-file datasets/als: exit {proc.returncode}: "
        f"{line}")
    check(proc.returncode == 0, "run als exits 0" + (
        "" if proc.returncode == 0 else f":\n{proc.stderr[-2000:]}"))
    first, last = (float(x) for x in line.split("rmse ")[1].split(" -> "))
    check(last < first, "run als's printed RMSE falls")
    return {"launches": launches, "iters_per_s": tp["rate"],
            "per_iter_ms": tp["per_iter_ms"], "rmse_rel_vs_cholesky": r_rel,
            "factor_rel_vs_cholesky": f_rel}


def als_variants():
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import als
    from harp_tpu_torch.ops import pallas_kernels as pk

    v = ALS_VARIANTS
    n, w, iters = v["n"], v["workers"], v["iterations"]
    log(f"[als variants] W={w} stacked, {n}x{n}, {v['density']:g}, rank "
        f"{v['rank']}, {iters} iterations, against the cholesky and CPU "
        f"fits")
    rows, cols, vals = datagen.sparse_ratings(n, n, rank=16,
                                              density=v["density"], seed=4)
    sess = HarpSession(num_workers=w)
    cpu = HarpSession(num_workers=w, device="cpu")
    for layout in ("dense", "sparse"):
        for implicit in (True, False):
            cfg = als.ALSConfig(rank=v["rank"], lam=0.1 if implicit else 0.05,
                                iterations=iters, implicit=implicit,
                                layout=layout)
            data = (rows, cols, np.abs(vals) if implicit else vals, n, n, 1)
            for name in pk.launches:
                pk.launches[name] = 0
            fit = als.ALS(sess, cfg).fit(*data)
            got = pk.launches["spd_solve"]
            mode = "implicit" if implicit else "explicit"
            log(f"  {layout} {mode}: rmse {fit[2].tolist()}")
            check(got == 2 * iters, f"{layout} {mode}: two launches an "
                  f"iteration ({got})")
            check(all(bool(np.isfinite(x).all()) for x in fit),
                  f"{layout} {mode}: finite RMSEs and factors")
            ref, yard = reference_fits(sess, cfg, data)
            check_als_fit(fit, ref, yard, "cholesky fit")
            check_als_fit(fit, als.ALS(cpu, cfg).fit(*data), yard, "CPU fit")


def als_phases():
    """Every SPD-solve and ALS phase; returns the kernels-line entry of
    spd_solve."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import als

    f = ALS_FLAGSHIP
    t0 = time.perf_counter()
    rows, cols, vals = datagen.sparse_ratings(
        f["users"], f["items"], rank=f["data_rank"], density=f["density"],
        seed=f["seed"])
    data = (rows, cols, np.abs(vals), f["users"], f["items"], 0)
    cfg = als.ALSConfig(rank=f["rank"], lam=f["lam"], alpha=f["alpha"],
                        iterations=f["iterations"], implicit=True)
    model = als.ALS(HarpSession(num_workers=1), cfg)
    state = model.prepare(*data)
    log(f"[als:prepare] {time.perf_counter() - t0:.2f} s: {len(vals)} "
        f"ratings drawn, {model.last_layout_stats['duplicates_dropped']} "
        f"duplicates dropped, layout {model.last_layout_stats['layout']}")
    flag, k64, gemm = spd_phases(state, cfg)
    del state
    fit = als_flagship(data, cfg)
    log(f"  kernel {flag['ms']:.4f} ms per solve (two an iteration) against "
        f"a bound of {flag['bound_ms']:.4f} ms ({flag['bound_by']}); fit "
        f"{fit['per_iter_ms']:.4f} ms an iteration")
    exp = als_explicit()
    als_variants()
    return {
        "name": "spd_solve", "route": "cuda",
        "source": "harp_tpu_torch/csrc/spd_solve.cu",
        "replaces": "harp_tpu/ops/pallas_kernels.py:829",
        "launches": fit["launches"]["spd_solve"],
        "max_abs_err": flag["max_abs_err"], "ms": flag["ms"],
        "plain_ms": flag["plain_ms"], "bound_ms": flag["bound_ms"],
        "bound_by": flag["bound_by"], "library_ms": flag["library_ms"],
        "rel_vs_float64": flag["rel_vs_float64"],
        "plain_rel_vs_float64": flag["plain_rel_vs_float64"],
        "k64_ms": k64["ms"], "k64_plain_ms": k64["plain_ms"],
        "k64_bound_ms": k64["bound_ms"], "k64_bound_by": k64["bound_by"],
        "k64_library_ms": k64["library_ms"],
        "gemm_bf16_out_f32_ms": gemm["bf16_out_f32_ms"],
        "gemm_f32_ms": gemm["f32_ms"],
        "fit_iters_per_s": fit["iters_per_s"],
        "fit_per_iter_ms": fit["per_iter_ms"],
        "fit_solve_ablated_per_iter_ms": fit["ablated_per_iter_ms"],
        "solve_share": fit["solve_share"],
        "fit_solve_kernel_ms": fit["solve_kernel_ms"],
        "fit_gemm_ms": fit["gemm_ms"], "fit_other_ms": fit["other_ms"],
        "fit_device_busy_share": fit["busy_share"],
        "fit_rmse_rel_vs_cholesky": fit["rmse_rel_vs_cholesky"],
        "fit_factor_rel_vs_cholesky": fit["factor_rel_vs_cholesky"],
        "explicit_fit_iters_per_s": exp["iters_per_s"],
        "explicit_fit_per_iter_ms": exp["per_iter_ms"],
        "explicit_launches": exp["launches"]["spd_solve"],
    }


# --------------------------------------------------------------------------- #
# Flash attention: kernel against plain and a float64 reference
# --------------------------------------------------------------------------- #

def attn_inputs(shape_qk, dv, dtype=torch.float32, seed=0):
    """q, k (shape_qk) and v (shape_qk[:-1] + (dv,)) made on the card from a
    seed, standard normal, in ``dtype``."""
    g = torch.Generator(device=CARD).manual_seed(seed)
    q, k = (torch.randn(shape_qk, generator=g, device=CARD) for _ in range(2))
    v = torch.randn(shape_qk[:-1] + (dv,), generator=g, device=CARD)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def sample_rows(l, n=256, seed=0):
    """n query rows drawn from a seed, with the first and the last, sorted."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.cat([torch.tensor([0, l - 1]),
                      torch.randint(0, l, (n,), generator=g)])
    return torch.unique(rows).to(CARD)


def attention_rows(q, k, v, causal, rows, dtype=torch.float64):
    """Full-row softmax attention of the query rows ``rows`` of every
    stacked worker and head against all keys, in ``dtype``: (out (W, R, H,
    Dv), m (W, R, H), den (W, R, H)). In float64 it is the reference; in
    float32 it is the plain version's arithmetic on those rows."""
    q, k, v = (x if x.dim() == 4 else x[None] for x in (q, k, v))
    scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.einsum("wqhd,wkhd->whqk", q[:, rows].to(dtype),
                     k.to(dtype)) * scale
    if causal:
        keys = torch.arange(k.shape[1], device=k.device)
        s.masked_fill_(rows[:, None] < keys[None, :], -1e30)
    m = s.amax(dim=3)
    p = torch.exp(s - m[..., None])
    den = p.sum(dim=3)
    out = torch.einsum("whqk,wkhd->wqhd", p, v.to(dtype))
    return (out / den.transpose(1, 2)[..., None], m.transpose(1, 2),
            den.transpose(1, 2))


def flash_bound(w, l, h, dh, dv, causal, in_bytes):
    """Least time for attention over (W, L, H): q, k, v read once and out
    written once, against (2 Dh + 2 Dv) H operations a live (query, key)
    pair, L (L + 1) / 2 pairs causal. The float32 path's operations take
    three TF32 passes (the fastest route to float32 accuracy); with bf16
    inputs the q k half runs at the bf16 rate, p v still as three TF32
    passes (p stays float32). Returns (ms, what bounds it, the same
    operations on the float32 CUDA cores in ms)."""
    pairs = w * h * (l * (l + 1) // 2 if causal else l * l)
    moved = w * l * h * ((2 * dh + dv) * in_bytes + dv * 4)
    qk, pv = 2 * dh * pairs, 2 * dv * pairs
    t_qk = qk / PEAK_BF16_FLOPS if in_bytes == 2 else 3 * qk / PEAK_TF32_FLOPS
    t_ops = t_qk + 3 * pv / PEAK_TF32_FLOPS
    t_bytes = moved / PEAK_BYTES_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            (qk + pv) / PEAK_F32_FLOPS * 1e3)


def library_attention(q, k, v, causal):
    """Yardstick only (never called by the port): PyTorch's
    scaled_dot_product_attention on the same (L, H, D) tensors, viewed (1,
    H, L, D) (a 3-D input would send it to its math backend, which holds
    the whole (H, L, L) score tensor)."""
    return torch.nn.functional.scaled_dot_product_attention(
        *(x.transpose(0, 1)[None] for x in (q, k, v)),
        is_causal=causal)[0].transpose(0, 1)


def hold(name, got, yard, exact):
    """``got`` (on the sampled rows) within max(1e-5, 4x the yardstick's
    distance) of the float64 reference, relative to its largest entry.
    Returns the distance."""
    err, ref = max_rel(got, exact), max_rel(yard, exact)
    tol = max(1e-5, 4 * ref)
    check(bool(torch.isfinite(got).all()) and err <= tol,
          f"{name} within {tol:.3g} of the float64 reference ({err:.3g}; "
          f"the plain arithmetic {ref:.3g})")
    return err


def flash_case(name, w, l, h, dh, dv, causal, dtype, timed, seed=0):
    """The kernel against a float64 reference on 256 sampled query rows of
    every worker and head, and against its plain version on every row: out,
    m and den. Reports the KV tiles the kernel counted as loaded."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    shape = (l, h, dh) if w is None else (w, l, h, dh)
    log(f"[flash:{name}] W={w or 1} L={l} H={h} Dh={dh} Dv={dv} "
        f"{'causal' if causal else 'full'} {str(dtype).split('.')[-1]}")
    q, k, v = attn_inputs(shape, dv, dtype, seed)
    with pk.count_flash_tiles() as counted_tiles:
        got = pk.flash_attention_cuda(q, k, v, causal, return_stats=True)
        tiles = counted_tiles()
    plain = pk.flash_attention_plain(q, k, v, causal, return_stats=True)
    rows = sample_rows(l, seed=seed)
    exact = attention_rows(q, k, v, causal, rows)
    lift = (lambda t: t) if w is not None else (lambda t: t[None])
    errs = {}
    for tag, a, b, c in zip(("out", "m", "den"), got, plain, exact):
        errs[tag] = hold(f"{tag}", lift(a)[:, rows], lift(b)[:, rows], c)
        # every row: the kernel and the plain version each lie within tol
        # of the exact values, so within 2 tol of each other
        tol = 2 * max(1e-5, 4 * max_rel(lift(b)[:, rows], c))
        rel = max_rel(a, b)
        check(rel <= tol, f"{tag} on every row within {tol:.3g} of the "
              f"plain version ({rel:.3g})")
    again = pk.flash_attention_cuda(q, k, v, causal, return_stats=True)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "two kernel runs bitwise equal")
    out = {"max_abs_err": float((got[0] - plain[0]).abs().max()),
           "rel_vs_float64": errs["out"], "tiles": tiles, "out": got[0],
           "inputs": (q, k, v)}
    log(f"  KV tiles the kernel loaded: {tiles}; kernel vs plain max abs "
        f"{out['max_abs_err']:.3g}")
    if timed:
        out["ms"] = cuda_time_ms(lambda: pk.flash_attention_cuda(q, k, v,
                                                                 causal),
                                 reps=10, warmup=2)
        out["plain_ms"] = cuda_time_ms(
            lambda: pk.flash_attention_plain(q, k, v, causal), reps=2,
            warmup=1)
        lib = library_attention(q, k, v, causal)
        out["library_rel_vs_float64"] = max_rel(lib[None][:, rows],
                                                exact[0])
        out["library_ms"] = cuda_time_ms(
            lambda: library_attention(q, k, v, causal), reps=10, warmup=2)
        out["bound_ms"], out["bound_by"], core = flash_bound(
            w or 1, l, h, dh, dv, causal, q.element_size())
        log(f"  kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
            f"library (SDPA, {out['library_rel_vs_float64']:.3g} from "
            f"float64) {out['library_ms']:.4f} ms, bound "
            f"{out['bound_ms']:.4f} ms ({out['bound_by']}; {core:.4f} ms on "
            f"the float32 CUDA cores); {l / out['ms'] * 1e3:.6g} tokens/s")
    return out


def flash_cases():
    """The kernel's phases; returns the timed flagship and dh128 cases."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    f, d = ATTN_FLAGSHIP, ATTN_DH128
    flag = flash_case("flagship", None, f["l"], f["h"], f["dh"], f["dh"],
                      True, torch.float32, timed=True)
    d128 = flash_case("dh128", None, d["l"], d["h"], d["dh"], d["dh"], True,
                      torch.float32, timed=True, seed=1)
    flash_case("ragged", None, 8209, 8, 64, 64, False, torch.float32, False,
               seed=2)
    flash_case("dv96", None, 4096, 8, 64, 96, True, torch.float32, False,
               seed=3)
    flash_case("bf16", None, f["l"], f["h"], f["dh"], f["dh"], True,
               torch.bfloat16, False, seed=4)
    # the ring's hops: W=4 stacked at the local length 8192, hop 0 causal,
    # hops 1-3 not
    r = ATTN_RING
    st = flash_case("stacked", r["workers"], r["l"] // r["workers"], r["h"],
                    r["dh"], r["dh"], True, torch.float32, False, seed=5)
    q, k, v = st["inputs"]
    one = [pk.flash_attention_cuda(q[i], k[i], v[i], True) for i in range(4)]
    check(all(torch.equal(st["out"][i], one[i]) for i in range(4)),
          "a stacked W=4 launch is bitwise 4 separate launches")
    del st
    flash_case("stacked_full", r["workers"], r["l"] // r["workers"], r["h"],
               r["dh"], r["dh"], False, torch.float32, False, seed=8)
    return flag, d128


# --------------------------------------------------------------------------- #
# Main path: blocked, ring and Ulysses attention
# --------------------------------------------------------------------------- #

def counted(fn):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after; returns (result, counts, the KV tiles the flash kernel counted as
    loaded in the run)."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    for name in pk.launches:
        pk.launches[name] = 0
    with pk.count_flash_tiles() as tiles:
        out = fn()
        torch.cuda.synchronize()
        return out, dict(pk.launches), tiles()


def tokens_two_point(fn, l):
    """Tokens/s two-point, as bench.py's tpu_attention defines them: L over
    the seconds of one call."""
    from harp_tpu_torch.benchmark import timing

    def build(n):
        def run():
            for _ in range(n):
                fn()
        run()
        return run

    return timing.two_point(build, 2, 8, float(l))


def blocked_phase(name, case, cfg):
    """``blocked_attention`` through the public function: one launch a
    call, bitwise the kernel case's output; tokens/s two-point."""
    from harp_tpu_torch.parallel import ring_attention as ra

    q, k, v = case["inputs"]
    log(f"[attention:blocked] {name}: L={cfg['l']} H={cfg['h']} "
        f"Dh={cfg['dh']} causal, f32")
    out, counts, tiles = counted(
        lambda: ra.blocked_attention(q, k, v, causal=True))
    check(counts["flash_attention"] == 1,
          f"one flash_attention launch a call ({counts['flash_attention']})")
    check(tiles == case["tiles"], f"the kernel case's {case['tiles']} KV "
          f"tiles loaded ({tiles})")
    check(torch.equal(out, case["out"]), "bitwise the kernel's output")
    tp = tokens_two_point(lambda: ra.blocked_attention(q, k, v, causal=True),
                          cfg["l"])
    log(f"  two-point: {tp['rate']:.6g} tokens/s, {tp['per_iter_ms']:.4f} ms "
        f"a call, spread {tp['spread_pct']:.1f}%")
    return {"launches": counts["flash_attention"], "tokens_per_s": tp["rate"],
            "per_call_ms": tp["per_iter_ms"], "tiles": tiles}


def sharded(sess, fn, q, k, v):
    return sess.run(fn, q, k, v, in_specs=(sess.shard(),) * 3,
                    out_specs=sess.shard())


def ring_phase():
    """``ring_attention_mha`` on 4 stacked workers at L=32768 (local 8192),
    causal and not: 4 launches a call, held against blocked attention of
    the whole sequence through the kernel and a float64 reference."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.ops import pallas_kernels as pk
    from harp_tpu_torch.parallel import ring_attention as ra

    c = ATTN_RING
    sess = HarpSession(num_workers=c["workers"])
    q, k, v = attn_inputs((c["l"], c["h"], c["dh"]), c["dh"], seed=6)
    rows = sample_rows(c["l"], seed=6)
    res = {}
    for causal in (True, False):
        tag = "causal" if causal else "full"
        log(f"[attention:ring] {tag}: W={c['workers']} L={c['l']} (local "
            f"{c['l'] // c['workers']}) H={c['h']} Dh={c['dh']} f32, "
            f"use_flash=None")

        def ring(flash=None, causal=causal):
            return sharded(sess, lambda a, b, d: ra.ring_attention_mha(
                a, b, d, causal, use_flash=flash), q, k, v)

        out, counts, tiles = counted(ring)
        check(counts["flash_attention"] == c["workers"],
              f"{c['workers']} flash_attention launches a call, one a hop "
              f"({counts['flash_attention']})")
        exact = attention_rows(q, k, v, causal, rows)[0]
        yard = attention_rows(q, k, v, causal, rows, torch.float32)[0]
        err = hold("ring out", out[None][:, rows], yard, exact)
        whole = ra.blocked_attention(q, k, v, causal)
        rel = max_rel(out, whole)
        check(rel <= max(1e-5, 4 * max_rel(yard, exact)),
              f"within the same bound of blocked attention of the whole "
              f"sequence through the kernel ({rel:.3g})")
        ms = cuda_time_ms(ring, reps=3, warmup=1)
        with mock.patch.object(pk, "flash_attention_cuda",
                               pk.flash_attention_plain):
            plain_ms = cuda_time_ms(ring, reps=1, warmup=1)
        einsum_ms = cuda_time_ms(lambda: ring(False), reps=1, warmup=1)
        lib_ms = cuda_time_ms(lambda: library_attention(q, k, v, causal),
                              reps=3, warmup=1)
        bound, by, core = flash_bound(1, c["l"], c["h"], c["dh"], c["dh"],
                                      causal, 4)
        log(f"  ring {ms:.4f} ms a call ({c['l'] / ms * 1e3:.6g} tokens/s), "
            f"through the plain version {plain_ms:.4f} ms, einsum hops "
            f"{einsum_ms:.4f} ms, SDPA over the whole sequence "
            f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}; {core:.4f} ms on "
            f"the float32 CUDA cores)")
        res[tag] = {"launches": counts["flash_attention"], "ms": ms,
                    "plain_ms": plain_ms, "einsum_ms": einsum_ms,
                    "library_ms": lib_ms,
                    "max_abs_err": float((out - whole).abs().max()),
                    "bound_ms": bound, "bound_by": by, "rel_vs_float64": err,
                    "tiles": tiles}
        log(f"  KV tiles the kernel loaded in the call: {tiles}")
    # hops 1-3 of the causal call and all 4 of the full one load the whole
    # square of their block; hop 0 (causal) must load only the trapezoid,
    # n (n + 1) / 2 of the n x n tiles of each (worker, head)
    w, h = c["workers"], c["h"]
    hop_full = res["full"]["tiles"] // w
    hop0 = res["causal"]["tiles"] - (w - 1) * hop_full
    n = round((hop_full / (w * h)) ** 0.5)
    check(res["full"]["tiles"] == w * w * h * n * n
          and hop0 == w * h * n * (n + 1) // 2,
          f"the causal hop loads the trapezoid ({hop0} KV tiles; a full hop "
          f"{hop_full}, {n} x {n} tiles a worker and head)")
    per, busy = device_profile(lambda: sharded(
        sess, lambda a, b, d: ra.ring_attention_mha(a, b, d, True), q, k, v))
    if busy is None:
        log("  profile: the profiler saw no device activity (not measured)")
    else:
        for name, ms in sorted(per.items(), key=lambda kv: -kv[1])[:8]:
            log(f"  profile, one causal call: {name} {ms:.4f} ms")
        log(f"  profile: device busy {100 * busy:.2f}% of the span")
    res["profile_busy_share"] = busy
    res["profile_ms"] = per
    return res


def ulysses_phase(flag):
    """``ulysses_attention`` on 4 stacked workers at the flagship's inputs:
    one stacked launch a call (each worker's 2 heads over the full
    sequence), held against blocked attention (the flagship kernel case)
    and a float64 reference."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.ops import pallas_kernels as pk
    from harp_tpu_torch.parallel import ring_attention as ra

    c = ATTN_ULYSSES
    log(f"[attention:ulysses] W={c['workers']} L={c['l']} H={c['h']} "
        f"Dh={c['dh']} causal, f32")
    sess = HarpSession(num_workers=c["workers"])
    q, k, v = flag["inputs"]

    def uly():
        return sharded(sess, lambda a, b, d: ra.ulysses_attention(
            a, b, d, c["h"], True), q, k, v)

    out, counts, tiles = counted(uly)
    check(counts["flash_attention"] == 1,
          f"one stacked flash_attention launch a call "
          f"({counts['flash_attention']})")
    check(tiles == flag["tiles"], f"the blocked flagship's {flag['tiles']} "
          f"KV tiles loaded ({tiles}): 4 workers x 2 heads over the whole "
          f"sequence")
    rows = sample_rows(c["l"], seed=7)
    exact = attention_rows(q, k, v, True, rows)[0]
    yard = attention_rows(q, k, v, True, rows, torch.float32)[0]
    err = hold("ulysses out", out[None][:, rows], yard, exact)
    rel = max_rel(out, flag["out"])
    check(rel <= max(1e-5, 4 * max_rel(yard, exact)),
          f"within the same bound of blocked attention ({rel:.3g})")
    tp = tokens_two_point(uly, c["l"])
    ms = cuda_time_ms(uly, reps=5, warmup=1)
    with mock.patch.object(pk, "flash_attention_cuda",
                           pk.flash_attention_plain):
        plain_ms = cuda_time_ms(uly, reps=1, warmup=1)
    lib_ms = cuda_time_ms(lambda: library_attention(q, k, v, True), reps=5,
                          warmup=1)
    bound, by, _ = flash_bound(1, c["l"], c["h"], c["dh"], c["dh"], True, 4)
    log(f"  two-point: {tp['rate']:.6g} tokens/s, {tp['per_iter_ms']:.4f} ms "
        f"a call, spread {tp['spread_pct']:.1f}%; {ms:.4f} ms a call by CUDA "
        f"events, {plain_ms:.4f} ms through the plain version, SDPA over "
        f"the whole sequence {lib_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return {"launches": counts["flash_attention"], "rel_vs_float64": err,
            "tokens_per_s": tp["rate"], "per_call_ms": tp["per_iter_ms"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "max_abs_err": float((out - flag["out"]).abs().max()),
            "library_ms": lib_ms, "tiles": tiles}


def crossover_phase():
    """blocked_attention's streamed torch loop against the kernel, causal,
    H=8, Dh=64, below and at the dispatch threshold."""
    from harp_tpu_torch.ops import pallas_kernels as pk
    from harp_tpu_torch.parallel import ring_attention as ra

    log("[attention:crossover] streamed torch loop (kv_block 512) against "
        "the kernel, causal, H=8, Dh=64, f32")
    res = {}
    for l in ATTN_CROSSOVER:
        q, k, v = attn_inputs((l, 8, 64), 64, seed=l)
        loop = cuda_time_ms(lambda: ra._streamed_attention(q, k, v, True),
                            reps=5, warmup=1)
        kern = cuda_time_ms(lambda: pk.flash_attention_cuda(q, k, v, True),
                            reps=10, warmup=2)
        log(f"  L={l}: loop {loop:.4f} ms, kernel {kern:.4f} ms, kernel "
            f"{loop / kern:.3f}x faster")
        res[str(l)] = {"loop_ms": loop, "kernel_ms": kern}
    return res


def attention_phases():
    """Every flash-attention phase; returns the kernels-line entry of
    flash_attention."""
    flag, d128 = flash_cases()
    blocked = blocked_phase("flagship", flag, ATTN_FLAGSHIP)
    blocked128 = blocked_phase("dh128", d128, ATTN_DH128)
    del d128["out"], d128["inputs"]
    torch.cuda.empty_cache()
    uly = ulysses_phase(flag)
    del flag["out"], flag["inputs"]
    torch.cuda.empty_cache()
    ring = ring_phase()
    torch.cuda.empty_cache()
    cross = crossover_phase()
    log(f"  kernel {flag['ms']:.4f} ms per flagship call against a bound of "
        f"{flag['bound_ms']:.4f} ms ({flag['bound_by']}); blocked "
        f"{blocked['tokens_per_s']:.6g} tokens/s")
    rc, rf = ring["causal"], ring["full"]
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "harp_tpu_torch/csrc/flash_attention.cu",
        "replaces": "harp_tpu/ops/pallas_kernels.py:542",
        "launches": blocked["launches"],
        "max_abs_err": flag["max_abs_err"], "ms": flag["ms"],
        "plain_ms": flag["plain_ms"], "bound_ms": flag["bound_ms"],
        "bound_by": flag["bound_by"], "library_ms": flag["library_ms"],
        "rel_vs_float64": flag["rel_vs_float64"],
        "library_rel_vs_float64": flag["library_rel_vs_float64"],
        "tiles": blocked["tiles"], "tokens_per_s": blocked["tokens_per_s"],
        "dh128_ms": d128["ms"], "dh128_plain_ms": d128["plain_ms"],
        "dh128_bound_ms": d128["bound_ms"], "dh128_bound_by": d128["bound_by"],
        "dh128_library_ms": d128["library_ms"],
        "dh128_max_abs_err": d128["max_abs_err"],
        "dh128_tiles": blocked128["tiles"],
        "dh128_launches": blocked128["launches"],
        "dh128_tokens_per_s": blocked128["tokens_per_s"],
        "ring_causal_launches": rc["launches"], "ring_causal_ms": rc["ms"],
        "ring_causal_plain_ms": rc["plain_ms"],
        "ring_causal_library_ms": rc["library_ms"],
        "ring_causal_bound_ms": rc["bound_ms"],
        "ring_causal_bound_by": rc["bound_by"],
        "ring_causal_rel_vs_float64": rc["rel_vs_float64"],
        "ring_causal_max_abs_err": rc["max_abs_err"],
        "ring_causal_einsum_ms": rc["einsum_ms"],
        "ring_causal_tiles": rc["tiles"],
        "ring_launches": rf["launches"], "ring_ms": rf["ms"],
        "ring_plain_ms": rf["plain_ms"], "ring_library_ms": rf["library_ms"],
        "ring_bound_ms": rf["bound_ms"], "ring_bound_by": rf["bound_by"],
        "ring_rel_vs_float64": rf["rel_vs_float64"],
        "ring_max_abs_err": rf["max_abs_err"],
        "ring_einsum_ms": rf["einsum_ms"],
        "ring_tiles": rf["tiles"],
        "ring_device_busy_share": ring["profile_busy_share"],
        "ulysses_launches": uly["launches"],
        "ulysses_rel_vs_float64": uly["rel_vs_float64"],
        "ulysses_tokens_per_s": uly["tokens_per_s"],
        "ulysses_per_call_ms": uly["per_call_ms"], "ulysses_ms": uly["ms"],
        "ulysses_plain_ms": uly["plain_ms"],
        "ulysses_bound_ms": uly["bound_ms"],
        "ulysses_bound_by": uly["bound_by"],
        "ulysses_library_ms": uly["library_ms"],
        "ulysses_max_abs_err": uly["max_abs_err"],
        "ulysses_tiles": uly["tiles"],
        "crossover": cross,
    }


# --------------------------------------------------------------------------- #
# Ring DMA: the hop and the allgather, stacked and across processes
# --------------------------------------------------------------------------- #

def ringdma_bound(nbytes):
    """Least time to move a payload: read once and written once at the
    card's memory rate (the engine does no arithmetic)."""
    return 2 * nbytes / PEAK_BYTES_S * 1e3


def zero_counts():
    from harp_tpu_torch.ops import pallas_kernels as pk
    from harp_tpu_torch.ops import ring_dma

    for counts in (pk.launches, ring_dma.launches):
        for name in counts:
            counts[name] = 0


def read_counts():
    from harp_tpu_torch.ops import pallas_kernels as pk
    from harp_tpu_torch.ops import ring_dma

    torch.cuda.synchronize()
    return {**pk.launches, **ring_dma.launches}


def ring_inputs(w, seed):
    """The stacked payloads of the ring phases, (W, ...) on the card: the
    SGD-MF flagship's H block (32 x 8192 f32, 1 MiB a worker) and its bf16
    and int32 twins, and a ragged uint8 block of 1 MiB + 6 bytes."""
    gen = torch.Generator(device=CARD).manual_seed(seed)
    f32 = torch.randn((w,) + RING_BLOCK, device=CARD, generator=gen)
    return {
        "f32": f32, "bf16": f32.bfloat16(),
        "int32": torch.randint(-2 ** 31, 2 ** 31 - 1, (w,) + RING_BLOCK,
                               dtype=torch.int32, device=CARD, generator=gen),
        "uint8 (1 MiB + 6 B)": torch.randint(
            0, 256, (w, (1 << 20) + 6), dtype=torch.uint8, device=CARD,
            generator=gen)}


def as_is(sess, fn, *xs, outs=1):
    """``fn`` through ``sess.run`` on stacked tensors passed as they are."""
    rep = sess.replicate()
    return sess.run(fn, *xs, in_specs=(rep,) * len(xs),
                    out_specs=rep if outs == 1 else (rep,) * outs)


def ringdma_stacked():
    """[ringdma:stacked]: W=4 in one process, every result bitwise the
    plain version's; kernel times against the bound and torch.roll."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.ops import ring_dma

    w = RING_W
    sess = HarpSession(num_workers=w)
    g = sess.workers
    cases = ring_inputs(w, seed=11)
    log(f"[ringdma:stacked] W={w}, one process: hop at shifts 1, -1, 3 and "
        f"ring_allgather against their plain versions")
    for name, x in cases.items():
        for shift in (1, -1, 3):
            got = as_is(sess, lambda a: ring_dma.hop(a, shift), x)
            check(torch.equal(got, ring_dma.hop_plain(x, shift, g)),
                  f"hop {name} {tuple(x.shape)}, shift {shift}: bitwise "
                  f"torch.roll")
    tree = (cases["f32"], cases["bf16"], cases["int32"])
    got = as_is(sess, lambda *t: ring_dma.hop_tree(t, 3), *tree, outs=3)
    check(all(torch.equal(a, ring_dma.hop_plain(b, 3, g))
              for a, b in zip(got, tree)),
          "hop_tree of (f32, bf16, int32), shift 3: bitwise")
    for name in ("f32", "uint8 (1 MiB + 6 B)"):
        x = cases[name]
        got = as_is(sess, ring_dma.ring_allgather, x)
        check(torch.equal(got, ring_dma.ring_allgather_plain(x, g)),
              f"ring_allgather {name}: bitwise the plain gather")
    f32 = cases["f32"]
    nbytes = f32.numel() * 4
    hop = {"ms": cuda_time_ms(lambda: ring_dma.hop_cuda(f32, 1, g), 50, 5),
           "plain_ms": cuda_time_ms(
               lambda: ring_dma.hop_plain(f32, 1, g), 50, 5),
           "library_ms": cuda_time_ms(lambda: torch.roll(f32, 1, 0), 50, 5),
           "bound_ms": ringdma_bound(nbytes)}
    small = f32.reshape(w, -1)[:, :1024].contiguous()       # 4 KiB a worker
    hop["ms_4kib"] = cuda_time_ms(
        lambda: ring_dma.hop_cuda(small, 1, g), 200, 10)
    hop["library_ms_4kib"] = cuda_time_ms(
        lambda: torch.roll(small, 1, 0), 200, 10)
    ag = {"ms": cuda_time_ms(lambda: ring_dma.ring_allgather_cuda(f32, g),
                             50, 5),
          "plain_ms": cuda_time_ms(
              lambda: ring_dma.ring_allgather_plain(f32, g), 50, 5),
          "library_ms": cuda_time_ms(lambda: f32.flatten(0, 1).clone(), 50,
                                     5),
          "bound_ms": ringdma_bound(nbytes)}
    # the kernels' own device time (the events above time back-to-back
    # calls, which the host's launch path can hold)
    for tag, fn, name in (
            ("device_ms", lambda: ring_dma.hop_cuda(f32, 1, g), "ring_hop"),
            ("device_ms_4kib", lambda: ring_dma.hop_cuda(small, 1, g),
             "ring_hop"),
            ("ag_device_ms", lambda: ring_dma.ring_allgather_cuda(f32, g),
             "ring_allgather")):
        per, _ = device_profile(lambda: [fn() for _ in range(20)])
        ms = sum(v for k, v in per.items() if k.startswith(name)) / 20
        (ag if tag.startswith("ag_") else hop)[tag.replace("ag_", "")] = (
            ms if per else None)
    log(f"  device time a launch (profiler): hop {hop['device_ms']} ms, "
        f"4 KiB hop {hop['device_ms_4kib']} ms, allgather "
        f"{ag['device_ms']} ms")
    log(f"  hop, 1 MiB a worker: kernel {hop['ms']:.6f} ms, torch.roll "
        f"{hop['library_ms']:.6f} ms, bound {hop['bound_ms']:.6f} ms "
        f"(bytes); 4 KiB a worker: kernel {hop['ms_4kib']:.6f} ms, "
        f"torch.roll {hop['library_ms_4kib']:.6f} ms")
    log(f"  ring_allgather, 1 MiB a worker: kernel {ag['ms']:.6f} ms, "
        f"flatten-and-copy {ag['library_ms']:.6f} ms, bound "
        f"{ag['bound_ms']:.6f} ms (bytes)")
    return hop, ag


def mf_fused_config(**kw):
    from harp_tpu_torch.models import sgd_mf

    f = MF_FLAGSHIP
    return sgd_mf.SGDMFConfig(**{
        "rank": f["rank"], "lam": f["lam"], "lr": f["lr"],
        "epochs": f["epochs"], "minibatches_per_hop": f["nmb"],
        "layout": "dense", **kw})


def mf_fused_data():
    from harp_tpu_torch.io import datagen

    f = MF_FLAGSHIP
    return datagen.sparse_ratings(f["users"], f["items"], rank=f["data_rank"],
                                  density=f["density"], seed=f["seed"])


def pull_factors(sess, out_w, out_h):
    """The trained W and H factor tables pulled to every process with
    ``table_ops.pull(fused=True)``: the ring_allgather kernel's path."""
    from harp_tpu_torch.collectives import table_ops
    from harp_tpu_torch.table import Table

    def pull(blocks):
        t = Table.sharded(blocks, num_workers=sess.workers.num_workers)
        return table_ops.pull(t, fused=True).data

    return [sess.run(pull, t, in_specs=(sess.shard(),),
                     out_specs=sess.replicate()) for t in (out_w, out_h)]


def factor_digest(tables, rmse) -> str:
    """sha256 of the pulled factor tables and of the RMSEs."""
    import hashlib

    h = hashlib.sha256()
    for full in tables:
        h.update(full.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    h.update(np.ascontiguousarray(rmse).tobytes())
    return h.hexdigest()


def mf_rates(model_for, state, nnz):
    """Ratings/s two-point (MF_FUSED_EPOCHS) of ``model_for(epochs)``."""
    from harp_tpu_torch.benchmark import timing

    def build(epochs):
        m = model_for(epochs)
        m.train_prepared(state)
        return lambda: m.train_prepared(state)

    lo, hi = MF_FUSED_EPOCHS
    return timing.two_point(build, lo, hi, float(nnz))


def mf_fused_stacked():
    """[sgd_mf:fused] stacked: the flagship at W=4 with fused_dma=True
    against fused_dma=False, bitwise; one hop launch a rotation step."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.models import sgd_mf

    f = MF_FLAGSHIP
    rows, cols, vals = mf_fused_data()
    sess = HarpSession(num_workers=RING_W)
    cfg = mf_fused_config(fused_dma=True)
    model = sgd_mf.SGDMF(sess, cfg)
    state = model.prepare(rows, cols, vals, f["users"], f["items"], seed=0)
    nnz = model.last_layout_stats["nnz"]
    log(f"[sgd_mf:fused] stacked W={RING_W}: {f['users']}x{f['items']}, "
        f"{f['density']:g}, rank {f['rank']}, {f['nmb']} minibatches a hop, "
        f"{f['epochs']} epochs, dense, nnz={nnz}")
    zero_counts()
    out_w, out_h, rmse = model.train_prepared(state)
    counts = read_counts()
    steps = f["epochs"] * RING_W
    check(counts["ring_dma_hop"] == steps and counts["dense_mf_hop"] == steps,
          f"one ring_dma_hop and one dense_mf_hop launch a rotation step "
          f"({counts['ring_dma_hop']}, {counts['dense_mf_hop']} = {steps})")
    plain = sgd_mf.SGDMF(sess, mf_fused_config(fused_dma=False))
    p_w, p_h, p_rmse = plain.train_prepared(state)
    check(torch.equal(out_w, p_w) and torch.equal(out_h, p_h)
          and np.array_equal(rmse, p_rmse),
          "factors and RMSEs bitwise the fused_dma=False fit")
    check(bool(np.all(np.isfinite(rmse))) and rmse[-1] < rmse[0],
          f"finite, falling RMSEs ({rmse[0]:.5f} -> {rmse[-1]:.5f})")
    digest = factor_digest(pull_factors(sess, out_w, out_h), rmse)
    fused_tp = mf_rates(lambda e: sgd_mf.SGDMF(sess, mf_fused_config(
        fused_dma=True, epochs=e)), state, nnz)
    plain_tp = mf_rates(lambda e: sgd_mf.SGDMF(sess, mf_fused_config(
        fused_dma=False, epochs=e)), state, nnz)
    log(f"  two-point: fused {fused_tp['rate']:.6g} ratings/s "
        f"({fused_tp['per_iter_ms']:.4f} ms an epoch), unfused "
        f"{plain_tp['rate']:.6g} ({plain_tp['per_iter_ms']:.4f} ms)")
    return {"launches": counts, "digest": digest,
            "rmse": [float(r) for r in rmse], "nnz": nnz,
            "ratings_per_s": fused_tp["rate"],
            "per_epoch_ms": fused_tp["per_iter_ms"],
            "unfused_ratings_per_s": plain_tp["rate"],
            "unfused_per_epoch_ms": plain_tp["per_iter_ms"]}


def ring_fused_phase():
    """[attention:ring fused]: ring attention at W=4, L=32768, causal, with
    the (k, v) hops through the ring-DMA kernel, bitwise the unfused ring."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.parallel import ring_attention as ra

    c = ATTN_RING
    sess = HarpSession(num_workers=c["workers"])
    q, k, v = attn_inputs((c["l"], c["h"], c["dh"]), c["dh"], seed=6)
    log(f"[attention:ring fused] W={c['workers']} L={c['l']} H={c['h']} "
        f"Dh={c['dh']} causal, fused_dma=True")

    def ring(fused):
        return sharded(sess, lambda a, b, d: ra.ring_attention_mha(
            a, b, d, True, fused_dma=fused), q, k, v)

    zero_counts()
    out = ring(True)
    counts = read_counts()
    hops = 2 * c["workers"]
    check(counts["ring_dma_hop"] == hops
          and counts["flash_attention"] == c["workers"],
          f"{hops} ring_dma_hop launches a call (k and v, W hops) and "
          f"{c['workers']} flash_attention ({counts['ring_dma_hop']}, "
          f"{counts['flash_attention']})")
    check(torch.equal(out, ring(False)), "bitwise the unfused ring call")
    ms, plain_ms = (cuda_time_ms(lambda: ring(f), reps=3, warmup=1)
                    for f in (True, False))
    log(f"  fused {ms:.4f} ms a call, unfused {plain_ms:.4f} ms")
    return {"launches": counts["ring_dma_hop"], "ms": ms,
            "unfused_ms": plain_ms}


def mp_child() -> int:
    """One process of the [ringdma:mp] gang (4 processes x 1 worker on the
    card, under the port's launcher): hops and allgathers against the gloo
    plain version, the credit test and the fused SGD-MF flagship. Prints
    one ``MP_CHILD {json}`` line."""
    import torch.distributed as dist

    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.models import sgd_mf
    from harp_tpu_torch.ops import ring_dma
    from harp_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    sess = HarpSession(num_workers=RING_W, distributed=True)
    g, rank = sess.workers, sess.workers.rank
    out = {"rank": rank, "sizes": {}}
    gen = torch.Generator(device=CARD)
    call = 0

    def payload(n):
        # random float32, drawn anew for every call from (rank, call): a
        # block from the wrong peer or a stale slot differs everywhere
        nonlocal call
        call += 1
        gen.manual_seed(1_000_003 * call + rank)
        return torch.randn((1, n), device=CARD, generator=gen)

    for nbytes in RING_MP_BYTES:
        n = nbytes // 4
        ok = True
        for shift in (1, -1, 3):
            x = payload(n)
            ok &= torch.equal(ring_dma.hop_cuda(x, shift, g),
                              ring_dma.hop_plain(x, shift, g))
        x = payload(n)
        ok &= torch.equal(ring_dma.ring_allgather_cuda(x, g),
                          ring_dma.ring_allgather_plain(x, g))
        reps = 20 if nbytes <= (1 << 20) else 5
        row = {"bitwise": bool(ok)}
        for name, fn, r in (
                ("hop_ms", lambda: ring_dma.hop_cuda(x, 1, g), reps),
                ("allgather_ms", lambda: ring_dma.ring_allgather_cuda(x, g),
                 reps),
                ("gloo_rotate_ms", lambda: ring_dma.hop_plain(x, 1, g), 3)):
            torch.cuda.synchronize()
            dist.barrier()
            row[name] = cuda_time_ms(fn, reps=r, warmup=1)
        out["sizes"][nbytes] = row
    ring_dma.check_errors()
    # credit test: rank 1 is held back before each hop by a busy kernel of
    # varying length; every hop must still deliver its iteration's block
    x = torch.empty((1, (1 << 20) // 4), device=CARD)
    bad = torch.zeros((), dtype=torch.int64, device=CARD)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for it in range(CREDIT_HOPS):
        if rank == 1:
            torch.cuda._sleep(20_000 * (it % 13))
        x.fill_(rank * 1000 + it)
        got = ring_dma.hop_cuda(x, 1, g)
        bad += (got != ((rank - 1) % RING_W) * 1000 + it).sum()
    torch.cuda.synchronize()
    out["credit_hops"] = CREDIT_HOPS
    out["credit_mismatches"] = int(bad)
    out["credit_s"] = time.perf_counter() - t0
    ring_dma.check_errors()

    # the SGD-MF flagship, 4 processes x 1 worker, fused_dma=True
    f = MF_FLAGSHIP
    rows, cols, vals = mf_fused_data()
    model = sgd_mf.SGDMF(sess, mf_fused_config(fused_dma=True))
    state = model.prepare(rows, cols, vals, f["users"], f["items"], seed=0)
    nnz = model.last_layout_stats["nnz"]
    zero_counts()
    out_w, out_h, rmse = model.train_prepared(state)
    out["launches"] = read_counts()
    zero_counts()
    tables = pull_factors(sess, out_w, out_h)
    out["pull_launches"] = read_counts()
    out["digest"] = factor_digest(tables, rmse)
    out["rmse"] = [float(r) for r in rmse]
    tp = mf_rates(lambda e: sgd_mf.SGDMF(sess, mf_fused_config(
        fused_dma=True, epochs=e)), state, nnz)
    staged = mf_rates(lambda e: sgd_mf.SGDMF(sess, mf_fused_config(
        fused_dma=False, epochs=e)), state, nnz)
    out.update(ratings_per_s=tp["rate"], per_epoch_ms=tp["per_iter_ms"],
               staged_ratings_per_s=staged["rate"],
               staged_per_epoch_ms=staged["per_iter_ms"])
    ring_dma.check_errors()
    distributed.shutdown()
    print("MP_CHILD " + json.dumps(out), flush=True)
    return 0


def ringdma_mp(stacked_mf):
    """[ringdma:mp] and [sgd_mf:fused] across 4 processes on the card,
    through the port's launcher; any child's failure fails the run."""
    from harp_tpu_torch.parallel import launch

    log(f"[ringdma:mp] {RING_W} processes x 1 worker on the card (the "
        f"port's launcher): hop and ring_allgather against the gloo plain "
        f"version at {', '.join(str(b) for b in RING_MP_BYTES)} bytes a "
        f"worker, {CREDIT_HOPS} credit hops, the SGD-MF flagship fused")
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    res = launch.launch(RING_W, [sys.executable, os.path.abspath(__file__),
                                 "--mp-child"], timeout=600, cwd=here)
    wall = time.perf_counter() - t0
    outs = {}
    for i, (rc, text) in enumerate(res):
        line = [ln for ln in text.splitlines() if ln.startswith("MP_CHILD ")]
        if rc != 0 or not line:
            log(text[-6000:])
            check(False, f"process {i} of the gang ran to its end (exit {rc})")
        outs[i] = json.loads(line[-1][len("MP_CHILD "):])
    log(f"  gang wall {wall:.2f} s")
    for nbytes in RING_MP_BYTES:
        rows = [outs[i]["sizes"][str(nbytes)] for i in outs]
        check(all(r["bitwise"] for r in rows),
              f"{nbytes} B a worker: hop (shifts 1, -1, 3) and "
              f"ring_allgather bitwise the gloo plain version on every rank")
        log(f"  {nbytes} B: hop {[round(r['hop_ms'], 6) for r in rows]} ms, "
            f"allgather {[round(r['allgather_ms'], 6) for r in rows]} ms, "
            f"gloo rotate (host-staged) "
            f"{[round(r['gloo_rotate_ms'], 6) for r in rows]} ms (ranks 0-3)")
    check(all(o["credit_mismatches"] == 0 for o in outs.values()),
          f"{CREDIT_HOPS} back-to-back hops with rank 1 held back: every "
          f"hop bitwise on every rank ({[round(o['credit_s'], 3) for o in outs.values()]} s)")
    steps = MF_FLAGSHIP["epochs"] * RING_W
    for i, o in outs.items():
        c, p = o["launches"], o["pull_launches"]
        check(c["ring_dma_hop"] == steps and c["dense_mf_hop"] == steps
              and c["ring_allgather"] == 0,
              f"rank {i}, the fit: {steps} ring_dma_hop and dense_mf_hop "
              f"launches, no ring_allgather ({c['ring_dma_hop']}, "
              f"{c['dense_mf_hop']}, {c['ring_allgather']})")
        check(p["ring_allgather"] == 2 and p["ring_dma_hop"] == 0,
              f"rank {i}, table_ops.pull(fused=True) of W and H: 2 "
              f"ring_allgather launches ({p['ring_allgather']})")
    check(all(o["digest"] == stacked_mf["digest"] for o in outs.values()),
          "SGD-MF fused, 4 processes: factors (pulled through the fused "
          "allgather) and RMSEs bitwise the stacked fit")
    o = outs[0]
    log(f"  SGD-MF 4 processes: fused {o['ratings_per_s']:.6g} ratings/s "
        f"({o['per_epoch_ms']:.4f} ms an epoch), host-staged fused_dma=False "
        f"{o['staged_ratings_per_s']:.6g} ({o['staged_per_epoch_ms']:.4f} ms)")
    return outs


def mp_smoke_phase():
    """[mp_smoke]: parallel/mp_smoke.py as 2 processes x 2 workers."""
    from harp_tpu_torch.parallel import launch

    log("[mp_smoke] 2 processes x 2 workers on the card")
    t0 = time.perf_counter()
    res = launch.launch(2, [sys.executable, "-m",
                            "harp_tpu_torch.parallel.mp_smoke"], 2,
                        timeout=300,
                        cwd=os.path.dirname(os.path.abspath(__file__)))
    for i, (rc, text) in enumerate(res):
        if rc != 0 or f"MP_SMOKE OK p{i}/2" not in text:
            log(text[-6000:])
        check(rc == 0 and f"MP_SMOKE OK p{i}/2" in text,
              f"process {i}: MP_SMOKE OK")
    log(f"  {time.perf_counter() - t0:.2f} s")


def ringdma_phases():
    """Every ring-DMA phase; returns the kernels-line entries of the hop and
    the allgather."""
    from harp_tpu_torch.ops import ring_dma

    hop, ag = ringdma_stacked()
    ring_dma.check_errors()
    torch.cuda.empty_cache()
    mf = mf_fused_stacked()
    ring_dma.check_errors()
    torch.cuda.empty_cache()
    attn = ring_fused_phase()
    ring_dma.check_errors()
    torch.cuda.empty_cache()
    mp = ringdma_mp(mf)          # each child checks after each of its parts
    mp_smoke_phase()
    mb = str(1 << 20)
    return [{
        "name": "ring_dma_hop", "route": "cuda",
        "source": "harp_tpu_torch/csrc/ring_dma.cu",
        "replaces": "harp_tpu/ops/ring_dma.py:224",
        "launches": mf["launches"]["ring_dma_hop"], "max_abs_err": 0.0,
        "ms": hop["ms"], "plain_ms": hop["plain_ms"],
        "bound_ms": hop["bound_ms"], "bound_by": "bytes",
        "library_ms": hop["library_ms"], "ms_4kib": hop["ms_4kib"],
        "library_ms_4kib": hop["library_ms_4kib"],
        "device_ms": hop["device_ms"], "device_ms_4kib": hop["device_ms_4kib"],
        "mp_launches": mp[0]["launches"]["ring_dma_hop"],
        "mp_ms_by_bytes": {b: [mp[i]["sizes"][str(b)]["hop_ms"] for i in mp]
                           for b in RING_MP_BYTES},
        "mp_gloo_rotate_ms_by_bytes": {
            b: [mp[i]["sizes"][str(b)]["gloo_rotate_ms"] for i in mp]
            for b in RING_MP_BYTES},
        "mp_library_ms": None,
        "mp_credit_s": [mp[i]["credit_s"] for i in mp],
        "fit_ratings_per_s": mf["ratings_per_s"],
        "fit_per_epoch_ms": mf["per_epoch_ms"],
        "fit_unfused_ratings_per_s": mf["unfused_ratings_per_s"],
        "mp_fit_ratings_per_s": mp[0]["ratings_per_s"],
        "mp_fit_per_epoch_ms": mp[0]["per_epoch_ms"],
        "mp_fit_staged_ratings_per_s": mp[0]["staged_ratings_per_s"],
        "ring_attention_launches": attn["launches"],
        "ring_attention_fused_ms": attn["ms"],
        "ring_attention_unfused_ms": attn["unfused_ms"],
    }, {
        "name": "ring_allgather", "route": "cuda",
        "source": "harp_tpu_torch/csrc/ring_dma.cu",
        "replaces": "harp_tpu/ops/ring_dma.py:295",
        "launches": mp[0]["pull_launches"]["ring_allgather"],
        "launches_path": "table_ops.pull(fused=True) of the trained W and H "
                         "factor tables, 4 processes x 1 worker",
        "fit_launches": mp[0]["launches"]["ring_allgather"],
        "max_abs_err": 0.0,
        "ms": ag["ms"], "plain_ms": ag["plain_ms"],
        "bound_ms": ag["bound_ms"], "bound_by": "bytes",
        "library_ms": ag["library_ms"], "device_ms": ag["device_ms"],
        "mp_ms_by_bytes": {b: [mp[i]["sizes"][str(b)]["allgather_ms"]
                               for i in mp] for b in RING_MP_BYTES},
        "mp_ms_1mib": mp[0]["sizes"][mb]["allgather_ms"],
        "mp_library_ms": None,
    }]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from harp_tpu_torch.ops import _cuda_build

    # the plain version and the library yardstick multiply in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _cuda_build.build_all()
    log(f"[build] {time.perf_counter() - t0:.2f} s: " + ", ".join(
        f"{k} ({'built' if v['built'] else 'cached'} {v['seconds']:.2f} s)"
        for k, v in built.items()))
    for name, v in built.items():
        for fn, regs, spill in ptxas_usage(v["log"]):
            log(f"  {name}: {fn}: {regs}; {spill}")

    f = FLAGSHIP
    flag = estep_case("flagship", f["n"], f["k"], f["d"], f["k"],
                      torch.float32, timed=True)
    estep_case("ragged", 999_999, f["k"], f["d"], f["k"], torch.float32, False)
    estep_case("valid_k", f["n"], 128, f["d"], f["k"], torch.float32, False)
    estep_case("bf16", f["n"], f["k"], f["d"], f["k"], torch.bfloat16, False)

    fit = flagship_fit()
    log(f"  kernel {flag['ms']:.4f} ms per E-step against a bound of "
        f"{flag['bound_ms']:.4f} ms ({flag['bound_by']}); plain "
        f"{flag['plain_ms']:.4f} ms, library {flag['library_ms']:.4f} ms")
    small_fit_vs_numpy()
    variants_bitwise()
    mf = mf_phases()
    torch.cuda.empty_cache()
    spd = als_phases()
    torch.cuda.empty_cache()
    attn = attention_phases()
    torch.cuda.empty_cache()
    ring = ringdma_phases()
    log(f"[done] {time.perf_counter() - t_start:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    kernels = [{
        "name": "kmeans_stats", "route": "cuda",
        "source": "harp_tpu_torch/csrc/kmeans_stats.cu",
        "replaces": "harp_tpu/ops/pallas_kernels.py:93",
        "launches": fit["launches"]["kmeans_stats"],
        "max_abs_err": flag["max_abs_err"], "ms": flag["ms"],
        "plain_ms": flag["plain_ms"], "bound_ms": flag["bound_ms"],
        "bound_by": flag["bound_by"], "library_ms": flag["library_ms"],
        "near_ties": flag["near_ties"], "count_moves": flag["count_moves"],
        "fit_iters_per_s": fit["iters_per_s"],
        "fit_per_iter_ms": fit["per_iter_ms"],
        "fit_centroid_rel_vs_plain": fit["centroid_rel_vs_plain"],
    }, mf, spd, attn, *ring]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(mp_child() if sys.argv[1:] == ["--mp-child"] else main())
