"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Builds every CUDA kernel of the port from ``harp_tpu_torch/csrc/`` with nvcc
(one nvcc per source, all at once), holds each kernel against its plain
PyTorch version on the card, and drives the main paths with the
launch counters and the dispatchers' plain-call counters
(``plain_on_card``) set to 0 just before each and read just after; every
main path must make no plain call on the card:

  * K-means regroupallgather through ``HarpSession`` and ``KMeans.fit`` at
    the flagship n=1,000,000, k=100, d=100, 10 iterations (the E-step grid
    and the ms an iteration printed beside the reading before the grid
    fix), and the five comm variants bitwise equal; the E-step at the
    flagship (float32 and bf16) and, past one block's shared memory, its
    wide variant at K=400, D=100 and K=1024, D=128 (n=1,048,576) and K=256,
    D=1024 (n=262,144), timed against the library path, the bound (on the
    tensor cores, and on the f32 CUDA cores beside it) and, where
    ``build/parent/kmeans_stats.cu`` holds the parent commit's source, in
    turns against the parent's kernel, with the profiler's split of both;
    and at bf16, a ragged n with phantom rows and the edges (the first K
    past shared memory at D=100, and K=1, D=825); the fit at K=1024,
    D=128 through the model (W=1, in lock step with the plain E-step,
    two-point), its five
    comm variants at W=4 bitwise equal and a stacked launch bitwise its
    per-worker launches;
  * dense SGD-MF rotation through ``SGDMF.prepare``/``fit_prepared`` at the
    flagship 32768 x 32768 ratings, 1%, rank 32, 8 minibatches a hop, 10
    epochs, against the same fit through the plain hop; then the stacked
    W=4 variants (1 and 2 slices, dense and sparse) at 4096 x 4096, 5%;
    the narrow hop's geometry (column tile, cluster, chunk rows, stages,
    clusters the card runs at once), its split by kernel under the profiler
    and, where ``build/parent/dense_mf_hop.cu`` holds the parent commit's
    source, its time in turns against the parent's kernel (flagship, rank
    128, the W=4 send);
    past the narrow kernel's rank 128, the wide hop at rank 256 (timed) and
    a ragged 136 on the flagship's slab and at 1024 on a 4096 x 4096
    corner of it, the flagship fit at rank 256 (W=1, against the plain-hop
    fit) and its fused 1-slice W=4 twin (bitwise the unfused fit);
  * implicit ALS through ``ALS.prepare``/``fit_prepared`` at the flagship
    8192 x 8192, 0.5%, rank 32, 10 iterations (dense layout, two SPD-solve
    launches an iteration), against the same fit through the "cholesky"
    solver; explicit ALS (sparse layout) at the same size, ``run als``, and
    the stacked W=4 variants (dense and sparse, implicit and explicit) at
    2048 x 2048 against the "cholesky" fit and the port's CPU fit, each
    with a float64-solve fit as the yardstick; the flagship's data at rank 64
    with the default ``solver="auto"`` and at 96 and 128 with
    ``solver="pallas"`` (the shared-memory solve, two launches an
    iteration) against the "cholesky" fit. The SPD solve is held against
    its plain version and a float64 solve on the flagship's own normal
    equations and at K = 10 (N odd), 33, 64, 65, 96, 128 and 256 (K = 64,
    96 and 128 timed against cuSOLVER, the plain version and the bound; the
    flagship's also from a CUDA graph, and in turns against the parent
    commit's kernel where ``build/parent/spd_solve.cu`` holds its source);
    ``[spd:sweep]`` at K = 1 to 338 (N = 8192): the routed kernel bitwise
    the global-memory kernel from K = 33 (below, logged), bitwise and timed
    in turns against the parent commit's route where
    ``build/parent/spd_solve.cu`` holds its source (to K = 32 from CUDA
    graphs), beside the global-memory kernel, cuSOLVER, the bound, the
    one-warp kernel's geometry and every geometry of the shared-memory
    kernel; past its limit the global-memory solve
    (panel-blocked) at K = 339 and 384 (N = 8192) and 512 (N = 2048),
    timed, at K = 300 (N = 8192) bitwise the shared-memory solve and timed
    against it, and the flagship's data at rank 384 with solver="pallas"
    against the "cholesky" fit;
  * attention: the flash kernel against its plain version and a float64
    reference on sampled query rows, and its KV tiles against the
    trapezoid of its tiles, at the flagship (causal L=16384, H=8, Dh=64,
    f32), at H=4, Dh=128, ragged L=8209, Dv=96, not causal at L=16384
    (Dh=64 and 128), bf16 and a stacked W=4 input (the ring's hop shape,
    causal and not; bf16 and the hop shape timed too);
    ``blocked_attention`` at both flagship shapes (one launch a
    call, tokens/s two-point), ``ring_attention_mha`` on 4 workers at
    L=32768 causal and not, ``fused_dma=False`` (4 launches a call) and
    ``ulysses_attention``
    on 4 workers at L=16384 (one stacked launch a call), held against
    blocked attention and the float64 reference; the streamed torch loop
    against the kernel at L = 2048, 4096 and 8192; heads past 128 (the
    wide variant): Dh = Dv = 256 and MLA's 192 / 128 at causal L=16384,
    H=4 (timed), 192 / 128 in bf16 at a ragged L, 512 at L=8192, and at
    Dh = 256 ``blocked_attention`` and a fused causal W=4 ring at L=32768
    (bitwise the unfused ring);
  * ring DMA: the hop (shifts 1, -1, 3; f32, bf16, int32 and a ragged
    uint8 block), ``hop_tree`` and ``ring_allgather`` on 4 stacked workers
    against their plain versions; the SGD-MF flagship at W=4 with
    ``fused_dma=True``, bitwise the unfused fit: on one slice through the
    hop kernel's in-kernel send (no ring-DMA hop), on two slices through
    one ring-DMA hop a micro-step; the in-kernel sends alone against the
    pairs they replace (``[mfhop:ring]`` at the flagship's W=4 hop shape,
    ``[flash:ring]`` at the ring's hop shape), bitwise and timed; ring
    attention fused (the flash kernel's in-kernel send); then, through the
    port's launcher, 4 processes on the card (``chip_smoke.py
    --mp-child``): hop and allgather between processes against the gloo
    plain version, 200 hops and 200 dense-MF sends with one rank held
    back, the fused causal ring attention call and the fused SGD-MF
    flagship bitwise the stacked ones, the factors pulled with
    ``table_ops.pull(fused=True)`` (the allgather kernel's path; the fit
    itself launches no allgather), and K-means at n = 1,048,576 (262,144 a
    worker), k = 100, d = 100, 5 iterations, and at k = 1024, d = 128, 3
    iterations (the wide variant), whose centroids, counts and costs are
    bitwise the stacked W=4 fits; and ``parallel/mp_smoke.py`` as 2
    processes x 2 workers;
  * the quantized wire format, mini-batch NN and the gradient solvers (no
    TPU kernel on the NN and solver paths: float32 ``torch.matmul``, TF32
    off): ``[codecs]``, the int8 and bf16 codes on the card bitwise the
    CPU's (a ragged n with an all-zero block, exact .5 ties, stacked rows,
    the packed-row round trip, an int8 allreduce with residual);
    ``[nn]``, bench.py's NN row (n = 65,536, d = 128, 256 x 128, batch
    512) at W=1, samples/s two-point, the first epochs held against the
    port's CPU fit within 1e-4 of the largest entry with the caller's
    TF32 on (the same fit with TF32 GEMMs must miss it), and a W=4 stacked
    twin; ``[nn:compute]`` (d = 512, 2048 x 1024, batch 8192), the median
    of three readings against its float32 bound; ``[solver]``, the five solvers at n =
    262,144, d = 256, iterations/s two-point, theta against a float64 run;
    ``[kmeans:quant]``, ``[kmeans:stacked]``'s fit in four variants x int8
    and bf16 within the JAX test's bounds of the float32 fit, one E-step
    launch an iteration; ``[sgd_mf:quant]``, the fused-asked flagship at
    W=4 on 1 and 2 slices with both codecs, RMSEs within 0.02 of the
    float32 fit, the float32 fit's hop launches and no send; in the
    4-process gang the int8 K-means fit, an NN fit at n = 16,384 and an
    int8 allreduce with residual, bitwise the stacked runs;
  * checkpoints, the device reshard and LDA (no new kernel): ``[ckpt]``,
    the SGD-MF flagship at W=4 stacked (1 slice, fused) stopped after 4
    epochs (save_every=2) and resumed in a fresh model to 6, bitwise the
    uninterrupted checkpointed fit (8 dense-MF hop launches with their
    sends), its W=4 directory restored at W=2 through the device, ring and
    host reshards (bitwise each other, every referenced row the saved one),
    and the K-means flagship (10 iterations, save_every=5) resumed from 5
    bitwise; save and restore ms; ``[reshard]``, the JAX package's reshard
    row (262,144 x 64 float32, W 4 -> 8, 1 MiB rounds): all_to_all and ring
    schedules and the host oracle, bitwise each other, with their rounds and
    largest round; ``[lda]``, bench.py's LDA rows at W=1 (262,144 tokens, K =
    32; the clueweb regime, 2,097,152 tokens, K = 64, flat and with
    vocab_sub_block=128), tokens/s two-point (2 vs 8 epochs), rising
    log-likelihoods, the counts against z, the threefry uniforms and one CGS
    epoch bitwise the CPU port's, CVB0 within 1e-5 of it; ``[lda:fused]``,
    the clueweb regime at W=4 stacked, fused_dma bitwise unfused on 1 and 2
    slices (one ring_dma_hop launch a rotation step), int8 quant_wt (no
    hop), a checkpoint resumed at W=2 (device against the host oracle), and
    in the 4-process gang the fused fit at a quarter of the documents,
    bitwise the stacked fit;
  * host IO and streamed K-means (no new kernel: the E-step on a new
    path): ``[ingest]``, ``benchmark/ingest.bench_ingest`` at the JAX
    package's row (about 1 GB of CSV in 16 part-files, 888,880 rows x 128,
    k = 64, 65,536-row chunks, W = 1) with every part parsed by the native
    loader built from ``native/loader.cpp``: load MB/s, the serialized and
    overlapped minibatch twins (bitwise each other), the stream->fit wall
    with one E-step launch an iteration; on the same files
    ``KMeans.fit_from_stream`` bitwise ``fit`` on ``load_dense_csv``
    (float32 and bf16), the distributed COO->CSR at W = 4 bitwise the host
    oracle, ``run kmeans --stream`` in this process, and in the 4-process
    gang a streamed fit bitwise the stacked one;
  * telemetry on the host event plane (no new kernel: the E-step and the
    dense-MF hop with its send on telemetry's paths): ``[telemetry]``, the
    K-means flagship through ``fit_checkpointed`` (save_every = 2) with
    telemetry off and on, bitwise, with the same launches and the same
    synchronizing calls (``torch.cuda.set_sync_debug_mode("warn")``), an
    event an iteration with the fit's cost and the port's price row times
    ``comm_scale``; a 2-boundary profiler window opened by the trigger
    file, whose trace names the E-step kernel; the exporter's ``/metrics``
    with the run's comm gauges; ``run kmeans --telemetry-dir`` on the card.
    In ``[ckpt]`` the uninterrupted fused W=4 SGD-MF fit runs with
    telemetry on (an event an epoch with its RMSE); in the 4-process gang a
    collective event from rank 0 reaches every rank,
    ``send_event(dest=...)`` raises until the P2P transport is ported, the
    straggler report from scripted step walls flags rank 1 only, and an
    events-triggered profiler window leaves a trace under each rank's
    directory;
  * dispatch: the plain-call counts of every main path (all 0); one call
    where the JAX package takes XLA (K-means on float16 points; attention
    at L=4096): no launch, one plain call, the plain version's answer; and
    one call at a width past the narrow kernels (K-means K=400, D=100;
    dense-MF K=192; flash Dh=192 at L=8192): one launch of the wide kernel,
    no plain call, the plain version's answer within the kernel's
    tolerance.

It prints:

  * the card's name and power limit (nvidia-smi);
  * a ``{"kernels": [...]}`` line: per kernel (the E-step's wide variant
    and the SPD solve's three variants apart) its launches on its path, its error against the plain
    version, its time, the plain version's time, the bound for the same
    work and a PyTorch yardstick's time; the dense-MF and flash rows also
    a ``ring_hop`` record (the in-kernel send: its launches on its path,
    stacked and in a process of the 4-process gang with that process's
    receive launches, its ms, the ms of the pair it replaces and its
    bound);
  * last, ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero. It imports nothing of
JAX. Without CUDA, or without the port beside it, it fails before printing a
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import statistics
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
# the flagship's K-means at 4 workers: n = 1,048,576 (262,144 a worker, 4096
# tiles, above the E-step's grid), k = 100, d = 100, regroupallgather, 5
# iterations; 4 processes x 1 worker against the stacked W=4 fit
KMEANS_MP = dict(n=1 << 20, k=100, d=100, iterations=5, seed=21)
# the E-step's time an iteration at the W=1 flagship before the grid stopped
# depending on W (PERF.md, H100 80GB HBM3, 700 W): printed beside this run's
KMEANS_FLAGSHIP_MS_BEFORE = 0.9202
# the E-step past one block's shared memory (the wide variant), timed: the
# flagship's width with four times the centroids, a codebook (vector
# quantisation, IVF coarse quantisers over SIFT) and past D = 824, on points
# drawn on the card by the flagship's recipe (card_points); the fit
# through the model at the codebook shape, W=1, two-point at 2 vs 6
# iterations, its five comm variants at W=4 on 65,536 of its points, and as
# 4 processes x 1 worker (3 iterations) against the stacked W=4 fit
ESTEP_WIDE = (("k400", 1 << 20, 400, 100), ("k1024", 1 << 20, 1024, 128),
              ("d1024", 262_144, 256, 1024))
KMEANS_WIDE = dict(n=1 << 20, k=1024, d=128, iterations=5, epochs=(2, 6),
                   variants_n=65_536)
KMEANS_WIDE_MP = dict(n=1 << 20, k=1024, d=128, iterations=3, seed=31,
                      on_card=True)
# SPD solve past K = 64 (the shared-memory kernel): timed at the ALS
# flagship's 8192 systems; fits on its data at these ranks, with the solver
# each takes (rank 64: the default "auto", the route ALS takes there)
SPD_WIDE = (96, 128)
ALS_WIDE = {64: "auto", 96: "pallas", 128: "pallas"}
ALS_WIDE_ITERATIONS = 5
# [spd:sweep]: N systems at each K, through the route the wrapper takes
# (the one-warp kernel to K = 32: its lanes-a-system edges 8 | 9 and 16 | 17
# and the ALS default rank 10)
SPD_SWEEP = dict(ks=(1, 8, 10, 16, 17, 24, 31, 32, 33, 48, 64, 65, 96, 128,
                     192, 256, 338), n=8192)
# The parent commit's sources, each timed in turns against this tree's
# kernel where it is present (git show <parent>:harp_tpu_torch/csrc/<name>.cu
# > build/parent/<name>.cu); a checkout without one times this tree's
# kernel alone
PARENT_DIR = os.path.join("build", "parent")
PARENT_SOURCES = ("dense_mf_hop", "spd_solve", "kmeans_stats")
# warmed launches of one hop under the profiler for its kernel split
MF_SPLIT_REPS = 5
# the widths past the narrow kernels: the dense-MF hop at ranks 256, 512
# and 1024 (each timed) and a ragged 136 on the SGD-MF flagship's data (and
# 1024, the top of the range, on a 4096 x 4096 corner of it), the flagship
# fit at rank 256, W=1 two-point at 2 vs 6 epochs, and its fused 1-slice W=4
# twin for 2 epochs, stacked and as 4 processes x 1 worker
MF_WIDE = dict(rank=256, timed=(256, 512, 1024), ragged=136, top=1024,
               top_rows=4096, epochs=(2, 6), fused_epochs=2)
# flash heads past 128: Gemma's 256 at causal L=16384, H=4 (timed, and
# through blocked_attention and a fused W=4 ring at L=32768), DeepSeek-V2/V3
# MLA's query/key 192 with value 128 (timed; and bf16 at a ragged L), and
# 512 at L=8192, the top of the checked range
ATTN_WIDE = dict(l=16384, h=4, dh=256, ring_l=32768, mla=(192, 128),
                 ragged_l=8209, top=512, top_l=8192, top_h=2)
# the SPD solve past K = 307 (the global-memory kernel): N systems at each
# K, timed (the plain version by its one checked call); ALS on the implicit
# flagship's data at rank 384 with solver="pallas", 2 iterations
SPD_GLOBAL = {339: 8192, 384: 8192, 512: 2048}
ALS_GLOBAL = dict(rank=384, iterations=2)
# a K both the shared-memory and the global-memory solve take: N systems,
# the two bitwise equal and timed against each other
SPD_BOTH = dict(k=300, n=8192)


# the statistics path (no TPU kernel on it: float32 torch.matmul and
# torch.linalg), at the JAX bench's full sizes, f32, one card. [stats:pca]:
# PCA(method="cor") on bench.py:1368's dense_points(262144, 256, seed=2),
# W=1, two-point fits/s from fit_repeated at 2 vs 8 repeats, and checked on
# it and on a copy with 8 strong directions (spikes: their correlation
# eigenvalues lie far apart, so the component check has components to
# check); the 4-process twin at n = 65,536
STATS_PCA = dict(n=262_144, d=256, seed=2, repeats=(2, 8),
                 spikes=(1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0),
                 mp_n=65_536, mp_seed=4)
# [stats:suite]: every `run stats` op on run stats' dense_points data at n =
# 2^20, D = 64, W = 4; the outlier threshold near the median distance of
# 64-dimensional uniform data (at run stats' 3.0 every row is flagged)
STATS_SUITE = dict(n=1 << 20, d=64, workers=4, seed=0,
                   qs=(0.0, 0.001, 0.25, 0.5, 0.75, 0.999, 1.0),
                   outlier_threshold=8.0)
# [stats:csr]: bench.py:1525 (CSR covariance, seed 23) and :1326 (CSR
# K-means, seed 11, k = 100): n = 262,144, D = 256, 5% dense; passes/s
# two-point at 4 vs 24 passes, iterations/s at 2 vs 10 iterations
STATS_CSR = dict(n=262_144, d=256, density=0.05, cov_seed=23, km_seed=11,
                 k=100, iterations=10, passes=(4, 24), iters=(2, 10))
# [collectives:keyed]: group_by_key_sharded at W = 4 stacked, 2^22 records
# a worker, keys in [0, 2^20), values (., 8) f32 small integers (every sum
# exact), a uniform and a Zipf (s = 1.1) key draw at the default capacity;
# the 4-process twin at 2^18 records a worker
KEYED = dict(workers=4, n=1 << 22, keys=1 << 20, feat=8, zipf=1.1, seed=41,
             mp_n=1 << 18)
# [nn]: bench.py:1413-1416's row (tpu_nn): classification_data(65536, 128,
# 16 classes, seed=4), layers 256 x 128, lr 0.05, batch 512, W=1;
# samples/s two-point at 1 vs 3 epochs (an epoch is host-bound, about half
# a second), the first 2 epochs held against the port's CPU fit within
# `tol` of the largest entry (the card's float32 fit lay 1.0e-6 and 8e-8
# from it on an H100; a float64 fit is no yardstick here: a rounding of
# float32 against float64 flips a ReLU at the third step and the two fits
# part by 2.4%); a W=4 stacked twin; the 4-process twin at n = 16,384
NN = dict(n=65_536, d=128, layers=(256, 128), classes=16, lr=0.05,
          batch=512, epochs=(1, 3), check_epochs=2, tol=1e-4, workers=4,
          mp_n=16_384, seed=4)
# [nn:compute]: bench.py:1435's compute-bound row: d = 512, layers 2048 x
# 1024, batch 8192 (1.24 TFLOP an epoch)
NN_COMPUTE = dict(n=65_536, d=512, layers=(2048, 1024), batch=8192)
# [solver]: the five solvers on regression_data at the PCA flagship's shape
# (n = 262,144, d = 256, f32: 256 MiB of x), 100 iterations (sgd_minibatch
# 16,384 rows a batch), iterations/s two-point at 20 vs 100, theta against a
# float64 run on the card
SOLVER = dict(n=262_144, d=256, seed=0, iterations=(20, 100),
              batch=16_384, kinds=("sgd", "sgd_minibatch", "sgd_momentum",
                                   "adagrad", "lbfgs"))
# [kmeans:quant]: [kmeans:stacked]'s data and shape (KMEANS_MP) in four
# variants x int8 and bf16 against the float32 fit, held to the JAX test's
# bounds from a start of one point of each generated cluster (the test's
# premise: no near ties between centroids sharing a cluster); from
# [kmeans:stacked]'s own start (43 of the 100 clusters without a starting
# centroid) the deviation is recorded; its int8 regroupallgather fit is the
# 4-process twin's stacked side
KMEANS_QUANT = dict(KMEANS_MP, quant="int8",
                    variants=("regroupallgather", "allreduce", "pushpull",
                              "rotation"),
                    bounds={"int8": (0.2, 1e-2), "bf16": (0.05, 1e-3)})
# the quantized allreduce's 4-process twin: a (4, 4099) float32 payload and
# residual from this seed
QUANT_AR = dict(n=4099, seed=51)
# checkpoints: the SGD-MF flagship at W=4 stacked (1 slice, fused), 4 epochs
# with save_every=2, resumed to 6 in a fresh model, then the W=4 directory
# restored at W=2 through each reshard mode; the K-means flagship, 10
# iterations with save_every=5, resumed from 5
CKPT = dict(mf_epochs=(4, 6), mf_save_every=2, restore_world=2,
            km_iterations=10, km_save_every=5, km_seed=61)
# the JAX package's reshard row (harp_tpu/benchmark/reshard_bench.py:31-32):
# 262,144 rows x rank 64 float32, W 4 -> 8, 1 MiB rounds
RESHARD = dict(rows=262_144, rank=64, old_world=4, new_world=8,
               chunk_bytes=1 << 20, reps=3)
# bench.py's LDA rows (bench.py:1378-1381 and 1395-1410): lda_corpus(...,
# seed=3), prepare(seed=1), tokens/s two-point over 2 vs 8 epochs; the
# clueweb regime flat and with vocab_sub_block=128; the fused W=4 fits at
# the clueweb regime, 2 epochs each, and their 4-process twin at n/4 docs
# (the clueweb rows are device-bound, their two rounds of the pair spread
# 0.1-0.4%: one round; the host-bound bench row spread 5-26% over three:
# five, 0.4 s each)
LDA_ROWS = (("bench", dict(docs=2048, vocab=2000, doc_len=128, topics=32,
                           reps=5)),
            ("clueweb", dict(docs=8192, vocab=8000, doc_len=256, topics=64,
                             reps=1)),
            ("clueweb_subblock", dict(docs=8192, vocab=8000, doc_len=256,
                                      topics=64, vocab_sub_block=128,
                                      reps=1)))
LDA_EPOCHS = (2, 8)
LDA_FUSED = dict(docs=8192, vocab=8000, doc_len=256, topics=64, epochs=2,
                 workers=4, mp_docs=2048, restore_world=2)
# [ingest]: the JAX package's ingest bench row (harp_tpu/benchmark/
# ingest.py:49-57), ~1 GB of %.6f CSV in 16 part-files, d = 128, k = 64,
# 65,536-row chunks, W = 1; a small part-file set for ``run kmeans
# --stream``; and the streamed fit of [ringdma:mp] (4 processes x 1 worker
# against the stacked W = 4 fit; each process writes its own copy)
INGEST = dict(total_mb=1024, d=128, k=64, parts=16, chunk_rows=65536,
              fit_iters=2, num_threads=4, queue_depth=4, coo_nnz=200_000,
              coo_rows=8192, coo_cols=4096, coo_seed=420, coo_workers=4)
INGEST_CLI = dict(parts=3, rows=4000, d=16, k=8, chunk_rows=1500,
                  iterations=3)
INGEST_MP = dict(parts=4, rows=16_384, d=32, k=16, chunk_rows=8192,
                 iterations=3, seed=61)
# [telemetry]: the K-means flagship (W = 1, regroupallgather, 10
# iterations) through fit_checkpointed at save_every = 2, telemetry off and
# on; a 2-boundary profiler window opened by the trigger file; `run kmeans
# --telemetry-dir` at 65,536 points of the flagship's width, 4 iterations
TELEMETRY = dict(FLAGSHIP, save_every=2, seed=71, window=2, cli_n=65_536,
                 cli_iterations=4)
# the card's name and power limit (nvidia-smi), printed beside every number
# of the statistics phases
CARD_NAME = ""
# W -> (prepared 1-slice state, nnz) of the SGD-MF flagship, handed from
# [ckpt] to [sgd_mf:fused] (prepare lays out 4 GiB of dense blocks on the
# host: seconds)
MF_FUSED_STATE = {}


# (seconds, tag) at the first line of each phase, for the phase times
PHASES = []


def log(msg: str) -> None:
    if msg.startswith("["):
        PHASES.append((time.perf_counter(), msg.split("]")[0] + "]"))
    print(msg, flush=True)


def phase_seconds():
    """Seconds from each phase's first line to the next phase's, longest
    first (a tag seen twice adds up)."""
    out = {}
    for (t0, tag), (t1, _) in zip(PHASES, PHASES[1:]):
        out[tag] = out.get(tag, 0.0) + t1 - t0
    return sorted(out.items(), key=lambda kv: -kv[1])


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    log(f"  ok: {what}")


# main path -> the plain calls its dispatchers made on the card, read just
# after the path ran (every one must be 0: the [dispatch] summary)
PLAIN_SEEN = {}


def zero_counts():
    """Every kernel launch count and every plain-call count set to 0."""
    from harp_tpu_torch.ops import pallas_kernels as pk
    from harp_tpu_torch.ops import ring_dma

    for counts in (pk.launches, ring_dma.launches, pk.plain_on_card):
        for name in counts:
            counts[name] = 0


def read_counts():
    """The kernel launch counts since :func:`zero_counts`."""
    from harp_tpu_torch.ops import pallas_kernels as pk
    from harp_tpu_torch.ops import ring_dma

    torch.cuda.synchronize()
    return {**pk.launches, **ring_dma.launches}


def plain_counts():
    """The calls each dispatcher sent to the plain version on the card since
    :func:`zero_counts`."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    return dict(pk.plain_on_card)


def check_no_plain(path, plain=None):
    """The main path just run went through its kernels only: no dispatcher
    took the plain version on the card."""
    plain = plain_counts() if plain is None else plain
    PLAIN_SEEN[path] = plain
    check(not any(plain.values()), f"{path}: plain_on_card is 0 for every "
          f"dispatcher ({plain})")


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


def graph_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """CUDA-event ms a call of ``fn`` replayed from one CUDA graph of
    ``reps`` calls: the device's time a call back to back, without the
    host's time a call (a solve of a few microseconds is shorter than its
    wrapper's host path, so eager calls would time the host). ``fn``'s
    launch counts add up at capture, once a call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int, rounds: int = 3) -> float:
    """Median over ``rounds`` of the host µs a call of ``fn`` (perf_counter
    over ``reps`` calls, no device sync inside the loop)."""
    for _ in range(min(reps, 200)):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return statistics.median(out)


def spmd_loop_us(sess, fn, x, reps: int) -> float:
    """Host µs a call of ``fn(x)`` made ``reps`` times inside one
    ``HarpSession.spmd`` call (the group bound, as a rotation runs)."""
    def loop(a):
        y = None
        for _ in range(reps):
            y = fn(a)
        return y

    rep = sess.replicate()
    sess.run(loop, x, in_specs=(rep,), out_specs=rep)      # warm-up
    torch.cuda.synchronize()
    out = []
    for _ in range(3):
        t0 = time.perf_counter()
        sess.run(loop, x, in_specs=(rep,), out_specs=rep)
        out.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return statistics.median(out)


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
    written once, against the operations: the cross term on the tensor
    cores at float32 accuracy, as ``flash_bound`` prices its products
    (float32 points three TF32 passes, bf16 points one bf16 pass against
    bf16-rounded centroids), the norms and sums on the float32 CUDA
    cores."""
    moved = n * d * x_bytes + k * d * 4 + (k * d + k + 1) * 4
    gemm = 2 * n * valid_k * d
    t_ops = ((3 * gemm / PEAK_TF32_FLOPS if x_bytes == 4
              else gemm / PEAK_BF16_FLOPS) + 3 * n * d / PEAK_F32_FLOPS)
    t_bytes = moved / PEAK_BYTES_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def estep_bound_cuda_cores(n, k, valid_k, d, x_bytes):
    """The bound of the E-step's float32 CUDA-core kernels: every
    operation on the float32 CUDA cores (67 TFLOP/s), against the same
    bytes; printed beside ``estep_bound`` for continuity."""
    moved = n * d * x_bytes + k * d * 4 + (k * d + k + 1) * 4
    return max(moved / PEAK_BYTES_S,
               (2 * n * valid_k * d + 3 * n * d) / PEAK_F32_FLOPS) * 1e3


def near_ties(x, c, valid_k):
    from harp_tpu_torch.ops import distance

    if valid_k < 2:
        return 0                  # one centroid: no second score
    cdtype = None if x.dtype == torch.float32 else x.dtype
    s = distance.pairwise_scores(x, c, cdtype)[:, :valid_k]
    top2 = torch.topk(s, 2, dim=1, largest=False).values
    return int(((top2[:, 1] - top2[:, 0])
                <= TIE_EPS * s.abs().amax(dim=1)).sum())


def card_points(n, d, k, seed):
    """``datagen.dense_points``' recipe drawn on the card (k uniform
    centres, spread 0.1) from a seeded generator, so every process of a
    gang draws the same points, and k of the points as initial
    centroids."""
    g = torch.Generator(device=CARD).manual_seed(seed)
    centers = torch.rand(k, d, device=CARD, generator=g)
    assign = torch.randint(k, (n,), device=CARD, generator=g)
    pts = centers[assign] + 0.1 * torch.randn(n, d, device=CARD, generator=g)
    pick = torch.randperm(n, device=CARD, generator=g)[:k]
    return pts, pts[pick].contiguous()


def estep_case(name, n, k, d, valid_k, dtype, timed, data=None):
    """One E-step shape, kernel against plain (``data``: float32 points and
    valid_k initial centroids on the card, else drawn on the host). Past one
    block's shared memory the wrapper must take the wide variant; there the
    plain version is timed over 3 calls after one warm-up."""
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.ops import pallas_kernels as pk

    log(f"[estep:{name}] n={n} k={k} valid_k={valid_k} d={d} "
        f"x={str(dtype).split('.')[-1]}")
    if data is None:
        pts = datagen.dense_points(n, d, seed=11, num_clusters=valid_k)
        data = (torch.from_numpy(pts).cuda(), torch.from_numpy(
            datagen.initial_centroids(pts, valid_k, seed=12)).cuda())
    x = data[0].to(dtype)
    c = torch.zeros(k, d, device="cuda")
    c[:valid_k] = data[1]
    wide = pk.kmeans_smem_bytes(d, k) > pk.MAX_SMEM_BYTES
    before = pk.launches["kmeans_stats_wide"]
    sums, counts, cost = pk.kmeans_stats_cuda(x, c, valid_k)
    torch.cuda.synchronize()
    check(pk.launches["kmeans_stats_wide"] - before == int(wide),
          f"the {'wide' if wide else 'narrow'} kernel ran")
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
        kernel = lambda: pk.kmeans_stats_cuda(x, c, valid_k)  # noqa: E731
        plib = parent_lib("kmeans_stats")
        if plib is None:
            out["ms"], out["parent_ms"] = cuda_time_ms(kernel), None
        else:
            p_out = parent_estep(plib, x, c, valid_k)
            torch.cuda.synchronize()
            p_moved = float((p_out[1] - pc).abs().sum())
            check(p_moved <= 2 * ties, f"the parent's counts equal the "
                  f"plain version's up to near ties ({p_moved:.0f})")
            out["parent_ms"], out["ms"] = in_turns(
                lambda: parent_estep(plib, x, c, valid_k), kernel, 20)
            check(out["ms"] <= out["parent_ms"], f"no slower than the "
                  f"parent's kernel ({out['ms']:.4f} against "
                  f"{out['parent_ms']:.4f} ms, in turns)")
        out["plain_ms"] = cuda_time_ms(
            lambda: pk.kmeans_stats_plain(x, c, valid_k),
            reps=3 if wide else 20, warmup=1 if wide else 3)
        out["library_ms"] = cuda_time_ms(lambda: library_estep(x, c, valid_k))
        out["bound_ms"], out["bound_by"] = estep_bound(
            n, k, valid_k, d, x.element_size())
        out["bound_cuda_cores_ms"] = estep_bound_cuda_cores(
            n, k, valid_k, d, x.element_size())
        log(f"  kernel {out['ms']:.4f} ms (parent in turns "
            f"{out['parent_ms']}), plain {out['plain_ms']:.4f} ms, library "
            f"{out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
            f"({out['bound_by']}; on the f32 CUDA cores "
            f"{out['bound_cuda_cores_ms']:.4f} ms)")
        out["split_ms"], _ = device_profile(kernel)
        log(f"  under the profiler: {out['split_ms']}")
        if plib is not None:
            out["parent_split_ms"], _ = device_profile(
                lambda: parent_estep(plib, x, c, valid_k))
            log(f"  the parent under the profiler (names profiled twice "
                f"may read low): {out['parent_split_ms']}")
    return out


PARENT_GRID = {}


def parent_estep(lib, x, c, valid_k):
    """One E-step through the parent's kernel with its wrapper's buffers:
    the narrow kernel's (W, G, K, D+2) partials, or past its shared memory
    the wide variant's norms, assignments, distances and slabs."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    x3 = x if x.dim() == 3 else x.unsqueeze(0)
    w, n, d = x3.shape
    k = c.shape[-2]
    bf16, per = int(x.dtype == torch.bfloat16), int(c.dim() == 3)
    new = lambda *s: torch.empty(s, dtype=torch.float32,  # noqa: E731
                                 device=x.device)
    sums, counts, cost = new(w, k, d), new(w, k), new(w)
    stream = torch.cuda.current_stream().cuda_stream
    wide = lib.kmeans_stats_smem_bytes(d, k) > pk.MAX_SMEM_BYTES
    key = (n, d, k, valid_k, bf16)
    if key not in PARENT_GRID:
        PARENT_GRID[key] = (lib.kmeans_stats_wide_grid(n, d, k) if wide else
                            lib.kmeans_stats_grid(n, d, k, valid_k, bf16))
    g = PARENT_GRID[key]
    ws = new(w, g, k, d + 2)
    if wide:
        norms = new((w if per else 1) * k)
        asg = torch.empty((w, n), dtype=torch.int32, device=x.device)
        err = lib.kmeans_stats_wide_launch(
            x3.data_ptr(), c.data_ptr(), norms.data_ptr(), asg.data_ptr(),
            new(w, n).data_ptr(), ws.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), cost.data_ptr(), w, n, d, k, valid_k, per, g,
            bf16, stream)
    else:
        err = lib.kmeans_stats_launch(
            x3.data_ptr(), c.data_ptr(), ws.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), cost.data_ptr(), w, n, d, k, valid_k, per, g,
            bf16, stream)
    if err:
        raise RuntimeError(f"the parent's kmeans_stats launch: CUDA {err}")
    return sums, counts, cost


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
    zero_counts()
    t0 = time.perf_counter()
    cen, costs = model.fit(pts, cen0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pk.launches)
    check_no_plain("[fit]")
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
    grid = pk._kmeans_lib().kmeans_stats_grid(f["n"], f["d"], f["k"], f["k"],
                                              0)
    rise = tp["per_iter_ms"] / KMEANS_FLAGSHIP_MS_BEFORE - 1
    log(f"  E-step grid {grid} blocks a worker, whatever W; "
        f"{tp['per_iter_ms']:.4f} ms an iteration against "
        f"{KMEANS_FLAGSHIP_MS_BEFORE} ms before the grid fix (PERF.md, H100 "
        f"80GB HBM3, 700 W): {100 * rise:+.2f}% (not a claim; above +5% "
        f"would say the fix moved the W=1 grid)")
    return {"launches": launches, "iters_per_s": tp["rate"],
            "per_iter_ms": tp["per_iter_ms"], "centroid_rel_vs_plain": rel,
            "grid": grid}


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
# K-means past one block's shared memory: the wide variant
# --------------------------------------------------------------------------- #

def estep_wide_phases():
    """[estep:wide:*]: the timed shapes, then bf16 at the codebook shape,
    a ragged N with phantom rows and the two edges (the first K past
    shared memory at D = 100, one centroid at D = 825), all on points
    drawn on the card. Returns the timed cases' results and the codebook's
    points and initial centroids."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    out, keep = {}, None
    for name, n, k, d in ESTEP_WIDE:
        data = card_points(n, d, k, seed=11)
        out[name] = estep_case(f"wide:{name}", n, k, d, k, torch.float32,
                               timed=True, data=data)
        if (n, k, d) == (KMEANS_WIDE["n"], KMEANS_WIDE["k"], KMEANS_WIDE["d"]):
            keep = data
            estep_case(f"wide:{name}:bf16", n, k, d, k, torch.bfloat16,
                       timed=False, data=data)
        del data
    edge = next(k for k in range(1, 1025)
                if pk.kmeans_smem_bytes(100, k) > pk.MAX_SMEM_BYTES)
    for name, n, k, d, valid_k in (("ragged", 65_537, 408, 100, 400),
                                   (f"k{edge}", 1 << 20, edge, 100, edge),
                                   ("d825", 65_536, 1, 825, 1)):
        estep_case(f"wide:{name}", n, k, d, valid_k, torch.float32, False,
                   data=card_points(n, d, valid_k, seed=13))
    return out, keep


def kmeans_wide_phase(data):
    """[kmeans:wide]: the K-means fit through the model at the codebook
    shape (W=1), in lock step with the plain E-step, two-point; the five
    comm variants at W=4 bitwise equal; a stacked W=4 launch bitwise its
    four single-worker launches."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.benchmark import timing
    from harp_tpu_torch.models import kmeans as km
    from harp_tpu_torch.ops import pallas_kernels as pk

    c = KMEANS_WIDE
    n, k, d, iters = c["n"], c["k"], c["d"], c["iterations"]
    log(f"[kmeans:wide] regroupallgather n={n} k={k} d={d} iterations="
        f"{iters}, W=1 (the wide variant)")
    pts, cen0 = data
    sess = HarpSession(num_workers=1)
    model = km.KMeans(sess, km.KMeansConfig(k, d, iters))
    p, c0 = model.prepare(pts, cen0)
    zero_counts()
    cen, costs = model.fit_prepared(p, c0)
    launches = read_counts()
    check_no_plain("[kmeans:wide]")
    check(launches["kmeans_stats"] == iters
          and launches["kmeans_stats_wide"] == iters,
          f"one wide kmeans_stats launch an iteration "
          f"({launches['kmeans_stats']}, {launches['kmeans_stats_wide']})")
    cc = costs.cpu().numpy().astype(np.float64)
    log(f"  costs {cc.tolist()}")
    check(bool(torch.isfinite(cen).all()) and np.all(np.isfinite(cc))
          and bool(np.all(np.diff(cc) <= 1e-6 * cc[:-1])),
          "finite centroids, costs non-increasing")
    lcen, rel = lockstep_fit(p, c0, iters)
    check(torch.equal(cen, lcen), "the model's fit is bitwise the kernel's "
          "Lloyd trajectory")

    def build(it):
        m = km.KMeans(sess, km.KMeansConfig(k, d, it))
        m.fit_prepared(p, c0)
        return lambda: m.fit_prepared(p, c0)

    lo, hi = c["epochs"]
    tp = timing.two_point(build, lo, hi, 1.0)
    log(f"  two-point ({lo} vs {hi}): {tp['per_iter_ms']:.4f} ms an "
        f"iteration, spread {tp['spread_pct']:.1f}%")
    x4 = p.reshape(4, n // 4, d)
    stacked = pk.kmeans_stats_cuda(x4, lcen)
    check(all(all(torch.equal(a[wi], b) for a, b in zip(
        stacked, pk.kmeans_stats_cuda(x4[wi], lcen))) for wi in range(4)),
        f"a stacked W=4 launch ({n // 4} points a worker) is bitwise its "
        f"four single-worker launches")
    del p, x4, stacked
    vn = c["variants_n"]
    log(f"[kmeans:wide variants] all five comm variants, W=4, n={vn} k={k} "
        f"d={d}, {iters} iterations")
    sess4 = HarpSession(num_workers=4)
    outs = {comm: km.KMeans(sess4, km.KMeansConfig(k, d, iters, comm)).fit(
        pts[:vn], cen0) for comm in km.COMM_VARIANTS}
    base = outs["regroupallgather"]
    for comm, (vc, vcost) in outs.items():
        check(torch.equal(vc, base[0]) and torch.equal(vcost, base[1]),
              f"{comm} bitwise equal to regroupallgather")
    return {"launches": launches, "per_iter_ms": tp["per_iter_ms"],
            "iters_per_s": tp["rate"], "centroid_rel_vs_plain": rel,
            "grid": pk._kmeans_lib().kmeans_stats_wide_grid(n, d, k)}


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


def mf_hop_bound(nw, rpw, cpb, k, nmb_fine, extra_bytes=0):
    """Least time for one hop: every worker's slab bucket (bf16), W, H and
    the counts read once and W, H, SSE written once (and ``extra_bytes``
    more moved), against 6 rpw cpb K operations at the bf16 tensor-core
    peak."""
    moved = nw * (rpw * cpb * 2 + 2 * rpw * k * 4 + 2 * cpb * k * 4
                  + rpw * 4 + nmb_fine * cpb * 4 + 4) + extra_bytes
    ops = 6 * nw * rpw * cpb * k
    t_bytes, t_ops = moved / PEAK_BYTES_S, ops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


PARENT = {}
# kernel -> ptxas's line of registers and memory, from this run's build
PTXAS = {}


def start_parent_builds():
    """Start nvcc on each parent source in ``PARENT_DIR`` (flags and
    headers of this tree's build) beside the other builds; log the ones
    that are absent."""
    from harp_tpu_torch.ops import _cuda_build

    for name in PARENT_SOURCES:
        src = os.path.join(PARENT_DIR, f"{name}.cu")
        if not os.path.exists(src):
            log(f"[parent] no {src}: {name} is timed without the parent's "
                f"kernel beside it")
            continue
        out = os.path.join(PARENT_DIR, f"lib{name}.so")
        cmd = [_cuda_build._nvcc(), *_cuda_build._flags(name), "-I",
               str(_cuda_build.CSRC), "-o", out, src]
        PARENT[name] = {"proc": subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            "path": out}


def bind_parent(name, lib):
    """The parent's launch entries, bound as the parent's wrapper bound
    them."""
    import ctypes

    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "kmeans_stats":
        lib.kmeans_stats_smem_bytes.argtypes = [i, i]
        lib.kmeans_stats_smem_bytes.restype = ctypes.c_longlong
        lib.kmeans_stats_grid.argtypes = [i] * 5
        lib.kmeans_stats_grid.restype = i
        lib.kmeans_stats_launch.argtypes = [vp] * 6 + [i] * 8 + [vp]
        lib.kmeans_stats_launch.restype = i
        lib.kmeans_stats_wide_grid.argtypes = [i] * 3
        lib.kmeans_stats_wide_grid.restype = i
        lib.kmeans_stats_wide_launch.argtypes = [vp] * 9 + [i] * 8 + [vp]
        lib.kmeans_stats_wide_launch.restype = i
    elif name == "dense_mf_hop":
        lib.dense_mf_hop_col_tile.argtypes = [i]
        lib.dense_mf_hop_col_tile.restype = i
        lib.dense_mf_hop_launch.argtypes = ([vp] * 12 + [i] * 7 + [
            f, f, vp, vp, vp, i, i, i, ctypes.c_ulonglong, vp])
        lib.dense_mf_hop_launch.restype = i
        lib.dense_mf_hop_wide_launch.argtypes = ([vp] * 13 + [i] * 7 + [
            f, f, vp, vp, vp, i, i, i, ctypes.c_ulonglong, vp])
        lib.dense_mf_hop_wide_launch.restype = i
    else:
        ll = ctypes.c_longlong
        lib.spd_solve_launch.argtypes = [vp, vp, vp, ll, i, vp]
        lib.spd_solve_launch.restype = i
        lib.spd_solve_block_per_sm.argtypes = [i, i, i]
        lib.spd_solve_block_per_sm.restype = i
        lib.spd_solve_block_launch.argtypes = [vp, vp, vp, ll, i, i, i, i,
                                               vp]
        lib.spd_solve_block_launch.restype = i
        lib.spd_solve_global_grid.argtypes = [ll, i]
        lib.spd_solve_global_grid.restype = i
        lib.spd_solve_global_launch.argtypes = [vp] * 4 + [ll, i, i, vp]
        lib.spd_solve_global_launch.restype = i


def parent_lib(name):
    """The parent's library of kernel ``name``, or None without its
    source."""
    import ctypes

    entry = PARENT.get(name)
    if entry is None:
        return None
    proc = entry.pop("proc", None)
    if proc is not None:
        log_text, _ = proc.communicate()
        check(proc.returncode == 0, f"the parent's {name}.cu builds "
              f"({log_text[-2000:] if proc.returncode else 'ok'})")
        for fn, regs, spill in ptxas_usage(log_text):
            if fn.startswith(f"{name}_kernel"):
                log(f"  the parent's {fn}: {regs}; {spill}")
        entry["lib"] = ctypes.CDLL(entry["path"])
        bind_parent(name, entry["lib"])
    return entry["lib"]


def parent_wide_shapes(nw, rpw, cpb, kp, nmb):
    """The parent's wide-path buffers, as its ``dense_mf_wide_shapes`` gave
    them: Wb (W, rpw, KP), G (W, rpw, cpb8) and the stripe snapshots (W,
    nmb, cpb8, KP), bf16, cpb8 = cpb rounded up to 8."""
    cpb8 = -(-cpb // 8) * 8
    return (nw, rpw, kp), (nw, rpw, cpb8), (nw, nmb, cpb8, kp)


def parent_hop(lib, slab, buckets, w, h, rc, cc, nmb, lr, lam, group=None):
    """One hop through the parent's kernel with its wrapper's buffers: the
    narrow kernel's Wb chunks and (W, ceil(n_ct / C), rpw, KP) workspace
    (``dense_mf_narrow_shapes``, which this tree keeps), or past rank 128
    the wide path's Wb, G and snapshots; with ``group`` (stacked) its ring
    send too. K must be a padded rank."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    nw, n_blocks, rpw, cpb = slab.shape
    kp = w.shape[-1]
    n_ct = -(-cpb // lib.dense_mf_hop_col_tile(kp))
    new = lambda *s: torch.empty(s, dtype=torch.float32,  # noqa: E731
                                 device=slab.device)
    bf = lambda s: torch.empty(s, dtype=torch.bfloat16,  # noqa: E731
                               device=slab.device)
    w_out, h_out = new(nw, rpw, kp), new(nw, cpb, kp)
    if kp > 128:
        ws = [bf(shape) for shape in parent_wide_shapes(nw, rpw, cpb, kp, nmb)]
        launch = lib.dense_mf_hop_wide_launch
    else:
        wb_shape, ws_shape = pk.dense_mf_narrow_shapes(nw, rpw, cpb, kp, nmb)
        ws, launch = [bf(wb_shape), new(*ws_shape)], lib.dense_mf_hop_launch
    sse_part, sse = new(nw, n_ct), new(nw)
    h_next = None if group is None else torch.empty_like(h_out)
    ring = ((None, None, 0, 0, 1, 0, None) if group is None else
            (h_next.data_ptr(), None, 0, 0, group.num_workers, 0, None))
    err = launch(
        slab.data_ptr(), buckets.data_ptr(), w.data_ptr(), h.data_ptr(),
        rc.data_ptr(), cc.data_ptr(), w_out.data_ptr(), h_out.data_ptr(),
        *(t.data_ptr() for t in ws), sse_part.data_ptr(), sse.data_ptr(), nw,
        n_blocks, rpw, cpb, kp, nmb, cc.shape[2], float(lr), float(lam),
        torch.cuda.current_stream().cuda_stream, *ring)
    if err:
        raise RuntimeError(f"the parent's dense_mf_hop launch: CUDA {err}")
    return (w_out, h_out, sse) if group is None else (w_out, h_out, sse,
                                                      h_next)


def hop_split(fn, reps=MF_SPLIT_REPS):
    """ms a call of each kernel ``fn`` launches: ``reps`` warmed calls under
    the profiler, divided."""
    fn()
    torch.cuda.synchronize()
    per, _ = device_profile(lambda: [fn() for _ in range(reps)])
    return {name: ms / reps for name, ms in per.items()}


def mf_geometry(kp, nw, cpb):
    """The kernel's geometry at padded rank ``kp`` as the library states
    it, and whether a launch of ``nw`` workers at ``cpb`` columns fits the
    clusters the card runs at once (one wave)."""
    import ctypes

    from harp_tpu_torch.ops import pallas_kernels as pk

    lib = pk._mf_lib()
    out = (ctypes.c_int * 6)()
    tile = lib.dense_mf_hop_col_tile(kp)
    if kp in pk.MF_WIDE_RANKS:
        check(lib.dense_mf_hop_wide_geometry(kp, out) == 0,
              f"geometry of KP={kp}")
        rows, stages, active, cluster, ranks, dw_stages = list(out)
        n_cl = -(-cpb // tile)
        extra = {"ranks_a_block": ranks, "dw_stages": dw_stages}
    else:
        check(lib.dense_mf_hop_geometry(kp, out) == 0, f"geometry of KP={kp}")
        rows, stages, active, cluster = list(out)[:4]
        n_cl = -(-cpb // (tile * cluster))
        extra = {}
    return {"col_tile": tile, "cluster": cluster, "rows": rows,
            "stages": stages, "max_active_clusters": active,
            "clusters": n_cl * nw, "one_wave": n_cl * nw <= active,
            "smem": lib.dense_mf_hop_smem_bytes(kp), **extra}


def mf_wide_bytes(nw, rpw, cpb, kp, nmb, parent_tile):
    """Bytes a wide hop moves through L2 for Wb (every column tile reads the
    bucket's Wb), and G's bytes (written once by the hop, read once a rank
    slice by the dW GEMM), this tree's and the parent's (its column tile
    ``parent_tile``; its dW GEMM read G once a 64-rank tile)."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    wb, g, snap, _ = pk.dense_mf_wide_shapes(nw, rpw, cpb, kp, nmb)
    n_ct = -(-cpb // pk.MF_WIDE_COLS)
    nsl = kp // pk.MF_WIDE_RANKS_A_BLOCK
    wb_bytes = 2 * int(np.prod(wb)) * n_ct
    g_bytes = 2 * int(np.prod(g))
    cpb8 = -(-cpb // 8) * 8
    return {"wb_l2_gb": wb_bytes / 1e9, "g_written_gb": g_bytes / 1e9,
            "g_read_gb": g_bytes * nsl / 1e9,
            "snapshot_gb": 2 * int(np.prod(snap)) / 1e9,
            "parent_wb_l2_gb": 2 * nw * rpw * kp * -(-cpb // parent_tile)
            / 1e9,
            "parent_g_written_gb": 2 * nw * rpw * cpb8 / 1e9,
            "parent_g_read_gb": 2 * nw * rpw * cpb8 * kp // 64 / 1e9}


def mfhop_case(name, slab, buckets, w, h, rc, cc, nmb, lr, lam, timed,
               turn_reps=10):
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
        kp = pk.mf_padded_rank(k)
        hop = lambda: pk.dense_mf_hop_cuda(*args)  # noqa: E731
        parent = parent_lib("dense_mf_hop") if kp == k else None
        if parent is not None:
            out["turns_ms"] = in_turns4(lambda: parent_hop(parent, *args),
                                        hop, turn_reps)
            p1, n1, n2, p2 = out["turns_ms"]
            out["parent_ms"], out["ms"] = (p1 + p2) / 2, (n1 + n2) / 2
        else:
            out["ms"] = cuda_time_ms(hop, reps=turn_reps, warmup=2)
        out["plain_ms"] = cuda_time_ms(lambda: pk.dense_mf_hop_plain(*args),
                                       reps=2, warmup=1)
        out["library_ms"] = (cuda_time_ms(lambda: library_hop(*args), reps=3,
                                          warmup=1) if nw == 1 else None)
        out["bound_ms"], out["bound_by"] = mf_hop_bound(
            nw, rpw, cpb, k, cc.shape[2])
        log(f"  kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
            f"library {out['library_ms']:.4f} ms, bound "
            f"{out['bound_ms']:.4f} ms ({out['bound_by']}), "
            f"{out['ms'] / out['bound_ms']:.2f}x the bound")
        if parent is not None:
            log(f"  in turns, parent / new / new / parent: " + " / ".join(
                f"{ms:.4f}" for ms in out["turns_ms"]) + f" ms (the parent's "
                f"kernel {out['parent_ms']:.4f}, this tree's "
                f"{out['ms']:.4f}, {out['parent_ms'] / out['ms']:.2f}x)")
        geo = mf_geometry(kp, nw, cpb)
        out["geometry"] = geo
        if kp in pk.MF_WIDE_RANKS:
            # the parent's column tile was 16384 / KP
            moved = mf_wide_bytes(nw, rpw, cpb, kp, nmb, 16384 // kp)
            out["bytes"] = moved
            ws = (f"wide path: {geo['col_tile']} columns x "
                  f"{geo['ranks_a_block']} ranks a block in clusters of "
                  f"{geo['cluster']} ({geo['clusters']} clusters, "
                  f"{geo['max_active_clusters']} at once on the card), "
                  f"{geo['rows']} rows a chunk, {geo['stages']} stages, "
                  f"{geo['smem']} B of shared memory a block, the dW GEMM "
                  f"{geo['dw_stages']} stages; Wb through L2 "
                  f"{moved['wb_l2_gb']:.2f} GB a hop (the parent's "
                  f"{moved['parent_wb_l2_gb']:.2f}), G "
                  f"{moved['g_written_gb']:.2f} GB written and "
                  f"{moved['g_read_gb']:.2f} read (the "
                  f"parent's {moved['parent_g_written_gb']:.2f} and "
                  f"{moved['parent_g_read_gb']:.2f}), snapshots "
                  f"{moved['snapshot_gb']:.3f} GB")
        else:
            wb_shape, ws_shape = pk.dense_mf_narrow_shapes(nw, rpw, cpb, kp,
                                                           nmb)
            ws = (f"{geo['col_tile']} columns a block in clusters of "
                  f"{geo['cluster']} ({geo['clusters']} clusters, "
                  f"{geo['max_active_clusters']} at once on the card: "
                  f"{'one wave' if geo['one_wave'] else 'more than one wave'}"
                  f"), {geo['rows']} rows a chunk, {geo['stages']} stages, "
                  f"{geo['smem']} B of shared memory a block; dW workspace "
                  f"{ws_shape[1]} partials a worker, "
                  f"{np.prod(ws_shape) * 4 / 1e9:.4f} GB written and read; "
                  f"Wb {np.prod(wb_shape) * 2 / 1e9:.4f} GB")
        out["split_ms"] = hop_split(hop)
        log(f"  {MF_SPLIT_REPS} warmed launches under the profiler, a "
            f"launch: " + ", ".join(f"{n} {ms:.4f} ms" for n, ms in
                                     out["split_ms"].items()) + f"; {ws}")
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
    zero_counts()
    t0 = time.perf_counter()
    fit = model.fit_prepared(state)
    wall = time.perf_counter() - t0
    launches = dict(pk.launches)
    check_no_plain("[sgd_mf]")
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
    prof = {"hop_kernel_ms": None, "w_reduce_ms": None, "wb_kernel_ms": None,
            "busy_share": busy}
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
            elif name.startswith("dense_mf_wb_"):
                prof["wb_kernel_ms"] = ms / epochs
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
        zero_counts()
        fit = model.fit_prepared(state)
        got = pk.launches["dense_mf_hop"]
        check_no_plain(f"[sgd_mf variants] dense, {ns} slice(s)")
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

    slab, buckets, w32, h32, rc, cc = args
    w128, h128 = rank_factors(w32, h32, 128, seed=128)
    r128 = mfhop_case("rank128", slab, buckets, w128, h128, rc, cc, f["nmb"],
                      f["lr"], f["lam"], timed=True)
    del w128, h128
    wide = mf_wide_hops(args)

    fit = mf_flagship(cfg, state, nnz)
    log(f"  kernel {flag['ms']:.4f} ms per hop (one hop an epoch) against a "
        f"bound of {flag['bound_ms']:.4f} ms ({flag['bound_by']}); fit "
        f"{fit['per_epoch_ms']:.4f} ms per epoch")
    del state, args, slab
    torch.cuda.empty_cache()
    mf_variants()
    torch.cuda.empty_cache()
    r256 = mf_rank256_phase(rows, cols, vals)
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
        "parent_ms": flag.get("parent_ms"),
        "rank128_parent_ms": r128.get("parent_ms"),
        "turns_ms": flag.get("turns_ms"),
        "rank128_turns_ms": r128.get("turns_ms"),
        "geometry": flag["geometry"], "rank128_geometry": r128["geometry"],
        "fit_ratings_per_s": fit["ratings_per_s"],
        "fit_per_epoch_ms": fit["per_epoch_ms"],
        "fit_rmse_rel_vs_plain": fit["rmse_rel_vs_plain"],
        "fit_factor_rel_vs_plain": fit["factor_rel_vs_plain"],
        "fit_hop_kernel_ms": fit["hop_kernel_ms"],
        "fit_w_reduce_ms": fit["w_reduce_ms"],
        "fit_wb_kernel_ms": fit["wb_kernel_ms"],
        "fit_device_busy_share": fit["busy_share"],
        **{f"rank{k}_{key}": wide[k].get(key) for k in MF_WIDE["timed"]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms", "max_abs_err", "split_ms", "parent_ms",
                       "turns_ms", "bytes", "geometry")},
        f"rank{MF_WIDE['ragged']}_max_abs_err":
            wide[MF_WIDE["ragged"]]["max_abs_err"],
        f"rank{MF_WIDE['top']}_corner_max_abs_err":
            wide["top"]["max_abs_err"],
        **{f"fit_rank{MF_WIDE['rank']}_{key}": val
           for key, val in r256.items()},
    }


def rank_factors(w, h, k, seed):
    """Random W and H of rank K shaped as ``w`` and ``h`` (standard normal
    over sqrt(K)), from a seed, on their device."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((rng.standard_normal(
        t.shape[:2] + (k,)) / k ** 0.5).astype(np.float32)).to(t.device)
        for t in (w, h))


def mf_wide_hops(args):
    """[mfhop:wide]: the hop past rank 128 (the wide path) on the SGD-MF
    flagship's slab, W=1: ranks 256, 512 and 1024 timed in turns against
    the parent commit's wide path where its source is at
    ``build/parent/dense_mf_hop.cu`` (256 over 10 launches a reading, 512
    and 1024 over 3), a ragged 136 (padded to 256), and one launch at 1024
    on a 4096 x 4096 corner of the slab with its own counts, each against
    the plain version and its float64 twin."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    f, m = MF_FLAGSHIP, MF_WIDE
    slab, buckets, w, h, rc, cc = args
    log(f"[mfhop:wide] ranks {', '.join(str(k) for k in m['timed'])} and "
        f"{m['ragged']} on the flagship's slab, {m['top']} on a "
        f"{m['top_rows']}^2 corner, past the narrow kernel's 128")
    out = {}
    for k in (*m["timed"], m["ragged"]):
        wk, hk = rank_factors(w, h, k, seed=k)
        out[k] = mfhop_case(f"rank{k}", slab, buckets, wk, hk, rc, cc,
                            f["nmb"], f["lr"], f["lam"],
                            timed=k in m["timed"],
                            turn_reps=10 if k == m["rank"] else 3)
        del wk, hk
        torch.cuda.empty_cache()
    n = m["top_rows"]
    small = slab[:, :, :n, :n].contiguous()
    seen = ~torch.isnan(small)
    nmb_fine = cc.shape[2]
    rc_s = seen.sum(3).float()
    cc_s = seen.reshape(1, 1, nmb_fine, n // nmb_fine, n).sum(3).float()
    wk, hk = rank_factors(w[:, :n], h[:, :n], m["top"], seed=m["top"])
    before = pk.launches["dense_mf_hop"]
    out["top"] = mfhop_case(f"rank{m['top']}", small, buckets, wk, hk, rc_s,
                            cc_s, f["nmb"], f["lr"], f["lam"], timed=False)
    check(pk.launches["dense_mf_hop"] - before == 2,
          f"rank {m['top']}: one launch a hop call (two calls, the second "
          f"the bitwise rerun)")
    torch.cuda.empty_cache()
    return out


def mf_rank256_phase(rows, cols, vals):
    """[sgd_mf:rank256]: the flagship fit at rank 256 (the wide hop), W=1,
    held to the SGD-MF rule against the plain-hop fit, ratings/s two-point;
    then the fused 1-slice fit at W=4 stacked (each hop launch with its
    in-kernel send) bitwise its unfused twin."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.benchmark import timing
    from harp_tpu_torch.models import sgd_mf
    from harp_tpu_torch.ops import pallas_kernels as pk

    f, m = MF_FLAGSHIP, MF_WIDE
    lo, hi = m["epochs"]
    cfg = sgd_mf.SGDMFConfig(rank=m["rank"], lam=f["lam"], lr=f["lr"],
                             epochs=lo, minibatches_per_hop=f["nmb"])
    sess = HarpSession(num_workers=1)
    model = sgd_mf.SGDMF(sess, cfg)
    state = model.prepare(rows, cols, vals, f["users"], f["items"], seed=0)
    nnz = model.last_layout_stats["nnz"]
    log(f"[sgd_mf:rank{m['rank']}] dense rotation {f['users']}x{f['items']}, "
        f"rank {m['rank']}, {f['nmb']} minibatches a hop, {lo} epochs, W=1")
    zero_counts()
    fit = model.fit_prepared(state)
    launches = dict(pk.launches)
    check_no_plain(f"[sgd_mf:rank{m['rank']}]")
    check(launches["dense_mf_hop"] == lo,
          f"dense_mf_hop launched once per epoch ({launches['dense_mf_hop']})")
    log(f"  rmse {fit[2].tolist()}")
    check(bool(np.all(np.isfinite(fit[2]))) and fit[2][-1] < fit[2][0],
          "finite, falling RMSEs")
    plain, exact = mf_plain_models(sess, cfg)
    r_rel, f_rel = check_fit_vs_plain(fit, plain.fit_prepared(state),
                                      exact.fit_prepared(state))

    def build(epochs):
        mm = sgd_mf.SGDMF(sess, dataclasses.replace(cfg, epochs=epochs))
        mm.train_prepared(state)
        return lambda: mm.train_prepared(state)

    tp = timing.two_point(build, lo, hi, float(nnz))
    log(f"  two-point ({lo} vs {hi} epochs): {tp['rate']:.6g} ratings/s, "
        f"{tp['per_iter_ms']:.4f} ms/epoch, spread {tp['spread_pct']:.1f}%")
    del state, model, plain, exact
    torch.cuda.empty_cache()

    ep = m["fused_epochs"]
    sess4 = HarpSession(num_workers=RING_W)
    kw = dict(rank=m["rank"], epochs=ep)
    fused = sgd_mf.SGDMF(sess4, mf_fused_config(fused_dma=True, **kw))
    state4 = fused.prepare(rows, cols, vals, f["users"], f["items"], seed=0)
    log(f"[sgd_mf:rank{m['rank']}] fused, 1 slice, W={RING_W} stacked, "
        f"{ep} epochs: fused_dma=True against False")
    zero_counts()
    got = fused.train_prepared(state4)
    counts = read_counts()
    check_no_plain(f"[sgd_mf:rank{m['rank']}] fused")
    steps = ep * RING_W
    check(counts["dense_mf_hop"] == steps
          and counts["dense_mf_hop_ring"] == steps
          and counts["ring_dma_hop"] == 0,
          f"one dense_mf_hop launch a rotation step, each with its send, no "
          f"ring_dma_hop ({counts['dense_mf_hop']}, "
          f"{counts['dense_mf_hop_ring']} = {steps}; "
          f"{counts['ring_dma_hop']})")
    want = sgd_mf.SGDMF(sess4, mf_fused_config(
        fused_dma=False, **kw)).train_prepared(state4)
    check(all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
              for a, b in zip(got, want)),
          "factors and RMSEs bitwise the fused_dma=False fit")
    digest = factor_digest(pull_factors(sess4, got[0], got[1]), got[2])
    del state4, fused
    torch.cuda.empty_cache()
    return {"launches": launches["dense_mf_hop"], "ratings_per_s": tp["rate"],
            "per_epoch_ms": tp["per_iter_ms"], "rmse_rel_vs_plain": r_rel,
            "factor_rel_vs_plain": f_rel,
            "fused_launches": counts["dense_mf_hop_ring"],
            "fused_digest": digest}


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
    read once and x written once, against (K³/3 + 2K²) floating-point
    operations a system (the Cholesky's K³/6 multiply-adds and the two
    substitutions' K², each multiply-add two operations) at the float32
    CUDA-core peak."""
    moved = lower_triangle_sectors(n, k) * 32 + 2 * n * k * 4
    ops = (k ** 3 / 3 + 2 * k * k) * n
    t_bytes, t_ops = moved / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_spd(a, b):
    """Yardstick only: the "cholesky" solver's route, cuSOLVER's batched
    Cholesky then ``cholesky_solve``."""
    return torch.cholesky_solve(b[..., None],
                                torch.linalg.cholesky_ex(a).L)[..., 0]


def random_spd(n, k, seed, chunk=None):
    """ALS-shaped systems made on the card from a seed: V'V over 4k rows
    plus 0.1 I, and right-hand sides; with ``chunk``, V is drawn ``chunk``
    systems at a time (at K = 384 one V for 8192 systems is 19 GB)."""
    g = torch.Generator(device=CARD).manual_seed(seed)
    if chunk is None:
        v = torch.randn(n, 4 * k, k, generator=g, device=CARD) / k ** 0.5
        a = torch.bmm(v.transpose(1, 2), v) + 0.1 * torch.eye(k, device=CARD)
        return a.contiguous(), torch.randn(n, k, generator=g, device=CARD)
    a = torch.empty(n, k, k, device=CARD)
    for i in range(0, n, chunk):
        v = torch.randn(min(chunk, n - i), 4 * k, k, generator=g,
                        device=CARD) / k ** 0.5
        torch.bmm(v.transpose(1, 2), v, out=a[i:i + chunk])
        del v
    a += 0.1 * torch.eye(k, device=CARD)
    return a, torch.randn(n, k, generator=g, device=CARD)


def spd_case(name, a, b, timed, reps=20, plain_reps=3):
    """One solve through the kernel, checked against the plain version and
    a float64 solve. ``timed``: the kernel's, the library's and the plain
    version's times; ``plain_reps`` = 0 takes the plain version's time from
    its one checked call (no warm-up), for the widths where it takes
    seconds."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    n, k = b.shape
    variant = spd_counter(k)
    log(f"[spd:{name}] N={n} K={k}, the {variant} kernel")
    before = pk.launches[variant]
    x = pk.spd_solve_cuda(a, b)
    torch.cuda.synchronize()
    check(pk.launches[variant] == before + 1, f"one {variant} launch")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = pk.spd_solve_plain(a, b)
    end.record()
    torch.cuda.synchronize()
    exact = torch.linalg.solve(a.double(), b.double())
    err, ref = max_rel(x, exact), max_rel(plain, exact)
    vs_plain = max_rel(x, plain)
    tol = max(1e-5, 4 * ref)
    log(f"  kernel vs float64 {err:.3g}, plain vs float64 {ref:.3g}, kernel "
        f"vs plain {vs_plain:.3g}")
    check(bool(torch.isfinite(x).all()) and err <= tol,
          f"x within {tol:.3g} of the float64 solve (1e-5 or 4x the plain "
          f"version's distance)")
    check(vs_plain <= 1e-4, "x within 1e-4 of the plain version (relative "
          "to max |x|)")
    check(torch.equal(x, pk.spd_solve_cuda(a, b)),
          "two kernel runs bitwise equal")
    out = {"max_abs_err": float((x - plain).abs().max()),
           "rel_vs_float64": err, "plain_rel_vs_float64": ref}
    if timed:
        warm = min(3, reps // 2)
        solve = lambda: pk.spd_solve_cuda(a, b)  # noqa: E731
        if variant == "spd_solve":
            out["ms"] = graph_time_ms(solve, reps=10 * reps, warmup=warm)
            out["eager_ms"] = cuda_time_ms(solve, reps=reps, warmup=warm)
            log(f"  one-warp kernel from a CUDA graph {out['ms']:.6f} ms, "
                f"eager calls back to back {out['eager_ms']:.6f} ms")
        else:
            out["ms"] = cuda_time_ms(solve, reps=reps, warmup=warm)
        out["plain_ms"] = (cuda_time_ms(lambda: pk.spd_solve_plain(a, b),
                                        reps=plain_reps, warmup=1)
                           if plain_reps else start.elapsed_time(end))
        out["library_ms"] = cuda_time_ms(lambda: library_spd(a, b),
                                         reps=reps, warmup=warm)
        out["bound_ms"], out["bound_by"] = spd_bound(n, k)
        log(f"  kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
            f"library {out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} "
            f"ms ({out['bound_by']}), {out['ms'] / out['bound_ms']:.2f}x the "
            f"bound")
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
    from harp_tpu_torch.ops import pallas_kernels as pk

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
    parent = parent_lib("spd_solve")
    if parent is not None:
        check(torch.equal(pk.spd_solve_cuda(a, b), parent_spd(parent, a, b)),
              "the flagship's x is the parent's one-warp kernel's, bitwise")
        flag["turns_ms"] = in_turns4(lambda: parent_spd(parent, a, b),
                                     lambda: pk.spd_solve_cuda(a, b), 200,
                                     timer=graph_time_ms)
        p1, n1, n2, p2 = flag["turns_ms"]
        flag["parent_ms"], flag["ms_in_turns"] = (p1 + p2) / 2, (n1 + n2) / 2
        log(f"  in turns, from CUDA graphs: parent / new / new / parent " +
            " / ".join(f"{ms:.6f}" for ms in flag["turns_ms"]) + f" ms "
            f"({flag['parent_ms'] / flag['ms_in_turns']:.2f}x)")
    del a, b
    spd_case("ragged", *random_spd(8191, 10, seed=10), timed=False)
    spd_case("k33", *random_spd(8192, 33, seed=33), timed=False)
    k64 = spd_case("k64", *random_spd(8192, 64, seed=64), timed=True)
    spd_case("K65", *random_spd(4097, 65, seed=65), timed=False)
    wide = {k: spd_case(f"K{k}", *random_spd(8192, k, seed=k), timed=True)
            for k in SPD_WIDE}
    torch.cuda.empty_cache()
    spd_case("K256", *random_spd(1024, 256, seed=256), timed=False)
    return flag, k64, wide, gemm


def parent_spd(lib, a, b):
    """One solve through the parent commit's route, as its
    ``spd_solve_cuda`` routes: its one-warp kernel (one system a warp, a
    column a lane) to K = 32, its shared-memory kernel at
    ``spd_solve_block_geometry(k)`` on its resident grid to K = 307, its
    global-memory kernel above."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    n, k = b.shape
    if k > pk.SPD_MAX_K_SMEM:
        return parent_spd_global(lib, a, b)
    x = torch.empty(n, k, device=a.device)
    stream = torch.cuda.current_stream().cuda_stream
    if k <= pk.SPD_MAX_K_WARP:
        err = lib.spd_solve_launch(a.data_ptr(), b.data_ptr(), x.data_ptr(),
                                   n, k, stream)
    else:
        threads, regs = pk.spd_solve_block_geometry(k)
        per_sm = lib.spd_solve_block_per_sm(k, threads, regs)
        if per_sm < 1:
            raise RuntimeError(f"the parent's spd_solve_block at K = {k}: no "
                               f"block fits an SM ({per_sm})")
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        err = lib.spd_solve_block_launch(
            a.data_ptr(), b.data_ptr(), x.data_ptr(), n, k, threads, regs,
            max(1, min(n, sms * per_sm)), stream)
    if err:
        raise RuntimeError(f"the parent's spd_solve launch: CUDA {err}")
    return x


def parent_spd_global(lib, a, b):
    """One solve through the parent commit's global-memory kernel, on its
    own persistent grid and workspace."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    n, k = b.shape
    x = torch.empty(n, k, device=a.device)
    grid = lib.spd_solve_global_grid(n, k)
    ws = torch.empty(pk.spd_solve_global_workspace_bytes(grid, k) // 4,
                     device=a.device)
    err = lib.spd_solve_global_launch(
        a.data_ptr(), b.data_ptr(), x.data_ptr(), ws.data_ptr(), n, k, grid,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the parent's spd_solve_global launch: CUDA {err}")
    return x


def spd_geometry(k):
    """The shared-memory solve's geometry at rank K as the wrapper launches
    it: panel columns, threads and registers a thread, resident blocks an
    SM and shared-memory bytes a block (one system's triangle and b, and
    the staging area)."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    threads, regs = pk.spd_solve_block_geometry(k)
    return {"nb": pk.SPD_PANEL, "threads": threads, "regs": regs,
            "blocks_per_sm": pk.spd_solve_block_per_sm(k, threads, regs),
            "smem": pk.spd_solve_block_smem_bytes(k)}


def spd_warp_geometry(k, n):
    """The one-warp solve's geometry at rank K as the wrapper launches it
    for N systems: lanes a system, rows a lane, systems a warp, resident
    blocks (and warps) an SM, the grid and shared-memory bytes a block."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    g = pk.spd_solve_warp_group(k)
    per_sm = pk.spd_solve_warp_per_sm(k)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"lanes": g, "rows_a_lane": -(-k // g), "systems_a_warp": 32 // g,
            "blocks_per_sm": per_sm,
            "warps_per_sm": pk.spd_solve_warp_block_warps(k) * per_sm,
            "grid": pk.spd_solve_warp_grid(n, k, per_sm, sms),
            "smem": pk.spd_solve_warp_smem_bytes(k)}


def spd_sweep_phase():
    """[spd:sweep]: at each K of ``SPD_SWEEP`` (N systems), the route the
    wrapper takes, held against the global-memory kernel (which takes any
    K: bitwise from K = 33, where both are panel-blocked; at K <= 32 a
    finding, logged); timed in turns against the parent commit's route
    (parent / new / new / parent; at K <= 32 from CUDA graphs) where its
    source is in ``PARENT_DIR``, and bitwise its x, beside the
    global-memory kernel, cuSOLVER, the bound, the one-warp kernel's
    geometry and every geometry of the shared-memory kernel that fits.
    Returns {K: readings}."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    n = SPD_SWEEP["n"]
    parent = parent_lib("spd_solve")
    log(f"[spd:sweep] N={n}, K = " + ", ".join(
        str(k) for k in SPD_SWEEP["ks"]) + f"; the one-warp kernel to K = "
        f"{pk.SPD_MAX_K_WARP}, the shared-memory kernel to K = "
        f"{pk.SPD_MAX_K_SMEM}, the global-memory kernel past it")
    out = {}
    for k in SPD_SWEEP["ks"]:
        a, b = random_spd(n, k, seed=k, chunk=512)
        variant = pk.spd_solve_variant(k)
        warp = variant == "spd_solve"
        x = pk.spd_solve_cuda(a, b)
        check(bool(torch.isfinite(x).all()), f"K = {k}: the {variant} "
              f"kernel's x is finite")
        row = {"variant": variant,
               "global_bitwise": bool(torch.equal(x, pk._spd_solve_global(
                   a, b)))}
        if warp:
            log(f"  K = {k}: the one-warp kernel's x is "
                f"{'' if row['global_bitwise'] else 'not '}bitwise the "
                f"global-memory kernel's (a finding, not a check)")
        else:
            check(row["global_bitwise"], f"K = {k}: the {variant} kernel's x "
                  f"is bitwise the global-memory kernel's")
        reps = 200 if warp else 10 if k <= 128 else 3
        timer = graph_time_ms if warp else cuda_time_ms

        def route():
            return pk.spd_solve_cuda(a, b)

        if parent is not None:
            row["parent_bitwise"] = bool(torch.equal(x, parent_spd(parent, a,
                                                                   b)))
            check(row["parent_bitwise"], f"K = {k}: x is the parent's "
                  f"route's, bitwise")
            row["turns_ms"] = in_turns4(lambda: parent_spd(parent, a, b),
                                        route, reps, timer=timer)
            p1, n1, n2, p2 = row["turns_ms"]
            row["parent_ms"], row["ms"] = (p1 + p2) / 2, (n1 + n2) / 2
        else:
            row["ms"] = timer(route, reps=reps, warmup=2)
        row["global_ms"] = cuda_time_ms(lambda: pk._spd_solve_global(a, b),
                                        reps=reps, warmup=1)
        row["library_ms"] = cuda_time_ms(lambda: library_spd(a, b),
                                         reps=reps, warmup=1)
        row["bound_ms"], row["bound_by"] = spd_bound(n, k)
        line = (f"  K={k} {variant}: {row['ms']:.6f} ms ("
                f"{row['ms'] / row['bound_ms']:.2f}x its bound "
                f"{row['bound_ms']:.6f}, {row['bound_by']})")
        if parent is not None:
            line += (f"; parent / new / new / parent " + " / ".join(
                f"{ms:.6f}" for ms in row["turns_ms"]) + f" ms ("
                f"{row['parent_ms'] / row['ms']:.2f}x), parent's x "
                f"{'bitwise' if row['parent_bitwise'] else 'not bitwise'}")
        line += (f"; global-memory {row['global_ms']:.6f}, cuSOLVER "
                 f"{row['library_ms']:.6f}")
        log(line)
        if warp:
            row["eager_ms"] = cuda_time_ms(route, reps=reps, warmup=2)
            row["geometry"] = g = spd_warp_geometry(k, n)
            g["registers"] = PTXAS.get(f"spd_solve_kernel<{k}>")
            log(f"    geometry: {g['lanes']} lanes a system, "
                f"{g['rows_a_lane']} rows a lane, "
                f"{g['systems_a_warp']} a warp, {g['blocks_per_sm']} blocks "
                f"({g['warps_per_sm']} warps) an SM, grid {g['grid']}, "
                f"{g['smem']} bytes a block; eager calls back to back "
                f"{row['eager_ms']:.6f} ms")
        elif variant == "spd_solve_block":
            row["geometry"] = g = spd_geometry(k)
            row["geometry_ms"] = {}
            for threads, regs in pk.SPD_BLOCK_SHAPES:
                row["geometry_ms"][f"{threads}/{regs}"] = cuda_time_ms(
                    lambda: pk._spd_solve_block(a, b, threads, regs),
                    reps=max(3, reps // 2), warmup=1)
            log(f"    geometry: nb {g['nb']}, {g['threads']} threads, "
                f"{g['regs']} registers, one buffer, "
                f"{g['blocks_per_sm']} blocks an SM, {g['smem']} bytes; "
                f"threads/registers: " + ", ".join(
                    f"{key} {ms:.4f}" for key, ms in
                    row["geometry_ms"].items()) + " ms")
        out[k] = row
        del a, b, x
        torch.cuda.empty_cache()
    if parent is not None:
        slower = [k for k, r in out.items() if r["ms"] > r["parent_ms"]]
        log(f"  K where the route is slower than the parent's: "
            f"{slower or 'none'}")
    return out


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


SPD_COUNTERS = ("spd_solve", "spd_solve_block", "spd_solve_global")


def spd_counter(k):
    """The launch counter of the SPD-solve variant that takes rank K (the
    wrapper's own routing)."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    return pk.spd_solve_variant(k)


def als_fit_checked(sess, cfg, data, layout, path):
    """Fit ``data`` through the kernel, counting launches, and hold it
    against the cholesky and float64-solve fits. Returns (launches, fit,
    RMSE distance, factor distance, the fit's wall seconds)."""
    from harp_tpu_torch.models import als
    from harp_tpu_torch.ops import pallas_kernels as pk

    model = als.ALS(sess, cfg)
    state = model.prepare(*data)
    check(model.last_layout_stats["layout"] == layout,
          f"layout {model.last_layout_stats['layout']}")
    zero_counts()
    t0 = time.perf_counter()
    fit = model.fit_prepared(state)
    wall = time.perf_counter() - t0
    launches = dict(pk.launches)
    check_no_plain(path)
    log(f"  fit wall {wall:.3f} s (first call, includes the factor fetch), "
        f"launches {launches}")
    name = spd_counter(cfg.rank)
    others = {n: launches[n] for n in SPD_COUNTERS if n != name}
    check(launches[name] == 2 * cfg.iterations and not any(others.values()),
          f"{name} launched twice an iteration ({launches[name]}), the "
          f"other variants never ({others})")
    log(f"  rmse {fit[2].tolist()}")
    check(bool(np.all(np.isfinite(fit[2]))) and np.isfinite(fit[0]).all()
          and np.isfinite(fit[1]).all(), "finite RMSEs and factors")
    ref, yard = reference_fits(sess, cfg, data)
    r_rel, f_rel = check_als_fit(fit, ref, yard, "cholesky fit")
    return launches, fit, r_rel, f_rel, wall


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
    launches, fit, r_rel, f_rel, _ = als_fit_checked(
        sess, cfg, data, "dense", "[als:flagship]")
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


def als_wide(data, cfg):
    """[als:rank64], [als:rank96], [als:rank128]: the implicit flagship's
    data at ranks the shared-memory solve takes, rank 64 with the default
    solver="auto" (the route ALS takes there) and 96 and 128 with an
    explicit solver="pallas", held against the "cholesky" fit under the ALS
    rule (PERF.md section 2)."""
    from harp_tpu_torch import HarpSession

    out = {}
    for rank, solver in ALS_WIDE.items():
        wcfg = dataclasses.replace(cfg, rank=rank, solver=solver,
                                   iterations=ALS_WIDE_ITERATIONS)
        log(f"[als:rank{rank}] implicit, the flagship's data, rank {rank}, "
            f"solver={solver!r}, {wcfg.iterations} iterations, W=1")
        sess = HarpSession(num_workers=1)
        launches, fit, r_rel, f_rel, _ = als_fit_checked(
            sess, wcfg, data, "dense", f"[als:rank{rank}]")
        tp = als_two_point(sess, wcfg, data)
        log(f"  two-point: {tp['rate']:.2f} iters/s, {tp['per_iter_ms']:.4f} "
            f"ms/iter, spread {tp['spread_pct']:.1f}%")
        out[rank] = {"launches": launches, "iters_per_s": tp["rate"],
                     "per_iter_ms": tp["per_iter_ms"],
                     "rmse_rel_vs_cholesky": r_rel,
                     "factor_rel_vs_cholesky": f_rel}
        torch.cuda.empty_cache()
    return out


def spd_both_phase():
    """[spd:wide:K300]: at a K both take, the global-memory kernel (called
    directly) against the shared-memory kernel the dispatcher launches
    there: bitwise equal, and both timed in turns."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    k, n = SPD_BOTH["k"], SPD_BOTH["n"]
    log(f"[spd:wide:K{k}] N={n}: the global-memory kernel against the "
        f"shared-memory kernel")
    a, b = random_spd(n, k, seed=k, chunk=512)
    check(torch.equal(pk._spd_solve_global(a, b), pk.spd_solve_cuda(a, b)),
          "the global-memory kernel's x is the shared-memory kernel's, "
          "bitwise")
    block, glob = in_turns(lambda: pk.spd_solve_cuda(a, b),
                           lambda: pk._spd_solve_global(a, b), 3)
    lib = cuda_time_ms(lambda: library_spd(a, b), reps=3, warmup=1)
    bound, by = spd_bound(n, k)
    log(f"  shared-memory {block:.4f} ms, global-memory {glob:.4f} ms "
        f"({block / glob:.2f}x); cuSOLVER {lib:.4f} ms, bound {bound:.4f} "
        f"ms ({by})")
    del a, b
    torch.cuda.empty_cache()
    return {"k300_block_ms": block, "k300_global_ms": glob,
            "k300_bitwise": True, "k300_library_ms": lib,
            "k300_bound_ms": bound, "k300_bound_by": by}


def spd_global_phases(data, cfg):
    """[spd:wide] and [als:rank384]: the solve past K = 307 (the
    global-memory kernel) alone at SPD_GLOBAL's K and N, timed against
    cuSOLVER, the plain version and the bound, and at SPD_BOTH against the
    shared-memory kernel, and, where the parent commit's source is in
    ``PARENT_DIR``, bitwise and in turns against its global-memory kernel;
    then the implicit flagship's data at rank 384 with solver="pallas",
    held against the "cholesky" fit under the ALS rule. Returns the
    kernels-line entry of spd_solve_global."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.ops import pallas_kernels as pk

    both = spd_both_phase()
    parent = parent_lib("spd_solve")
    cases = {}
    for k, n in SPD_GLOBAL.items():
        a, b = random_spd(n, k, seed=k, chunk=512)
        cases[k] = c = spd_case(f"wide:K{k}", a, b, timed=True, reps=3,
                                plain_reps=0)
        if parent is not None:
            check(torch.equal(pk._spd_solve_global(a, b),
                              parent_spd_global(parent, a, b)),
                  f"K = {k}: x is the parent's global-memory kernel's, "
                  f"bitwise")
            c["turns_ms"] = in_turns4(lambda: parent_spd_global(parent, a, b),
                                      lambda: pk._spd_solve_global(a, b), 3)
            p1, n1, n2, p2 = c["turns_ms"]
            c["parent_ms"] = (p1 + p2) / 2
            log(f"  parent / new / new / parent " + " / ".join(
                f"{ms:.4f}" for ms in c["turns_ms"]) + f" ms (the parent "
                f"{c['parent_ms'] / ((n1 + n2) / 2):.3f}x the new)")
        del a, b
        torch.cuda.empty_cache()
    g = ALS_GLOBAL
    rank = g["rank"]
    gcfg = dataclasses.replace(cfg, rank=rank, solver="pallas",
                               iterations=g["iterations"])
    log(f"[als:rank{rank}] implicit, the flagship's data, rank {rank}, "
        f"solver='pallas', {gcfg.iterations} iterations, W=1")
    sess = HarpSession(num_workers=1)
    launches, fit, r_rel, f_rel, wall = als_fit_checked(
        sess, gcfg, data, "dense", f"[als:rank{rank}]")
    per_iter_ms = 1e3 * wall / gcfg.iterations
    log(f"  {per_iter_ms:.4f} ms an iteration (the checked fit's wall over "
        f"its iterations)")
    torch.cuda.empty_cache()
    entry = {
        "name": "spd_solve_global", "route": "cuda",
        "source": "harp_tpu_torch/csrc/spd_solve.cu",
        "replaces": "harp_tpu/ops/pallas_kernels.py:829",
        "launches": launches["spd_solve_global"],
        "launches_path": f"ALS.fit_prepared, implicit, the flagship's data, "
                         f"rank {rank}, solver='pallas', {gcfg.iterations} "
                         f"iterations",
        "k": rank, "n": SPD_GLOBAL[rank],
        **{key: cases[rank][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "rel_vs_float64", "plain_rel_vs_float64")},
        "fit_per_iter_ms": per_iter_ms,
        "fit_rmse_rel_vs_cholesky": r_rel,
        "fit_factor_rel_vs_cholesky": f_rel,
        **both,
    }
    for k, c in cases.items():
        for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err", "parent_ms", "turns_ms"):
            if key in c:
                entry[f"k{k}_{key}"] = c[key]
        entry[f"k{k}_n"] = SPD_GLOBAL[k]
    return entry


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
    launches, fit, r_rel, f_rel, _ = als_fit_checked(
        sess, cfg, data, "sparse", "[als:explicit]")
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
            zero_counts()
            fit = als.ALS(sess, cfg).fit(*data)
            got = pk.launches["spd_solve"]
            mode = "implicit" if implicit else "explicit"
            check_no_plain(f"[als variants] {layout} {mode}")
            log(f"  {layout} {mode}: rmse {fit[2].tolist()}")
            check(got == 2 * iters, f"{layout} {mode}: two launches an "
                  f"iteration ({got})")
            check(all(bool(np.isfinite(x).all()) for x in fit),
                  f"{layout} {mode}: finite RMSEs and factors")
            ref, yard = reference_fits(sess, cfg, data)
            check_als_fit(fit, ref, yard, "cholesky fit")
            check_als_fit(fit, als.ALS(cpu, cfg).fit(*data), yard, "CPU fit")


def als_phases():
    """Every SPD-solve and ALS phase; returns the kernels-line entries of
    the SPD solve's three variants (one warp, the shared-memory kernel, the
    global-memory kernel)."""
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
    flag, k64, wide, gemm = spd_phases(state, cfg)
    del state
    sweep = spd_sweep_phase()
    fit = als_flagship(data, cfg)
    log(f"  kernel {flag['ms']:.4f} ms per solve (two an iteration) against "
        f"a bound of {flag['bound_ms']:.4f} ms ({flag['bound_by']}); fit "
        f"{fit['per_iter_ms']:.4f} ms an iteration")
    wide_fits = als_wide(data, cfg)
    glob = spd_global_phases(data, cfg)
    exp = als_explicit()
    als_variants()
    top = max(SPD_WIDE)
    block = {
        "name": "spd_solve_block", "route": "cuda",
        "source": "harp_tpu_torch/csrc/spd_solve.cu",
        "replaces": "harp_tpu/ops/pallas_kernels.py:829",
        "launches": wide_fits[top]["launches"]["spd_solve_block"],
        "launches_path": f"ALS.fit_prepared, implicit, the flagship's data, "
                         f"rank {top}, solver='pallas', "
                         f"{ALS_WIDE_ITERATIONS} iterations",
        "k": top,
        **{key: wide[top][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "rel_vs_float64", "plain_rel_vs_float64")},
        **{key: sweep[top][key] for key in ("parent_ms", "turns_ms")
           if key in sweep[top]},
        "geometry": sweep[top]["geometry"],
        "sweep": {str(k): row for k, row in sweep.items()
                  if row["variant"] != "spd_solve"},
    }
    for rank, case in ((64, k64), *((r, wide[r]) for r in SPD_WIDE)):
        for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err"):
            block[f"k{rank}_{key}"] = case[key]
    for rank in ALS_WIDE:
        for key, val in wide_fits[rank].items():
            block[f"fit_rank{rank}_{key}"] = (
                val["spd_solve_block"] if key == "launches" else val)
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
        "eager_ms": flag["eager_ms"],
        **{key: flag[key] for key in ("parent_ms", "turns_ms", "ms_in_turns")
           if key in flag},
        "registers": PTXAS.get(f"spd_solve_kernel<{f['rank']}>"),
        "geometry": sweep[f["rank"]]["geometry"],
        "sweep": {str(k): row for k, row in sweep.items()
                  if row["variant"] == "spd_solve"},
    }, block, glob


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


def flash_bound(w, l, h, dh, dv, causal, in_bytes, extra_bytes=0):
    """Least time for attention over (W, L, H): q, k, v read once and out
    written once (and ``extra_bytes`` more moved), against (2 Dh + 2 Dv) H
    operations a live (query, key) pair, L (L + 1) / 2 pairs causal. The
    float32 path's operations take three TF32 passes (the fastest route to
    float32 accuracy); with bf16 inputs the q k half runs at the bf16 rate
    and p v takes two TF32 passes (p stays float32, v is exact in TF32: p's
    hi and lo against v). Returns (ms, what bounds it, the same operations
    on the float32 CUDA cores in ms)."""
    pairs = w * h * (l * (l + 1) // 2 if causal else l * l)
    moved = w * l * h * ((2 * dh + dv) * in_bytes + dv * 4) + extra_bytes
    qk, pv = 2 * dh * pairs, 2 * dv * pairs
    if in_bytes == 2:
        t_ops = qk / PEAK_BF16_FLOPS + 2 * pv / PEAK_TF32_FLOPS
    else:
        t_ops = 3 * (qk + pv) / PEAK_TF32_FLOPS
    t_bytes = moved / PEAK_BYTES_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            (qk + pv) / PEAK_F32_FLOPS * 1e3)


def library_attention(q, k, v, causal):
    """Yardstick only (never called by the port): PyTorch's
    scaled_dot_product_attention on the same (L, H, D) or stacked (W, L, H,
    D) tensors, viewed (W, H, L, D) (a 3-D input would send it to its math
    backend, which holds the whole (H, L, L) score tensor)."""
    lift = (lambda x: x) if q.dim() == 4 else (lambda x: x[None])
    out = torch.nn.functional.scaled_dot_product_attention(
        *(lift(x).transpose(1, 2) for x in (q, k, v)),
        is_causal=causal).transpose(1, 2)
    return out if q.dim() == 4 else out[0]


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
    wide = dh > 128 or dv > 128
    want = (w or 1) * h * pk.trapezoid_tiles(
        l, causal, pk.FLASH_WIDE_TILES if wide else pk.FLASH_TILES) * (
        -(-dv // 256) if wide else 1)
    shape_of = "causal trapezoid" if causal else "rectangle"
    check(tiles == want, f"the kernel loaded the {shape_of} of its tiles: "
          f"{tiles} KV tiles ({want})")
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
        out["library_rel_vs_float64"] = max_rel(lift(lib)[:, rows],
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


TIMED_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
              "max_abs_err", "rel_vs_float64", "tiles")


def flash_cases():
    """The kernel's phases; returns the timed flagship and dh128 cases and
    the readings of the other timed ones (bf16, the ring's two hop shapes)
    keyed by case."""
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
    # not causal at the flagship length: every row sums all 16384 keys,
    # where a tensor-core sum carried across the KV tiles drifts
    flash_case("full16k", None, f["l"], f["h"], f["dh"], f["dh"], False,
               torch.float32, False, seed=9)
    flash_case("full16k_dh128", None, d["l"], d["h"], d["dh"], d["dh"],
               False, torch.float32, False, seed=10)
    timed = {"bf16": flash_case("bf16", None, f["l"], f["h"], f["dh"],
                                f["dh"], True, torch.bfloat16, True, seed=4)}
    # the ring's hops: W=4 stacked at the local length 8192, hop 0 causal,
    # hops 1-3 not
    r = ATTN_RING
    st = flash_case("stacked", r["workers"], r["l"] // r["workers"], r["h"],
                    r["dh"], r["dh"], True, torch.float32, True, seed=5)
    q, k, v = st["inputs"]
    one = [pk.flash_attention_cuda(q[i], k[i], v[i], True) for i in range(4)]
    check(all(torch.equal(st["out"][i], one[i]) for i in range(4)),
          "a stacked W=4 launch is bitwise 4 separate launches")
    timed["hop_causal"] = st
    timed["hop_full"] = flash_case(
        "stacked_full", r["workers"], r["l"] // r["workers"], r["h"],
        r["dh"], r["dh"], False, torch.float32, True, seed=8)
    return flag, d128, {tag: {key: case[key] for key in TIMED_KEYS}
                        for tag, case in timed.items()}


# --------------------------------------------------------------------------- #
# Main path: blocked, ring and Ulysses attention
# --------------------------------------------------------------------------- #

def counted(fn, path):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after, and no plain call on the card; returns (result, counts, the KV
    tiles the flash kernel counted as loaded in the run)."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    zero_counts()
    with pk.count_flash_tiles() as tiles:
        out = fn()
        torch.cuda.synchronize()
        check_no_plain(path)
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
        lambda: ra.blocked_attention(q, k, v, causal=True),
        f"[attention:blocked] {name}")
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
                a, b, d, causal, use_flash=flash, fused_dma=False), q, k, v)

        out, counts, tiles = counted(ring, f"[attention:ring] {tag}")
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
    # rectangle of their block; hop 0 (causal) must load only the trapezoid
    # of the kernel's tiles, for each (worker, head)
    w, h, local = c["workers"], c["h"], c["l"] // c["workers"]
    hop_full = res["full"]["tiles"] // w
    hop0 = res["causal"]["tiles"] - (w - 1) * hop_full
    full, trap = (pk.trapezoid_tiles(local, cz, pk.FLASH_TILES)
                  for cz in (False, True))
    check(hop_full == w * h * full and hop0 == w * h * trap,
          f"the causal hop loads the trapezoid ({hop0} KV tiles, {trap} a "
          f"worker and head; a full hop {hop_full}, {full} a worker and head "
          f"on {pk.FLASH_TILES[0]} x {pk.FLASH_TILES[1]} tiles)")
    per, busy = device_profile(lambda: sharded(
        sess, lambda a, b, d: ra.ring_attention_mha(a, b, d, True,
                                                    fused_dma=False),
        q, k, v))
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

    out, counts, tiles = counted(uly, "[attention:ulysses]")
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


def flash_wide_phases():
    """[flash:wide] and [attention:wide]: heads past 128 (the kernel's wide
    variant). The kernel alone at Dh = Dv = 256 and at MLA's 192 / 128,
    causal L=16384, H=4, f32, timed; MLA's shape in bf16 at a ragged L and
    Dh = Dv = 512 at L=8192, untimed; blocked_attention at the 256 case
    (one launch a call); one fused causal ring call at W=4, L=32768, 4
    launches with their sends, bitwise the unfused ring and held against
    the float64 reference."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.parallel import ring_attention as ra

    a = ATTN_WIDE
    l, h, dh = a["l"], a["h"], a["dh"]
    d256 = flash_case(f"wide:dh{dh}", None, l, h, dh, dh, True,
                      torch.float32, timed=True, seed=20)
    mdh, mdv = a["mla"]
    mla = flash_case(f"wide:dh{mdh}_dv{mdv}", None, l, h, mdh, mdv, True,
                     torch.float32, timed=True, seed=21)
    del mla["out"], mla["inputs"]
    flash_case(f"wide:dh{mdh}_dv{mdv}_bf16", None, a["ragged_l"], h, mdh,
               mdv, True, torch.bfloat16, False, seed=22)
    top = flash_case(f"wide:dh{a['top']}", None, a["top_l"], a["top_h"],
                     a["top"], a["top"], True, torch.float32, False, seed=23)
    del top["out"], top["inputs"]
    blocked = blocked_phase(f"dh{dh}", d256, dict(l=l, h=h, dh=dh))
    del d256["out"], d256["inputs"]
    torch.cuda.empty_cache()

    w, rl = RING_W, a["ring_l"]
    sess = HarpSession(num_workers=w)
    q, k, v = attn_inputs((rl, h, dh), dh, seed=24)
    log(f"[attention:wide] fused ring: W={w} L={rl} (local {rl // w}) H={h} "
        f"Dh={dh} causal, fused_dma=True against False")

    def ring(fused):
        return sharded(sess, lambda x, y, z: ra.ring_attention_mha(
            x, y, z, True, fused_dma=fused), q, k, v)

    zero_counts()
    out = ring(True)
    counts = read_counts()
    check_no_plain("[attention:wide] ring")
    check(counts["flash_attention"] == w
          and counts["flash_attention_ring"] == w
          and counts["ring_dma_hop"] == 0,
          f"{w} flash_attention launches a call, each with its send, no "
          f"ring_dma_hop ({counts['flash_attention']}, "
          f"{counts['flash_attention_ring']}; {counts['ring_dma_hop']})")
    check(torch.equal(out, ring(False)), "bitwise the unfused ring call")
    rows = sample_rows(rl, seed=24)
    exact = attention_rows(q, k, v, True, rows)[0]
    yard = attention_rows(q, k, v, True, rows, torch.float32)[0]
    err = hold("ring out", out[None][:, rows], yard, exact)
    plain_ms, ms = in_turns(lambda: ring(False), lambda: ring(True), 2,
                            warmup=1)
    log(f"  fused {ms:.4f} ms a call, unfused {plain_ms:.4f} ms")
    del q, k, v, out
    torch.cuda.empty_cache()
    return {"dh256": d256, "mla": mla, "blocked": blocked,
            "ring": {"launches": counts["flash_attention_ring"], "ms": ms,
                     "unfused_ms": plain_ms, "rel_vs_float64": err}}


def attention_phases():
    """Every flash-attention phase; returns the kernels-line entry of
    flash_attention."""
    flag, d128, more = flash_cases()
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
    wide = flash_wide_phases()
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
        **{f"{tag}_{key}": val for tag, case in more.items()
           for key, val in case.items()},
        "crossover": cross,
        **{f"{tag}_{key}": wide[tag][key] for tag in ("dh256", "mla")
           for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms", "max_abs_err", "rel_vs_float64",
                       "tiles")},
        "dh256_blocked_launches": wide["blocked"]["launches"],
        "dh256_blocked_tokens_per_s": wide["blocked"]["tokens_per_s"],
        **{f"dh256_ring_fused_{key}": val
           for key, val in wide["ring"].items()},
    }


# --------------------------------------------------------------------------- #
# Ring DMA: the hop and the allgather, stacked and across processes
# --------------------------------------------------------------------------- #

def ringdma_bound(nbytes):
    """Least time to move a payload: read once and written once at the
    card's memory rate (the engine does no arithmetic)."""
    return 2 * nbytes / PEAK_BYTES_S * 1e3


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
    plain version's; kernel times against the bound and torch.roll, and the
    host µs a call of the wrappers, of ``ring_dma.hop`` inside
    ``HarpSession.spmd`` and of their yardsticks."""
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
    # the host's µs a call (perf_counter, no sync): what paces calls made
    # back to back while the device needs a few µs
    reps = 2000
    hop["host_us"] = host_us(lambda: ring_dma.hop_cuda(f32, 1, g), reps)
    hop["host_us_spmd"] = spmd_loop_us(
        sess, lambda a: ring_dma.hop(a, 1), f32, reps)
    hop["library_host_us"] = host_us(lambda: torch.roll(f32, 1, 0), reps)
    ag["host_us"] = host_us(lambda: ring_dma.ring_allgather_cuda(f32, g),
                            reps)
    ag["host_us_spmd"] = spmd_loop_us(sess, ring_dma.ring_allgather, f32,
                                      reps)
    ag["library_host_us"] = host_us(lambda: f32.flatten(0, 1).clone(), reps)
    steps = ring_host_steps(f32, g, reps)
    hop["host_us_steps"] = {k: v for k, v in steps.items()
                            if not k.startswith("ag_")}
    ag["host_us_steps"] = {k[3:]: v for k, v in steps.items()
                           if k.startswith("ag_")}
    log("  host us a step, alone: " + ", ".join(
        f"{k} {v:.3f}" for k, v in steps.items()))
    log(f"  host us a call, 1 MiB a worker: hop_cuda {hop['host_us']:.3f}, "
        f"ring_dma.hop in HarpSession.spmd {hop['host_us_spmd']:.3f}, "
        f"torch.roll {hop['library_host_us']:.3f}; ring_allgather_cuda "
        f"{ag['host_us']:.3f}, ring_allgather in HarpSession.spmd "
        f"{ag['host_us_spmd']:.3f}, flatten-and-copy "
        f"{ag['library_host_us']:.3f}")
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


def ring_host_steps(x, group, reps):
    """Host µs a call of each step of the stacked ``hop_cuda`` and
    ``ring_allgather_cuda`` on ``x``, alone: the checks, the output's
    allocation, the device index, the raw stream and the ctypes call of the
    stacked entry (into a preallocated output)."""
    from harp_tpu_torch.ops import ring_dma

    lib = ring_dma._lib()
    dev = x.get_device()
    rows, nb = x.shape[0], x[0].numel() * x.element_size()
    out, gathered = torch.empty_like(x), x.flatten(0, 1).clone()
    shape = (group.num_workers * x.shape[1],) + x.shape[2:]

    def check():
        ring_dma._check(x, group, "hop")
        return x.is_cuda

    steps = {
        "check": check,
        "contiguous_empty_like": lambda: torch.empty_like(x.contiguous()),
        "get_device": x.get_device,
        "stream_raw": lambda: ring_dma._stream(dev),
        "launch_stacked": lambda: lib.ring_dma_hop_stacked(
            x.data_ptr(), out.data_ptr(), nb, rows, 1, dev,
            ring_dma._stream(dev)),
        "ag_new_empty": lambda: x.new_empty(shape),
        "ag_launch_stacked": lambda: lib.ring_dma_allgather_stacked(
            x.data_ptr(), gathered.data_ptr(), nb * rows, dev,
            ring_dma._stream(dev)),
    }
    return {k: host_us(fn, reps) for k, fn in steps.items()}


def in_turns4(fn_a, fn_b, reps, warmup=2, timer=cuda_time_ms):
    """CUDA-event ms of ``fn_a`` and ``fn_b`` timed in turns: the readings
    (a, b, b, a), each by ``timer`` (``cuda_time_ms`` or
    ``graph_time_ms``)."""
    a1 = timer(fn_a, reps, warmup)
    b1, b2 = (timer(fn_b, reps, warmup) for _ in range(2))
    return a1, b1, b2, timer(fn_a, reps, warmup)


def in_turns(fn_a, fn_b, reps, warmup=2):
    """CUDA-event ms of ``fn_a`` and ``fn_b`` timed in turns (a, b, b, a),
    each the mean of its two readings."""
    a1, b1, b2, a2 = in_turns4(fn_a, fn_b, reps, warmup)
    return (a1 + a2) / 2, (b1 + b2) / 2


def mfhop_ring_phase(state):
    """[mfhop:ring]: the hop with its in-kernel send (``ring_hop=True``) at
    the flagship's W=4 hop shape, against the pair it replaces (the hop,
    then ``ring_dma.hop_cuda`` of h'): every output bitwise, CUDA-event ms
    of both in turns, and the bound (the hop's, whose bytes already read H
    and write h', plus one more write of H: h_next)."""
    from harp_tpu_torch.ops import pallas_kernels as pk
    from harp_tpu_torch.ops import ring_dma
    from harp_tpu_torch.parallel.mesh import WorkerGroup

    f = MF_FLAGSHIP
    args = (*mf_hop_args(state), f["nmb"], f["lr"], f["lam"])
    slab, _, w, _, _, cc = args[:6]
    nw, _, rpw, cpb = slab.shape
    k = w.shape[-1]
    g = WorkerGroup(nw, slab.device)
    log(f"[mfhop:ring] W={nw} stacked, rpw={rpw} cpb={cpb} K={k} "
        f"nmb={f['nmb']}: dense_mf_hop_cuda(ring_hop=True) against the hop "
        f"and ring_dma.hop_cuda")

    def ring():
        return pk.dense_mf_hop_cuda(*args, ring_hop=True, group=g)

    def pair():
        out = pk.dense_mf_hop_cuda(*args)
        return (*out, ring_dma.hop_cuda(out[1], 1, g))

    got, want = ring(), pair()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "w', h', sse and h_next bitwise the pair's")
    pair_ms, ms = in_turns(pair, ring, 10)
    hop_bound, _ = mf_hop_bound(nw, rpw, cpb, k, cc.shape[2])
    bound, by = mf_hop_bound(nw, rpw, cpb, k, cc.shape[2],
                             extra_bytes=nw * cpb * k * 4)
    log(f"  ring_hop {ms:.4f} ms, the pair {pair_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({by}; the hop's alone {hop_bound:.4f} ms, plus "
        f"the write of h_next)")
    out = {"ms": ms, "pair_ms": pair_ms, "bound_ms": bound, "bound_by": by}
    parent = parent_lib("dense_mf_hop")
    if parent is not None:
        prev = parent_hop(parent, *args, group=g)
        check(torch.equal(prev[3], torch.roll(prev[1], 1, 0)),
              "the parent's send: h_next is its h' rolled by one worker")
        out["turns_ms"] = in_turns4(
            lambda: parent_hop(parent, *args, group=g), ring, 10)
        p1, n1, n2, p2 = out["turns_ms"]
        out["parent_ms"], out["ms_in_turns"] = (p1 + p2) / 2, (n1 + n2) / 2
        log(f"  in turns, parent / new / new / parent: " + " / ".join(
            f"{ms:.4f}" for ms in out["turns_ms"]) + f" ms (the parent's "
            f"ring_hop {out['parent_ms']:.4f}, this tree's "
            f"{out['ms_in_turns']:.4f})")
    return out


def flash_ring_phase():
    """[flash:ring]: flash attention with its in-kernel send at the ring's
    hop shape (W=4 stacked, L=8192 local, H=8, Dh=64, not causal) against
    the pair it replaces (the kernel, then ``ring_dma.hop_cuda`` of k and of
    v): every output bitwise, CUDA-event ms of both in turns, and the bound
    (the flash bound, whose bytes already read k and v, plus one more
    write of them: k_next, v_next)."""
    from harp_tpu_torch.ops import pallas_kernels as pk
    from harp_tpu_torch.ops import ring_dma
    from harp_tpu_torch.parallel.mesh import WorkerGroup

    c = ATTN_RING
    w, l = c["workers"], c["l"] // c["workers"]
    q, k, v = attn_inputs((w, l, c["h"], c["dh"]), c["dh"], seed=12)
    g = WorkerGroup(w, q.device)
    log(f"[flash:ring] W={w} stacked, L={l} H={c['h']} Dh={c['dh']} full "
        f"f32: flash_attention_cuda(ring_hop=True) against the kernel and "
        f"two ring_dma.hop_cuda")

    def ring():
        return pk.flash_attention_cuda(q, k, v, False, True, ring_hop=True,
                                       group=g)

    def pair():
        return (*pk.flash_attention_cuda(q, k, v, False, True),
                ring_dma.hop_cuda(k, 1, g), ring_dma.hop_cuda(v, 1, g))

    got, want = ring(), pair()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "out, m, den, k_next and v_next bitwise the pair's")
    pair_ms, ms = in_turns(pair, ring, 5, warmup=1)
    kv_bytes = k.numel() * 4 + v.numel() * 4
    bound, by, _ = flash_bound(w, l, c["h"], c["dh"], c["dh"], False, 4,
                               kv_bytes)
    log(f"  ring_hop {ms:.4f} ms, the pair {pair_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({by})")
    return {"ms": ms, "pair_ms": pair_ms, "bound_ms": bound, "bound_by": by}


def mf_fused_config(**kw):
    from harp_tpu_torch.models import sgd_mf

    f = MF_FLAGSHIP
    return sgd_mf.SGDMFConfig(**{
        "rank": f["rank"], "lam": f["lam"], "lr": f["lr"],
        "epochs": f["epochs"], "minibatches_per_hop": f["nmb"],
        "layout": "dense", **kw})


@functools.lru_cache(maxsize=1)
def mf_fused_data():
    """The SGD-MF flagship's ratings, made once a process (``[ckpt]`` and
    ``[sgd_mf:fused]`` share them; nothing writes into them)."""
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


def kmeans_mp_fit(sess, c=KMEANS_MP):
    """The fit ``c`` (KMEANS_MP or KMEANS_WIDE_MP) on ``sess`` (stacked
    W=4, or one process of the 4-process group): sha256 of its centroids,
    its per-iteration costs and the counts of one more E-step from the
    final centroids (summed over the workers), with the fit's launch and
    plain-call counts and the seconds the whole took (data included)."""
    import hashlib

    from harp_tpu_torch.collectives import lax_ops
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import kmeans as km
    from harp_tpu_torch.ops import pallas_kernels as pk

    t0 = time.perf_counter()
    if c.get("on_card"):
        pts, cen0 = card_points(c["n"], c["d"], c["k"], c["seed"])
    else:
        pts = datagen.dense_points(c["n"], c["d"], seed=c["seed"],
                                   num_clusters=c["k"])
        cen0 = datagen.initial_centroids(pts, c["k"], seed=c["seed"] + 1)
    model = km.KMeans(sess, km.KMeansConfig(c["k"], c["d"], c["iterations"],
                                            "regroupallgather",
                                            quant=c.get("quant")))
    p, c0 = model.prepare(pts, cen0)
    del pts
    zero_counts()
    cen, costs = model.fit_prepared(p, c0)
    launches, plain = read_counts(), plain_counts()
    counts = sess.run(
        lambda x, cc: lax_ops.allreduce(pk.kmeans_stats(x, cc)[1]), p,
        cen.contiguous(), in_specs=(sess.shard(), sess.replicate()),
        out_specs=sess.replicate())
    h = hashlib.sha256()
    for t in (cen, costs, counts):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return {"digest": h.hexdigest(), "launches": launches, "plain": plain,
            "cost": float(costs[-1]), "seconds": time.perf_counter() - t0}


def kmeans_mp_launches_ok(launches, c):
    """One kmeans_stats launch an iteration of fit ``c``, each of the wide
    variant past one block's shared memory and none of it below."""
    from harp_tpu_torch.ops import pallas_kernels as pk

    wide = pk.kmeans_smem_bytes(c["d"], c["k"]) > pk.MAX_SMEM_BYTES
    return (launches["kmeans_stats"] == c["iterations"]
            and launches["kmeans_stats_wide"] == c["iterations"] * wide)


def kmeans_mp_stacked(c=KMEANS_MP, name="[kmeans:stacked]"):
    """The stacked W=4 side of a [ringdma:mp] K-means fit, in this
    process."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.ops import pallas_kernels as pk

    per = c["n"] // RING_W
    lib = pk._kmeans_lib()
    if pk.kmeans_smem_bytes(c["d"], c["k"]) > pk.MAX_SMEM_BYTES:
        grid = lib.kmeans_stats_wide_grid(per, c["d"], c["k"])
    else:
        grid = lib.kmeans_stats_grid(per, c["d"], c["k"], c["k"], 0)
    log(f"{name} W={RING_W} in one process: n={c['n']} ({per} a "
        f"worker, {-(-per // 64)} tiles, grid {grid} blocks a worker), "
        f"k={c['k']}, d={c['d']}, regroupallgather, {c['iterations']} "
        f"iterations")
    ref = kmeans_mp_fit(HarpSession(num_workers=RING_W), c)
    check(kmeans_mp_launches_ok(ref["launches"], c),
          f"one stacked kmeans_stats launch an iteration "
          f"({ref['launches']['kmeans_stats']}, wide "
          f"{ref['launches']['kmeans_stats_wide']})")
    check_no_plain(name, ref["plain"])
    log(f"  final cost {ref['cost']:.8g}, digest {ref['digest'][:16]}, "
        f"{ref['seconds']:.2f} s")
    return ref


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
    against fused_dma=False, bitwise: on one slice the hop kernel's
    in-kernel send (one dense_mf_hop launch a rotation step, each with the
    send, no ring_dma_hop), on two slices the out-of-kernel hop (one
    ring_dma_hop and one dense_mf_hop launch a micro-step); and
    [mfhop:ring] on the 1-slice state."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.models import sgd_mf

    f = MF_FLAGSHIP
    rows, cols, vals = mf_fused_data()
    sess = HarpSession(num_workers=RING_W)
    cfg = mf_fused_config(fused_dma=True)
    model = sgd_mf.SGDMF(sess, cfg)
    if RING_W in MF_FUSED_STATE:              # prepared by [ckpt]
        state, nnz = MF_FUSED_STATE.pop(RING_W)
    else:
        state = model.prepare(rows, cols, vals, f["users"], f["items"],
                              seed=0)
        nnz = model.last_layout_stats["nnz"]
    log(f"[sgd_mf:fused] stacked W={RING_W}: {f['users']}x{f['items']}, "
        f"{f['density']:g}, rank {f['rank']}, {f['nmb']} minibatches a hop, "
        f"{f['epochs']} epochs, dense, nnz={nnz}")
    zero_counts()
    out_w, out_h, rmse = model.train_prepared(state)
    counts = read_counts()
    check_no_plain("[sgd_mf:fused] stacked")
    steps = f["epochs"] * RING_W
    check(counts["dense_mf_hop"] == steps
          and counts["dense_mf_hop_ring"] == steps
          and counts["ring_dma_hop"] == 0 and counts["ring_recv"] == 0,
          f"one dense_mf_hop launch a rotation step, each with the in-kernel "
          f"send, and no ring_dma_hop or receive kernel (stacked) "
          f"({counts['dense_mf_hop']}, {counts['dense_mf_hop_ring']} = "
          f"{steps}; {counts['ring_dma_hop']}, {counts['ring_recv']})")
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
    ring = mfhop_ring_phase(state)
    quant = {1: mf_quant_case(sess, state, 1, rmse)}
    del state, model, plain
    torch.cuda.empty_cache()

    log(f"[sgd_mf:fused] stacked W={RING_W}, 2 slices: the same data, "
        f"fused_dma=True against False")
    cfg2 = mf_fused_config(fused_dma=True, num_slices=2)
    model2 = sgd_mf.SGDMF(sess, cfg2)
    state2 = model2.prepare(rows, cols, vals, f["users"], f["items"], seed=0)
    zero_counts()
    fit2 = model2.train_prepared(state2)
    counts2 = read_counts()
    check_no_plain("[sgd_mf:fused] stacked, 2 slices")
    micro = 2 * steps
    check(counts2["ring_dma_hop"] == micro and counts2["dense_mf_hop"] == micro
          and counts2["dense_mf_hop_ring"] == 0,
          f"one ring_dma_hop and one dense_mf_hop launch a micro-step, no "
          f"in-kernel send ({counts2['ring_dma_hop']}, "
          f"{counts2['dense_mf_hop']} = {micro}; "
          f"{counts2['dense_mf_hop_ring']})")
    unfused2 = sgd_mf.SGDMF(sess, mf_fused_config(
        fused_dma=False, num_slices=2)).train_prepared(state2)
    check(all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
              for a, b in zip(fit2, unfused2)),
          "2 slices: factors and RMSEs bitwise the fused_dma=False fit")
    fused2_tp = mf_rates(lambda e: sgd_mf.SGDMF(sess, mf_fused_config(
        fused_dma=True, num_slices=2, epochs=e)), state2, nnz)
    plain2_tp = mf_rates(lambda e: sgd_mf.SGDMF(sess, mf_fused_config(
        fused_dma=False, num_slices=2, epochs=e)), state2, nnz)
    log(f"  two-point, 2 slices: fused {fused2_tp['rate']:.6g} ratings/s "
        f"({fused2_tp['per_iter_ms']:.4f} ms an epoch), unfused "
        f"{plain2_tp['rate']:.6g} ({plain2_tp['per_iter_ms']:.4f} ms)")
    quant[2] = mf_quant_case(sess, state2, 2, fit2[2])
    return {"launches": counts, "launches2": counts2, "digest": digest,
            "rmse": [float(r) for r in rmse], "nnz": nnz,
            "ratings_per_s": fused_tp["rate"],
            "per_epoch_ms": fused_tp["per_iter_ms"],
            "unfused_ratings_per_s": plain_tp["rate"],
            "unfused_per_epoch_ms": plain_tp["per_iter_ms"],
            "two_slice_per_epoch_ms": fused2_tp["per_iter_ms"],
            "two_slice_unfused_per_epoch_ms": plain2_tp["per_iter_ms"],
            "ring_hop": ring, "quant": quant}


def mf_quant_case(sess, state, ns, rmse32):
    """[sgd_mf:quant]: the fused-asked flagship fit on ``ns`` slices with
    the int8 and bf16 wires: the RMSE trajectory within atol 0.02 of the
    float32 fit (tests/test_quantize.py:354-371), one hop-kernel launch a
    rotation step as the float32 fit makes, no in-kernel send and no ring
    hop (a quantized wire takes precedence over fused_dma); ms an epoch in
    turns against the unfused float32 fit."""
    from harp_tpu_torch.models import sgd_mf

    f = MF_FLAGSHIP
    steps = f["epochs"] * RING_W * ns
    log(f"[sgd_mf:quant] stacked W={RING_W}, {ns} slice{'s' * (ns > 1)}, "
        f"fused_dma=True asked, int8 and bf16 against the float32 fit")
    out = {}
    f32 = sgd_mf.SGDMF(sess, mf_fused_config(fused_dma=False,
                                             num_slices=ns))
    for codec in ("int8", "bf16"):
        model = sgd_mf.SGDMF(sess, mf_fused_config(
            fused_dma=True, num_slices=ns, quant=codec))
        zero_counts()
        _, _, rmse = model.train_prepared(state)
        counts = read_counts()
        check_no_plain(f"[sgd_mf:quant] {ns} slices {codec}")
        d = float(np.abs(np.asarray(rmse) - np.asarray(rmse32)).max())
        check(counts["dense_mf_hop"] == steps
              and counts["dense_mf_hop_ring"] == 0
              and counts["ring_dma_hop"] == 0 and counts["ring_recv"] == 0
              and bool(np.all(np.isfinite(rmse))) and d <= 0.02,
              f"{codec}: {counts['dense_mf_hop']} dense_mf_hop launches (= "
              f"{steps}, as the float32 fit), {counts['dense_mf_hop_ring']} "
              f"in-kernel sends, {counts['ring_dma_hop']} ring hops; RMSE "
              f"{rmse[0]:.5f} -> {rmse[-1]:.5f} within {d:.3g} (<= 0.02) of "
              f"the float32 fit")
        ms32, msq = in_turns(lambda: f32.train_prepared(state),
                             lambda: model.train_prepared(state), 3,
                             warmup=1)
        log(f"  {codec}: {msq / f['epochs']:.4f} ms an epoch against "
            f"{ms32 / f['epochs']:.4f} float32 unfused, in turns")
        out[codec] = {"launches": counts["dense_mf_hop"],
                      "rmse_dist": d, "per_epoch_ms": msq / f["epochs"],
                      "f32_per_epoch_ms": ms32 / f["epochs"]}
    return out


def ring_digest(out) -> str:
    """sha256 of a ring attention output's bytes."""
    import hashlib

    return hashlib.sha256(out.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def ring_fused_phase():
    """[attention:ring fused]: ring attention at W=4, L=32768, causal, with
    the (k, v) hops inside the W flash launches (the in-kernel send), bitwise
    the unfused ring; [flash:ring] after it."""
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
    check_no_plain("[attention:ring fused]")
    w = c["workers"]
    check(counts["flash_attention"] == w
          and counts["flash_attention_ring"] == w
          and counts["ring_dma_hop"] == 0 and counts["ring_recv"] == 0,
          f"{w} flash_attention launches a call, each with the in-kernel "
          f"send, and no ring_dma_hop or receive kernel (stacked) "
          f"({counts['flash_attention']}, {counts['flash_attention_ring']}; "
          f"{counts['ring_dma_hop']}, {counts['ring_recv']})")
    check(torch.equal(out, ring(False)), "bitwise the unfused ring call")
    plain_ms, ms = in_turns(lambda: ring(False), lambda: ring(True), 3,
                            warmup=1)
    log(f"  fused {ms:.4f} ms a call, unfused {plain_ms:.4f} ms")
    res = {"launches": counts, "ms": ms, "unfused_ms": plain_ms,
           "digest": ring_digest(out)}
    del q, k, v, out
    torch.cuda.empty_cache()
    res["ring_hop"] = flash_ring_phase()
    return res


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

    # 200 back-to-back dense-MF in-kernel sends, rank 1 held back the same
    # way: an all-missing slab with zero counts leaves H as it was, so every
    # h_next must be the left neighbour's block of the same iteration
    from harp_tpu_torch.ops import pallas_kernels as pk

    slab = torch.full((1, 1, 16, 1000), float("nan"),
                      device=CARD).bfloat16()
    mf = (slab, torch.zeros(1, dtype=torch.int32, device=CARD),
          torch.ones(1, 16, 16, device=CARD))
    h = torch.empty((1, 1000, 16), device=CARD)
    counts = (torch.zeros(1, 1, 16, device=CARD),
              torch.zeros(1, 1, 1, 1000, device=CARD))
    bad.zero_()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for it in range(CREDIT_HOPS):
        if rank == 1:
            torch.cuda._sleep(20_000 * (it % 13))
        h.fill_(rank * 1000 + it)
        got = pk.dense_mf_hop_cuda(*mf, h, *counts, 1, 0.05, 0.01,
                                   ring_hop=True, group=g)[3]
        bad += (got != ((rank - 1) % RING_W) * 1000 + it).sum()
    torch.cuda.synchronize()
    out["mf_credit_mismatches"] = int(bad)
    out["mf_credit_s"] = time.perf_counter() - t0
    ring_dma.check_errors()

    # the causal ring attention call of [attention:ring fused], 4 processes
    # x 1 worker, fused (the in-kernel sends) and unfused
    from harp_tpu_torch.parallel import ring_attention as ra

    c = ATTN_RING
    q, k, v = (sess.scatter(t) for t in attn_inputs(
        (c["l"], c["h"], c["dh"]), c["dh"], seed=6))

    def ring(fused):
        return sharded(sess, lambda a, b, d: ra.ring_attention_mha(
            a, b, d, True, fused_dma=fused), q, k, v)

    zero_counts()
    got = ring(True)
    out["ring_launches"] = read_counts()
    out["ring_plain"] = plain_counts()
    out["ring_digest"] = ring_digest(distributed.gather_rows(got))
    out["ring_unfused_bitwise"] = bool(torch.equal(got, ring(False)))
    for name, fused in (("ring_ms", True), ("ring_unfused_ms", False)):
        torch.cuda.synchronize()
        dist.barrier()
        out[name] = cuda_time_ms(lambda: ring(fused), reps=3, warmup=1)
    ring_dma.check_errors()
    del q, k, v, got
    torch.cuda.empty_cache()

    # the SGD-MF flagship, 4 processes x 1 worker, fused_dma=True
    f = MF_FLAGSHIP
    rows, cols, vals = mf_fused_data()
    model = sgd_mf.SGDMF(sess, mf_fused_config(fused_dma=True))
    state = model.prepare(rows, cols, vals, f["users"], f["items"], seed=0)
    nnz = model.last_layout_stats["nnz"]
    zero_counts()
    out_w, out_h, rmse = model.train_prepared(state)
    out["launches"] = read_counts()
    out["plain"] = plain_counts()
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
    del state, model
    torch.cuda.empty_cache()

    # the fused 1-slice fit at rank 256 of [sgd_mf:rank256]: the wide path's
    # in-kernel send between processes
    m = MF_WIDE
    model = sgd_mf.SGDMF(sess, mf_fused_config(
        fused_dma=True, rank=m["rank"], epochs=m["fused_epochs"]))
    state = model.prepare(rows, cols, vals, f["users"], f["items"], seed=0)
    zero_counts()
    out_w, out_h, rmse = model.train_prepared(state)
    out["wide_launches"] = read_counts()
    out["wide_plain"] = plain_counts()
    out["wide_digest"] = factor_digest(pull_factors(sess, out_w, out_h), rmse)
    ring_dma.check_errors()
    del state, model, out_w, out_h
    torch.cuda.empty_cache()
    out["kmeans"] = kmeans_mp_fit(sess)
    torch.cuda.empty_cache()
    out["kmeans_wide"] = kmeans_mp_fit(sess, KMEANS_WIDE_MP)
    torch.cuda.empty_cache()
    out["stats_pca"] = pca_mp_digest(sess)
    out["keyed"] = keyed_mp_digests(sess)
    out["kmeans_quant"] = kmeans_mp_fit(sess, KMEANS_QUANT)
    torch.cuda.empty_cache()
    out["nn"] = nn_mp_digest(sess)
    out["quant_ar"] = quant_ar_digest(sess)
    # the fused LDA fit of [lda:fused] at n/4 docs: the ring hop between
    # processes
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import lda

    c = LDA_FUSED
    # lda_corpus draws document by document: its first mp_docs documents
    # are those of the full corpus
    docs = datagen.lda_corpus(c["mp_docs"], c["vocab"],
                              max(2, c["topics"] // 2), c["doc_len"], seed=3)
    model = lda.LDA(sess, lda.LDAConfig(num_topics=c["topics"],
                                        vocab=c["vocab"], epochs=c["epochs"],
                                        fused_dma=True))
    state = model.prepare(docs, seed=1)
    zero_counts()
    dt, wt, ll = model.fit_prepared(state)
    out["lda_launches"] = read_counts()
    out["lda_plain"] = plain_counts()
    out["lda"] = lda_digest(dt, wt, ll)
    ring_dma.check_errors()
    del state, model, docs, dt, wt
    torch.cuda.empty_cache()
    # the streamed fit of [ingest]: part-files of this process through the
    # reader pool and the H2D prefetch into fit_from_stream
    out["stream"] = stream_fit_digest(sess)
    # the host event plane and telemetry across the gang (four profiler
    # windows on one card at once)
    from harp_tpu_torch.parallel import mp_smoke

    t0 = time.perf_counter()
    out["events"] = mp_smoke.event_telemetry_checks(sess)
    out["events"]["seconds"] = time.perf_counter() - t0
    distributed.shutdown()
    print("MP_CHILD " + json.dumps(out), flush=True)
    return 0


def ringdma_mp(stacked_mf, stacked_km, stacked_ring, stacked_kmw,
               stacked_wide, stacked_stats, stacked_new):
    """[ringdma:mp] and [sgd_mf:fused] across 4 processes on the card,
    through the port's launcher, the fused causal ring attention call, the
    fused rank-256 SGD-MF fit (the wide path's send; ``stacked_wide`` the
    digest of its stacked twin), the K-means fits at n = 1M (k = 100, and
    k = 1024, d = 128 through the wide variant), and a PCA fit and the
    keyed shuffle (``stacked_stats``: their stacked twins' digests), the
    int8 regroupallgather K-means fit, a 2-epoch NN fit and an int8
    allreduce with residual (``stacked_new``) across 4 processes; any
    child's failure fails the run."""
    from harp_tpu_torch.parallel import launch

    log(f"[ringdma:mp] {RING_W} processes x 1 worker on the card (the "
        f"port's launcher): hop and ring_allgather against the gloo plain "
        f"version at {', '.join(str(b) for b in RING_MP_BYTES)} bytes a "
        f"worker, {CREDIT_HOPS} credit hops and dense-MF sends, the fused "
        f"ring attention call, the SGD-MF flagship fused")
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
    check(all(o["mf_credit_mismatches"] == 0 for o in outs.values()),
          f"{CREDIT_HOPS} back-to-back dense-MF in-kernel sends with rank 1 "
          f"held back: every h_next bitwise on every rank "
          f"({[round(o['mf_credit_s'], 3) for o in outs.values()]} s)")
    w = ATTN_RING["workers"]
    for i, o in outs.items():
        c = o["ring_launches"]
        check(c["flash_attention"] == w and c["flash_attention_ring"] == w
              and c["ring_recv"] == w and c["ring_dma_hop"] == 0,
              f"rank {i}, the fused ring call: {w} flash_attention launches, "
              f"each with the in-kernel send and its receive launch, no "
              f"ring_dma_hop ({c['flash_attention']}, "
              f"{c['flash_attention_ring']}, {c['ring_recv']}, "
              f"{c['ring_dma_hop']})")
        check_no_plain(f"[ringdma:mp] ring attention fused, rank {i}",
                       o["ring_plain"])
    check(all(o["ring_digest"] == stacked_ring["digest"]
              and o["ring_unfused_bitwise"] for o in outs.values()),
          f"ring attention, 4 processes x 1 worker, L={ATTN_RING['l']} "
          f"causal: bitwise the stacked call and the unfused call")
    log(f"  ring attention 4 processes: fused "
        f"{[round(o['ring_ms'], 4) for o in outs.values()]} ms a call, "
        f"unfused {[round(o['ring_unfused_ms'], 4) for o in outs.values()]}")
    steps = MF_FLAGSHIP["epochs"] * RING_W
    for i, o in outs.items():
        c, p = o["launches"], o["pull_launches"]
        check(c["dense_mf_hop"] == steps and c["dense_mf_hop_ring"] == steps
              and c["ring_recv"] == steps and c["ring_dma_hop"] == 0
              and c["ring_allgather"] == 0,
              f"rank {i}, the fit: {steps} dense_mf_hop launches, each with "
              f"the in-kernel send and its receive launch, no ring_dma_hop "
              f"or ring_allgather ({c['dense_mf_hop']}, "
              f"{c['dense_mf_hop_ring']}, {c['ring_recv']}, "
              f"{c['ring_dma_hop']}, {c['ring_allgather']})")
        check(p["ring_allgather"] == 2 and p["ring_dma_hop"] == 0,
              f"rank {i}, table_ops.pull(fused=True) of W and H: 2 "
              f"ring_allgather launches ({p['ring_allgather']})")
        check_no_plain(f"[ringdma:mp] SGD-MF fused, rank {i}", o["plain"])
        for key, c, what in (("kmeans", KMEANS_MP, "K-means"),
                             ("kmeans_wide", KMEANS_WIDE_MP,
                              "K-means wide")):
            kmo = o[key]
            check(kmeans_mp_launches_ok(kmo["launches"], c),
                  f"rank {i}, the {what} fit: one kmeans_stats launch an "
                  f"iteration ({kmo['launches']['kmeans_stats']}, wide "
                  f"{kmo['launches']['kmeans_stats_wide']})")
            check_no_plain(f"[ringdma:mp] {what}, rank {i}", kmo["plain"])
    check(all(o["digest"] == stacked_mf["digest"] for o in outs.values()),
          "SGD-MF fused, 4 processes: factors (pulled through the fused "
          "allgather) and RMSEs bitwise the stacked fit")
    m = MF_WIDE
    steps_w = m["fused_epochs"] * RING_W
    for i, o in outs.items():
        c = o["wide_launches"]
        check(c["dense_mf_hop"] == steps_w
              and c["dense_mf_hop_ring"] == steps_w
              and c["ring_recv"] == steps_w and c["ring_dma_hop"] == 0,
              f"rank {i}, the fused rank-{m['rank']} fit: {steps_w} "
              f"dense_mf_hop launches (the wide path), each with the "
              f"in-kernel send and its receive launch, no ring_dma_hop "
              f"({c['dense_mf_hop']}, {c['dense_mf_hop_ring']}, "
              f"{c['ring_recv']}, {c['ring_dma_hop']})")
        check_no_plain(f"[ringdma:mp] SGD-MF rank {m['rank']} fused, rank "
                       f"{i}", o["wide_plain"])
    check(all(o["wide_digest"] == stacked_wide for o in outs.values()),
          f"SGD-MF rank {m['rank']} fused, 4 processes x 1 worker, "
          f"{m['fused_epochs']} epochs: factors and RMSEs bitwise the stacked "
          f"fused fit")
    check(all(o["kmeans"]["digest"] == stacked_km["digest"]
              for o in outs.values()),
          f"K-means, 4 processes x 1 worker, n={KMEANS_MP['n']}: centroids, "
          f"counts and costs bitwise the stacked W={RING_W} fit")
    c = KMEANS_WIDE_MP
    check(all(o["kmeans_wide"]["digest"] == stacked_kmw["digest"]
              for o in outs.values()),
          f"K-means wide, 4 processes x 1 worker, n={c['n']}, k={c['k']}, "
          f"d={c['d']}: centroids, counts and costs bitwise the stacked "
          f"W={RING_W} fit")
    log(f"  K-means wide in each process "
        f"{[round(o['kmeans_wide']['seconds'], 2) for o in outs.values()]} "
        f"s (data drawn, {c['iterations']} iterations, one more E-step)")
    p = STATS_PCA
    check(all(o["stats_pca"] == stacked_stats["pca"] for o in outs.values()),
          f"PCA fit, 4 processes x 1 worker, n={p['mp_n']}, d={p['d']}: "
          f"eigenvalues, components and mean bitwise the stacked W={RING_W} "
          f"fit")
    for name, want in stacked_stats["keyed"].items():
        check(all(o["keyed"][name] == want for o in outs.values()),
              f"group_by_key_sharded, {name} keys, 4 processes x 1 worker, "
              f"{KEYED['mp_n']} records a worker: combined values and "
              f"overflow bitwise the stacked W={RING_W} run")
    for i, o in outs.items():
        kmo = o["kmeans_quant"]
        check(kmeans_mp_launches_ok(kmo["launches"], KMEANS_QUANT),
              f"rank {i}, the int8 K-means fit: one kmeans_stats launch an "
              f"iteration ({kmo['launches']['kmeans_stats']})")
        check_no_plain(f"[ringdma:mp] K-means int8, rank {i}", kmo["plain"])
    check(all(o["kmeans_quant"]["digest"] == stacked_new["kmeans_quant"]
              for o in outs.values()),
          f"K-means int8 regroupallgather, 4 processes x 1 worker, "
          f"n={KMEANS_QUANT['n']}: centroids, counts and costs bitwise the "
          f"stacked W={RING_W} fit")
    check(all(o["nn"] == stacked_new["nn"] for o in outs.values()),
          f"NN, 4 processes x 1 worker, n={NN['mp_n']}, "
          f"{NN['check_epochs']} epochs: losses and parameters bitwise the "
          f"stacked W={RING_W} fit")
    ep = LDA_FUSED["epochs"]
    for i, o in outs.items():
        c = o["lda_launches"]
        check(c["ring_dma_hop"] == ep * RING_W,
              f"rank {i}, the fused LDA fit: {ep * RING_W} ring_dma_hop "
              f"launches ({c['ring_dma_hop']})")
        check_no_plain(f"[ringdma:mp] LDA fused, rank {i}", o["lda_plain"])
    check(all(o["lda"] == stacked_new["lda"] for o in outs.values()),
          f"LDA CGS fused, 4 processes x 1 worker, {LDA_FUSED['mp_docs']} "
          f"docs of the clueweb regime, {ep} epochs: doc_topic, word_topic "
          f"and log-likelihoods bitwise the stacked W={RING_W} fit")
    m = INGEST_MP
    for i, o in outs.items():
        st = o["stream"]
        check(st["launches"]["kmeans_stats"] == m["iterations"],
              f"rank {i}, the streamed fit: one kmeans_stats launch an "
              f"iteration ({st['launches']['kmeans_stats']})")
        check_no_plain(f"[ringdma:mp] streamed K-means, rank {i}",
                       st["plain"])
    check(all(o["stream"]["digest"] == stacked_new["stream"]
              for o in outs.values()),
          f"streamed K-means (fit_from_stream through DevicePrefetcher), 4 "
          f"processes x 1 worker, {m['parts']} parts x {m['rows']} rows: "
          f"centroids and costs bitwise the stacked W={RING_W} fit")
    ev = [o["events"] for o in outs.values()]
    check(all(e["suspects"] == [1] and e["bsp_suspects"] == []
              and e["trace_bytes"] > 0 for e in ev),
          f"the event plane across {RING_W} processes: a collective event "
          f"from rank 0 on every rank, send_event(dest=...) refused, the "
          f"straggler report from scripted walls flags rank 1 only (rank 0 "
          f"wrote it), a profiler trace under every rank's directory "
          f"({[e['trace_bytes'] for e in ev]} B; "
          f"{[round(e['seconds'], 2) for e in ev]} s)")
    check(all(o["quant_ar"] == stacked_new["quant_ar"]
              for o in outs.values()),
          f"int8 allreduce with residual, 4 processes x 1 worker: result "
          f"and residuals bitwise the stacked W={RING_W} call")
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


def ringdma_phases(stacked_wide, stacked_stats, stacked_new):
    """Every ring-DMA phase (``stacked_wide``: the digest of the stacked
    fused rank-256 SGD-MF fit, ``stacked_stats`` those of the PCA and
    keyed-shuffle twins, ``stacked_new`` those of the quantized K-means,
    NN and quantized allreduce twins, for their 4-process twins); returns
    the
    ring_hop records of the dense-MF and flash kernels and the kernels-line
    entries of the hop and the allgather."""
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
    km = kmeans_mp_stacked()
    torch.cuda.empty_cache()
    kmw = kmeans_mp_stacked(KMEANS_WIDE_MP, "[kmeans:wide stacked]")
    torch.cuda.empty_cache()
    mp = ringdma_mp(mf, km, attn, kmw, stacked_wide, stacked_stats,
                    stacked_new)                       # each child checks
    mp_smoke_phase()
    mb = str(1 << 20)
    mf_ring = {"launches": mf["launches"]["dense_mf_hop_ring"],
               "mp_launches": mp[0]["launches"]["dense_mf_hop_ring"],
               "mp_recv_launches": mp[0]["launches"]["ring_recv"],
               "mp_wide_launches": mp[0]["wide_launches"]["dense_mf_hop_ring"],
               **mf["ring_hop"], "quant": mf["quant"]}
    flash_ring = {
        "launches": attn["launches"]["flash_attention_ring"],
        "mp_launches": mp[0]["ring_launches"]["flash_attention_ring"],
        "mp_recv_launches": mp[0]["ring_launches"]["ring_recv"],
        **attn["ring_hop"]}
    return mf_ring, flash_ring, [{
        "name": "ring_dma_hop", "route": "cuda",
        "source": "harp_tpu_torch/csrc/ring_dma.cu",
        "replaces": "harp_tpu/ops/ring_dma.py:224",
        "launches": mf["launches2"]["ring_dma_hop"],
        "launches_path": "the 2-slice fused SGD-MF flagship fit at W=4",
        "one_slice_fit_launches": mf["launches"]["ring_dma_hop"],
        "max_abs_err": 0.0,
        "ms": hop["ms"], "plain_ms": hop["plain_ms"],
        "bound_ms": hop["bound_ms"], "bound_by": "bytes",
        "library_ms": hop["library_ms"], "ms_4kib": hop["ms_4kib"],
        "library_ms_4kib": hop["library_ms_4kib"],
        "device_ms": hop["device_ms"], "device_ms_4kib": hop["device_ms_4kib"],
        "host_us": hop["host_us"], "host_us_spmd": hop["host_us_spmd"],
        "library_host_us": hop["library_host_us"],
        "host_us_steps": hop["host_us_steps"],
        "mp_launches": mp[0]["launches"]["ring_dma_hop"],
        "lda_mp_launches": mp[0]["lda_launches"]["ring_dma_hop"],
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
        "fit_unfused_per_epoch_ms": mf["unfused_per_epoch_ms"],
        "two_slice_fit_per_epoch_ms": mf["two_slice_per_epoch_ms"],
        "two_slice_fit_unfused_per_epoch_ms":
            mf["two_slice_unfused_per_epoch_ms"],
        "mp_fit_ratings_per_s": mp[0]["ratings_per_s"],
        "mp_fit_per_epoch_ms": mp[0]["per_epoch_ms"],
        "mp_fit_staged_ratings_per_s": mp[0]["staged_ratings_per_s"],
        "mp_fit_staged_per_epoch_ms": mp[0]["staged_per_epoch_ms"],
        "ring_attention_launches": attn["launches"]["ring_dma_hop"],
        "ring_attention_fused_ms": attn["ms"],
        "ring_attention_unfused_ms": attn["unfused_ms"],
        "mp_ring_attention_fused_ms": [mp[i]["ring_ms"] for i in mp],
        "mp_ring_attention_unfused_ms": [mp[i]["ring_unfused_ms"]
                                         for i in mp],
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
        "host_us": ag["host_us"], "host_us_spmd": ag["host_us_spmd"],
        "library_host_us": ag["library_host_us"],
        "host_us_steps": ag["host_us_steps"],
        "mp_ms_by_bytes": {b: [mp[i]["sizes"][str(b)]["allgather_ms"]
                               for i in mp] for b in RING_MP_BYTES},
        "mp_ms_1mib": mp[0]["sizes"][mb]["allgather_ms"],
        "mp_library_ms": None,
    }]


# --------------------------------------------------------------------------- #
# The statistics path: PCA, the dense suite, the CSR family and the keyed
# shuffle (float32 torch.matmul and torch.linalg; no TPU kernel on it)
# --------------------------------------------------------------------------- #

def digest(*arrays) -> str:
    """sha256 of the bytes of host arrays or tensors, in order."""
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def spiked_points(c):
    """``dense_points`` plus 8 strong directions of ``c["spikes"]`` times
    the data's spread: 8 correlation eigenvalues far apart from the rest
    and from each other."""
    from harp_tpu_torch.io import datagen

    x = datagen.dense_points(c["n"], c["d"], seed=c["seed"])
    rng = np.random.default_rng(c["seed"] + 1)
    q, _ = np.linalg.qr(rng.standard_normal((c["d"], len(c["spikes"]))))
    z = rng.random((c["n"], len(c["spikes"])), dtype=np.float32)
    return x + (z * np.float32(c["spikes"])) @ q.T.astype(np.float32)


def check_pca(name, w, comps, x, ref=None):
    """Eigenvalues within 1e-3 relative of float64 ``eigvalsh(np.corrcoef)``
    (tests/test_stats.py:38), components orthonormal within 1e-4, and each
    component whose eigenvalue lies more than 1 % from its neighbours'
    within |dot| >= 1 - 1e-3 of its float64 counterpart. Returns the
    reference (eigenvalues, components) for reuse."""
    if ref is None:
        rw, rv = np.linalg.eigh(np.corrcoef(x, rowvar=False))
        ref = rw[::-1], rv[:, ::-1].T
    rw, rv = ref
    w64, c64 = np.asarray(w, np.float64), np.asarray(comps, np.float64)
    rel = float(np.max(np.abs(w64 - rw) / np.abs(rw)))
    orth = float(np.abs(c64 @ c64.T - np.eye(len(w64))).max())
    gap = np.full(len(rw), np.inf)
    gap[1:] = np.minimum(gap[1:], np.abs(np.diff(rw)))
    gap[:-1] = np.minimum(gap[:-1], np.abs(np.diff(rw)))
    sep = gap > 0.01 * np.abs(rw)
    dots = np.abs(np.sum(c64 * rv, axis=1))
    worst = float(dots[sep].min()) if sep.any() else 1.0
    check(rel <= 1e-3 and orth <= 1e-4 and worst >= 1 - 1e-3,
          f"{name}: eigenvalues within {rel:.3g} (<= 1e-3) of float64, "
          f"components orthonormal within {orth:.3g} (<= 1e-4), the "
          f"{int(sep.sum())} separated ones |dot| >= {worst:.8f} "
          f"(>= 1 - 1e-3)")
    return ref


def pca_mp_digest(sess):
    """The [ringdma:mp] PCA twin on ``sess`` (stacked W=4, or one process
    of the 4-process group): sha256 of one fit's results."""
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import stats

    c = STATS_PCA
    x = datagen.dense_points(c["mp_n"], c["d"], seed=c["mp_seed"])
    return digest(*stats.PCA(sess).fit(x))


def stats_pca_phase():
    """[stats:pca]: PCA(method="cor") at n = 262,144, D = 256, W=1:
    fits/s two-point, the split of one fit (the gram GEMM, eigh, the rest)
    and its host syncs, checked against float64; method="svd" and a W=4
    stacked fit on the same data. Returns the 4-process twin's digest."""
    import warnings

    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.benchmark import timing
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import stats
    from harp_tpu_torch.ops import linalg

    c = STATS_PCA
    n, d = c["n"], c["d"]
    log(f"[stats:pca] PCA(method='cor') n={n} d={d} f32, W=1 "
        f"(bench.py:1368's data), then the same with "
        f"{len(c['spikes'])} strong directions")
    sess = HarpSession(num_workers=1)
    x = datagen.dense_points(n, d, seed=c["seed"])
    x_dev = sess.scatter(x)
    model = stats.PCA(sess)
    zero_counts()
    w, comps, mean = model.fit(x_dev)
    check_no_plain("[stats:pca]")
    ref = check_pca("bench data", w, comps, x)
    check(np.abs(mean - x.astype(np.float64).mean(0)).max() <= 1e-5,
          "mean within 1e-5 of float64")
    lo, hi = c["repeats"]

    def build(r):
        model.fit_repeated(x_dev, r)
        return lambda: model.fit_repeated(x_dev, r)

    tp = timing.two_point_timers(build(lo), build(hi), lo, hi, 1.0)
    gram_ms = cuda_time_ms(lambda: torch.matmul(x_dev.T, x_dev), 10, 2)
    corr = sess.run(lambda a: linalg.correlation(a)[0], x_dev,
                    in_specs=(sess.shard(),), out_specs=sess.replicate())
    eigh_ms = cuda_time_ms(lambda: linalg.small_eigh(corr), 10, 2)
    # the float32 solve small_eigh avoids (cuSOLVER's Jacobi syevj)
    eigh32_ms = cuda_time_ms(lambda: torch.linalg.eigh(corr), 10, 2)
    v32 = torch.linalg.eigh(corr)[1].double()
    orth32 = float((v32.T @ v32 - torch.eye(d, dtype=torch.float64,
                                             device=CARD)).abs().max())
    fit_ms = cuda_time_ms(lambda: model._fit_device(x_dev), 10, 2)
    per, busy = device_profile(lambda: model._fit_device(x_dev))
    bound = 2 * n * d * d / PEAK_F32_FLOPS * 1e3
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        model._fit_device(x_dev)
        torch.cuda.set_sync_debug_mode("default")
    # where the port's code synchronised (set_sync_debug_mode's own
    # warning is attributed to torch's file, not to the port's)
    syncs = sorted({f"{os.path.basename(m.filename)}:{m.lineno}"
                    for m in caught if "synchroniz" in str(m.message)
                    and "harp_tpu_torch" in m.filename})
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    log(f"  {tp['rate']:.6g} fits/s two-point ({lo} vs {hi} repeats, "
        f"{tp['per_iter_ms']:.4f} ms a fit, spread "
        f"{tp['spread_pct']:.1f}%) [{CARD_NAME}]")
    log(f"  one fit {fit_ms:.4f} ms: gram GEMM {gram_ms:.4f} ms (f32 bound "
        f"{bound:.4f} ms, 2 N D^2 / 67 TFLOP/s), eigh in float64 "
        f"{eigh_ms:.4f} ms (float32 torch.linalg.eigh {eigh32_ms:.4f} ms, "
        f"its vectors orthonormal within {orth32:.3g}), the rest "
        f"{fit_ms - gram_ms - eigh_ms:.4f} ms; device busy "
        f"{100 * (busy or 0):.2f}% of the profiled fit, its longest "
        f"kernels {[(k, round(v, 4)) for k, v in top]} [{CARD_NAME}]")
    log(f"  host syncs in the port's code in one fit (sync debug mode): "
        f"{syncs}")
    spiked = spiked_points(c)
    sw, scomps, _ = model.fit(spiked)
    sref = check_pca("spiked data", sw, scomps, spiked)
    vw, vcomps, _ = stats.PCA(sess, method="svd").fit(x_dev)
    rel = float(np.max(np.abs(vw - w) / np.abs(w)))
    check(rel <= 1e-3, f"method='svd': eigenvalues within {rel:.3g} "
          f"(<= 1e-3) of the correlation method's")
    check_pca("method='svd', bench data", vw, vcomps, x, ref)
    sess4 = HarpSession(num_workers=4)
    for name, data, r in (("bench data", x, ref), ("spiked data", spiked,
                                                   sref)):
        w4, c4, _ = stats.PCA(sess4).fit(data)
        check_pca(f"W=4 stacked, {name}", w4, c4, data, r)
    del x_dev, corr
    torch.cuda.empty_cache()
    return {"fits_per_s": tp["rate"], "fit_ms": fit_ms, "gram_ms": gram_ms,
            "eigh_ms": eigh_ms, "eigh32_ms": eigh32_ms, "orth32": orth32,
            "gram_bound_ms": bound, "busy": busy, "syncs": syncs,
            "mp_digest": pca_mp_digest(sess4)}


def stats_suite_phase():
    """[stats:suite]: every `run stats` op at n = 2^20, D = 64, W = 4
    stacked, each against a float64 numpy reference with its tolerance."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import stats

    c = STATS_SUITE
    n, d = c["n"], c["d"]
    log(f"[stats:suite] every run-stats op, n={n} d={d} f32, "
        f"W={c['workers']} stacked, against float64 numpy")
    sess = HarpSession(num_workers=c["workers"])
    x = datagen.dense_points(n, d, seed=c["seed"])
    x64 = x.astype(np.float64)
    mean64 = x64.mean(0)
    gram64 = x64.T @ x64
    cov64 = (gram64 - n * np.outer(mean64, mean64)) / (n - 1)
    xmax = float(np.abs(x).max())
    x_dev = sess.scatter(x)
    walls = {}

    def timed(op, fn):
        t0 = time.perf_counter()
        out = fn()
        walls[op] = time.perf_counter() - t0
        return out

    def within(what, got, want, tol, scale=None):
        scale = float(np.abs(want).max()) if scale is None else scale
        err = float(np.abs(np.asarray(got, np.float64) - want).max())
        check(err <= tol * scale, f"{what}: within {err / scale:.3g} "
              f"(<= {tol:g}) of max|ref|")

    zero_counts()
    cov, mean = timed("cov", lambda: stats.Covariance(sess).compute(x_dev))
    within("cov", cov, cov64, 1e-4)
    within("cov mean", mean, mean64, 1e-5)
    m = timed("moments", lambda: stats.LowOrderMoments(sess).compute(x_dev))
    check(float(m.count) == n and np.array_equal(m.minimum, x.min(0))
          and np.array_equal(m.maximum, x.max(0)),
          "moments: count exact, min and max bitwise np.min/np.max")
    var64 = x64.var(0, ddof=1)
    for what, got, want, tol in (
            ("sum", m.sum, x64.sum(0), 1e-5),
            ("mean", m.mean, mean64, 1e-5),
            ("sum of squares", m.sum_squares, (x64 * x64).sum(0), 1e-5),
            ("variance", m.variance, var64, 1e-4),
            ("std", m.std_dev, np.sqrt(var64), 1e-4)):
        within(f"moments {what}", got, want, tol)
    z = timed("zscore", lambda: stats.ZScore(sess).transform(x_dev))
    within("zscore", z, (x64 - mean64) / np.sqrt(var64), 1e-4)
    mm = timed("minmax", lambda: stats.MinMax(sess).transform(x_dev))
    lo64, hi64 = x64.min(0), x64.max(0)
    within("minmax", mm, (x64 - lo64) / (hi64 - lo64), 1e-6)
    del z, mm
    q, r = timed("qr", lambda: stats.QR(sess).compute(x_dev))
    within("qr: ||QR - X||", q.astype(np.float64) @ r, x64, 1e-4, xmax)
    within("qr: Q'Q", q.T.astype(np.float64) @ q, np.eye(d), 1e-4, 1.0)
    check(bool(np.all(np.diag(r) >= 0)), "qr: R's diagonal nonnegative")
    blk = x_dev[: n // c["workers"]]
    q32, r32 = torch.linalg.qr(blk)         # the float32 QR tsqr avoids
    err32 = float((q32.double() @ r32.double() - blk.double()).abs().max())
    log(f"  float32 torch.linalg.qr of one worker's block, for comparison: "
        f"||QR - X|| {err32 / xmax:.3g} of max|X|")
    del q32, r32
    q, r, piv = timed("pivoted_qr",
                      lambda: stats.PivotedQR(sess).compute(x_dev))
    check(sorted(piv.tolist()) == list(range(d)), "pivoted_qr: pivots are a "
          "permutation")
    within("pivoted_qr: ||QR - X[:, piv]||", q.astype(np.float64) @ r,
           x64[:, piv], 1e-4, xmax)
    dr = np.abs(np.diag(r)).astype(np.float64)
    check(bool(np.all(dr[1:] <= dr[:-1] * (1 + 1e-4))),
          "pivoted_qr: |R_kk| non-increasing (within 1e-4)")
    within("pivoted_qr: R'R", r.T.astype(np.float64) @ r,
           gram64[np.ix_(piv, piv)], 1e-4)
    del q
    u, sv, vt = timed("svd", lambda: stats.SVD(sess).compute(x_dev))
    sv64 = np.sqrt(np.linalg.eigvalsh(gram64)[::-1])
    within("svd: singular values", sv, sv64, 1e-4)
    within("svd: U S V'", (u.astype(np.float64) * sv) @ vt, x64, 1e-4, xmax)
    del u
    chol = timed("cholesky", lambda: stats.Cholesky(sess).compute(x_dev))
    within("cholesky", chol, np.linalg.cholesky(gram64), 1e-4)
    qs = list(c["qs"])
    quant = timed("quantiles",
                  lambda: stats.Quantiles(sess).compute(x_dev, qs))
    within("quantiles", quant, np.quantile(x, qs, axis=0), 1e-6, xmax)
    srt = timed("sort", lambda: stats.Sorting(sess).compute(x_dev))
    want = np.sort(x, axis=0)
    check(np.array_equal(srt, want), "sort: bitwise np.sort(axis=0)")
    pos = np.asarray(qs) * (n - 1)
    whole = pos == np.floor(pos)
    check(np.array_equal(quant[whole], want[pos[whole].astype(int)]),
          "quantiles at whole positions: bitwise the sorted rows")
    del srt, want
    thr = c["outlier_threshold"]
    flags = timed("outlier", lambda: stats.OutlierDetection(
        sess, thr).compute(x_dev))
    prec = np.linalg.inv(cov64 + 1e-6 * np.eye(d))
    xc = x64 - mean64
    dist = np.sqrt(((xc @ prec) * xc).sum(1))
    near = np.abs(dist - thr) <= 1e-4 * thr
    agree = np.array_equal(flags[~near], (dist[~near] > thr).astype(np.int32))
    check(agree, f"outlier (threshold {thr}): flags equal the float64 "
          f"distances' except {int(near.sum())} rows within 1e-4 of the "
          f"threshold ({int(flags.sum())} of {n} flagged)")
    check_no_plain("[stats:suite]")
    log("  wall a call, incl. the first call and the fetch: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in walls.items()) + f" [{CARD_NAME}]")
    del x_dev
    torch.cuda.empty_cache()
    return walls


def sparse_lockstep(idx, val, mask, real, x_sq, dense, cen0, iterations,
                    strategy):
    """Lloyd iterations through ``sparse_kmeans_stats``, each E-step also
    run through the plain dense E-step on the densified matrix from the
    SAME centroids: counts equal up to near ties, rows of equal counts
    within rtol 1e-4 (as ``lockstep_fit``). Returns the sparse trajectory's
    end, its costs and the worst error."""
    from harp_tpu_torch.models import sparse as sp
    from harp_tpu_torch.ops import pallas_kernels as pk

    cen, worst, costs = cen0.clone(), 0.0, []
    for _ in range(iterations):
        st, cost = sp.sparse_kmeans_stats(idx, val, mask, real, x_sq, cen,
                                          strategy)
        s2, n2, _ = pk.kmeans_stats_plain(dense, cen)
        n1 = st[:, -1]
        moved = float((n1 - n2).abs().sum())
        ties = near_ties(dense, cen, cen.shape[0])
        check(moved <= 2 * ties, f"{strategy}: lock-step counts equal up to "
              f"near ties ({moved:.0f} <= 2 x {ties})")
        c1 = st[:, :-1] / torch.clamp(n1[:, None], min=1.0)
        c2 = s2 / torch.clamp(n2[:, None], min=1.0)
        same = n1 == n2
        err = ((c1 - c2).abs()[same]
               / (c2.abs()[same] + 1e-3 * float(c2.abs().max())))
        worst = max(worst, float(err.max()))
        cen = c1
        costs.append(cost)
    check(worst <= 1e-4, f"{strategy}: lock-step centroids within rtol 1e-4 "
          f"of the dense plain E-step at every iteration (max rel "
          f"{worst:.3g})")
    return cen, torch.stack(costs), worst


def stats_csr_phase():
    """[stats:csr]: CSRCovariance passes/s and CSRPCA against the dense
    Covariance and PCA of the densified matrix; SparseKMeans (k = 100,
    both strategies) iterations/s, in lock step with the dense plain
    E-step."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.benchmark import timing
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import sparse as sp
    from harp_tpu_torch.models import stats

    c = STATS_CSR
    n, d = c["n"], c["d"]
    sess = HarpSession(num_workers=1)
    rows, cols, vals = datagen.sparse_points(n, d, c["density"],
                                             seed=c["cov_seed"])
    log(f"[stats:csr] n={n} d={d} density {c['density']} ({len(vals)} "
        f"nonzeros), W=1: CSRCovariance, CSRPCA, SparseKMeans k={c['k']}")
    dense = np.zeros((n, d), np.float32)
    dense[rows, cols] = vals
    zero_counts()
    cov_model = sp.CSRCovariance(sess)
    cov, mean = cov_model.compute(rows, cols, vals, n, d)
    dcov, dmean = stats.Covariance(sess).compute(dense)
    np.testing.assert_allclose(cov, dcov, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(mean, dmean, rtol=1e-3, atol=1e-4)
    log("  ok: CSRCovariance within rtol 1e-3, atol 1e-4 of the dense "
        "Covariance of the densified matrix")
    w, comps, _ = sp.CSRPCA(sess).fit(rows, cols, vals, n, d)
    dw, dcomps, _ = stats.PCA(sess).fit(dense)
    np.testing.assert_allclose(w, dw, rtol=1e-3, atol=1e-4)
    gap = np.full(d, np.inf)
    gap[1:] = np.minimum(gap[1:], np.abs(np.diff(dw)))
    gap[:-1] = np.minimum(gap[:-1], np.abs(np.diff(dw)))
    sep = gap > 0.01 * np.abs(dw)
    dots = np.abs(np.sum(comps.astype(np.float64) * dcomps, axis=1))
    check(bool(np.all(dots[sep] >= 1 - 1e-3)),
          f"CSRPCA: eigenvalues within rtol 1e-3, atol 1e-4 of the dense "
          f"PCA's, the {int(sep.sum())} separated components |dot| >= 1 - "
          f"1e-3")
    placed = cov_model._layout(rows, cols, vals, n, d)
    p_lo, p_hi = c["passes"]
    tp = timing.two_point_timers(
        lambda: cov_model._run(placed, d, p_lo),
        lambda: cov_model._run(placed, d, p_hi), p_lo, p_hi, 1.0)
    log(f"  CSRCovariance {tp['rate']:.6g} passes/s two-point ({p_lo} vs "
        f"{p_hi} passes on the placed layout, {tp['per_iter_ms']:.4f} ms a "
        f"pass, spread {tp['spread_pct']:.1f}%) [{CARD_NAME}]")
    out = {"cov_passes_per_s": tp["rate"], "cov_pass_ms": tp["per_iter_ms"]}
    del placed, dense
    torch.cuda.empty_cache()

    rows, cols, vals = datagen.sparse_points(n, d, c["density"],
                                             seed=c["km_seed"])
    k = c["k"]
    dense0 = np.zeros((k, d), np.float32)
    head = rows < k
    dense0[rows[head], cols[head]] = vals[head]
    dense = torch.zeros((n, d), device=CARD)
    dense[torch.from_numpy(rows).to(CARD), torch.from_numpy(cols).to(CARD)] = (
        torch.from_numpy(vals).to(CARD))
    cen0 = torch.from_numpy(dense0).to(CARD)
    for strategy in ("densify", "gather"):
        model = sp.SparseKMeans(sess, sp.SparseKMeansConfig(
            k, d, c["iterations"], strategy))
        state = model.prepare(rows, cols, vals, n)
        zero_counts()
        cen, costs = model.fit_prepared(state, dense0)
        check_no_plain(f"[stats:csr] SparseKMeans {strategy}")
        lcen, lcosts, worst = sparse_lockstep(        # W=1: one block
            *state, dense, cen0, c["iterations"], strategy)
        if strategy == "densify":
            check(np.array_equal(cen, lcen.cpu().numpy())
                  and np.array_equal(costs, lcosts.cpu().numpy()),
                  "densify: the model's fit is bitwise its lock-step "
                  "trajectory")
        else:
            rel = abs(float(costs[-1]) - float(lcosts[-1])) / float(
                lcosts[-1])
            check(rel <= 1e-4, f"gather: the model's final cost within "
                  f"rtol 1e-4 of its lock-step trajectory's ({rel:.3g})")
        check(bool(np.all(np.diff(costs) <= 1e-5 * costs[:-1])),
              f"{strategy}: costs non-increasing")
        lo, hi = c["iters"]

        def build(iters):
            m = sp.SparseKMeans(sess, sp.SparseKMeansConfig(k, d, iters,
                                                            strategy))
            m.fit_prepared(state, dense0)
            return lambda: m.fit_prepared(state, dense0)

        tp = timing.two_point_timers(build(lo), build(hi), lo, hi, 1.0)
        log(f"  SparseKMeans {strategy}: {tp['rate']:.6g} iterations/s "
            f"two-point ({lo} vs {hi}, {tp['per_iter_ms']:.4f} ms an "
            f"iteration, spread {tp['spread_pct']:.1f}%), cost "
            f"{costs[0]:.8g} -> {costs[-1]:.8g} [{CARD_NAME}]")
        out[f"kmeans_{strategy}_iters_per_s"] = tp["rate"]
        out[f"kmeans_{strategy}_iter_ms"] = tp["per_iter_ms"]
        out[f"kmeans_{strategy}_lockstep_rel"] = worst
        del state
        torch.cuda.empty_cache()
    return out


def keyed_records(n_total, c, zipf):
    """Keys in [0, c["keys"]) (uniform, or Zipf(zipf) over the key
    space) and values (n_total, feat) of small integers as float32."""
    rng = np.random.default_rng(c["seed"] + (1 if zipf else 0))
    if zipf:
        p = np.arange(1, c["keys"] + 1, dtype=np.float64) ** -zipf
        keys = rng.choice(c["keys"], size=n_total, p=p / p.sum())
    else:
        keys = rng.integers(0, c["keys"], size=n_total)
    vals = rng.integers(-3, 4, size=(n_total, c["feat"]),
                        dtype=np.int8).astype(np.float32)
    return keys.astype(np.int64), vals


def keyed_run(sess, keys, vals, num_keys):
    """``group_by_key_sharded`` (SUM, the default capacity) of the sharded
    records on ``sess``: (combined values, overflow), replicated."""
    from harp_tpu_torch.collectives import table_ops

    rep = sess.replicate()
    return sess.run(lambda k, v: table_ops.group_by_key_sharded(
        k, v, num_keys), keys, vals, in_specs=(sess.shard(),) * 2,
        out_specs=(rep, rep))


def keyed_mp_digests(sess):
    """The [ringdma:mp] keyed-shuffle twins on ``sess``: sha256 of the
    combined values and the overflow, uniform and Zipf draws."""
    c = KEYED
    out = {}
    for name, zipf in (("uniform", None), ("zipf", c["zipf"])):
        keys, vals = keyed_records(c["workers"] * c["mp_n"], c, zipf)
        out[name] = digest(*keyed_run(sess, sess.scatter(keys),
                                      sess.scatter(vals), c["keys"]))
    return out


def kept_records(dest, w, cap):
    """Which records ``bucket_route`` keeps, in numpy: a record is kept
    when its rank among its worker's records of the same destination (in
    record order) is below ``cap``."""
    kept = np.zeros(dest.shape, bool)
    for r in range(dest.shape[0]):
        order = np.argsort(dest[r], kind="stable")
        d_s = dest[r][order]
        starts = np.concatenate([[0], np.cumsum(np.bincount(
            d_s, minlength=w))])[:-1]
        kept[r, order] = np.arange(len(d_s)) - starts[d_s] < cap
    return kept


def keyed_phase():
    """[collectives:keyed]: group_by_key_sharded at W = 4 stacked, 2^22
    records a worker, uniform and Zipf keys, against numpy; a bucket_route
    / route_back round trip; gather, send_recv, rotate_map and barrier on
    the 1 MiB H block, each bitwise an index op. Returns the 4-process
    twins' digests."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.collectives import lax_ops, table_ops

    c = KEYED
    w, n, nk = c["workers"], c["n"], c["keys"]
    kpw = -(-nk // w)
    cap = table_ops.default_route_capacity(n, w)
    log(f"[collectives:keyed] group_by_key_sharded W={w} stacked, {n} "
        f"records a worker, keys in [0, {nk}), values (., {c['feat']}) f32, "
        f"capacity {cap}")
    sess = HarpSession(num_workers=w)
    cpu = HarpSession(num_workers=w, device="cpu")
    out = {}
    for name, zipf in (("uniform", None), ("zipf", c["zipf"])):
        keys, vals = keyed_records(w * n, c, zipf)
        kept = kept_records(np.minimum(keys // kpw, w - 1).reshape(w, n), w,
                            cap).reshape(-1)
        ref = np.stack([np.bincount(keys[kept], weights=vals[kept, j].astype(
            np.float64), minlength=nk) for j in range(c["feat"])], axis=1)
        k_dev, v_dev = sess.scatter(keys), sess.scatter(vals)
        zero_counts()
        got, ovf = keyed_run(sess, k_dev, v_dev, nk)
        check_no_plain(f"[collectives:keyed] {name}")
        _, cpu_ovf = keyed_run(cpu, cpu.scatter(keys),
                               cpu.scatter(vals[:, :1]), nk)
        check(np.array_equal(got.cpu().numpy().astype(np.float64), ref),
              f"{name}: combined values bitwise the float64 sums (np "
              f"bincount of the kept records, exact as np.add.at)")
        check(int(ovf) == int(cpu_ovf) == int((~kept).sum()),
              f"{name}: overflow {int(ovf)} equal to the CPU port's "
              f"{int(cpu_ovf)} and numpy's {int((~kept).sum())}")
        ms = cuda_time_ms(lambda: keyed_run(sess, k_dev, v_dev, nk), 3, 1)
        log(f"  {name}: {w * n / ms * 1e3:.6g} records/s ({ms:.4f} ms a "
            f"call, W={w} x {n} records) [{CARD_NAME}]")
        out[name] = {"records_per_s": w * n / ms * 1e3, "ms": ms,
                     "overflow": int(ovf)}
        if name == "uniform":
            def round_trip(k, v):
                dest = torch.clamp(k // kpw, max=w - 1)
                (routed,), _, _, routing = table_ops.bucket_route(
                    dest, cap, (v,))
                return table_ops.route_back(routed, routing)

            back, ok = sess.run(round_trip, k_dev, v_dev,
                                in_specs=(sess.shard(),) * 2,
                                out_specs=(sess.shard(), sess.shard()))
            check(np.array_equal(ok.cpu().numpy(), kept)
                  and torch.equal(back[ok], v_dev[ok])
                  and not bool(back[~ok].any()),
                  "bucket_route -> route_back returns every kept record "
                  "to its place, bitwise, and zeros for the others")
        del k_dev, v_dev, got
        torch.cuda.empty_cache()
    x = ring_inputs(w, seed=11)["f32"]
    perm = {0: 2, 1: 3, 2: 1, 3: 0}
    pairs = [(0, 3), (1, 0), (3, 2)]
    gathered = torch.zeros((w, w * x.shape[1]) + tuple(x.shape[2:]),
                           device=CARD)
    gathered[2] = x.flatten(0, 1)
    sent = torch.zeros_like(x)
    for s_, d_ in pairs:
        sent[d_] = x[s_]
    rotated = torch.empty_like(x)
    rotated[list(perm.values())] = x[list(perm.keys())]
    times = {}
    for name, fn, want in (
            ("gather", lambda a: lax_ops.gather(a, 2), gathered),
            ("send_recv", lambda a: lax_ops.send_recv(a, pairs), sent),
            ("rotate_map", lambda a: lax_ops.rotate_map(a, perm), rotated),
            ("barrier", lambda a: (lax_ops.barrier(), a)[1], x)):
        check(torch.equal(as_is(sess, fn, x), want),
              f"{name} on the 1 MiB H block (W={w}): bitwise its index op")
        times[name] = cuda_time_ms(lambda: as_is(sess, fn, x), 20, 3)
    log("  ms a call on the 1 MiB H block: " + ", ".join(
        f"{k} {v:.6f}" for k, v in times.items()) + f" [{CARD_NAME}]")
    out["collective_ms"] = times
    out["mp_digests"] = keyed_mp_digests(sess)
    return out


def stats_phases():
    """The statistics phases in order; returns their records, the
    4-process twins' digests among them."""
    res = {"pca": stats_pca_phase()}
    torch.cuda.empty_cache()
    res["suite"] = stats_suite_phase()
    torch.cuda.empty_cache()
    res["csr"] = stats_csr_phase()
    torch.cuda.empty_cache()
    res["keyed"] = keyed_phase()
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------- #
# Mini-batch NN, the gradient solvers (float32 torch.matmul with TF32 off; no
# TPU kernel on their path) and the quantized wire format of the collectives
# --------------------------------------------------------------------------- #

def rel_dist(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def nn_config(layers, batch, epochs, **kw):
    from harp_tpu_torch.models import nn

    return nn.NNConfig(layers=tuple(layers), num_classes=NN["classes"],
                       lr=NN["lr"], batch_size=batch, epochs=epochs, **kw)


def nn_flat(model) -> np.ndarray:
    """A fitted MLPClassifier's parameters as one float64 host vector."""
    return np.concatenate([t.detach().double().cpu().numpy().ravel()
                           for wb in model.params for t in wb])


def nn_mp_digest(sess):
    """The [ringdma:mp] NN twin on ``sess`` (stacked W=4, or one process of
    the 4-process group): sha256 of the losses and parameters of a 2-epoch
    fit at n = 16,384."""
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import nn

    c = NN
    x, y = datagen.classification_data(c["mp_n"], c["d"], c["classes"],
                                       seed=c["seed"])
    m = nn.MLPClassifier(sess, nn_config(c["layers"], c["batch"],
                                         c["check_epochs"]))
    losses = m.fit(x, y, seed=0)
    return digest(losses, *[t for wb in m.params for t in wb])


def quant_ar_digest(sess):
    """The [ringdma:mp] quantized allreduce twin on ``sess``: sha256 of the
    int8 allreduce (SUM) of a (4, 4099) payload with its residual, the
    result and every worker's new residual."""
    from harp_tpu_torch import combiner
    from harp_tpu_torch.collectives import lax_ops, quantize
    from harp_tpu_torch.parallel import distributed

    rng = np.random.default_rng(QUANT_AR["seed"])
    x = rng.standard_normal((RING_W, QUANT_AR["n"])).astype(np.float32)
    r = (rng.standard_normal(x.shape) * 0.01).astype(np.float32)
    comm = quantize.CommConfig("int8")
    out, res = sess.run(
        lambda a, b: lax_ops.allreduce(a, combiner.SUM, comm=comm,
                                       residual=b),
        sess.scatter(x), sess.scatter(r),
        in_specs=(sess.shard(), sess.shard()),
        out_specs=(sess.replicate(), sess.shard()))
    if sess.workers.process_group:
        res = distributed.gather_rows(res)
    return digest(out, res)


def nn_phase():
    """[nn]: bench.py's NN row at W=1: samples/s two-point, the device's
    share of an epoch, the first epochs' losses and the parameters against
    the port's CPU fit from the same init_params (within ``NN["tol"]``,
    fitted with TF32 on outside the port; the same fit with TF32 GEMMs
    must miss it); a W=4 stacked twin; the 4-process twin's stacked
    digest."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.benchmark import nn_budget
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import nn

    c = NN
    x, y = datagen.classification_data(c["n"], c["d"], c["classes"],
                                       seed=c["seed"])
    mults = nn_budget.weight_mults(c["d"], c["layers"], c["classes"])
    bound_ms = 6.0 * mults * c["n"] / PEAK_F32_FLOPS * 1e3
    steps = -(-c["n"] // c["batch"])
    log(f"[nn] n={c['n']} d={c['d']} layers "
        f"{'x'.join(map(str, c['layers']))}, {c['classes']} classes, batch "
        f"{c['batch']} ({steps} steps an epoch), lr {c['lr']}, W=1 "
        f"({CARD_NAME})")
    sess = HarpSession()
    xd, yd = sess.scatter(x), sess.scatter(y)
    cfg = nn_config(c["layers"], c["batch"], c["check_epochs"])
    # a caller's TF32 on around the fit: the port's full_f32_matmul must
    # turn it off inside and give it back; the same fit with the helper
    # bypassed shows what the limit below would see of TF32 GEMMs
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        zero_counts()
        m = nn.MLPClassifier(sess, cfg)
        losses = m.fit(xd, yd, seed=0)
        launched = {k: v for k, v in read_counts().items() if v}
        tf32_after = torch.backends.cuda.matmul.allow_tf32
        with mock.patch.object(nn, "full_f32_matmul", contextlib.nullcontext):
            m_tf32 = nn.MLPClassifier(sess, cfg)
            l_tf32 = m_tf32.fit(xd, yd, seed=0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    check_no_plain("[nn]")
    log(f"  kernel launches on the path: {launched or 'none'} (no TPU "
        f"kernel on it: float32 torch.matmul, TF32 off)")
    m_cpu = nn.MLPClassifier(HarpSession(device="cpu"), cfg)
    l_cpu = m_cpu.fit(x, y, seed=0)
    p32, p_cpu = nn_flat(m), nn_flat(m_cpu)
    dl, dp = rel_dist(losses, l_cpu), rel_dist(p32, p_cpu)
    check(bool(np.all(np.isfinite(losses))) and losses[-1] < losses[0],
          f"finite, falling losses ({losses[0]:.6f} -> {losses[-1]:.6f})")
    check(tf32_after is True,
          "the caller's TF32 setting (on) is back after the fit")
    check(dl <= NN["tol"] and dp <= NN["tol"],
          f"the first {c['check_epochs']} epochs' losses within {dl:.3g} "
          f"and the parameters within {dp:.3g} of the port's CPU fit "
          f"(<= {NN['tol']:g} of the largest entry), fitted with TF32 on "
          f"outside the port")
    dl_tf, dp_tf = rel_dist(l_tf32, l_cpu), rel_dist(nn_flat(m_tf32), p_cpu)
    check(dp_tf > NN["tol"],
          f"the limit catches TF32: with full_f32_matmul bypassed the fit "
          f"is {dp_tf:.3g} (losses {dl_tf:.3g}) from the CPU fit, above "
          f"{NN['tol']:g}")
    acc = float((m.predict(xd) == y).mean())
    eps = nn_budget.two_point_epoch_s(sess, c["n"], c["d"], c["layers"],
                                      c["batch"], c["epochs"], data=(xd, yd))
    per, busy = device_profile(lambda: nn.MLPClassifier(sess, nn_config(
        c["layers"], c["batch"], 1)).fit(xd, yd, seed=0))
    dev_ms = sum(per.values())
    log(f"  {c['n'] / eps:.6g} samples/s two-point ({eps * 1e3:.4f} ms an "
        f"epoch, {eps / steps * 1e6:.2f} us a step); f32 bound "
        f"{bound_ms:.4f} ms an epoch ({eps * 1e3 / bound_ms:.1f}x); device "
        f"time in a profiled epoch {dev_ms:.4f} ms, busy "
        f"{100 * (busy or 0):.2f}% of its span; train accuracy {acc:.4f}")
    w = c["workers"]
    sess4 = HarpSession(num_workers=w)
    xd4, yd4 = sess4.scatter(x), sess4.scatter(y)
    zero_counts()
    l4 = nn.MLPClassifier(sess4, cfg).fit(xd4, yd4, seed=0)
    check_no_plain(f"[nn] W={w}")
    check(bool(np.all(np.isfinite(l4))) and l4[-1] < l4[0],
          f"W={w} stacked: finite, falling losses ({l4[0]:.6f} -> "
          f"{l4[-1]:.6f})")
    eps4 = nn_budget.two_point_epoch_s(sess4, c["n"], c["d"], c["layers"],
                                       c["batch"], c["epochs"],
                                       data=(xd4, yd4))
    log(f"  W={w} stacked: {c['n'] / eps4:.6g} samples/s two-point "
        f"({eps4 * 1e3:.4f} ms an epoch)")
    mp = nn_mp_digest(sess4)
    return {"samples_per_s": c["n"] / eps, "epoch_ms": eps * 1e3,
            "bound_ms": bound_ms, "device_ms": dev_ms, "busy": busy,
            "loss_rel_vs_cpu": dl, "param_rel_vs_cpu": dp,
            "w4_samples_per_s": c["n"] / eps4, "mp_digest": mp}


def nn_compute_phase():
    """[nn:compute]: bench.py's compute-bound NN row at W=1: ms an epoch
    two-point against its float32 bound."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.benchmark import nn_budget
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import nn

    c = NN_COMPUTE
    x, y = datagen.classification_data(c["n"], c["d"], NN["classes"],
                                       seed=NN["seed"])
    mults = nn_budget.weight_mults(c["d"], c["layers"], NN["classes"])
    flops = 6.0 * mults * c["n"]
    bound_ms = flops / PEAK_F32_FLOPS * 1e3
    log(f"[nn:compute] n={c['n']} d={c['d']} layers "
        f"{'x'.join(map(str, c['layers']))}, batch {c['batch']}, W=1: "
        f"{flops / 1e12:.4f} TFLOP an epoch, f32 bound {bound_ms:.4f} ms")
    sess = HarpSession()
    xd, yd = sess.scatter(x), sess.scatter(y)
    zero_counts()
    losses = nn.MLPClassifier(sess, nn_config(c["layers"], c["batch"],
                                              2)).fit(xd, yd, seed=0)
    check_no_plain("[nn:compute]")
    check(bool(np.all(np.isfinite(losses))) and losses[-1] < losses[0],
          f"finite, falling losses ({losses[0]:.6f} -> {losses[-1]:.6f})")
    row = nn_budget.compute_row(sess, data=(xd, yd))
    eps = row["epoch_ms"] / 1e3
    clock = row.get("sm_mhz_min_median_max")
    log(f"  {eps * 1e3:.4f} ms an epoch two-point, the median of "
        f"{', '.join(f'{v:.4f}' for v in row['epoch_ms_reads'])} "
        f"({c['n'] / eps:.6g} samples/s, {flops / eps / 1e12:.3f} TFLOP/s): "
        f"{100 * bound_ms / (eps * 1e3):.2f}% of the f32 bound; SM clock "
        f"{clock} MHz (min, median, max), power up to "
        f"{row.get('power_w_max')} W")
    return {"epoch_ms": eps * 1e3, "bound_ms": bound_ms,
            "samples_per_s": c["n"] / eps, "epoch_ms_reads":
            row["epoch_ms_reads"], "sm_mhz": clock,
            "power_w_max": row.get("power_w_max")}


def solver_phase():
    """[solver]: the five solvers at the PCA flagship's shape, W=1:
    iterations/s two-point, theta and the losses within 1e-5 (of the
    largest entry) of a float64 run on the card (float32 against float64
    sums over 262,144 rows: a few 1e-7 on the CPU), finite falling losses."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.benchmark import timing
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import solvers

    c = SOLVER
    x, y, _ = datagen.regression_data(c["n"], c["d"], seed=c["seed"])
    sess = HarpSession()
    x32, y32 = sess.scatter(x), sess.scatter(y.reshape(-1))
    x64, y64 = x32.double(), y32.double()
    theta0 = np.zeros(c["d"], np.float32)
    lo, hi = c["iterations"]
    log(f"[solver] n={c['n']} d={c['d']} f32 ({x32.numel() * 4 / 2**20:.0f} "
        f"MiB of x), mse_objective, {hi} iterations, W=1 ({CARD_NAME})")
    out = {}
    for kind in c["kinds"]:
        def make(iters):
            return solvers.Solver(sess, kind, solvers.SolverConfig(
                iterations=iters, batch_size=c["batch"]))

        zero_counts()
        t32, l32 = make(hi).minimize(solvers.mse_objective, x32, y32, theta0)
        check_no_plain(f"[solver] {kind}")
        t64, l64 = make(hi).minimize(solvers.mse_objective, x64, y64, theta0)
        dt, dl = rel_dist(t32, t64), rel_dist(l32, l64)
        check(bool(np.all(np.isfinite(l32))) and l32[-1] < l32[0]
              and dt <= 1e-5 and dl <= 1e-5,
              f"{kind}: mse {l32[0]:.6g} -> {l32[-1]:.6g}; theta within "
              f"{dt:.3g} and the losses within {dl:.3g} (<= 1e-5) of the "
              f"float64 run")

        def build(iters):
            s = make(iters)
            s.minimize(solvers.mse_objective, x32, y32, theta0)
            return lambda: s.minimize(solvers.mse_objective, x32, y32,
                                      theta0)

        tp = timing.two_point(build, lo, hi, 1.0)
        log(f"  {kind}: {tp['rate']:.6g} iterations/s two-point "
            f"({tp['per_iter_ms']:.4f} ms an iteration)")
        out[kind] = {"iters_per_s": tp["rate"], "ms": tp["per_iter_ms"],
                     "theta_rel_f64": dt}
    return out


def codec_case(x, codec, block=None):
    """Encode ``x`` (host, float32, (..., n)) with the port on the CPU and
    on the card; whether codes, scales, decode and error-fed residual are
    bitwise equal."""
    from harp_tpu_torch.collectives import quantize

    comm = quantize.CommConfig(codec)
    block = block or quantize._block_for(x.shape[-1], comm)
    res = np.full(x.shape, 0.003, np.float32)
    outs = []
    for dev in ("cpu", CARD):
        t = torch.from_numpy(x).to(dev)
        p, sc, n = quantize.encode_flat(t, comm, block)
        dec = quantize.decode_flat(p, sc, n, comm)
        *_, r = quantize.ef_encode_flat(t, torch.from_numpy(res).to(dev),
                                        comm, block)
        outs.append([v for v in (p, sc, dec, r) if v is not None])
    return all(digest(a) == digest(b) for a, b in zip(*outs))


def codec_phase():
    """[codecs]: the port's codecs on the card bitwise its CPU codes: a
    ragged n, an all-zero block, exact .5 ties, stacked rows, and the
    packed-row round trip; the int8 allreduce with residual bitwise the CPU
    port's."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.collectives import quantize

    log("[codecs] int8 and bf16 codes on the card against the port's CPU "
        "codes")
    rng = np.random.default_rng(61)
    ragged = (rng.standard_normal(4099) * 10.0 ** rng.uniform(
        -3, 3, 4099)).astype(np.float32)
    ragged[:256] = 0.0                                 # an all-zero block
    ties = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -2.5] * 4,
                    np.float32)
    stacked = rng.standard_normal((RING_W, 3, 1000)).astype(np.float32)
    for codec in ("int8", "bf16"):
        for name, x, block in (("ragged n=4099 with a zero block", ragged,
                                None), ("exact .5 ties", ties, 8),
                               ("stacked rows (4, 3, 1000)", stacked, None)):
            check(codec_case(x, codec, block),
                  f"{codec}, {name}: codes, scales, decode and residual "
                  f"bitwise the CPU port's")
    rows = rng.standard_normal((64, 33)).astype(np.float32)
    rows[5] = 0.0
    packed = quantize.encode_rows_np(rows)
    got = [quantize.dequantize_rows(torch.from_numpy(packed).to(dev))
           for dev in ("cpu", CARD)]
    q, scale = quantize.decode_rows(torch.from_numpy(packed).to(CARD))
    want = (np.abs(rows).max(-1) / 127.0).astype(np.float32)
    check(digest(got[0]) == digest(got[1])
          and np.array_equal(scale.cpu().numpy().view(np.uint32),
                             want.view(np.uint32))
          and not got[1][5].any(),
          "packed rows: the decode on the card bitwise the CPU's, the "
          "scales bitwise their float32 bits, a zero row decodes to zeros")
    cpu = quant_ar_digest(HarpSession(num_workers=RING_W, device="cpu"))
    card = quant_ar_digest(HarpSession(num_workers=RING_W))
    check(cpu == card, f"the int8 allreduce with residual at W={RING_W}: "
          f"result and residuals bitwise the CPU port's")
    return card


def cluster_starts(c):
    """One point of each cluster that ``datagen.dense_points(c["n"],
    c["d"], seed=c["seed"], num_clusters=c["k"])`` draws: the first point
    of each cluster, its assignments replayed from the generator's own
    draws (a start with no two centroids in one cluster)."""
    rng = np.random.default_rng(c["seed"])
    rng.random((c["k"], c["d"]), dtype=np.float32)          # the centres
    assign = rng.integers(0, c["k"], size=c["n"])
    return np.array([int(np.argmax(assign == j)) for j in range(c["k"])])


def kmeans_quant_phase():
    """[kmeans:quant]: [kmeans:stacked]'s data and shape in four variants x
    int8 and bf16 against the float32 fit. From a start of one point of
    each generated cluster, held to the JAX test's bounds
    (tests/test_quantize.py:317-343: costs rtol 2e-2, the final cost 1e-2
    int8 / 1e-3 bf16, centroids 0.2 / 0.05), which the JAX reference meets
    there on the CPU (int8 final within 1.6e-3, bf16 6.8e-4, centroids
    0.016); from [kmeans:stacked]'s own start, where near ties between
    centroids sharing a cluster let the lossy wire move the fit to another
    local optimum (the JAX reference's int8 fit leaves the float32 costs by
    11.6% there), the deviation is recorded. One E-step launch an iteration;
    ms an iteration in turns against the float32 fit; the int8
    regroupallgather fit's digest for its 4-process twin."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import kmeans as km

    c = KMEANS_QUANT
    it = c["iterations"]
    log(f"[kmeans:quant] W={RING_W} stacked: n={c['n']}, k={c['k']}, "
        f"d={c['d']}, {it} iterations, {len(c['variants'])} variants x int8 "
        f"and bf16 against the float32 fit")
    pts = datagen.dense_points(c["n"], c["d"], seed=c["seed"],
                               num_clusters=c["k"])
    starts = {"one point a cluster": np.ascontiguousarray(
                  pts[cluster_starts(c)]),
              "[kmeans:stacked]'s start": datagen.initial_centroids(
                  pts, c["k"], seed=c["seed"] + 1)}
    sess = HarpSession(num_workers=RING_W)

    def model(variant, quant=None):
        return km.KMeans(sess, km.KMeansConfig(c["k"], c["d"], it, variant,
                                               quant=quant))

    p, _ = model("regroupallgather").prepare(pts, starts[
        "one point a cluster"])
    del pts
    out = {"launches": {}, "ms_per_iter": {}, "flagship_start": {}}
    for start, cen0 in starts.items():
        c0 = sess.replicate_put(cen0, dtype=torch.float32)
        held = start == "one point a cluster"
        for variant in c["variants"] if held else c["variants"][:1]:
            cen32, cost32 = (t.cpu().numpy() for t in
                             model(variant).fit_prepared(p, c0))
            for codec, (cen_tol, cost_tol) in c["bounds"].items():
                zero_counts()
                cen, cost = (t.cpu().numpy() for t in
                             model(variant, codec).fit_prepared(p, c0))
                launches = read_counts()
                check_no_plain(f"[kmeans:quant] {variant} {codec}, {start}")
                dc = float(np.abs(cen - cen32).max())
                dk = float(np.max(np.abs(cost - cost32) / np.abs(cost32)))
                dlast = abs(float(cost[-1] - cost32[-1])) / abs(float(
                    cost32[-1]))
                what = (f"{variant} {codec}, {start}: "
                        f"{launches['kmeans_stats']} E-step launches; costs "
                        f"within {dk:.3g}, the final within {dlast:.3g}, "
                        f"centroids within {dc:.3g} of the float32 fit")
                ok = (launches["kmeans_stats"] == it
                      and launches["kmeans_stats_wide"] == 0
                      and bool(np.all(np.isfinite(cost))))
                if held:
                    check(ok and dk <= 2e-2 and dlast <= cost_tol
                          and dc < cen_tol,
                          f"{what} (<= 2e-2, <= {cost_tol:g}, < {cen_tol:g})")
                    out["launches"][f"{variant}_{codec}"] = launches[
                        "kmeans_stats"]
                else:
                    check(ok, f"{what} (recorded)")
                    out["flagship_start"][codec] = {
                        "costs_rel": dk, "final_rel": dlast,
                        "centroids": dc}
    c0 = sess.replicate_put(starts["[kmeans:stacked]'s start"],
                            dtype=torch.float32)
    for codec in ("int8", "bf16"):
        f32, q = model("regroupallgather"), model("regroupallgather", codec)
        ms32, msq = in_turns(lambda: f32.fit_prepared(p, c0),
                             lambda: q.fit_prepared(p, c0), 3, warmup=1)
        out["ms_per_iter"][codec] = msq / it
        out["ms_per_iter"][f"float32_beside_{codec}"] = ms32 / it
        log(f"  regroupallgather {codec}: {msq / it:.4f} ms an iteration "
            f"against {ms32 / it:.4f} float32, in turns (one card: the wire "
            f"compresses nothing, the codec adds its passes)")
    del p, c0
    torch.cuda.empty_cache()
    ref = kmeans_mp_fit(sess, c)
    check(kmeans_mp_launches_ok(ref["launches"], c),
          f"the int8 regroupallgather fit: one kmeans_stats launch an "
          f"iteration ({ref['launches']['kmeans_stats']})")
    out["digest"] = ref["digest"]
    return out


def quant_nn_solver_phases():
    """[codecs], [nn], [nn:compute], [solver] and [kmeans:quant]; returns
    their records, the stacked digests of the 4-process twins among
    them."""
    res = {"quant_ar_digest": codec_phase()}
    res["nn"] = nn_phase()
    torch.cuda.empty_cache()
    res["nn_compute"] = nn_compute_phase()
    torch.cuda.empty_cache()
    res["solver"] = solver_phase()
    torch.cuda.empty_cache()
    res["kmeans_quant"] = kmeans_quant_phase()
    torch.cuda.empty_cache()
    res["mp"] = {"kmeans_quant": res["kmeans_quant"]["digest"],
                 "nn": res["nn"]["mp_digest"],
                 "quant_ar": res["quant_ar_digest"]}
    return res


# --------------------------------------------------------------------------- #
# Checkpoints, the device reshard and LDA (no new kernel: the dense-MF hop on
# the checkpointed SGD-MF path, the ring hop on LDA's fused path)
# --------------------------------------------------------------------------- #

class TimedCheckpointer:
    """``utils.checkpoint.Checkpointer`` with its saves and restores timed
    (host clock, ms; a save is the write of a host copy taken before)."""

    def __init__(self, path):
        from harp_tpu_torch.utils.checkpoint import Checkpointer

        self.ck = Checkpointer(path)
        self.save_ms, self.restore_ms = [], []

    def save(self, *args, **kw):
        t0 = time.perf_counter()
        out = self.ck.save(*args, **kw)
        self.save_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def restore_latest_valid(self, *args, **kw):
        t0 = time.perf_counter()
        out = self.ck.restore_latest_valid(*args, **kw)
        self.restore_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def wait(self):
        self.ck.wait()


def ckpt_mf_phase(root):
    """[ckpt] on the SGD-MF flagship at W=4 stacked, 1 slice, fused: 4
    epochs with save_every=2, resumed to 6 in a fresh model bitwise the
    uninterrupted checkpointed fit; the W=4 directory restored at W=2
    through "device", "ring" and "host", bitwise each other and every
    referenced row the saved row."""
    import shutil

    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.models import sgd_mf

    c, f = CKPT, MF_FLAGSHIP
    lo, hi = c["mf_epochs"]
    log(f"[ckpt] SGD-MF flagship {f['users']} x {f['items']}, rank "
        f"{f['rank']}, W={RING_W} stacked, 1 slice, fused_dma=True: {lo} "
        f"epochs with save_every={c['mf_save_every']}, resumed to {hi}; "
        f"restored at W={c['restore_world']} [{CARD_NAME}]")
    rows, cols, vals = mf_fused_data()
    cfg = mf_fused_config(fused_dma=True, epochs=hi)
    states = {}

    def fit(sess, path, epochs, **kw):
        m = sgd_mf.SGDMF(sess, dataclasses.replace(cfg, **kw))
        w = sess.num_workers
        if w not in states:       # a fit never writes into its start state
            states[w] = (m.prepare(rows, cols, vals, f["users"], f["items"],
                                   seed=0), m.last_layout_stats["nnz"])
        st = states[w][0]
        ck = TimedCheckpointer(path)
        zero_counts()
        t0 = time.perf_counter()
        out = m.fit_checkpointed(st, ck, epochs=epochs,
                                 save_every=c["mf_save_every"])
        torch.cuda.synchronize()
        return (out, read_counts(), plain_counts(), ck,
                (time.perf_counter() - t0) * 1e3)

    sess = HarpSession(num_workers=RING_W)
    # the uninterrupted fit runs with telemetry on: the bitwise check of
    # the resumed fit below (telemetry off) covers the on/off pair
    from harp_tpu_torch import telemetry

    tlog = telemetry.configure(f"{root}/tele_mf", interval=2)
    try:
        (w_a, h_a, r_a, s_a), _, _, ck_a, _ = fit(sess, f"{root}/mf_a", hi)
    finally:
        telemetry.disable()
    events = read_jsonl(tlog.path)
    check([e["step"] for e in events] == list(range(hi))
          and [e["loss"] for e in events] == np.asarray(r_a).tolist()
          and all(e["model"] == "sgd_mf"
                  and e["wire_pricing"] == "traced_shape" for e in events),
          f"the uninterrupted fit with telemetry on: {len(events)} step "
          f"events, one an epoch, each with the RMSE the fit returned")
    fit(sess, f"{root}/mf_b", lo)
    (w_b, h_b, r_b, s_b), launches, plain, ck_b, _ = fit(
        sess, f"{root}/mf_b", hi)
    steps = (hi - lo) * RING_W
    check(s_a == 0 and s_b == lo and np.array_equal(w_b, w_a)
          and np.array_equal(h_b, h_a) and np.array_equal(r_b, r_a[lo:]),
          f"SGD-MF stopped at epoch {lo} and resumed in a fresh model to "
          f"{hi}: factors and RMSEs bitwise the uninterrupted checkpointed "
          f"fit")
    check(launches["dense_mf_hop"] == steps
          and launches["dense_mf_hop_ring"] == steps
          and launches["ring_dma_hop"] == 0,
          f"the resumed {hi - lo} epochs: {steps} dense_mf_hop launches, "
          f"each with its in-kernel send ({launches['dense_mf_hop']}, "
          f"{launches['dense_mf_hop_ring']}, ring_dma_hop "
          f"{launches['ring_dma_hop']})")
    check_no_plain("[ckpt] SGD-MF resume", plain)
    # [sgd_mf:fused] starts from the same 1-slice W=4 state
    MF_FUSED_STATE[RING_W] = states.pop(RING_W)
    sess2 = HarpSession(num_workers=c["restore_world"])
    restored = {}
    for mode in ("device", "ring", "host"):
        path = f"{root}/mf_{mode}"
        shutil.copytree(f"{root}/mf_a", path)
        (w_r, h_r, r_r, s_r), _, pl, ck_r, ms = fit(
            sess2, path, hi, reshard=mode, fused_dma=False)
        check(s_r == hi and len(r_r) == 0,
              f"W={c['restore_world']} {mode}: resumed at epoch {hi}, "
              f"nothing left to run")
        check_no_plain(f"[ckpt] SGD-MF restore at W={c['restore_world']} "
                       f"({mode})", pl)
        restored[mode] = (w_r, h_r, ck_r.restore_ms[0], ms)
    same = all(np.array_equal(restored[m][0], restored["device"][0])
               and np.array_equal(restored[m][1], restored["device"][1])
               for m in restored)
    check(same and np.array_equal(restored["device"][0], w_a)
          and np.array_equal(restored["device"][1], h_a),
          f"the W={RING_W} directory restored at W={c['restore_world']}: "
          f"device, ring and host bitwise each other, every referenced row "
          f"of W and H the saved row")
    rec = {"save_ms": ck_a.save_ms, "restore_ms": ck_b.restore_ms[0],
           "launches": launches,
           "restore": {m: {"read_ms": v[2], "resume_ms": v[3]}
                       for m, v in restored.items()}}
    log(f"  save {[round(x, 3) for x in rec['save_ms']]} ms a step, "
        f"restore {rec['restore_ms']:.3f} ms (same world); at W="
        f"{c['restore_world']}: " + ", ".join(
            f"{m} read {v['read_ms']:.3f} ms, whole resume {v['resume_ms']:.3f}"
            f" ms" for m, v in rec["restore"].items()) + f" [{CARD_NAME}]")
    return rec


def ckpt_kmeans_phase(root):
    """[ckpt] on the K-means flagship (W=1): 10 iterations with
    save_every=5, resumed from 5 in a fresh model bitwise uninterrupted."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.models import kmeans as km

    c, f = CKPT, FLAGSHIP
    log(f"[ckpt] K-means flagship n={f['n']}, k={f['k']}, d={f['d']}, W=1: "
        f"{c['km_iterations']} iterations with save_every="
        f"{c['km_save_every']}, resumed from {c['km_save_every']} "
        f"[{CARD_NAME}]")
    pts, cen0 = card_points(f["n"], f["d"], f["k"], c["km_seed"])
    sess = HarpSession(num_workers=1)
    cfg = km.KMeansConfig(f["k"], f["d"], c["km_iterations"])
    p, c0 = km.KMeans(sess, cfg).prepare(pts, cen0)
    del pts
    ck_a = TimedCheckpointer(f"{root}/km_a")
    cen_a, costs_a, _ = km.KMeans(sess, cfg).fit_checkpointed(
        p, c0, ck_a, save_every=c["km_save_every"])
    km.KMeans(sess, cfg).fit_checkpointed(
        p, c0, TimedCheckpointer(f"{root}/km_b"),
        save_every=c["km_save_every"], iterations=c["km_save_every"])
    ck_b = TimedCheckpointer(f"{root}/km_b")
    zero_counts()
    cen_b, costs_b, start = km.KMeans(sess, cfg).fit_checkpointed(
        p, c0, ck_b, save_every=c["km_save_every"])
    launches, plain = read_counts(), plain_counts()
    rest = c["km_iterations"] - c["km_save_every"]
    check(start == c["km_save_every"] and torch.equal(cen_b, cen_a)
          and np.array_equal(costs_b, costs_a[start:]),
          f"K-means resumed from iteration {start}: centroids and costs "
          f"bitwise the uninterrupted checkpointed fit")
    check(launches["kmeans_stats"] == rest,
          f"{rest} kmeans_stats launches in the resumed iterations "
          f"({launches['kmeans_stats']})")
    check_no_plain("[ckpt] K-means resume", plain)
    log(f"  save {[round(x, 3) for x in ck_a.save_ms]} ms, restore "
        f"{ck_b.restore_ms[0]:.3f} ms [{CARD_NAME}]")
    return {"save_ms": ck_a.save_ms, "restore_ms": ck_b.restore_ms[0],
            "launches": launches["kmeans_stats"]}


def reshard_phase():
    """[reshard]: the JAX package's reshard row on the card, alltoall and
    ring schedules and the host oracle, bitwise each other, each round's
    payload within the chunk."""
    from unittest import mock as _mock

    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.collectives import lax_ops
    from harp_tpu_torch.collectives import repartition as rep
    from harp_tpu_torch.collectives import reshard as rs
    from harp_tpu_torch.models.sgd_mf import identity_assign, serpentine_assign

    c = RESHARD
    rows, rank, ow, nw = c["rows"], c["rank"], c["old_world"], c["new_world"]
    log(f"[reshard] {rows} rows x rank {rank} float32, W {ow} -> {nw} "
        f"stacked, rounds of at most {c['chunk_bytes']} bytes a worker "
        f"[{CARD_NAME}]")
    sess = HarpSession(num_workers=nw)
    rng = np.random.default_rng(0)
    old_rpb, new_rpb = -(-rows // ow), -(-rows // nw)
    old_assign = serpentine_assign(rng.integers(1, 64, rows), ow)
    new_assign = identity_assign(rows, nw)
    saved = rng.standard_normal((ow * old_rpb, rank)).astype(np.float32)
    fill_host = np.zeros((nw * new_rpb, rank), np.float32)
    old_lay = rs.block_layout(old_assign, old_rpb, ow)
    new_lay = rs.block_layout(new_assign, new_rpb, nw)
    oracle = rep.repartition_factor(saved, old_assign, old_rpb, new_assign,
                                    new_rpb, rows, fill_host.copy())
    rec = {}
    for schedule in ("alltoall", "ring"):
        plan = rs.plan_factor_reshard(old_lay, ow, new_lay, nw, rows,
                                      rank * 4, c["chunk_bytes"], schedule)
        fn, args = rs.prepare_reshard(sess, saved, plan,
                                      sess.scatter(fill_host))
        sizes = []
        real = {"all_to_all": lax_ops.all_to_all, "rotate": lax_ops.rotate}

        def spy(name):
            def f(x, *a, **k):
                sizes.append(x[0].numel() * x.element_size())
                return real[name](x, *a, **k)
            return f

        with _mock.patch.object(lax_ops, "all_to_all", spy("all_to_all")), \
                _mock.patch.object(lax_ops, "rotate", spy("rotate")):
            out = fn(*args)
        check(np.array_equal(out.cpu().numpy(), oracle),
              f"{schedule}: bitwise the host oracle")
        check(max(sizes) <= c["chunk_bytes"],
              f"{schedule}: {len(sizes)} collective rounds, the largest "
              f"{max(sizes)} bytes a worker (<= {c['chunk_bytes']})")
        times = []
        for _ in range(c["reps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        rec[schedule] = {"ms": statistics.median(times), "ms_all": times,
                         "rounds": plan.rounds, "collectives": len(sizes),
                         "max_round_bytes": max(sizes),
                         "bytes_moved": plan.bytes_moved}
    times = []
    for _ in range(c["reps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moved = rep.repartition_factor(saved, old_assign, old_rpb,
                                       new_assign, new_rpb, rows,
                                       fill_host.copy())
        sess.scatter(moved)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rec["host"] = {"ms": statistics.median(times), "ms_all": times,
                   "bytes": int(saved.nbytes)}
    log("  " + ", ".join(f"{k} {v['ms']:.3f} ms" + (
        f" ({v['rounds']} rounds, largest {v['max_round_bytes']} B, "
        f"{v['bytes_moved']} B cross workers)" if "rounds" in v else
        " (numpy gather-and-resplit + upload)") for k, v in rec.items())
        + f" [{CARD_NAME}]")
    return rec


def lda_model_for(sess, cfg, state):
    """An LDA model of ``cfg`` whose program is built for ``state``'s
    layout (a state prepared once serves several configs)."""
    from harp_tpu_torch.models import lda

    model = lda.LDA(sess, cfg)
    key = state[0]
    model._fns[key] = model._build(key[0], key[1], key[2], key[3] // key[0],
                                   key[6])
    return model


def lda_digest(dt, wt, ll) -> str:
    import hashlib

    h = hashlib.sha256()
    for a in (dt, wt, ll):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def lda_counts_exact(model, state, name):
    """doc_topic, word_topic and topic totals of a 1-worker, 1-slice fit
    recomputed from its z, exactly."""
    key, data, seed, _ = state
    dt, wt, z, ll = model._fns[key](*data, seed)
    k = model.config.num_topics
    docs_b, mask_b = data[0], data[1]
    oh = torch.nn.functional.one_hot(z.long(), k).float() * mask_b[..., None]
    dt_z = oh.sum(dim=(1, 2))
    wt_z = torch.zeros_like(wt).index_add_(0, docs_b.reshape(-1).long(),
                                           oh.reshape(-1, k))
    check(torch.equal(dt_z, dt) and torch.equal(wt_z, wt)
          and torch.equal(wt.sum(0), dt.sum(0))
          and int(dt.sum()) == int(mask_b.sum()),
          f"{name}: doc_topic, word_topic and the topic totals equal the "
          f"counts of z exactly")
    return ll


def lda_cpu_twin(model, state, cfg):
    """The same fit's program on the CPU from the card state's arrays."""
    from harp_tpu_torch import HarpSession, convert
    from harp_tpu_torch.models import lda

    cpu = lda.LDA(HarpSession(num_workers=1, device="cpu"), cfg)
    arrays = convert.lda_state_to_jax(model, state)
    return cpu, convert.lda_state_from_jax(cpu, arrays, seed=arrays["seed"])


def lda_phase():
    """[lda]: bench.py's LDA rows at W=1, tokens/s two-point (2 vs 8
    epochs); on the bench row the uniforms, one CGS epoch and a CVB0 fit
    held against the CPU port, the counts against z, rising
    log-likelihoods."""
    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.benchmark import timing
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import lda
    from harp_tpu_torch.ops import threefry

    sess = HarpSession(num_workers=1)
    lo, hi = LDA_EPOCHS
    rec, corpora = {}, {}
    for name, r in LDA_ROWS:
        t0 = time.perf_counter()
        key = (r["docs"], r["vocab"], r["doc_len"], r["topics"])
        if key not in corpora:
            corpora[key] = datagen.lda_corpus(r["docs"], r["vocab"],
                                              max(2, r["topics"] // 2),
                                              r["doc_len"], seed=3)
        docs = corpora[key]
        cfg = lda.LDAConfig(num_topics=r["topics"], vocab=r["vocab"],
                            epochs=hi,
                            vocab_sub_block=r.get("vocab_sub_block", 0))
        model = lda.LDA(sess, cfg)
        state = model.prepare(docs, seed=1)
        data_s = time.perf_counter() - t0
        log(f"[lda] {name}: {r['docs']} docs x {r['doc_len']} tokens "
            f"({docs.size}), V={r['vocab']}, K={r['topics']}, W=1"
            + (f", vocab_sub_block={r['vocab_sub_block']}"
               if r.get("vocab_sub_block") else "")
            + f": write path {model.last_layout_stats['wt_path']}, padding "
            f"x{model.last_layout_stats['overhead']:.3f} (corpus and "
            f"prepare {data_s:.2f} s) [{CARD_NAME}]")
        lls = {}

        def timer(ne):
            m = lda_model_for(sess, dataclasses.replace(cfg, epochs=ne),
                              state)

            def run():
                lls[ne] = m.fit_prepared(state)[2]
            return run

        t_lo, t_hi = timer(lo), timer(hi)
        zero_counts()
        t_lo()                        # warm: the same launches as t_hi's
        check_no_plain(f"[lda] {name}")
        tp = timing.two_point_timers(t_lo, t_hi, lo, hi, float(docs.size),
                                     reps=r.get("reps", 3))
        ll = lls[hi]
        check(bool(np.all(np.isfinite(ll))) and ll[-1] > ll[0],
              f"{name}: log-likelihood rises over {hi} epochs "
              f"({ll[0]:.6g} -> {ll[-1]:.6g})")
        reps = r.get("reps", 3)
        spread = tp["spread_pct"] if reps > 1 else None
        rec[name] = {"tokens_per_s": tp["rate"],
                     "per_epoch_ms": tp["per_iter_ms"],
                     "spread_pct": spread, "pairs": reps,
                     "low_resolution": tp["low_resolution"],
                     "ll_first": float(ll[0]), "ll_last": float(ll[-1]),
                     "wt_path": model.last_layout_stats["wt_path"],
                     "padding": model.last_layout_stats["overhead"]}
        log(f"  {tp['rate']:.6g} tokens/s ({tp['per_iter_ms']:.4f} ms an "
            f"epoch, " + (f"spread {spread:.1f}% over {reps} pairs"
                          if spread is not None else "one pair")
            + f"), ll {ll[0]:.6g} -> {ll[-1]:.6g} [{CARD_NAME}]")
        if name != "bench":
            continue
        one = dataclasses.replace(cfg, epochs=1)
        m1 = lda_model_for(sess, one, state)
        lda_counts_exact(m1, state, name)
        # the uniforms of the first group, on the card and on the CPU
        d_local = docs.shape[0]
        dg = d_local // m1._effective_minibatches(d_local)
        shape = (dg, state[0][2], 1)
        keys = threefry.fold_in(threefry.prng_key(0, CARD),
                                torch.arange(4, device=CARD) + 1)
        u_card = threefry.uniform(threefry.split(keys)[:, 1], shape)
        keys_c = threefry.fold_in(threefry.prng_key(0), torch.arange(4) + 1)
        u_cpu = threefry.uniform(threefry.split(keys_c)[:, 1], shape)
        check(torch.equal(u_card.cpu(), u_cpu),
              f"threefry uniforms {tuple(u_card.shape)} on the card bitwise "
              f"the CPU's")
        # one CGS epoch from the same state, card and CPU
        cpu, cstate = lda_cpu_twin(m1, state, one)
        key_ = state[0]
        _, wt_g, z_g, ll_g = m1._fns[key_](*state[1], state[2])
        _, wt_c, z_c, ll_c = cpu._fns[cstate[0]](*cstate[1], cstate[2])
        moved = int((z_g.cpu() != z_c).sum())
        check(moved == 0 and torch.equal(wt_g.cpu(), wt_c),
              f"one CGS epoch from the same state: z ({z_g.numel()} "
              f"tokens) and the word-topic counts bitwise the CPU port's "
              f"({moved} draws differ)")
        rec[name]["ll_card_vs_cpu_rel"] = float(
            abs(float(ll_g[0]) - float(ll_c[0])) / abs(float(ll_c[0])))
        # CVB0: a quarter of the corpus, 2 epochs, card against CPU
        small = docs[: docs.shape[0] // 4]
        soft = dataclasses.replace(cfg, epochs=2, method="cvb0",
                                   vocab_sub_block=0)
        ms = lda.LDA(sess, soft)
        sst = ms.prepare(small, seed=1)
        zero_counts()
        got = ms.fit_prepared(sst)
        check_no_plain(f"[lda] {name} CVB0")
        cpu, cst = lda_cpu_twin(ms, sst, soft)
        want = cpu.fit_prepared(cst)
        err = max(float(np.abs(a - b).max() / np.abs(b).max())
                  for a, b in zip(got[:2], want[:2]))
        check(err <= 1e-5, f"CVB0 ({small.shape[0]} docs, 2 epochs, path "
              f"{ms.last_layout_stats['wt_path']}): doc_topic and "
              f"word_topic within 1e-5 of the CPU port's ({err:.3g})")
        rec[name]["cvb0_rel_vs_cpu"] = err
    return rec, corpora


def lda_fused_phase(corpora):
    """[lda:fused]: the clueweb regime at W=4 stacked, fused_dma bitwise
    unfused on 1 and 2 slices (ring_dma_hop launches counted), int8
    quant_wt, a checkpoint resumed at W=2 (device against the host
    oracle), and the stacked side of the 4-process twin."""
    import shutil
    import tempfile

    from harp_tpu_torch import HarpSession
    from harp_tpu_torch.models import lda
    from harp_tpu_torch.utils.checkpoint import Checkpointer

    c = LDA_FUSED
    w, ep = c["workers"], c["epochs"]
    docs = corpora[(c["docs"], c["vocab"], c["doc_len"], c["topics"])]
    log(f"[lda:fused] clueweb regime ({docs.size} tokens, V={c['vocab']}, "
        f"K={c['topics']}) at W={w} stacked, {ep} epochs: fused_dma against "
        f"unfused on 1 and 2 slices, int8 quant_wt, a checkpoint resumed at "
        f"W={c['restore_world']} [{CARD_NAME}]")
    sess = HarpSession(num_workers=w)
    base = lda.LDAConfig(num_topics=c["topics"], vocab=c["vocab"], epochs=ep)
    rec = {}
    for ns in (1, 2):
        cfg = dataclasses.replace(base, num_model_slices=ns)
        state = lda.LDA(sess, cfg).prepare(docs, seed=1)
        outs = {}
        for fused in (False, True):
            m = lda_model_for(sess, dataclasses.replace(cfg, fused_dma=fused),
                              state)
            zero_counts()
            outs[fused] = m.fit_prepared(state)
            launches, plain = read_counts(), plain_counts()
            check_no_plain(f"[lda:fused] {ns} slice(s), fused={fused}", plain)
            want = ep * w * ns if fused else 0
            check(launches["ring_dma_hop"] == want,
                  f"{ns} slice(s), fused_dma={fused}: {want} ring_dma_hop "
                  f"launches ({launches['ring_dma_hop']})")
            row = {"ring_dma_hop": launches["ring_dma_hop"]}
            if ns == 1:               # one timed fit each, 1 slice
                row["ms_per_epoch"] = cuda_time_ms(
                    lambda: m.fit_prepared(state), reps=1, warmup=0) / ep
            rec[f"s{ns}_{'fused' if fused else 'unfused'}"] = row
        check(all(np.array_equal(a, b) for a, b in zip(outs[False],
                                                       outs[True])),
              f"{ns} slice(s): the fused fit bitwise the unfused fit")
        ll = outs[True][2]
        check(bool(np.all(np.isfinite(ll))) and ll[-1] > ll[0],
              f"{ns} slice(s): log-likelihood rises ({ll[0]:.6g} -> "
              f"{ll[-1]:.6g})")
        if ns == 1:
            ll32 = ll
            state1 = state
    qcfg = dataclasses.replace(base, quant="int8", quant_wt=True,
                               fused_dma=True)
    m = lda_model_for(sess, qcfg, state1)
    zero_counts()
    qll = m.fit_prepared(state1)[2]
    launches = read_counts()
    qerr = float(np.abs(qll - ll32).max() / np.abs(ll32).max())
    check(launches["ring_dma_hop"] == 0 and qerr <= 0.2,
          f"int8 quant_wt (fused asked): no ring_dma_hop launch (the "
          f"quantized wire takes precedence), log-likelihoods within 20% of "
          f"the float32 fit's ({qerr:.3g})")
    check_no_plain("[lda:fused] int8 quant_wt")
    rec["quant_wt_int8_ll_rel"] = qerr
    root = tempfile.mkdtemp(prefix="harp_lda_ckpt_")
    m4 = lda_model_for(sess, dataclasses.replace(base, fused_dma=True),
                       state1)
    dt4, wt4, _, _ = m4.fit_checkpointed(state1, Checkpointer(root),
                                         save_every=1)
    sess2 = HarpSession(num_workers=c["restore_world"])
    got = {}
    state2 = lda.LDA(sess2, base).prepare(docs, seed=1)
    for mode in ("device", "host"):
        m2 = lda.LDA(sess2, dataclasses.replace(base, reshard=mode))
        t0 = time.perf_counter()
        dt, wt, ll2, start = m2.fit_checkpointed(state2, Checkpointer(root))
        got[mode] = (dt, wt, (time.perf_counter() - t0) * 1e3, start)
    check(all(g[3] == ep for g in got.values())
          and np.array_equal(got["device"][1], got["host"][1])
          and np.array_equal(got["device"][0], got["host"][0])
          and np.array_equal(got["device"][1], wt4)
          and np.array_equal(got["device"][0], dt4),
          f"the W={w} chain resumed at W={c['restore_world']}: the device "
          f"reshard's word-topic and doc-topic counts equal the host "
          f"oracle's and the saved chain's exactly")
    rec["restore_ms"] = {m: g[2] for m, g in got.items()}
    shutil.rmtree(root, ignore_errors=True)
    # the stacked side of [ringdma:mp]'s LDA twin
    small = docs[: c["mp_docs"]]
    mcfg = dataclasses.replace(base, fused_dma=True)
    mm = lda.LDA(sess, mcfg)
    zero_counts()
    dt, wt, ll = mm.fit_prepared(mm.prepare(small, seed=1))
    rec["mp_digest"] = lda_digest(dt, wt, ll)
    rec["mp_stacked_launches"] = read_counts()["ring_dma_hop"]
    log(f"  ms an epoch: " + ", ".join(
        f"{k} {v['ms_per_epoch']:.4f}" for k, v in rec.items()
        if isinstance(v, dict) and "ms_per_epoch" in v)
        + f"; resume at W={c['restore_world']}: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in rec["restore_ms"].items())
        + f" [{CARD_NAME}]")
    return rec


def checkpoint_lda_phases():
    """[ckpt], [reshard], [lda] and [lda:fused]; returns their records."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="harp_ckpt_")
    try:
        res = {"ckpt_mf": ckpt_mf_phase(root)}
        torch.cuda.empty_cache()
        res["ckpt_kmeans"] = ckpt_kmeans_phase(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    res["reshard"] = reshard_phase()
    torch.cuda.empty_cache()
    res["lda"], corpora = lda_phase()
    torch.cuda.empty_cache()
    res["lda_fused"] = lda_fused_phase(corpora)
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------- #
# Host IO: the native loader, the reader pool, the H2D prefetch and the
# streamed K-means fits
# --------------------------------------------------------------------------- #

def write_parts(root, parts, rows, d, k, seed):
    """``parts`` CSV part-files of ``rows`` clustered points (%.6f, as the
    bench writes them) under ``root``; their paths."""
    from harp_tpu_torch.io import datagen

    paths = []
    for i in range(parts):
        path = os.path.join(root, f"part-{i:05d}")
        np.savetxt(path, datagen.dense_points(rows, d, seed=seed + i,
                                              num_clusters=k),
                   fmt="%.6f", delimiter=",")
        paths.append(path)
    return paths


def stream_fit_digest(sess, c=INGEST_MP):
    """The streamed fit ``c`` on ``sess`` (stacked W=4, or one process of
    the 4-process group): part-files written into a temporary directory of
    this process, ``StreamLoader`` -> ``DevicePrefetcher`` ->
    ``KMeans.fit_from_stream``; sha256 of its centroids and costs, with its
    launch and plain-call counts."""
    import shutil
    import tempfile

    from harp_tpu_torch.io import datagen, loaders
    from harp_tpu_torch.io import pipeline as pl
    from harp_tpu_torch.models import kmeans as km

    root = tempfile.mkdtemp(prefix="harp_stream_")
    try:
        paths = write_parts(root, c["parts"], c["rows"], c["d"], c["k"],
                            c["seed"])
        cen0 = datagen.initial_centroids(loaders.load_dense_csv(paths[:1]),
                                         c["k"], seed=c["seed"])
        loader = pl.StreamLoader(paths, chunk_rows=c["chunk_rows"])
        n_fit = loader.total_rows - loader.total_rows % sess.num_workers
        model = km.KMeans(sess, km.KMeansConfig(c["k"], c["d"],
                                                c["iterations"]))
        zero_counts()
        cen, costs = model.fit_from_stream(
            pl.DevicePrefetcher(loader, sess.replicate_put), cen0, n_fit)
        launches, plain = read_counts(), plain_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"digest": digest(cen, costs), "launches": launches,
            "plain": plain, "cost": float(costs[-1])}


def ingest_phase():
    """[ingest]: ``benchmark/ingest.bench_ingest`` at the JAX package's row
    on the card, then on the same files the stream-fed fit bitwise the
    in-memory fit (float32 and bf16), the minibatch twins bitwise each
    other, the distributed COO->CSR at W=4 bitwise the host oracle,
    ``run kmeans --stream`` in this process, and the stacked W=4 streamed
    fit whose digest the 4-process gang must match."""
    import shutil
    import tempfile

    from harp_tpu_torch import HarpSession
    from harp_tpu_torch import run as trun
    from harp_tpu_torch.benchmark import ingest
    from harp_tpu_torch.io import datagen, loaders, native_bridge
    from harp_tpu_torch.io import pipeline as pl
    from harp_tpu_torch.models import kmeans as km
    from harp_tpu_torch.ops import pallas_kernels as pk

    c = INGEST
    wide = pk.kmeans_smem_bytes(c["d"], c["k"]) > pk.MAX_SMEM_BYTES
    log(f"[ingest] bench_ingest(total_mb={c['total_mb']}, d={c['d']}, "
        f"k={c['k']}, parts={c['parts']}, chunk_rows={c['chunk_rows']}, "
        f"fit_iters={c['fit_iters']}, num_threads={c['num_threads']}, "
        f"queue_depth={c['queue_depth']}), W=1, on {CARD_NAME}; "
        f"os.cpu_count() {os.cpu_count()}; the E-step at K={c['k']}, "
        f"D={c['d']} takes the {'wide' if wide else 'narrow'} kernel")
    t_phase = time.perf_counter()
    check(native_bridge.available(),
          "the native loader built from native/loader.cpp and loaded "
          f"({native_bridge._find_lib()._name})")
    reads = []
    read_part = pl._read_part

    def counted_read(path, sep, metrics):
        reads.append(path)
        return read_part(path, sep, metrics)

    root = tempfile.mkdtemp(prefix="harp_ingest_")
    res = {}
    try:
        parsed0 = native_bridge.parses["csv"]
        zero_counts()
        t0 = time.perf_counter()
        with mock.patch.object(pl, "_read_part", counted_read):
            row = ingest.bench_ingest(
                **{key: c[key] for key in (
                    "total_mb", "d", "k", "parts", "chunk_rows", "fit_iters",
                    "num_threads", "queue_depth")}, tmpdir=root)
        res["bench_s"] = time.perf_counter() - t0
        launches, plain = read_counts(), plain_counts()
        parsed = native_bridge.parses["csv"] - parsed0
        check(parsed == len(reads) and len(reads) >= 4 * c["parts"],
              f"every part read in the bench parsed natively ({parsed} "
              f"native parses of {len(reads)} part reads)")
        check(launches["kmeans_stats"] == c["fit_iters"]
              and launches["kmeans_stats_wide"] == c["fit_iters"] * wide,
              f"the bench's stream->fit: one kmeans_stats launch an "
              f"iteration ({launches['kmeans_stats']}, wide "
              f"{launches['kmeans_stats_wide']})")
        check_no_plain("[ingest] bench_ingest", plain)
        res["launches"] = launches["kmeans_stats"]
        log(f"  {row['csv_bytes']} CSV bytes, {row['total_rows']} rows, "
            f"{row['chunks']} chunks, bench {res['bench_s']:.3f} s")
        log(f"  load {row['stream_load_mb_per_sec']} MB/s; serialized "
            f"{row['serialized_wall_s']} s, overlapped "
            f"{row['overlapped_wall_s']} s, overlap efficiency "
            f"{row['overlap_efficiency']} (gate {row['overlap_gate']}, "
            f"pass {row['overlap_pass']}); stream->fit "
            f"{row['e2e_stream_fit_wall_s']} s")
        for stage, t in row["stages"].items():
            log(f"  stage {stage}: {t}")
        log(f"  regroup (W=1): {row['regroup']}")

        paths = loaders.list_files(root)
        sess = HarpSession()
        whole = loaders.load_dense_csv(paths, num_threads=c["num_threads"])
        check(whole.shape == (row["total_rows"], c["d"]),
              f"load_dense_csv of the {len(paths)} parts: {whole.shape}")
        cen0 = datagen.initial_centroids(whole[:len(whole) // c["parts"]],
                                         c["k"], seed=419)
        fits = {}
        for dtype in ("float32", "bfloat16"):
            model = km.KMeans(sess, km.KMeansConfig(
                c["k"], c["d"], c["fit_iters"], compute_dtype=dtype))
            zero_counts()
            t0 = time.perf_counter()
            got = model.fit_from_stream(pl.DevicePrefetcher(
                pl.StreamLoader(paths, chunk_rows=c["chunk_rows"],
                                num_threads=c["num_threads"],
                                queue_depth=c["queue_depth"]),
                sess.replicate_put), cen0, len(whole))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches, plain = read_counts(), plain_counts()
            ref = model.fit(whole, cen0)
            check(all(torch.equal(a, b) for a, b in zip(got, ref))
                  and all(bool(torch.isfinite(a).all()) for a in got),
                  f"fit_from_stream ({dtype}, {c['fit_iters']} iterations, "
                  f"{secs:.3f} s from the files): centroids and costs "
                  f"bitwise fit on load_dense_csv of the same files "
                  f"(cost {float(got[1][-1]):.8g})")
            check(launches["kmeans_stats"] == c["fit_iters"],
                  f"fit_from_stream ({dtype}): one kmeans_stats launch an "
                  f"iteration ({launches['kmeans_stats']})")
            check_no_plain(f"[ingest] fit_from_stream ({dtype})", plain)
            fits[dtype] = secs
        res["stream_fit_s"] = fits
        del whole, got, ref

        model = km.KMeans(sess, km.KMeansConfig(c["k"], c["d"], 1))
        twins = []
        for serial in (True, False):
            t0 = time.perf_counter()
            twins.append(model.fit_stream_minibatch(pl.DevicePrefetcher(
                pl.StreamLoader(paths, chunk_rows=c["chunk_rows"],
                                num_threads=c["num_threads"],
                                queue_depth=c["queue_depth"],
                                serial=serial),
                sess.scatter, enabled=not serial), cen0))
            twins[-1] += (time.perf_counter() - t0,)
        (cen_s, cost_s, t_s), (cen_o, cost_o, t_o) = twins
        check(np.array_equal(cen_s, cen_o) and np.array_equal(cost_s, cost_o),
              f"fit_stream_minibatch: the serialized twin ({t_s:.3f} s) and "
              f"the overlapped twin ({t_o:.3f} s) bitwise each other")
        full = cost_s[:len(cost_s) - 1] if row["total_rows"] % c[
            "chunk_rows"] else cost_s
        check(np.isfinite(cost_s).all() and full[-1] < full[0],
              f"minibatch costs finite, the last full chunk's below the "
              f"first's ({full[0]:.8g} -> {full[-1]:.8g}, {len(cost_s)} "
              f"chunks)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(not os.path.exists(root), f"the bench's directory {root} removed")

    rng = np.random.default_rng(c["coo_seed"])
    crow = rng.integers(0, c["coo_rows"], c["coo_nnz"]).astype(np.int64)
    ccol = rng.integers(0, c["coo_cols"], c["coo_nnz"]).astype(np.int64)
    cval = rng.standard_normal(c["coo_nnz"]).astype(np.float32)
    w = c["coo_workers"]
    t0 = time.perf_counter()
    got = pl.coo_to_csr_distributed(HarpSession(num_workers=w), crow, ccol,
                                    cval, num_rows=c["coo_rows"])
    secs = time.perf_counter() - t0
    block = -(-c["coo_rows"] // w)
    ok = True
    for wi, (r, cc, v) in enumerate(loaders.regroup_coo_by_row(
            crow, ccol, cval, w)):
        want = loaders.coo_to_csr(r - wi * block, cc, v, num_rows=block)
        ok &= all(np.array_equal(a, b) and a.dtype == b.dtype
                  for a, b in zip(got[wi], want))
    check(ok, f"coo_to_csr_distributed at W={w} stacked, {c['coo_nnz']} "
          f"nonzeros ({secs:.3f} s): bitwise regroup_coo_by_row then "
          f"coo_to_csr per block")

    cl = INGEST_CLI
    root = tempfile.mkdtemp(prefix="harp_ingest_cli_")
    try:
        write_parts(root, cl["parts"], cl["rows"], cl["d"], cl["k"], 7)
        zero_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = trun.main(["kmeans", "--stream", "--points-file", root,
                            "--chunk-rows", str(cl["chunk_rows"]),
                            "--num-centroids", str(cl["k"]),
                            "--iterations", str(cl["iterations"])])
        line = out.getvalue().strip().splitlines()[-1]
        launches, plain = read_counts(), plain_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(rc == 0 and line.startswith(
        f"kmeans[stream/regroupallgather] workers=1 n="
        f"{cl['parts'] * cl['rows']} k={cl['k']} d={cl['d']}")
        and launches["kmeans_stats"] == cl["iterations"],
        f"run kmeans --stream on the card: {line!r}, "
        f"{launches['kmeans_stats']} kmeans_stats launches")
    check_no_plain("[ingest] run kmeans --stream", plain)

    res["mp"] = stream_fit_digest(HarpSession(num_workers=RING_W))
    m = INGEST_MP
    check(res["mp"]["launches"]["kmeans_stats"] == m["iterations"],
          f"the stacked W={RING_W} streamed fit ({m['parts']} parts x "
          f"{m['rows']} rows, d={m['d']}, k={m['k']}): one kmeans_stats "
          f"launch an iteration ({res['mp']['launches']['kmeans_stats']})")
    check_no_plain("[ingest] stacked streamed fit", res["mp"]["plain"])
    res["row"] = row
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"  [ingest] {res['phase_s']:.1f} s on {CARD_NAME}")
    return res


# --------------------------------------------------------------------------- #
# Dispatch: the plain calls of the main paths, and one shape outside each
# kernel's predicate
# --------------------------------------------------------------------------- #

def synced_fit(model, pts, cen0, path, save_every):
    """``KMeans.fit_checkpointed`` with the launch and plain-call counts
    and the synchronizing calls it made (``torch.cuda.set_sync_debug_mode
    ("warn")``, counted from the recorded warnings)."""
    import warnings

    from harp_tpu_torch.utils.checkpoint import Checkpointer

    ck = Checkpointer(path)
    torch.cuda.synchronize()
    zero_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            cen, costs, _ = model.fit_checkpointed(pts, cen0, ck,
                                                   save_every=save_every)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return {"cen": cen, "costs": costs, "launches": read_counts(),
            "plain": plain_counts(),
            "syncs": sum("synchroniz" in str(w.message) for w in caught)}


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f.read().strip().splitlines()]


def telemetry_phase():
    """[telemetry]: the K-means flagship through ``fit_checkpointed`` with
    telemetry off and on (bitwise, the same launches and synchronizing
    calls, an event an iteration priced at the port's row times
    ``comm_scale``), a profiler window opened by the trigger file (its
    trace names the E-step kernel), the exporter's gauges, and ``run
    kmeans --telemetry-dir``."""
    import shutil
    import tempfile
    import urllib.request

    from harp_tpu_torch import HarpSession, telemetry
    from harp_tpu_torch import run as trun
    from harp_tpu_torch.models import kmeans as km
    from harp_tpu_torch.telemetry import comm_ledger
    from harp_tpu_torch.telemetry.exporter import MetricsExporter
    from harp_tpu_torch.telemetry.xprof import XprofController
    from harp_tpu_torch.utils.metrics import Metrics

    c = TELEMETRY
    t_phase = time.perf_counter()
    log(f"[telemetry] K-means flagship n={c['n']}, k={c['k']}, d={c['d']}, "
        f"W=1, {c['iterations']} iterations, save_every={c['save_every']}: "
        f"telemetry off and on, a {c['window']}-boundary profiler window, "
        f"the exporter, run kmeans --telemetry-dir [{CARD_NAME}]")
    root = tempfile.mkdtemp(prefix="harp_tele_")
    try:
        pts, cen0 = card_points(c["n"], c["d"], c["k"], c["seed"])
        sess = HarpSession(num_workers=1)
        model = km.KMeans(sess, km.KMeansConfig(c["k"], c["d"],
                                                c["iterations"]))
        p, c0 = model.prepare(pts, cen0)
        del pts

        def fit(name):
            return synced_fit(model, p, c0, f"{root}/ck_{name}",
                              c["save_every"])

        t0 = time.perf_counter()
        fit("warm")
        off = fit("off")
        m = Metrics()
        tlog = telemetry.configure(f"{root}/on", interval=2, metrics=m)
        on = fit("on")
        telemetry.disable()
        check(torch.equal(on["cen"], off["cen"])
              and np.array_equal(on["costs"], off["costs"]),
              "telemetry on: centroids and costs bitwise the fit with it "
              "off")
        check(on["launches"] == off["launches"]
              and off["launches"]["kmeans_stats"] == c["iterations"],
              f"telemetry on: the same launches as off "
              f"({off['launches']['kmeans_stats']} kmeans_stats)")
        check_no_plain("[telemetry] off", off["plain"])
        check_no_plain("[telemetry] on", on["plain"])
        check(on["syncs"] == off["syncs"] > 0,
              f"telemetry on: the same synchronizing calls as off "
              f"({on['syncs']} and {off['syncs']}, counted from the sync "
              f"debug mode's warnings)")
        events = read_jsonl(tlog.path)
        row = comm_ledger.CommLedger("kmeans_regroupallgather")
        wire = row.bytes_per_step * model.comm_scale()
        check(len(events) == c["iterations"]
              and [e["step"] for e in events] == list(range(c["iterations"]))
              and [e["loss"] for e in events] == off["costs"].tolist()
              and all(e["wire_bytes_per_step"] == wire
                      and e["wire_pricing"] == "traced_shape"
                      and e["model"] == "kmeans" for e in events),
              f"{c['iterations']} step events: the fit's costs, "
              f"{wire:.0f} wire bytes a step (the row's "
              f"{row.bytes_per_step:.0f} x comm_scale "
              f"{model.comm_scale():.6g}), traced_shape pricing at W=1")
        check(m.timing("telemetry.phase.kmeans.checkpoint")["count"]
              == c["iterations"] // c["save_every"],
              "one checkpoint phase timing a chunk")
        with MetricsExporter(m, port=0) as ex:
            with urllib.request.urlopen(
                    f"http://{ex.host}:{ex.port}/metrics", timeout=10) as r:
                text = r.read().decode()
        gauges = {ln.split()[0]: float(ln.split()[1])
                  for ln in text.splitlines()
                  if ln.startswith("harp_comm_kmeans_regroupallgather_")}
        want = {f"harp_comm_kmeans_regroupallgather_{g}" for g in (
            "pricing_exact", "wire_bytes_per_step", "cumulative_gb",
            "busbw_gbps")}
        cum = gauges.get("harp_comm_kmeans_regroupallgather_cumulative_gb")
        check(set(gauges) == want and cum is not None
              and abs(cum - wire * c["iterations"] / 1e9)
              <= 1e-5 * cum,
              f"the exporter serves /metrics with the run's comm gauges "
              f"({gauges})")

        t_fits = time.perf_counter() - t0
        # the operator's trigger file, written after the controller starts
        t0 = time.perf_counter()
        tdir = f"{root}/window"
        wlog = telemetry.configure(tdir, interval=2, metrics=Metrics())
        ctrl = XprofController(sess, rank=0,
                               trigger_path=f"{tdir}/xprof_request.json",
                               default_dir=f"{tdir}/xprof")
        wlog.add_boundary_hook(ctrl)
        with open(f"{tdir}/xprof_request.json", "w") as f:
            json.dump({"steps": c["window"]}, f)
        win = fit("window")
        telemetry.disable()
        with open(ctrl.trace_path) as f:
            trace = json.load(f)
        kernels = sorted({e.get("name", "") for e in trace["traceEvents"]
                          if e.get("cat") == "kernel"})
        estep = [k for k in kernels if "kmeans_stats_kernel" in k]
        check(not ctrl.tracing and bool(estep)
              and torch.equal(win["cen"], off["cen"]),
              f"the trigger file opened a {c['window']}-boundary window: "
              f"its trace ({os.path.getsize(ctrl.trace_path)} B, "
              f"{len(kernels)} kernel names) names the E-step "
              f"({estep[:1]}); the fit bitwise the one without")
        log(f"  synchronizing calls: off {off['syncs']}, on {on['syncs']}, "
            f"with the profiler window {win['syncs']}")
        t_window = time.perf_counter() - t0

        t0 = time.perf_counter()
        zero_counts()
        cli_root = f"{root}/cli"
        argv = ["kmeans", "--num-points", str(c["cli_n"]), "--num-centroids",
                str(c["k"]), "--dim", str(c["d"]), "--iterations",
                str(c["cli_iterations"]), "--save-every",
                str(c["save_every"]), "--work-dir", f"{cli_root}/work",
                "--telemetry-dir", f"{cli_root}/tele"]
        rc = trun.main(argv)
        telemetry.disable()
        cli_launches, cli_plain = read_counts(), plain_counts()
        cli = read_jsonl(f"{cli_root}/tele/rank0/steps.jsonl")
        check(rc == 0 and len(cli) == c["cli_iterations"]
              and all(e["model"] == "kmeans" and np.isfinite(e["loss"])
                      for e in cli)
              and cli_launches["kmeans_stats"] == c["cli_iterations"],
              f"run kmeans --telemetry-dir on the card: "
              f"{len(cli)} events in rank0/steps.jsonl, "
              f"{cli_launches['kmeans_stats']} kmeans_stats launches")
        check_no_plain("[telemetry] run kmeans", cli_plain)
        t_cli = time.perf_counter() - t0
    finally:
        telemetry.disable()
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(f"  [telemetry] {seconds:.2f} s: three fits (warm, off, on) and "
        f"the exporter {t_fits:.2f} s, the profiler window's fit "
        f"{t_window:.2f} s, run kmeans {t_cli:.2f} s [{CARD_NAME}]")
    return {"seconds": seconds, "fits_s": t_fits, "window_s": t_window,
            "cli_s": t_cli, "launches": on["launches"]["kmeans_stats"],
            "cli_launches": cli_launches["kmeans_stats"],
            "window_launches": win["launches"]["kmeans_stats"],
            "syncs": {"off": off["syncs"], "on": on["syncs"],
                      "window": win["syncs"]},
            "wire_bytes_per_step": wire}


def dispatch_phase():
    """[dispatch]: the plain_on_card counts read after every main path (all
    0); one call on the card where the JAX package takes XLA (K-means on
    float16 points, attention at L=4096): no launch, one plain call, the
    plain version's answer; and one at a width past the narrow kernels
    (K-means K=400 at D=100, dense-MF K=192, flash Dh=192 at L=8192): one
    launch of the wide kernel, no plain call, the plain version's answer
    within the kernel's own tolerance. Returns each dispatcher's plain
    calls summed over the main paths."""
    from harp_tpu_torch.ops import pallas_kernels as pk
    from harp_tpu_torch.parallel import ring_attention as ra

    log(f"[dispatch] plain_on_card after each of the {len(PLAIN_SEEN)} main "
        f"paths")
    total = {}
    for path, plain in PLAIN_SEEN.items():
        log(f"  {path}: {plain}")
        for name, n in plain.items():
            total[name] = total.get(name, 0) + n
    check(not any(total.values()), f"plain_on_card is 0 on every main path "
          f"({total})")
    g = torch.Generator(device=CARD).manual_seed(8)
    x = torch.randn(4096, 100, device=CARD, generator=g)
    c = torch.randn(400, 100, device=CARD, generator=g)
    xh, ch = x.half(), c[:100].contiguous()
    q, k, v = attn_inputs((4096, 8, 64), 64, seed=4)
    plain_cases = (
        ("kmeans_stats", "K=100, D=100, float16 points (not a kernel type)",
         lambda: pk.kmeans_stats(xh, ch),
         lambda: pk.kmeans_stats_plain(xh, ch)),
        ("flash_attention", "L=4096, H=8, Dh=64, causal (below the length)",
         lambda: ra.blocked_attention(q, k, v, True),
         lambda: ra._streamed_attention(q, k, v, True)))
    for name, shape, fn, plain in plain_cases:
        zero_counts()
        got = fn()
        launched, calls = read_counts(), plain_counts()
        want = plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        rel = max(max_rel(a, b) for a, b in zip(got, want))
        log(f"  {name} at {shape}: launches {launched}, plain {calls}, "
            f"relative distance from the plain version {rel:.3g}")
        check(not any(launched.values()) and calls[name] == 1
              and sum(calls.values()) == 1,
              f"{name} outside its predicate: no launch, one plain call")
        check(rel <= 1e-5, f"{name}: the plain version's answer (within 1e-5 "
              f"of its largest entry; the E-step's index_add_ sums with "
              f"atomics)")
    slab = torch.randn(1, 1, 512, 1024, device=CARD, generator=g)
    slab[torch.rand(slab.shape, device=CARD, generator=g) > 0.05] = np.nan
    seen = ~torch.isnan(slab)
    mf = (slab.bfloat16(), torch.zeros(1, dtype=torch.int32, device=CARD),
          torch.randn(1, 512, 192, device=CARD, generator=g) / 192 ** 0.5,
          torch.randn(1, 1024, 192, device=CARD, generator=g) / 192 ** 0.5,
          seen.sum(3).float(), seen.reshape(1, 1, 4, 128, 1024).sum(3).float(),
          4, 0.05, 0.01)
    qw, kw, vw = attn_inputs((8192, 1, 192), 192, seed=8)
    rows = sample_rows(8192, seed=8)

    def mf_rel(got):
        # the hop rule: within max(1e-4, 4x the float32 plain version's
        # distance) of the float64 plain hop, W and H
        plain, exact = pk.dense_mf_hop_plain(*mf), plain64_hop(*mf)
        return max(max_rel(g, e) / max(1e-4, 4 * max_rel(p, e))
                   for g, p, e in zip(got[:2], plain[:2], exact[:2]))

    def flash_rel(got):
        # the flash rule on sampled rows against the float64 reference
        exact = attention_rows(qw, kw, vw, True, rows)[0]
        yard = attention_rows(qw, kw, vw, True, rows, torch.float32)[0]
        return (max_rel(got[None][:, rows], exact)
                / max(1e-5, 4 * max_rel(yard, exact)))

    def km_rel(got):
        # the E-step rule: counts up to near ties, sums rtol 1e-4 on rows
        # with equal counts, cost rtol 1e-4
        ps, pc, pq = pk.kmeans_stats_plain(x, c)
        moved = float((got[1] - pc).abs().sum())
        ties = near_ties(x, c, c.shape[0])
        same = got[1] == pc
        sums = float(((got[0] - ps).abs()[same]
                      / (ps.abs()[same] + 1e-3 * float(ps.abs().max())))
                     .max())
        cost = abs(float(got[2]) - float(pq)) / abs(float(pq))
        return max(moved / max(2 * ties, 1e-30), sums / 1e-4, cost / 1e-4)

    wide_cases = (
        ("kmeans_stats", "K=400, D=100", lambda: pk.kmeans_stats(x, c),
         km_rel, {"kmeans_stats": 1, "kmeans_stats_wide": 1}),
        ("dense_mf_hop", "K=192", lambda: pk.dense_mf_hop(*mf), mf_rel,
         {"dense_mf_hop": 1}),
        ("flash_attention", "L=8192, Dh=Dv=192, causal",
         lambda: ra.blocked_attention(qw, kw, vw, True), flash_rel,
         {"flash_attention": 1}))
    for name, shape, fn, rel_of, want in wide_cases:
        zero_counts()
        got = fn()
        launched, calls = read_counts(), plain_counts()
        moved = {n: c for n, c in launched.items() if c}
        ratio = rel_of(got)
        log(f"  {name} at {shape}: launches {moved}, plain {calls}, "
            f"distance {ratio:.3g} of the kernel's tolerance")
        check(moved == want and not any(calls.values()),
              f"{name} past the narrow kernel's width: one launch of its "
              f"wide kernel, no plain call")
        check(ratio <= 1.0, f"{name}: the plain version's answer within the "
              f"kernel's own tolerance")
    return total


def kmeans_wide_row(wide, fit):
    """The kernels-line entry of the E-step's wide variant: its numbers at
    the codebook shape, the other timed shapes as prefixed keys."""
    name = next(n for n, _, k, d in ESTEP_WIDE
                if (k, d) == (KMEANS_WIDE["k"], KMEANS_WIDE["d"]))
    keys = ("max_abs_err", "ms", "parent_ms", "plain_ms", "bound_ms",
            "bound_by", "bound_cuda_cores_ms", "library_ms")
    row = {"name": "kmeans_stats_wide", "route": "cuda",
           "source": "harp_tpu_torch/csrc/kmeans_stats.cu",
           "replaces": "harp_tpu/ops/pallas_kernels.py:93",
           "launches": fit["launches"]["kmeans_stats_wide"],
           "launches_path": f"KMeans.fit_prepared, regroupallgather, n="
                            f"{KMEANS_WIDE['n']}, k={KMEANS_WIDE['k']}, d="
                            f"{KMEANS_WIDE['d']}, W=1, "
                            f"{KMEANS_WIDE['iterations']} iterations",
           **{key: wide[name][key] for key in keys},
           "fit_per_iter_ms": fit["per_iter_ms"],
           "fit_iters_per_s": fit["iters_per_s"],
           "fit_centroid_rel_vs_plain": fit["centroid_rel_vs_plain"],
           "grid": fit["grid"]}
    for other, n, k, d in ESTEP_WIDE:
        for key in keys + ("near_ties", "count_moves", "split_ms"):
            row[f"{other}_{key}"] = wide[other][key]
    return row


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
    global CARD_NAME
    CARD_NAME = card
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    start_parent_builds()
    built = _cuda_build.build_all()
    log(f"[build] {time.perf_counter() - t0:.2f} s: " + ", ".join(
        f"{k} ({'built' if v['built'] else 'cached'} {v['seconds']:.2f} s)"
        for k, v in built.items()))
    for name, v in built.items():
        for fn, regs, spill in ptxas_usage(v["log"]):
            log(f"  {name}: {fn}: {regs}; {spill}")
            PTXAS[fn] = regs
            if fn.startswith(("dense_mf_hop_kernel", "kmeans_",
                              "spd_solve_kernel")):
                check(" 0 bytes spill stores, 0 bytes spill loads" in
                      f" {spill}", f"{fn} spills nothing")

    f = FLAGSHIP
    flag = estep_case("flagship", f["n"], f["k"], f["d"], f["k"],
                      torch.float32, timed=True)
    estep_case("ragged", 999_999, f["k"], f["d"], f["k"], torch.float32, False)
    estep_case("valid_k", f["n"], 128, f["d"], f["k"], torch.float32, False)
    flag_bf16 = estep_case("bf16", f["n"], f["k"], f["d"], f["k"],
                           torch.bfloat16, timed=True)

    fit = flagship_fit()
    log(f"  kernel {flag['ms']:.4f} ms per E-step against a bound of "
        f"{flag['bound_ms']:.4f} ms ({flag['bound_by']}); plain "
        f"{flag['plain_ms']:.4f} ms, library {flag['library_ms']:.4f} ms")
    small_fit_vs_numpy()
    variants_bitwise()
    wide, data = estep_wide_phases()
    torch.cuda.empty_cache()
    wide_fit = kmeans_wide_phase(data)
    del data
    torch.cuda.empty_cache()
    mf = mf_phases()
    torch.cuda.empty_cache()
    spd = als_phases()
    torch.cuda.empty_cache()
    attn = attention_phases()
    torch.cuda.empty_cache()
    st = stats_phases()
    new = quant_nn_solver_phases()
    cl = checkpoint_lda_phases()
    new["mp"]["lda"] = cl["lda_fused"]["mp_digest"]
    torch.cuda.empty_cache()
    ing = ingest_phase()
    new["mp"]["stream"] = ing["mp"]["digest"]
    torch.cuda.empty_cache()
    tele = telemetry_phase()
    torch.cuda.empty_cache()
    mf["ckpt_resume_launches"] = cl["ckpt_mf"]["launches"]["dense_mf_hop"]
    mf["ckpt_resume_path"] = (
        f"[ckpt]: the flagship at W={RING_W} stacked, 1 slice, fused, "
        f"epochs {CKPT['mf_epochs'][0]} to {CKPT['mf_epochs'][1]} resumed")
    mf["ckpt"] = cl["ckpt_mf"]
    mf_ring_lda = {k: cl["lda_fused"][k] for k in cl["lda_fused"]
                   if k != "mp_digest"}
    mf["ring_hop"], attn["ring_hop"], ring = ringdma_phases(
        mf.pop(f"fit_rank{MF_WIDE['rank']}_fused_digest"),
        {"pca": st["pca"]["mp_digest"],
         "keyed": st["keyed"]["mp_digests"]}, new["mp"])
    mf["quant"] = mf["ring_hop"].pop("quant")
    ring[0]["lda_fused"] = mf_ring_lda
    ring[0]["lda_fused_launches"] = mf_ring_lda["s1_fused"]["ring_dma_hop"]
    ring[0]["lda_fused_two_slice_launches"] = \
        mf_ring_lda["s2_fused"]["ring_dma_hop"]
    ring[0]["lda_fused_path"] = (
        f"[lda:fused]: the clueweb regime at W={LDA_FUSED['workers']} "
        f"stacked, {LDA_FUSED['epochs']} epochs")
    torch.cuda.empty_cache()
    plain = dispatch_phase()
    attn["plain_on_card"] = plain["flash_attention"]
    log(f"[done] {time.perf_counter() - t_start:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("  phases of 1 s or more, longest first: " + ", ".join(
        f"{tag} {sec:.1f} s" for tag, sec in phase_seconds() if sec >= 1))

    kernels = [{
        "name": "kmeans_stats", "route": "cuda",
        "source": "harp_tpu_torch/csrc/kmeans_stats.cu",
        "replaces": "harp_tpu/ops/pallas_kernels.py:93",
        "launches": fit["launches"]["kmeans_stats"],
        "max_abs_err": flag["max_abs_err"], "ms": flag["ms"],
        "parent_ms": flag["parent_ms"],
        "plain_ms": flag["plain_ms"], "bound_ms": flag["bound_ms"],
        "bound_by": flag["bound_by"],
        "bound_cuda_cores_ms": flag["bound_cuda_cores_ms"],
        "library_ms": flag["library_ms"], "split_ms": flag["split_ms"],
        "near_ties": flag["near_ties"], "count_moves": flag["count_moves"],
        **{f"bf16_{key}": flag_bf16[key] for key in (
            "ms", "parent_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "split_ms")},
        "fit_iters_per_s": fit["iters_per_s"],
        "fit_per_iter_ms": fit["per_iter_ms"],
        "fit_centroid_rel_vs_plain": fit["centroid_rel_vs_plain"],
        "grid": fit["grid"],
        "plain_on_card": plain["kmeans_stats"],
        "quant_fit_launches": new["kmeans_quant"]["launches"],
        "quant_fit_ms_per_iter": new["kmeans_quant"]["ms_per_iter"],
        "ckpt": cl["ckpt_kmeans"],
        "ckpt_resume_launches": cl["ckpt_kmeans"]["launches"],
        "ckpt_resume_path": (
            f"[ckpt]: the flagship at W=1, iterations {CKPT['km_save_every']}"
            f" to {CKPT['km_iterations']} resumed"),
        "ingest_launches": ing["launches"],
        "ingest_path": (
            f"[ingest]: bench_ingest's StreamLoader -> DevicePrefetcher -> "
            f"KMeans.fit_from_stream, n={ing['row']['total_rows']}, "
            f"k={INGEST['k']}, d={INGEST['d']}, W=1, "
            f"{INGEST['fit_iters']} iterations"),
    }, kmeans_wide_row(wide, wide_fit), mf, *spd, attn, *ring]
    print(card)
    # the reshard and LDA's W=1 rates run no kernel of their own: beside
    # the kernels, not under one
    print(json.dumps({"kernels": kernels, "reshard": cl["reshard"],
                      "lda": cl["lda"], "ingest": ing["row"],
                      "telemetry": tele}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(mp_child() if sys.argv[1:] == ["--mp-child"] else main())
