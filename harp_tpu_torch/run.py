"""Command-line launcher: ``python -m harp_tpu_torch.run <algorithm> [flags]``.

Port of ``harp_tpu/run.py``. Ported subcommands: ``kmeans`` (dense, and
``--format csr`` for sparse input), ``sgd_mf``, ``lda``, ``als``, ``pca``
(``--method
cor|svd``, ``--format dense|csr``), ``stats --op {cov, moments, zscore,
minmax, qr, pivoted_qr, svd, cholesky, quantiles, sort, outlier}``, ``nn``
and ``solver --kind {sgd, sgd_minibatch, sgd_momentum, adagrad, lbfgs}``.
The run goes on CUDA unless ``--device cpu`` is given; without CUDA the
default fails.

``kmeans --stream --points-file DIR [--chunk-rows N]`` streams the
part-files through the chunked ingestion pipeline (``io/pipeline.py``: the
native parser on a reader pool, each chunk copied to the card on a side
stream while the last is placed) into the fit, instead of loading them
whole: the centroids are bitwise those of the in-memory fit. The first
part-file alone seeds the centroids. File input (``--points-file``,
``--ratings-file``, ``--corpus-file``) is a file, a directory of part-files
or a glob, local or a ``scheme://`` URL (through fsspec where it is
installed), parsed by ``io/loaders.py``.

``kmeans``, ``sgd_mf`` and ``lda`` take ``--save-every N`` with
``--work-dir``: checkpoints every N iterations or epochs under
``<work-dir>/ckpt`` (``utils/checkpoint.py``; a populated directory
resumes, also at another worker count). ``kmeans``, ``sgd_mf`` and ``lda``
take ``--quant {int8,bf16}``, the quantized wire format of their
collectives, and ``nn`` takes ``--layers`` as
comma-separated hidden sizes (``--layers 256,128``). The JAX launcher
registers both flags but drops them (its config parsing keeps only int,
float, str and bool fields), so there a run takes the float32 wire and the
default layers.

Under the launcher (``python -m harp_tpu_torch.parallel.launch --nproc P
[--workers-per-process W_local] -- python -m harp_tpu_torch.run sgd_mf
...``), ``run sgd_mf`` joins the gang when ``HARP_NUM_PROCESSES`` is set:
its session spans the P processes, with ``--num-workers`` (default P times
``HARP_WORKERS_PER_PROCESS``) workers, and process 0 prints the result.

Every subcommand takes the telemetry flags (``harp_tpu_torch.telemetry``):
``--telemetry-dir DIR`` writes one JSON event a training step to
``DIR/rank<r>/steps.jsonl`` (loss, step wall, and for the priced fits the
reference collective volume of a step: the JAX package's traced figure,
not bytes the port moved) and polls the trigger file
``DIR/xprof_request.json``: writing ``{"steps": N}`` there while the job
runs opens a ``torch.profiler`` window over the next N chunk boundaries
into ``DIR/xprof/rank<r>/``. In a gang, every ``--telemetry-interval``
boundaries (default 16; also the JSONL flush cadence) the ranks exchange
their metric snapshots over the session's event plane and process 0
writes ``DIR/straggler_report.json``. ``--metrics-port P`` serves
``/metrics`` (Prometheus text), ``/snapshot`` and, in a gang, ``/gang`` on
127.0.0.1 (0: an ephemeral port; above 0: P plus the rank), and prints the
address to stderr. The JAX launcher's ``--slo-p99-ms``, ``--slo-window-s``
and ``--slo-error-budget`` wait for the port of ``telemetry/watchdog.py``
and are not registered.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

from harp_tpu_torch.config import add_dataclass_args

def _common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--num-workers", type=int, default=None,
                   help="workers of the group (reference: map tasks); default "
                        "1, or every process's workers under the launcher")
    p.add_argument("--device", default="cuda",
                   help="device to run on (default cuda; cpu runs the plain "
                        "PyTorch path)")
    p.add_argument("--work-dir", default="",
                   help="output directory (optional)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--telemetry-dir", default="",
                   help="enable telemetry (harp_tpu_torch.telemetry): "
                        "per-step JSONL events and comm-volume gauges in "
                        "DIR/rank<r>/, the xprof trigger file "
                        "DIR/xprof_request.json, and in a gang the "
                        "straggler report. Empty = off.")
    p.add_argument("--telemetry-interval", type=int, default=16,
                   help="telemetry cadence in CHUNK BOUNDARIES (a count, so "
                        "gang ranks stay aligned): flush and gang straggler "
                        "publish every N boundaries")
    p.add_argument("--metrics-port", type=int, default=-1,
                   help="start the pull exporter (telemetry.exporter: "
                        "/metrics Prometheus text, /snapshot JSON, /gang in "
                        "a gang) on 127.0.0.1. 0 = ephemeral port (printed "
                        "at startup), >0 = that port + this process's rank, "
                        "negative = off.")


def _session(args, num_workers=None, distributed=False):
    """The subcommand's HarpSession, with telemetry brought up as the
    flags ask."""
    from harp_tpu_torch.session import HarpSession

    sess = HarpSession(num_workers=num_workers or args.num_workers or 1,
                       device=args.device, distributed=distributed)
    if args.telemetry_dir:
        _enable_telemetry(sess, args.telemetry_dir, args.telemetry_interval,
                          metrics_port=args.metrics_port)
    elif args.metrics_port >= 0:
        # the exporter serves without the JSONL layer (scrape-only runs)
        _start_exporter(args.metrics_port, collector=None)
    return sess


def _start_exporter(metrics_port: int, collector):
    from harp_tpu_torch.telemetry.exporter import MetricsExporter

    rank = int(os.environ.get("HARP_PROCESS_ID", "0"))
    port = metrics_port + rank if metrics_port > 0 else 0
    exporter = MetricsExporter(
        port=port, rank=rank,
        gang=collector.snapshots if collector is not None else None)
    print(f"harp_tpu_torch.telemetry: metrics exporter on "
          f"http://{exporter.host}:{exporter.port} "
          f"(/metrics, /snapshot{', /gang' if collector else ''})",
          file=sys.stderr, flush=True)
    return exporter


def _enable_telemetry(sess, directory: str, interval: int, *,
                      metrics_port: int = -1) -> None:
    """Bring up telemetry for this run: the per-step JSONL and comm gauges,
    the xprof controller on the trigger file as a chunk-boundary hook, in
    a gang the straggler publisher (a count-based cadence: every member
    runs the same host loop), and the exporter when ``metrics_port`` >= 0."""
    from harp_tpu_torch import telemetry
    from harp_tpu_torch.parallel import distributed
    from harp_tpu_torch.telemetry.xprof import XprofController

    log = telemetry.configure(directory, interval=interval)
    # the operator trigger: `echo '{"steps": 20}' > DIR/xprof_request.json`
    # while the job runs opens a window on every rank at its next boundary
    log.add_boundary_hook(XprofController(
        sess, trigger_path=os.path.join(directory, "xprof_request.json"),
        default_dir=os.path.join(directory, "xprof")))
    collector = None
    if distributed.process_count() > 1:
        from harp_tpu_torch.telemetry.gang import GangCollector

        collector = GangCollector(sess, directory)
        log.add_boundary_hook(collector)
    if metrics_port >= 0:
        _start_exporter(metrics_port, collector)


def _quant(value):
    """``--quant``: None for an empty value or "none", else the codec
    (checked by the model's ``CommConfig``)."""
    return None if value in (None, "", "none") else value


def _load_points(spec: str) -> np.ndarray:
    """A CSV file, a directory of CSV part-files, or a glob (path order;
    ``_``/``.``-prefixed part-files such as ``_README`` are skipped), parsed
    by ``loaders.load_dense_csv`` (the native parser where it builds)."""
    from harp_tpu_torch.io import loaders

    return loaders.load_dense_csv(loaders.list_files(spec))


def run_kmeans(argv) -> int:
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import kmeans as km
    p = argparse.ArgumentParser(prog="harp_tpu_torch.run kmeans")
    _common_flags(p)
    p.add_argument("--num-points", type=int, default=100_000)
    p.add_argument("--points-file", default="")
    p.add_argument("--format", default="dense", choices=["dense", "csr"],
                   help="csr = sparse-input variant "
                        "(daal_kmeans/allreducecsr); synthetic data is "
                        "sparsified at --density")
    p.add_argument("--density", type=float, default=0.05,
                   help="synthetic sparsity for --format csr")
    p.add_argument("--save-every", type=int, default=0,
                   help="checkpoint centroids every N iterations into "
                        "work-dir (resumes automatically)")
    p.add_argument("--stream", action="store_true",
                   help="stream --points-file through the chunked "
                        "ingestion pipeline (harp_tpu_torch.io.pipeline) "
                        "instead of loading it whole: bounded host memory, "
                        "H2D overlapped with assembly, bitwise-identical "
                        "centroids")
    p.add_argument("--chunk-rows", type=int, default=65536,
                   help="rows per streamed chunk (--stream)")
    add_dataclass_args(p, km.KMeansConfig)
    args = p.parse_args(argv)
    if args.save_every and not args.work_dir:
        p.error("--save-every requires --work-dir (nowhere to checkpoint)")
    if args.stream and not args.points_file:
        p.error("--stream streams part-files: it requires --points-file")
    if args.stream and args.save_every:
        p.error("--stream runs the fit once over the assembled block: "
                "checkpointing applies to the in-memory path (drop --stream "
                "or --save-every)")
    args.quant = _quant(args.quant)
    cfg = km.KMeansConfig(**{f.name: getattr(args, f.name)
                             for f in dataclasses.fields(km.KMeansConfig)})
    if args.format == "csr" and (args.points_file or args.quant
                                 or args.save_every
                                 or cfg.comm != "regroupallgather"):
        p.error("--format csr supports synthetic data with the fixed "
                "allreduce collective (daal_kmeans/allreducecsr): "
                "--points-file/--save-every/--comm/--quant do not apply")
    sess = _session(args)
    if args.format == "csr":
        return _kmeans_csr(sess, cfg, args)
    if args.stream:
        return _kmeans_stream(p, sess, cfg, args)
    if args.points_file:
        pts = _load_points(args.points_file)
        cfg = dataclasses.replace(cfg, dim=pts.shape[1])
    else:
        pts = datagen.dense_points(args.num_points, cfg.dim, seed=args.seed,
                                   num_clusters=cfg.num_centroids)
    pts = pts[: len(pts) - len(pts) % sess.num_workers]
    if len(pts) == 0:
        p.error(f"fewer points than the {sess.num_workers} workers")
    cen0 = datagen.initial_centroids(pts, cfg.num_centroids, seed=args.seed + 1)
    model = km.KMeans(sess, cfg)
    pts_dev, cen_dev = model.prepare(pts, cen0)
    if args.save_every:
        from harp_tpu_torch.utils.checkpoint import Checkpointer

        ckpt = Checkpointer(os.path.join(args.work_dir, "ckpt"))
        t0 = time.perf_counter()
        cen, costs, start = model.fit_checkpointed(
            pts_dev, cen_dev, ckpt, save_every=args.save_every)
        sess.barrier()
        ran = cfg.iterations - start
        timing = " (incl build)"
    else:
        model.fit_prepared(pts_dev, cen_dev)      # warm-up (builds the kernel)
        sess.barrier()
        t0 = time.perf_counter()
        cen, costs = model.fit_prepared(pts_dev, cen_dev)
        sess.barrier()
        costs = costs.cpu().numpy()
        ran = cfg.iterations
        timing = ""
    dt = time.perf_counter() - t0
    if ran > 0:
        print(f"kmeans[{cfg.comm}] workers={sess.num_workers} n={len(pts)} "
              f"k={cfg.num_centroids} d={cfg.dim}: {ran / dt:.2f} "
              f"iters/s{timing}, cost {costs[0]:.1f} -> {costs[-1]:.1f}")
    else:
        print(f"kmeans[{cfg.comm}] workers={sess.num_workers}: fully "
              f"resumed from checkpoint, nothing left to run")
    if args.work_dir:
        os.makedirs(args.work_dir, exist_ok=True)
        np.savetxt(os.path.join(args.work_dir, "centroids.csv"),
                   cen.cpu().numpy(), delimiter=",")
    return 0


def _kmeans_stream(p, sess, cfg, args) -> int:
    """``run kmeans --stream``: part-files -> StreamLoader (native parse on
    the reader pool) -> DevicePrefetcher (H2D on a side stream) ->
    ``KMeans.fit_from_stream``."""
    from harp_tpu_torch.io import datagen, loaders
    from harp_tpu_torch.io import pipeline as pl
    from harp_tpu_torch.models import kmeans as km

    paths = loaders.list_files(args.points_file)
    if not paths:
        p.error(f"no input files match {args.points_file!r}")
    # the head part alone seeds the centroids: streaming exists so that the
    # whole set never sits in host memory at once
    head = loaders.load_dense_csv([paths[0]])
    cfg = dataclasses.replace(cfg, dim=head.shape[1])
    loader = pl.StreamLoader(paths, chunk_rows=args.chunk_rows)
    total = loader.total_rows
    if total is None:             # no native counter, or URLs
        total = 0
        for pth in paths:
            opener = (loaders._fsspec_open(pth) if loaders._is_url(pth)
                      else open(pth, "rb"))
            with opener as f:
                total += sum(1 for ln in f if ln.strip())
    n_fit = total - total % sess.num_workers
    if n_fit <= 0:
        p.error(f"--stream input has {total} rows, fewer than the "
                f"{sess.num_workers} workers need")
    cen0 = datagen.initial_centroids(head, cfg.num_centroids,
                                     seed=args.seed + 1)
    model = km.KMeans(sess, cfg)
    t0 = time.perf_counter()
    cen, costs = model.fit_from_stream(
        pl.DevicePrefetcher(loader, sess.replicate_put), cen0, n_fit)
    costs = costs.cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"kmeans[stream/{cfg.comm}] workers={sess.num_workers} "
          f"n={n_fit} k={cfg.num_centroids} d={cfg.dim} "
          f"chunk_rows={args.chunk_rows}: {cfg.iterations / dt:.2f} "
          f"iters/s (incl stream+assembly), cost "
          f"{costs[0]:.1f} -> {costs[-1]:.1f}")
    if args.work_dir:
        os.makedirs(args.work_dir, exist_ok=True)
        np.savetxt(os.path.join(args.work_dir, "centroids.csv"),
                   cen.cpu().numpy(), delimiter=",")
    return 0


def _kmeans_csr(sess, cfg, args) -> int:
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import sparse as sp

    n = args.num_points - args.num_points % sess.num_workers
    rows, cols, vals = datagen.sparse_points(n, cfg.dim, args.density,
                                             seed=args.seed)
    dense0 = np.zeros((cfg.num_centroids, cfg.dim), np.float32)
    head = rows < cfg.num_centroids
    dense0[rows[head], cols[head]] = vals[head]
    model = sp.SparseKMeans(sess, sp.SparseKMeansConfig(
        cfg.num_centroids, cfg.dim, cfg.iterations))
    state = model.prepare(rows, cols, vals, n)
    model.fit_prepared(state, dense0)                  # warm-up
    sess.barrier()
    t0 = time.perf_counter()
    cen, costs = model.fit_prepared(state, dense0)
    dt = time.perf_counter() - t0
    print(f"kmeans[csr-allreduce] workers={sess.num_workers} n={n} "
          f"k={cfg.num_centroids} d={cfg.dim} nnz={len(vals)}: "
          f"{cfg.iterations / dt:.2f} iters/s, cost "
          f"{costs[0]:.1f} -> {costs[-1]:.1f}")
    return 0


def run_sgd_mf(argv) -> int:
    from harp_tpu_torch.io import datagen, loaders
    from harp_tpu_torch.models import sgd_mf
    p = argparse.ArgumentParser(prog="harp_tpu_torch.run sgd_mf")
    _common_flags(p)
    p.add_argument("--num-users", type=int, default=8192)
    p.add_argument("--num-items", type=int, default=8192)
    p.add_argument("--density", type=float, default=0.01)
    p.add_argument("--ratings-file", default="",
                   help="COO 'row col value' file/dir/glob (e.g. "
                        "datasets/sgd_mf); overrides the synthetic data")
    p.add_argument("--adaptive", action="store_true",
                   help="auto-tune the per-hop budget (adjustMiniBatch analog)")
    p.add_argument("--save-every", type=int, default=0,
                   help="checkpoint every N epochs into work-dir (resumes "
                        "automatically if checkpoints exist)")
    add_dataclass_args(p, sgd_mf.SGDMFConfig)
    args = p.parse_args(argv)
    if args.save_every and not args.work_dir:
        p.error("--save-every requires --work-dir (nowhere to checkpoint)")
    args.quant = _quant(args.quant)
    cfg = sgd_mf.SGDMFConfig(**{
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(sgd_mf.SGDMFConfig)})
    gang = "HARP_NUM_PROCESSES" in os.environ
    workers = args.num_workers
    if workers is None:
        workers = (int(os.environ["HARP_NUM_PROCESSES"]) * int(
            os.environ.get("HARP_WORKERS_PER_PROCESS", "1")) if gang else 1)
    sess = _session(args, workers, distributed=gang)
    lead = sess.workers.rank == 0
    if args.ratings_file:
        rows, cols, vals = loaders.load_coo(
            loaders.list_files(args.ratings_file))
        # shapes come from the data; --num-users/--num-items are ignored
        nu, ni = int(rows.max()) + 1, int(cols.max()) + 1
    else:
        rows, cols, vals = datagen.sparse_ratings(
            args.num_users, args.num_items, rank=min(cfg.rank, 16),
            density=args.density, seed=args.seed)
        nu, ni = args.num_users, args.num_items
    model = sgd_mf.SGDMF(sess, cfg)
    state = model.prepare(rows, cols, vals, nu, ni, seed=args.seed)
    ran = cfg.epochs
    if args.save_every:
        from harp_tpu_torch.utils.checkpoint import Checkpointer

        ckpt = Checkpointer(os.path.join(args.work_dir, "ckpt"))
        model.warmup_epoch(state)                 # builds outside the timing
        sess.barrier()
        t0 = time.perf_counter()
        w, h, rmse, start = model.fit_checkpointed(
            state, ckpt, save_every=args.save_every)
        sess.barrier()
        dt = time.perf_counter() - t0
        ran = cfg.epochs - start
    elif args.adaptive:
        w, h, rmse, tuner = model.fit_adaptive(state)
        if lead:
            print(f"tuned budget: {tuner.chosen} "
                  f"(times {dict(sorted(tuner.times.items()))})")
        # the tuner's steady-state epoch times, not the warm-up calls
        dt = tuner.times[tuner.chosen] * cfg.epochs
    else:
        model.fit_prepared(state)                 # warm-up (builds the kernel)
        sess.barrier()
        t0 = time.perf_counter()
        w, h, rmse = model.fit_prepared(state)
        dt = time.perf_counter() - t0
    nnz = len(vals) - model.last_layout_stats.get("duplicates_dropped", 0)
    steady = " (tuner steady-state)" if args.adaptive else ""
    if gang:
        from harp_tpu_torch.ops import ring_dma
        from harp_tpu_torch.parallel import distributed

        ring_dma.check_errors()
        distributed.shutdown()
    if not lead:
        return 0
    if ran <= 0 or not len(rmse):
        print(f"sgd_mf[{model.last_layout_stats['layout']}] "
              f"workers={sess.num_workers}: fully resumed from checkpoint, "
              f"nothing left to run")
        return 0
    sps = nnz * ran / dt
    print(f"sgd_mf[{model.last_layout_stats['layout']}] "
          f"workers={sess.num_workers} nnz={nnz} rank={cfg.rank}: "
          f"{sps / 1e6:.2f} M samples/s{steady}, rmse {rmse[0]:.4f} -> "
          f"{rmse[-1]:.4f}")
    if args.work_dir:
        os.makedirs(args.work_dir, exist_ok=True)
        np.savetxt(os.path.join(args.work_dir, "w.csv"), w, delimiter=",")
        np.savetxt(os.path.join(args.work_dir, "h.csv"), h, delimiter=",")
    return 0


def run_lda(argv) -> int:
    from harp_tpu_torch.io import datagen, loaders
    from harp_tpu_torch.models import lda
    p = argparse.ArgumentParser(prog="harp_tpu_torch.run lda")
    _common_flags(p)
    p.add_argument("--num-docs", type=int, default=1024)
    p.add_argument("--doc-len", type=int, default=64)
    p.add_argument("--corpus-file", default="",
                   help="token-id corpus file/dir/glob (one doc per line, "
                        "fixed length — e.g. datasets/lda); overrides the "
                        "synthetic corpus; vocab grows to fit the data")
    p.add_argument("--save-every", type=int, default=0,
                   help="checkpoint the chain (z + word-topic model) every "
                        "N epochs into work-dir (resumes automatically)")
    add_dataclass_args(p, lda.LDAConfig)
    args = p.parse_args(argv)
    if args.save_every and not args.work_dir:
        p.error("--save-every requires --work-dir (nowhere to checkpoint)")
    args.quant = _quant(args.quant)
    cfg = lda.LDAConfig(**{f.name: getattr(args, f.name)
                           for f in dataclasses.fields(lda.LDAConfig)})
    sess = _session(args)
    if args.corpus_file:
        docs = loaders.truncate_to_workers(
            loaders.load_corpus(args.corpus_file), sess.num_workers)
        num_docs = len(docs)
        if docs.size and int(docs.max()) >= cfg.vocab:
            cfg = dataclasses.replace(cfg, vocab=int(docs.max()) + 1)
    else:
        num_docs = args.num_docs - args.num_docs % sess.num_workers
        docs = datagen.lda_corpus(num_docs, cfg.vocab,
                                  max(2, cfg.num_topics // 2), args.doc_len,
                                  seed=args.seed)
    model = lda.LDA(sess, cfg)
    state = model.prepare(docs, seed=args.seed)   # host layout + H2D once
    if args.save_every:
        from harp_tpu_torch.utils.checkpoint import Checkpointer

        ckpt = Checkpointer(os.path.join(args.work_dir, "ckpt"))
        t0 = time.perf_counter()
        _, _, ll, start = model.fit_checkpointed(
            state, ckpt, save_every=args.save_every)
        sess.barrier()
        ran = cfg.epochs - start
        dt = time.perf_counter() - t0
        timing = " (incl build)"
        if ran <= 0:
            print(f"lda[{cfg.method}] workers={sess.num_workers}: fully "
                  f"resumed from checkpoint, nothing left to run")
            return 0
    else:
        model.fit_prepared(state)                 # warm-up
        sess.barrier()
        t0 = time.perf_counter()
        _, _, ll = model.fit_prepared(state)
        sess.barrier()
        ran = cfg.epochs
        dt = time.perf_counter() - t0
        timing = ""
    toks = docs.size * ran
    print(f"lda[{cfg.method}] workers={sess.num_workers} docs={num_docs} "
          f"vocab={cfg.vocab} K={cfg.num_topics}: {toks / dt / 1e6:.2f} "
          f"M tokens/s{timing}, ll {ll[0]:.4e} -> {ll[-1]:.4e}")
    return 0


def run_als(argv) -> int:
    from harp_tpu_torch.io import datagen, loaders
    from harp_tpu_torch.models import als
    p = argparse.ArgumentParser(prog="harp_tpu_torch.run als")
    _common_flags(p)
    p.add_argument("--num-users", type=int, default=2048)
    p.add_argument("--num-items", type=int, default=2048)
    p.add_argument("--density", type=float, default=0.01)
    p.add_argument("--ratings-file", default="",
                   help="COO 'row col value' file/dir/glob (e.g. "
                        "datasets/als); overrides the synthetic data")
    add_dataclass_args(p, als.ALSConfig)
    args = p.parse_args(argv)
    cfg = als.ALSConfig(**{f.name: getattr(args, f.name)
                           for f in dataclasses.fields(als.ALSConfig)})
    sess = _session(args)
    if args.ratings_file:
        rows, cols, vals = loaders.load_coo(
            loaders.list_files(args.ratings_file))
        # shapes come from the data; --num-users/--num-items are ignored
        nu, ni = int(rows.max()) + 1, int(cols.max()) + 1
    else:
        rows, cols, vals = datagen.sparse_ratings(
            args.num_users, args.num_items, rank=min(cfg.rank, 16),
            density=args.density, seed=args.seed)
        nu, ni = args.num_users, args.num_items
    if cfg.implicit:
        vals = np.abs(vals)      # implicit mode consumes interaction counts
    model = als.ALS(sess, cfg)
    state = model.prepare(rows, cols, vals, nu, ni, seed=args.seed)
    model.train_prepared(state)                   # warm-up (builds the kernel)
    sess.barrier()
    t0 = time.perf_counter()
    u, v, rmse = model.fit_prepared(state)
    dt = time.perf_counter() - t0
    mode = "implicit" if cfg.implicit else "explicit"
    print(f"als[{mode}] workers={sess.num_workers} nnz={len(vals)} "
          f"rank={cfg.rank}: {cfg.iterations / dt:.2f} iters/s, "
          f"rmse {rmse[0]:.4f} -> {rmse[-1]:.4f}")
    if args.work_dir:
        os.makedirs(args.work_dir, exist_ok=True)
        np.savetxt(os.path.join(args.work_dir, "u.csv"), u, delimiter=",")
        np.savetxt(os.path.join(args.work_dir, "v.csv"), v, delimiter=",")
    return 0


def run_pca(argv) -> int:
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import stats
    p = argparse.ArgumentParser(prog="harp_tpu_torch.run pca")
    _common_flags(p)
    p.add_argument("--num-points", type=int, default=65536)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--iterations", type=int, default=5,
                   help="timed repeats")
    p.add_argument("--method", default="cor", choices=["cor", "svd"],
                   help="cor = cordensedistr; svd = svddensedistr "
                        "(z-score + TSQR-SVD)")
    p.add_argument("--format", default="dense", choices=["dense", "csr"],
                   help="csr = daal_pca/corcsrdistr from sparse input")
    p.add_argument("--density", type=float, default=0.05,
                   help="synthetic sparsity for --format csr")
    p.add_argument("--points-file", default="",
                   help="dense CSV file/dir/glob (e.g. datasets/pca); "
                        "overrides the synthetic data (dense format only)")
    args = p.parse_args(argv)
    if args.points_file and args.format == "csr":
        p.error("--points-file applies to --format dense only")
    if args.format == "csr" and args.method != "cor":
        p.error("--format csr implements the correlation method only "
                "(daal_pca/corcsrdistr: the reference has no svd-csr "
                "variant)")
    sess = _session(args)
    n = args.num_points - args.num_points % sess.num_workers
    if args.format == "csr":
        from harp_tpu_torch.models import sparse as sp

        rows, cols, vals = datagen.sparse_points(n, args.dim, args.density,
                                                 seed=args.seed)
        t0 = time.perf_counter()
        w, comps, mean = sp.CSRPCA(sess).fit(rows, cols, vals, n, args.dim)
        dt = time.perf_counter() - t0
        print(f"pca[csr] workers={sess.num_workers} n={n} d={args.dim} "
              f"nnz={len(vals)}: fit in {dt:.2f}s (incl. first call), top "
              f"eigenvalue {w[0]:.4f}")
        return 0
    if args.points_file:
        x = _load_points(args.points_file)
        x = x[: len(x) - len(x) % sess.num_workers]
        if len(x) == 0:
            p.error(f"fewer points than the {sess.num_workers} workers")
        n = len(x)
    else:
        x = datagen.dense_points(n, args.dim, seed=args.seed)
    x_dev = sess.scatter(x)       # placed once; the fits take it as it is
    model = stats.PCA(sess, method=args.method)
    model.fit_repeated(x_dev, args.iterations)        # warm-up
    sess.barrier()
    t0 = time.perf_counter()
    w, comps, mean = model.fit_repeated(x_dev, args.iterations)
    dt = time.perf_counter() - t0
    tag = "pca" if args.method == "cor" else "pca[svd]"
    print(f"{tag} workers={sess.num_workers} n={n} d={x.shape[1]}: "
          f"{args.iterations / dt:.2f} fits/s, top eigenvalue {w[0]:.4f}")
    return 0


def run_nn(argv) -> int:
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import nn
    p = argparse.ArgumentParser(prog="harp_tpu_torch.run nn")
    _common_flags(p)
    p.add_argument("--num-points", type=int, default=8192)
    p.add_argument("--dim", type=int, default=64)
    add_dataclass_args(p, nn.NNConfig)
    args = p.parse_args(argv)
    if isinstance(args.layers, str):
        try:
            args.layers = tuple(int(v) for v in args.layers.split(",") if v)
        except ValueError:
            p.error(f"--layers takes comma-separated sizes, got "
                    f"{args.layers!r}")
    cfg = nn.NNConfig(**{f.name: getattr(args, f.name)
                         for f in dataclasses.fields(nn.NNConfig)})
    sess = _session(args)
    n = args.num_points - args.num_points % sess.num_workers
    x, y = datagen.classification_data(n, args.dim, cfg.num_classes,
                                       seed=args.seed)
    x_dev, y_dev = sess.scatter(x), sess.scatter(y)   # placed once
    model = nn.MLPClassifier(sess, cfg)
    model.fit(x_dev, y_dev, seed=args.seed)           # warm-up
    sess.barrier()
    t0 = time.perf_counter()
    losses = model.fit(x_dev, y_dev, seed=args.seed)
    dt = time.perf_counter() - t0
    acc = (model.predict(x) == y).mean()
    samples = n * cfg.epochs
    print(f"nn workers={sess.num_workers} n={n} d={args.dim} "
          f"layers={cfg.layers}: {samples / dt / 1e6:.2f} M samples/s, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"train acc {acc:.3f}")
    return 0


SOLVER_KINDS = ("sgd", "sgd_minibatch", "sgd_momentum", "adagrad", "lbfgs")


def run_solver(argv) -> int:
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import solvers
    p = argparse.ArgumentParser(prog="harp_tpu_torch.run solver")
    _common_flags(p)
    p.add_argument("--kind", default="lbfgs", choices=SOLVER_KINDS)
    p.add_argument("--num-points", type=int, default=4096)
    p.add_argument("--dim", type=int, default=32)
    add_dataclass_args(p, solvers.SolverConfig)
    args = p.parse_args(argv)
    cfg = solvers.SolverConfig(**{
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(solvers.SolverConfig)})
    sess = _session(args)
    n = args.num_points - args.num_points % sess.num_workers
    x, y, _ = datagen.regression_data(n, args.dim, seed=args.seed)
    y = y.reshape(-1)
    theta0 = np.zeros(args.dim, np.float32)
    t0 = time.perf_counter()
    theta, losses = solvers.Solver(sess, args.kind, cfg).minimize(
        solvers.mse_objective, x, y, theta0)
    dt = time.perf_counter() - t0
    print(f"solver[{args.kind}] workers={sess.num_workers} n={n} "
          f"d={args.dim}: {cfg.iterations / dt:.1f} iters/s (first call), "
          f"mse {losses[0]:.4f} -> {losses[-1]:.6f}")
    return 0


STATS_OPS = ("cov", "moments", "zscore", "minmax", "qr", "pivoted_qr", "svd",
             "cholesky", "quantiles", "sort", "outlier")


def run_stats(argv) -> int:
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import stats
    p = argparse.ArgumentParser(prog="harp_tpu_torch.run stats")
    _common_flags(p)
    p.add_argument("--op", default="cov", choices=STATS_OPS)
    p.add_argument("--num-points", type=int, default=8192)
    p.add_argument("--dim", type=int, default=64)
    args = p.parse_args(argv)
    sess = _session(args)
    n = args.num_points - args.num_points % sess.num_workers
    x = datagen.dense_points(n, args.dim, seed=args.seed)
    t0 = time.perf_counter()
    if args.op == "cov":
        cov, mean = stats.Covariance(sess).compute(x)
        res = f"trace {np.trace(cov):.4f}"
    elif args.op == "moments":
        m = stats.LowOrderMoments(sess).compute(x)
        res = f"mean[0] {m.mean[0]:.4f} var[0] {m.variance[0]:.4f}"
    elif args.op == "zscore":
        z = stats.ZScore(sess).transform(x)
        res = f"col0 mean {z[:, 0].mean():.2e} std {z[:, 0].std():.4f}"
    elif args.op == "minmax":
        mm = stats.MinMax(sess).transform(x)
        res = f"range [{mm.min():.3f}, {mm.max():.3f}]"
    elif args.op == "qr":
        q, r = stats.QR(sess).compute(x)
        res = f"||QR-X|| {np.abs(q @ r - x).max():.2e}"
    elif args.op == "pivoted_qr":
        q, r, piv = stats.PivotedQR(sess).compute(x)
        res = f"||QR-X[:,piv]|| {np.abs(q @ r - x[:, piv]).max():.2e}"
    elif args.op == "svd":
        u, s, vt = stats.SVD(sess).compute(x)
        res = f"top sv {s[0]:.4f}"
    elif args.op == "cholesky":
        l = stats.Cholesky(sess).compute(x)
        res = f"diag[0] {l[0, 0]:.4f}"
    elif args.op == "quantiles":
        q = stats.Quantiles(sess).compute(x, [0.25, 0.5, 0.75])
        res = f"col0 quartiles {np.round(q[:, 0], 4).tolist()}"
    elif args.op == "sort":
        s = stats.Sorting(sess).compute(x)
        res = f"col0 sorted: {bool((np.diff(s[:, 0]) >= 0).all())}"
    else:
        flags = stats.OutlierDetection(sess).compute(x)
        res = f"outliers {int(flags.sum())}/{n}"
    dt = time.perf_counter() - t0
    print(f"stats[{args.op}] workers={sess.num_workers} n={n} "
          f"d={args.dim}: {res} ({dt:.1f}s incl. first call)")
    return 0


COMMANDS = {"kmeans": run_kmeans, "sgd_mf": run_sgd_mf, "lda": run_lda,
            "als": run_als,
            "pca": run_pca, "stats": run_stats, "nn": run_nn,
            "solver": run_solver}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m harp_tpu_torch.run {{{','.join(COMMANDS)}}} "
              f"[flags]", file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
