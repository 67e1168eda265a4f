"""Command-line launcher: ``python -m harp_tpu_torch.run <algorithm> [flags]``.

Port of ``harp_tpu/run.py``. Ported subcommands: ``kmeans``, ``sgd_mf`` and
``als``.
The run goes on CUDA unless ``--device cpu`` is given; without CUDA the
default fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

from harp_tpu_torch.config import add_dataclass_args

# flags of the JAX launcher whose paths are not ported yet
NOT_PORTED = {"--stream": dict(action="store_true"),
              "--save-every": dict(type=int, default=0),
              "--quant": dict(default=None)}


def _common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--num-workers", type=int, default=1,
                   help="workers of the stacked group (reference: map tasks)")
    p.add_argument("--device", default="cuda",
                   help="device to run on (default cuda; cpu runs the plain "
                        "PyTorch path)")
    p.add_argument("--work-dir", default="",
                   help="output directory (optional)")
    p.add_argument("--seed", type=int, default=0)


def _load_points(spec: str) -> np.ndarray:
    """A CSV file, a directory of CSV part-files, or a glob (path order;
    ``_``/``.``-prefixed part-files such as ``_README`` are skipped)."""
    from harp_tpu_torch.io import loaders

    paths = loaders.list_files(spec)
    if not paths:
        raise FileNotFoundError(f"no input files match {spec!r}")
    return np.concatenate([np.loadtxt(p, delimiter=",", dtype=np.float32,
                                      ndmin=2) for p in paths])


def run_kmeans(argv) -> int:
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import kmeans as km
    from harp_tpu_torch.session import HarpSession

    p = argparse.ArgumentParser(prog="harp_tpu_torch.run kmeans")
    _common_flags(p)
    p.add_argument("--num-points", type=int, default=100_000)
    p.add_argument("--points-file", default="")
    p.add_argument("--format", default="dense")
    for flag, kw in NOT_PORTED.items():
        p.add_argument(flag, **kw)
    add_dataclass_args(p, km.KMeansConfig)
    args = p.parse_args(argv)
    for flag in NOT_PORTED:
        if getattr(args, flag[2:].replace("-", "_")):
            p.error(f"{flag} is not yet ported to harp_tpu_torch")
    if args.format != "dense":
        p.error(f"--format {args.format} is not yet ported to harp_tpu_torch "
                f"(dense only)")
    cfg = km.KMeansConfig(**{f.name: getattr(args, f.name)
                             for f in dataclasses.fields(km.KMeansConfig)})
    sess = HarpSession(num_workers=args.num_workers, device=args.device)
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
    model.fit_prepared(pts_dev, cen_dev)          # warm-up (builds the kernel)
    sess.barrier()
    t0 = time.perf_counter()
    cen, costs = model.fit_prepared(pts_dev, cen_dev)
    sess.barrier()
    dt = time.perf_counter() - t0
    costs = costs.cpu().numpy()
    print(f"kmeans[{cfg.comm}] workers={sess.num_workers} n={len(pts)} "
          f"k={cfg.num_centroids} d={cfg.dim}: {cfg.iterations / dt:.2f} "
          f"iters/s, cost {costs[0]:.1f} -> {costs[-1]:.1f}")
    if args.work_dir:
        os.makedirs(args.work_dir, exist_ok=True)
        np.savetxt(os.path.join(args.work_dir, "centroids.csv"),
                   cen.cpu().numpy(), delimiter=",")
    return 0


def run_sgd_mf(argv) -> int:
    from harp_tpu_torch.io import datagen, loaders
    from harp_tpu_torch.models import sgd_mf
    from harp_tpu_torch.session import HarpSession

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
    p.add_argument("--save-every", type=int, default=0)
    add_dataclass_args(p, sgd_mf.SGDMFConfig)
    args = p.parse_args(argv)
    if args.save_every:
        p.error("--save-every is not yet ported to harp_tpu_torch")
    if args.quant not in (None, "", "none"):
        p.error("--quant is not yet ported to harp_tpu_torch")
    if args.fused_dma:
        p.error("--fused-dma is not yet ported to harp_tpu_torch")
    cfg = sgd_mf.SGDMFConfig(**{
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(sgd_mf.SGDMFConfig) if f.name != "quant"})
    sess = HarpSession(num_workers=args.num_workers, device=args.device)
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
    if args.adaptive:
        w, h, rmse, tuner = model.fit_adaptive(state)
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
    sps = nnz * cfg.epochs / dt
    steady = " (tuner steady-state)" if args.adaptive else ""
    print(f"sgd_mf[{model.last_layout_stats['layout']}] "
          f"workers={sess.num_workers} nnz={nnz} rank={cfg.rank}: "
          f"{sps / 1e6:.2f} M samples/s{steady}, rmse {rmse[0]:.4f} -> "
          f"{rmse[-1]:.4f}")
    if args.work_dir:
        os.makedirs(args.work_dir, exist_ok=True)
        np.savetxt(os.path.join(args.work_dir, "w.csv"), w, delimiter=",")
        np.savetxt(os.path.join(args.work_dir, "h.csv"), h, delimiter=",")
    return 0


def run_als(argv) -> int:
    from harp_tpu_torch.io import datagen, loaders
    from harp_tpu_torch.models import als
    from harp_tpu_torch.session import HarpSession

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
    sess = HarpSession(num_workers=args.num_workers, device=args.device)
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


COMMANDS = {"kmeans": run_kmeans, "sgd_mf": run_sgd_mf, "als": run_als}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m harp_tpu_torch.run {{{','.join(COMMANDS)}}} "
              f"[flags]", file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
