"""Where the narrow E-step's cycles go: a clock-stamped copy of the kernel.

The narrow E-step kernel (``kmeans_stats_kernel`` in
``harp_tpu_torch/csrc/kmeans_stats.cu``) is copied with ``clock64()`` stamps
between the phases of its tile loop, built beside the real library, and run
once at the K-means flagship's shape (N = 1,000,000, K = D = 100) on points
drawn on the card. Each of the block (0, 0)'s three warpgroups stamps from
its first thread, summed over its tiles; the script prints cycles a tile
for each warpgroup and phase:

    load    the tile's copies and the warpgroup's barrier after them
    scores  the products, a chunk's argmin and runner-up
    rank    the quad's best two, near ties re-scored, the stable rank
    token   the wait for the adds' turn
    adds    the tile added into the partial
    end     the barrier that frees the tile

The stamps cost cycles of their own, so the phases sum to more than an
unstamped tile; compare phases, not totals. Run on a card:

    python -m harp_tpu_torch.benchmark.estep_stamps [--dtype float32 bfloat16]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch

PHASES = ("load", "scores", "rank", "token", "adds", "end")
GROUPS = 3                  # warpgroups a narrow block (kGroups)

_DEFS = """
__device__ unsigned long long g_stamp[32];
#define STAMP(k, t) do { if (blockIdx.x == 0 && blockIdx.y == 0 && \\
    threadIdx.x % 128 == 0) { unsigned long long n_ = clock64(); \\
    atomicAdd(&g_stamp[8 * (threadIdx.x / 128) + (k)], n_ - (t)); \\
    t = n_; } } while (0)
"""
_API = """
extern "C" int stamp_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
}
extern "C" int stamp_reset() {
  unsigned long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(g_stamp, z, sizeof(z));
}
"""
# (anchor in the narrow kernel, the stamp put before it, the stamp after)
_MARKS = (
    ("  if (wg == kGroups - 1 && iters > 0) bar_arrive(kTokenBar, 2 * kWG);\n",
     "", "  unsigned long long ts = clock64();\n"),
    ("      load_tile<T>(xw + (size_t)base * d, cnt, d, S, tile, wt, vb);\n"
     "      bar_sync(kGroupBar + wg, kWG);\n", "", "      STAMP(0, ts);\n"),
    ("      quad_finish(top, xsq);\n", "      STAMP(1, ts);\n", ""),
    ("    bar_sync(kTokenBar + wg, 2 * kWG);\n", "    STAMP(2, ts);\n",
     "    STAMP(3, ts);\n"),
    ("    bar_sync(kGroupBar + wg, kWG);        // the tile's readers are "
     "done\n", "    STAMP(4, ts);\n", "    STAMP(5, ts);\n"),
)


def stamped_source(src: str) -> str:
    """The kernel source with the stamps put in; raises if an anchor is
    missing (the kernel changed: update ``_MARKS``)."""
    def once(text, old, new):
        if text.count(old) != 1:
            raise RuntimeError("estep_stamps: an anchor of the narrow E-step "
                               "kernel is not in the source:\n" + old)
        return text.replace(old, new)

    out = once(src, "namespace {\n\nconstexpr int kTile", _DEFS +
               "namespace {\n\nconstexpr int kTile")
    for anchor, before, after in _MARKS:
        out = once(out, anchor, before + anchor + after)
    return out + _API


def build(out_dir: str) -> ctypes.CDLL:
    """nvcc the stamped copy with the library's own flags into
    ``out_dir`` and load it."""
    from harp_tpu_torch.ops import _cuda_build

    os.makedirs(out_dir, exist_ok=True)
    src = (_cuda_build.CSRC / "kmeans_stats.cu").read_text()
    path = os.path.join(out_dir, "kmeans_stats_stamped.cu")
    with open(path, "w") as f:
        f.write(stamped_source(src))
    lib_path = os.path.join(out_dir, "libkmeans_stats_stamped.so")
    subprocess.run([_cuda_build._nvcc(), *_cuda_build._flags("kmeans_stats"),
                    "-I", str(_cuda_build.CSRC), "-o", lib_path, path],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(lib_path)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` bound as the wrapper binds the real library."""
    from harp_tpu_torch.ops import _cuda_build, pallas_kernels as pk

    saved, real = pk._LIB.pop("kmeans_stats", None), _cuda_build.library
    _cuda_build.library = lambda name: lib
    try:
        return pk._kmeans_lib()
    finally:
        _cuda_build.library = real
        pk._LIB.pop("kmeans_stats", None)
        if saved is not None:
            pk._LIB["kmeans_stats"] = saved


def flagship_points(n=1_000_000, k=100, d=100, seed=11):
    """``datagen.dense_points``' recipe drawn on the card (k uniform
    centres, spread 0.1) and k of the points as centroids."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.rand(k, d, device="cuda", generator=g)
    assign = torch.randint(k, (n,), device="cuda", generator=g)
    pts = centers[assign] + 0.1 * torch.randn(n, d, device="cuda",
                                              generator=g)
    pick = torch.randperm(n, device="cuda", generator=g)[:k]
    return pts, pts[pick].contiguous()


def main(argv=None) -> int:
    from harp_tpu_torch.ops import pallas_kernels as pk

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--out", default=os.path.join("build", "estep_stamps"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("estep_stamps needs an NVIDIA GPU")
    lib = bind(build(args.out))
    lib.stamp_read.argtypes = [ctypes.c_void_p]
    x, c = flagship_points()
    n, d = x.shape
    k = c.shape[0]
    tiles = -(-n // 64)
    saved = pk._LIB.get("kmeans_stats")
    try:
        for name in args.dtype:
            xt = x.to(getattr(torch, name))
            pk._LIB["kmeans_stats"] = lib
            grid = lib.kmeans_stats_grid(n, d, k, k, int(name == "bfloat16"))
            pk.kmeans_stats_cuda(xt, c)
            torch.cuda.synchronize()
            lib.stamp_reset()
            pk.kmeans_stats_cuda(xt, c)
            torch.cuda.synchronize()
            arr = (ctypes.c_ulonglong * 32)()
            lib.stamp_read(arr)
            mine = -(-tiles // grid)          # block 0's tiles
            for wg in range(GROUPS):
                count = len(range(wg, mine, GROUPS))
                per = {p: arr[8 * wg + i] / count
                       for i, p in enumerate(PHASES)}
                print(f"[estep_stamps] {name}, {torch.cuda.get_device_name(0)}"
                      f", grid {grid}: cycles a tile, block (0, 0), warpgroup "
                      f"{wg} ({count} tiles): " + ", ".join(
                          f"{p} {v:.0f}" for p, v in per.items())
                      + f"; sum {sum(per.values()):.0f}", flush=True)
    finally:
        if saved is None:
            pk._LIB.pop("kmeans_stats", None)
        else:
            pk._LIB["kmeans_stats"] = saved
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
