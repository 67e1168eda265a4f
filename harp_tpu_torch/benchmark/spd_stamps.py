"""Where the one-warp SPD solve's cycles go: clock-stamped copies of it.

The K <= 32 kernel of ``harp_tpu_torch/csrc/spd_solve.cu``
(``spd_solve_kernel<K>``), or of the same source of another tree given by
``--sources`` (one whose K <= 32 kernel keeps a column of the system a lane
and moves l_j by shuffles, one system a warp, is stamped too), is copied with
``clock64()`` stamps between the phases of a system, built beside the real
library and run once on N ALS-shaped systems (V'V over 4K rows plus 0.1 I)
drawn on the card. Lane 0 of each warp of block 0 stamps, summed over the
warp's systems; the script prints cycles a warp's turn (one system, or the
2 or 4 a warp solves at once at K <= 16) for each phase:

    wait    the system's copies waited for (a column-per-lane copy: its
            loads, until every loaded value has arrived)
    load    the rows read from shared memory and the next system's copies
            issued (none in a column-per-lane copy)
    factor  the factorization and the forward substitution
    back    the back substitution (with the columns of L read back)

and the resident blocks an SM. The stamps cost cycles of their own, so
compare phases, not totals. Run on a card:

    python -m harp_tpu_torch.benchmark.spd_stamps [--k 32 10] [--n 8192] \\
        [--sources build/parent/spd_solve.cu harp_tpu_torch/csrc/spd_solve.cu]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch

PHASES = ("wait", "load", "factor", "back")
STAMPED_WARPS = 4            # the most warps a block of either kernel

_DEFS = """
__device__ unsigned long long g_stamp[32];
#define STAMP(i, t) do { if (blockIdx.x == 0 && (threadIdx.x & 31) == 0) { \\
    unsigned long long n_ = clock64(); \\
    atomicAdd(&g_stamp[8 * (threadIdx.x >> 5) + (i)], n_ - (t)); \\
    t = n_; } } while (0)
#define STAMP_TURN() do { if (blockIdx.x == 0 && (threadIdx.x & 31) == 0) \\
    atomicAdd(&g_stamp[8 * (threadIdx.x >> 5) + 7], 1ull); } while (0)
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
# this tree's kernel: (anchor, the stamp put before it, the stamp after)
_MARKS = (
    ("  for (;;) {\n", "", "    unsigned long long ts = clock64();\n"),
    ("    // row rho[r] of the system: c[r][i], entries i < (r + 1) G read\n",
     "    STAMP(0, ts);\n", ""),
    ("    __syncwarp();                            // the slot's rows are "
     "read\n", "", "    STAMP(1, ts);\n"),
    ("    __syncwarp();                            // the slot holds L by "
     "columns\n", "    STAMP(2, ts);\n", ""),
    ("    if (sys < n) {\n", "    STAMP(3, ts);\n    STAMP_TURN();\n", ""),
)
# a column of the system a lane, one system a warp
_PARENT_MARKS = (
    ("  if (sys >= n) return;                    // the whole warp leaves "
     "together\n  const float* as = a + sys * k * k;\n", "",
     "  unsigned long long ts = clock64();\n"),
    ("#pragma unroll\n  for (int j = 0; j < 32; ++j)\n    if (j < k) "
     "factor_step", "  {  // every loaded value has arrived\n"
     "    float s_ = r;\n    for (int i = 0; i < 32; ++i) s_ += c[i];\n"
     "    if (s_ == 1.2345e-38f) g_stamp[31] = 1;\n  }\n  STAMP(0, ts);\n",
     ""),
    ("#pragma unroll\n  for (int p = 31; p >= 0; --p)", "  STAMP(2, ts);\n",
     ""),
    ("  if (lane < k) x[sys * k + lane] = r;\n",
     "  STAMP(3, ts);\n  STAMP_TURN();\n", ""),
)
_PARENT_API = """
extern "C" int stamp_per_sm() {
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, spd_solve_kernel, kWarpBlock, 0);
  return e == cudaSuccess ? per_sm : -(int)e;
}
"""


def is_parent_layout(src: str) -> bool:
    """Whether ``src``'s K <= 32 kernel is the column-per-lane one."""
    return "factor_step(c, r, j, k, lane)" in src


def stamped_source(src: str) -> str:
    """The source with the stamps put in; raises if an anchor is missing
    (the kernel changed: update the marks)."""
    def once(text, old, new):
        if text.count(old) != 1:
            raise RuntimeError("spd_stamps: an anchor of the K <= 32 kernel "
                               "is not in the source:\n" + old)
        return text.replace(old, new)

    parent = is_parent_layout(src)
    out = once(src, "namespace {\n\nconstexpr unsigned kFull",
               _DEFS + "namespace {\n\nconstexpr unsigned kFull")
    for anchor, before, after in _PARENT_MARKS if parent else _MARKS:
        out = once(out, anchor, before + anchor + after)
    return out + _API + (_PARENT_API if parent else "")


def build(src_path: str, out_dir: str, name: str) -> ctypes.CDLL:
    """nvcc the stamped copy of ``src_path`` with the library's own flags
    into ``out_dir`` and load it."""
    from harp_tpu_torch.ops import _cuda_build

    os.makedirs(out_dir, exist_ok=True)
    with open(src_path) as f:
        text = stamped_source(f.read())
    path = os.path.join(out_dir, f"{name}_stamped.cu")
    with open(path, "w") as f:
        f.write(text)
    lib_path = os.path.join(out_dir, f"lib{name}_stamped.so")
    subprocess.run([_cuda_build._nvcc(), *_cuda_build._flags("spd_solve"),
                    "-I", str(_cuda_build.CSRC), "-o", lib_path, path],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    lib.stamp_read.argtypes = [ctypes.c_void_p]
    return lib


def systems(n: int, k: int, seed: int):
    """N ALS-shaped systems of rank K and right-hand sides, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    v = torch.randn(n, 4 * k, k, generator=g, device="cuda") / k ** 0.5
    a = torch.bmm(v.transpose(1, 2), v) + 0.1 * torch.eye(k, device="cuda")
    return a.contiguous(), torch.randn(n, k, generator=g, device="cuda")


def turns(lib, solve):
    """Cycles a warp's turn by phase (block 0's warps, their turns summed),
    from one stamped solve after a warm one; and the turns counted."""
    solve()
    torch.cuda.synchronize()
    lib.stamp_reset()
    solve()
    torch.cuda.synchronize()
    arr = (ctypes.c_ulonglong * 32)()
    lib.stamp_read(arr)
    count = sum(arr[8 * w + 7] for w in range(STAMPED_WARPS))
    return {p: sum(arr[8 * w + i] for w in range(STAMPED_WARPS)) /
            max(count, 1) for i, p in enumerate(PHASES)}, count


def main(argv=None) -> int:
    from harp_tpu_torch.ops import _cuda_build, pallas_kernels as pk

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, nargs="+", default=[32, 10])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--sources", nargs="+",
                    default=[str(_cuda_build.CSRC / "spd_solve.cu")],
                    help="spd_solve.cu of this tree or of another, each "
                         "stamped and timed in the order given")
    ap.add_argument("--out", default=os.path.join("build", "spd_stamps"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spd_stamps needs an NVIDIA GPU")
    card = torch.cuda.get_device_name(0)
    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    libs = []
    for n_src, path in enumerate(args.sources):
        with open(path) as f:
            parent = is_parent_layout(f.read())
        lib = build(path, args.out, f"spd_solve_{n_src}")
        if parent:
            lib.spd_solve_launch.argtypes = [vp, vp, vp, ll, i, vp]
        else:
            lib.spd_solve_launch.argtypes = [vp, vp, vp, ll, i, i, vp]
            lib.spd_solve_warp_per_sm.argtypes = [i]
        libs.append((path, parent, lib))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k in args.k:
        a, b = systems(args.n, k, seed=k)
        x = torch.empty(args.n, k, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for path, parent, lib in libs:
            if parent:
                per_sm, warps = lib.stamp_per_sm(), 4
                extra = ()
            else:
                per_sm = lib.spd_solve_warp_per_sm(k)
                warps = pk.spd_solve_warp_block_warps(k)
                extra = (pk.spd_solve_warp_grid(args.n, k, per_sm, sms),)

            def solve():
                err = lib.spd_solve_launch(a.data_ptr(), b.data_ptr(),
                                           x.data_ptr(), args.n, k, *extra,
                                           stream)
                if err:
                    raise RuntimeError(f"spd_stamps: launch failed, CUDA "
                                       f"error {err}")
            per, count = turns(lib, solve)
            print(f"[spd_stamps] {path}, K={k}, N={args.n}, {card}: "
                  f"{per_sm} blocks ({warps * per_sm} warps) an SM; cycles a "
                  f"warp's turn, block 0 ({count} turns): " + ", ".join(
                      f"{p} {v:.0f}" for p, v in per.items())
                  + f"; sum {sum(per.values()):.0f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
