"""Where a wide dense-MF hop's cycles go: a clock-stamped copy of the kernel.

The wide hop kernel (``dense_mf_hop_wide_kernel`` in
``harp_tpu_torch/csrc/dense_mf_hop.cu``) is copied with ``clock64()`` stamps
between the phases of its consumer loop, built beside the real library, and
run once at the SGD-MF flagship's shape (32768 x 32768 slab, 1% rated, 8
stripes) at each wide rank. The stamps are taken by thread 0 of block (0, 0)
(warpgroup 0's first thread) and summed over the hop's chunks; the script
prints cycles a 64-row chunk for each phase:

    wait    the wait for the chunk's stage (V and the Wb slice)
    pred    pred = Wb Hb^T issued and waited for (with the V loads and the
            dH of the chunk before, still on the tensor cores)
    g       G formed (with the cluster's exchange past rank 256)
    sync    the proxy fence and the warpgroup's barrier
    dh      the G tile's bulk store and dH^T += Wb^T G issued
    stripe  the H update at each stripe end (its share a chunk)
    top     the rest of the loop

The stamps cost cycles of their own, so the phases sum to more than an
unstamped hop; compare phases, not totals. Run on a card:

    python -m harp_tpu_torch.benchmark.mf_wide_stamps [--ranks 256 512 1024]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch

PHASES = ("top", "wait", "pred", "g", "sync", "dh", "stripe")

_DEFS = """
__device__ unsigned long long g_stamp[16];
#define STAMP(k, t) do { if (blockIdx.x == 0 && blockIdx.y == 0 && \\
    threadIdx.x == 0) { unsigned long long n_ = clock64(); \\
    atomicAdd(&g_stamp[k], n_ - (t)); t = n_; } } while (0)
"""
_API = """
extern "C" int stamp_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
}
extern "C" int stamp_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_stamp, z, sizeof(z));
}
"""
# (anchor in the wide kernel's consumer loop, the text put after it)
_MARKS = (
    ("""    for (int g = 0; g < total; ++g) {
      const int i = g / nch;
      const int c = g - i * nch;
      const int nr = min(R, s_rows - c * R);
      const int s = g % S;
      const int slot = g & 1;
""", "      STAMP(0, ts);\n"),
    ("""      mbar_wait(full + s, (unsigned)(g / S) & 1u);
      if (c == 0 && lead)""", None),
    ("""      wgmma_wait(pr);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) pin(dh[mt]);
""", "      STAMP(2, ts);\n"),
    ("""      // the G tile (generic stores) before wgmma and the bulk store read
""", None),
    ("""      if (lead) bulk_wait_read();
      group_sync(q);
""", "      STAMP(4, ts);\n"),
    ("""              wg_desc(gt + 2 * kk * WC * 16, WC * 16, 128), c > 0 || kk > 0);
      wgmma_commit();
""", "      STAMP(5, ts);\n"),
    ("""        // Hb^T (generic stores) before the next stripe's wgmma reads it
        asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
        group_sync(q);
""", "        STAMP(6, ts);\n"),
)


def stamped_source(src: str) -> str:
    """The kernel source with the stamps put in; raises if an anchor is
    missing (the kernel changed: update ``_MARKS``)."""
    def once(text, old, new):
        if text.count(old) != 1:
            raise RuntimeError("mf_wide_stamps: an anchor of the wide hop "
                               "kernel is not in the source:\n" + old)
        return text.replace(old, new)

    out = once(src, "namespace {\n\nusing ring_dma::HopPlan;",
               _DEFS + "\nnamespace {\n\nusing ring_dma::HopPlan;")
    loop = _MARKS[0][0]
    out = once(out, loop, "    unsigned long long ts = clock64();\n" + loop
               + _MARKS[0][1])
    out = once(out, _MARKS[1][0], _MARKS[1][0].replace(
        "      if (c == 0 && lead)", "      STAMP(1, ts);\n      if (c == 0 "
        "&& lead)"))
    out = once(out, _MARKS[2][0], _MARKS[2][0] + _MARKS[2][1])
    out = once(out, _MARKS[3][0], "      STAMP(3, ts);\n" + _MARKS[3][0])
    for old, new in _MARKS[4:]:
        out = once(out, old, old + new)
    return out + _API


def build(out_dir: str) -> ctypes.CDLL:
    """nvcc the stamped copy with the library's own flags into
    ``out_dir`` and load it."""
    from harp_tpu_torch.ops import _cuda_build

    os.makedirs(out_dir, exist_ok=True)
    src = (_cuda_build.CSRC / "dense_mf_hop.cu").read_text()
    path = os.path.join(out_dir, "dense_mf_hop_stamped.cu")
    with open(path, "w") as f:
        f.write(stamped_source(src))
    lib_path = os.path.join(out_dir, "libdense_mf_hop_stamped.so")
    subprocess.run([_cuda_build._nvcc(), *_cuda_build._flags("dense_mf_hop"),
                    "-I", str(_cuda_build.CSRC), "-o", lib_path, path],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(lib_path)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` bound as the wrapper binds the real library."""
    from harp_tpu_torch.ops import _cuda_build, pallas_kernels as pk

    saved, real = pk._LIB.pop("dense_mf_hop", None), _cuda_build.library
    _cuda_build.library = lambda name: lib
    try:
        return pk._mf_lib()
    finally:
        _cuda_build.library = real
        pk._LIB.pop("dense_mf_hop", None)
        if saved is not None:
            pk._LIB["dense_mf_hop"] = saved


def flagship_inputs(n=32768, nmb=8, density=0.01, seed=0):
    """A flagship-shaped slab on the card (random ratings, ``density``
    rated, NaN elsewhere) with its counts."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    v = torch.randn(1, 1, n, n, device="cuda", generator=gen)
    v[torch.rand(1, 1, n, n, device="cuda", generator=gen) >= density] = \
        float("nan")
    v = v.bfloat16()
    seen = ~torch.isnan(v)
    rc = seen.sum(3).float()
    cc = seen.reshape(1, 1, nmb, n // nmb, n).sum(3).float()
    return v, rc, cc, gen


def main(argv=None) -> int:
    from harp_tpu_torch.ops import pallas_kernels as pk

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[256, 512, 1024])
    ap.add_argument("--out", default=os.path.join("build", "mf_wide_stamps"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mf_wide_stamps needs an NVIDIA GPU")
    lib = bind(build(args.out))
    lib.stamp_read.argtypes = [ctypes.c_void_p]
    n, nmb = 32768, 8
    v, rc, cc, gen = flagship_inputs(n, nmb)
    b = torch.zeros(1, dtype=torch.int32, device="cuda")
    chunks = nmb * -(-(n // nmb) // 64)
    saved = pk._LIB.get("dense_mf_hop")
    try:
        for k in args.ranks:
            w = torch.randn(1, n, k, device="cuda", generator=gen) / k ** 0.5
            h = torch.randn(1, n, k, device="cuda", generator=gen) / k ** 0.5
            pk._LIB["dense_mf_hop"] = lib
            pk.dense_mf_hop_cuda(v, b, w, h, rc, cc, nmb, 0.05, 0.01)
            torch.cuda.synchronize()
            lib.stamp_reset()
            pk.dense_mf_hop_cuda(v, b, w, h, rc, cc, nmb, 0.05, 0.01)
            torch.cuda.synchronize()
            arr = (ctypes.c_ulonglong * 16)()
            lib.stamp_read(arr)
            per = {name: arr[i] / chunks for i, name in enumerate(PHASES)}
            print(f"[mf_wide_stamps] rank {k}, {torch.cuda.get_device_name(0)}"
                  f": cycles a chunk, block (0, 0), warpgroup 0: " + ", ".join(
                      f"{name} {c:.0f}" for name, c in per.items())
                  + f"; sum {sum(per.values()):.0f}", flush=True)
            del w, h
    finally:
        if saved is None:
            pk._LIB.pop("dense_mf_hop", None)
        else:
            pk._LIB["dense_mf_hop"] = saved
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
