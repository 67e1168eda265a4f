"""The E-step kernel's tensor-core arithmetic, emulated on the CPU.

The CUDA E-step (``harp_tpu_torch/csrc/kmeans_stats.cu``) takes the cross
term x . c of float32 points as three TF32 products, lo hi' + hi lo' +
hi hi', where hi is the value rounded to TF32 (to nearest, ties away from
zero: add 0x1000 to the bits and clear the low 13) and lo the rest rounded
the same way; bf16 points take one product against the centroids rounded
to bf16 (exact in float32). There is no GPU here, so this file emulates
that arithmetic in torch with the kernel's bit recipe, sums in float32, on
seeded points (``datagen.dense_points``), and shows:

* the three-pass scores ||c||^2 - 2 x . c lie within 4x the float32 plain
  scores' distance from a float64 reference, each row measured against its
  own largest score (the row's scale);
* their argmins are the plain version's (``kmeans_stats_plain``) except on
  near ties (best two plain scores within 1e-5 of the row's scale);
* one TF32 pass lies far outside that bound, so the check discriminates;
* an E-step on the emulated scores matches the JAX package's kernel
  (``kmeans_stats_pallas`` in interpret mode) and its XLA path
  (``distance.partial_sums_counts``) by tests/test_torch_kmeans.py's rules:
  float32 counts exact, sums rtol/atol 1e-4, cost rtol 1e-4; bf16 counts
  atol 1, sums rtol 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.ops import distance as jdist
from harp_tpu.ops import pallas_kernels as jpk
from harp_tpu_torch.io import datagen
from harp_tpu_torch.ops import pallas_kernels as tpk

TIE_EPS = 1e-5
# (N, K, D): the flagship's width, a codebook, and embeddings past D = 824
SHAPES = [(20_000, 100, 100), (4_096, 1024, 128), (4_096, 256, 1024)]


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as the kernel rounds: the bits plus 0x1000,
    the low 13 cleared."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def emulated_scores(x: torch.Tensor, c: torch.Tensor, passes: int = 3):
    """||c||^2 - 2 x . c with the cross term as the kernel takes it, float32
    sums: three TF32 passes (lo hi' + hi lo' + hi hi') or one (hi hi');
    bf16 points one product against bf16-rounded centroids."""
    c2 = (c * c).sum(1)
    if x.dtype == torch.bfloat16:
        cross = x.float() @ c.to(torch.bfloat16).float().T
    else:
        (xh, xl), (ch, cl) = split(x), split(c)
        cross = xh @ ch.T
        if passes == 3:
            cross = (xl @ ch.T + xh @ cl.T) + cross
    return c2[None, :] - 2.0 * cross


def row_error(s: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |s - ref| of a row over that row's largest |ref|."""
    err = (s.double() - ref).abs().amax(1) / ref.abs().amax(1)
    return float(err.max())


def near_tie_rows(s: torch.Tensor) -> torch.Tensor:
    top2 = torch.topk(s, 2, dim=1, largest=False).values
    return (top2[:, 1] - top2[:, 0]) <= TIE_EPS * s.abs().amax(1)


def points(n, k, d):
    pts = datagen.dense_points(n, d, seed=n + k + d, num_clusters=k)
    cen = datagen.initial_centroids(pts, k, seed=k)
    return torch.from_numpy(pts), torch.from_numpy(cen)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "n%d-k%d-d%d" % s)
def scored(request):
    """One shape's points, centroids, plain float32 scores and their float64
    reference."""
    n, k, d = request.param
    x, c = points(n, k, d)
    ref = (c.double() ** 2).sum(1)[None, :] - 2.0 * (x.double() @ c.double().T)
    plain = (c * c).sum(1)[None, :] - 2.0 * (x @ c.T)
    return x, c, plain, ref


def test_three_tf32_passes_are_float32_accurate(scored):
    x, c, plain, ref = scored
    yard = row_error(plain, ref)
    three = emulated_scores(x, c, passes=3)
    assert row_error(three, ref) <= 4 * yard
    # the argmin moves only where the plain scores nearly tie
    moved = torch.argmin(three, 1) != torch.argmin(plain, 1)
    assert not bool((moved & ~near_tie_rows(plain)).any())
    _, counts, _ = tpk.kmeans_stats_plain(x, c)
    assert torch.equal(torch.bincount(torch.argmin(plain, 1), minlength=len(c))
                       .float(), counts)


def test_one_tf32_pass_is_not(scored):
    """The check above fails when one TF32 pass is substituted."""
    x, c, plain, ref = scored
    assert row_error(emulated_scores(x, c, passes=1), ref) > 4 * row_error(
        plain, ref)


def emulated_estep(x: torch.Tensor, c: torch.Tensor, valid_k=None):
    """The E-step on the emulated scores: argmin (lowest index on ties),
    sums, counts and cost = sum of min scores + sum of ||x||^2."""
    s = emulated_scores(x, c)
    if valid_k is not None:
        s[:, valid_k:] = float("inf")
    best, a = torch.min(s, 1)
    xf = x.float()
    sums = torch.zeros(c.shape).index_add_(0, a, xf)
    counts = torch.zeros(len(c)).index_add_(0, a, torch.ones(len(a)))
    return sums, counts, best.sum() + (xf * xf).sum()


@pytest.mark.parametrize("dtype,valid_k", [("float32", 6), ("bfloat16", None)])
def test_emulated_estep_matches_jax(dtype, valid_k):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((256, 16)).astype(np.float32)
    c = rng.standard_normal((8, 16)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    sums, counts, cost = emulated_estep(xt, torch.from_numpy(c), valid_k)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    pallas = jpk.kmeans_stats_pallas(xj, jnp.asarray(c), block_n=64,
                                     interpret=True, valid_k=valid_k)
    xla = jdist.partial_sums_counts(
        xj, jnp.asarray(c), compute_dtype=None if dtype == "float32"
        else jnp.bfloat16, valid_k=valid_k)
    if valid_k is not None:
        assert float(counts[valid_k:].sum()) == 0.0
    assert float(counts.sum()) == x.shape[0]
    for s_ref, c_ref, cost_ref in (pallas, xla):
        if dtype == "float32":
            np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))
            np.testing.assert_allclose(sums.numpy(), np.asarray(s_ref),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(float(cost), float(cost_ref),
                                       rtol=1e-4)
        else:
            np.testing.assert_allclose(counts.numpy(), np.asarray(c_ref),
                                       atol=1)
            np.testing.assert_allclose(sums.numpy(), np.asarray(s_ref),
                                       rtol=2e-2, atol=0.2)
            np.testing.assert_allclose(float(cost), float(cost_ref),
                                       rtol=2e-2)


def test_stamped_copy_finds_its_anchors():
    """``benchmark/estep_stamps.py`` stamps a copy of the narrow kernel at
    fixed anchors; each must still be in the source, once."""
    from harp_tpu_torch.benchmark import estep_stamps
    from harp_tpu_torch.ops import _cuda_build

    src = (_cuda_build.CSRC / "kmeans_stats.cu").read_text()
    stamped = estep_stamps.stamped_source(src)
    # a stamp a phase, and the macro's definition
    assert stamped.count("STAMP(") == len(estep_stamps.PHASES) + 1
