"""The port's ALS slice against the JAX package's, on the CPU.

Same numpy inputs (made from a seed) go through ``harp_tpu`` and its
counterpart in ``harp_tpu_torch``:

* the batched SPD solve's plain version against the Pallas kernel in
  interpret mode (it follows the kernel's steps, so rtol/atol 1e-5 relative
  to max |x|) and, at K = 33 and 64, against ``jax.scipy.linalg.solve``
  (1e-4 relative to max |x|: two float32 algorithms on systems of condition
  about 20);
* ``_spd_solve`` for every solver and the ablation (1e-5 relative to max
  |x|; the ablation exactly);
* the host layouts (``pad_csr_lists``, ``pad_csr_chunks``) and
  ``zipf_ratings``, exactly;
* one half-step of each layout and mode from the same factors (lock step):
  1e-5 relative to the largest entry (the normal equations agree to the
  last bit or nearly; the solves round differently);
* whole ``ALS`` fits in every (workers, layout, mode) case, 3 iterations:
  per-iteration RMSE within rtol 1e-4 and factors within 1e-3 of their
  largest entry. The dense layout rounds each factor to bf16 before its
  products, so a last-bit difference in a factor can flip an entry's
  rounding and move the next solve by far more than the difference: over
  longer fits the packages drift apart by more than rounding at the step
  (measured at 4 iterations: dense implicit RMSE 1.5e-4 and factors 1.3e-3
  apart, dense explicit at λ = 0.05 3.0e-3 and 8.8e-3, while one half-step
  agrees to 4e-7). The sparse layout has no bf16 rounding and agrees to
  about 1e-6 at any length;
* ``prepare``'s checks and layout choice, the state converter, the CLI.
"""

import dataclasses
import pathlib
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.io import datagen as jdatagen
from harp_tpu.io import loaders as jloaders
from harp_tpu.models import als as jals
from harp_tpu.ops import pallas_kernels as jpk
from harp_tpu.session import HarpSession as JaxSession
from harp_tpu_torch import convert
from harp_tpu_torch import run as trun
from harp_tpu_torch.io import datagen as tdatagen
from harp_tpu_torch.models import als as tals
from harp_tpu_torch.ops import pallas_kernels as tpk
from harp_tpu_torch.session import HarpSession as TorchSession

REPO = pathlib.Path(__file__).resolve().parent.parent
NU, NI = 128, 96


@pytest.fixture(scope="module")
def ratings():
    return jdatagen.sparse_ratings(NU, NI, rank=4, density=0.1, seed=3)


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def normal_equations(n, k, seed):
    """ALS-shaped SPD systems: V'V over 4k factor rows plus 0.1 I (the
    regularizer), with a right-hand side, as numpy float32."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 4 * k, k)).astype(np.float32) / np.sqrt(k)
    a = (np.einsum("nek,nel->nkl", v, v)
         + 0.1 * np.eye(k, dtype=np.float32)).astype(np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    return a, b


# --------------------------------------------------------------------------- #
# The batched SPD solve
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n,k", [(256, 16), (300, 10), (64, 32)])
def test_spd_solve_plain_matches_pallas_interpret(n, k):
    a, b = normal_equations(n, k, seed=n + k)
    ref = np.asarray(jpk.spd_solve_pallas(jnp.asarray(a), jnp.asarray(b),
                                          interpret=True))
    got = tpk.spd_solve_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (n, k)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy() / scale, ref / scale, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("k", [33, 64])
def test_spd_solve_plain_matches_jax_solve(k):
    a, b = normal_equations(48, k, seed=k)
    ref = np.asarray(jax.scipy.linalg.solve(
        jnp.asarray(a), jnp.asarray(b)[..., None], assume_a="pos"))[..., 0]
    got = tpk.spd_solve_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert max_rel(got.numpy(), ref) <= 1e-4
    exact = np.linalg.solve(a.astype(np.float64), b[..., None])[..., 0]
    assert max_rel(got.numpy(), exact) <= 1e-4


@pytest.mark.parametrize("n,k", [(6, 339), (4, 400)])
def test_spd_solve_plain_past_the_block_width_matches_float64(n, k):
    """K past the shared-memory kernel's 307 (the global-memory kernel on
    the card). The oracle is a float64 numpy solve, not the Pallas kernel in
    interpret mode: that unrolls its K steps in Python and would spend
    minutes compiling at these K. 1e-4 relative to max |x|: float32
    Cholesky on systems of condition about 20."""
    a, b = normal_equations(n, k, seed=k)
    got = tpk.spd_solve_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (n, k)
    exact = np.linalg.solve(a.astype(np.float64),
                            b[..., None].astype(np.float64))[..., 0]
    assert max_rel(got.numpy(), exact) <= 1e-4


def test_spd_solve_dispatch_and_checks():
    a, b = (torch.from_numpy(x) for x in normal_equations(8, 5, seed=1))
    before = dict(tpk.launches)
    assert torch.equal(tpk.spd_solve(a, b), tpk.spd_solve_plain(a, b))
    assert tpk.launches == before            # no kernel launched on the CPU
    with pytest.raises(ValueError, match="CUDA device"):
        tpk.spd_solve_cuda(a, b)
    with pytest.raises(ValueError, match=r"\(N, K, K\)"):
        tpk.spd_solve(a[:, :4], b)
    for k, device, want in ((64, "cuda", True), (65, "cuda", False),
                            (8, "cpu", False)):
        assert tpk.use_spd_solve_pallas(k, device) is want
    # "auto" follows the predicate; an explicit "pallas" on the card takes
    # the kernel at every rank (past K = 338 the global-memory solve)
    resolve = tals._resolve_solver
    assert resolve(tals.ALSConfig(rank=64), "cuda") == "pallas"
    assert resolve(tals.ALSConfig(rank=65), "cuda") == "cholesky"
    assert resolve(tals.ALSConfig(rank=8), "cpu") == "cholesky"
    assert resolve(tals.ALSConfig(rank=8, solver="pallas"), "cpu") == "pallas"
    assert resolve(tals.ALSConfig(rank=65, solver="pallas"), "cuda") == "pallas"
    assert resolve(tals.ALSConfig(rank=339, solver="pallas"),
                   "cuda") == "pallas"
    with pytest.raises(ValueError, match="solver must be"):
        resolve(tals.ALSConfig(solver="lu"), "cpu")


@pytest.mark.parametrize("solver,ablate", [
    ("auto", False), ("pallas", False), ("cholesky", False),
    ("newton", False), ("auto", True)])
def test_spd_solve_solvers_match_jax(solver, ablate):
    a, b = normal_equations(32, 8, seed=11)
    kw = dict(rank=8, solver=solver, ablate_solve=ablate)
    ref = np.asarray(jals._spd_solve(jnp.asarray(a), jnp.asarray(b),
                                     jals.ALSConfig(**kw)))
    got = tals._spd_solve(torch.from_numpy(a), torch.from_numpy(b),
                          tals.ALSConfig(**kw)).numpy()
    if ablate:
        np.testing.assert_array_equal(got, ref)
    else:
        assert max_rel(got, ref) <= 1e-5


# --------------------------------------------------------------------------- #
# Host layouts: exact
# --------------------------------------------------------------------------- #

def _assert_same(got, ref):
    assert type(got) is type(ref)
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _assert_same(g, r)
    elif isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref


@pytest.mark.parametrize("balance", [True, False])
def test_layouts_match_jax(ratings, balance):
    rows, cols, vals = ratings
    _assert_same(tals.pad_csr_lists(rows, cols, vals, NU, 3),
                 jals.pad_csr_lists(rows, cols, vals, NU, 3))
    _assert_same(tals.pad_csr_chunks(rows, cols, vals, NU, 3, 1.5, balance),
                 jals.pad_csr_chunks(rows, cols, vals, NU, 3, 1.5, balance))


def test_zipf_layout_bounds_padding():
    """zipf_ratings is bitwise the JAX package's, and on it the capped
    chunks keep the padding bounded (the bound of
    tests/test_als_nn_solvers.py) where the all-rows-to-max layout does
    not."""
    kw = dict(num_users=256, num_items=192, rank=4, alpha=1.3, density=0.08,
              seed=9, noise=0.01)
    got, ref = tdatagen.zipf_ratings(**kw), jdatagen.zipf_ratings(**kw)
    _assert_same(got, ref)
    rows, cols, vals = got
    cfg = tals.ALSConfig(rank=8, lam=0.05, iterations=8, implicit=False,
                         layout="sparse")
    model = tals.ALS(TorchSession(num_workers=4, device="cpu"), cfg)
    u, v, rmse = model.fit(rows, cols, vals, 256, 192)
    assert model.last_layout_stats["overhead"] <= 4.0
    m = max(np.bincount(rows).max(), np.bincount(cols).max())
    assert model.last_layout_stats["overhead"] < 256 * m / len(vals)
    assert rmse[-1] < 0.5 * rmse[0]
    pred = np.einsum("ij,ij->i", u[rows], v[cols])
    assert np.sqrt(np.mean((vals - pred) ** 2)) < 0.15


# --------------------------------------------------------------------------- #
# Whole fits
# --------------------------------------------------------------------------- #

def _kw(implicit, layout, **extra):
    return dict(dict(rank=8, lam=0.1, alpha=40.0, iterations=3,
                     implicit=implicit, layout=layout), **extra)


def _vals(vals, implicit):
    return np.abs(vals) if implicit else vals


def check_fit(got, ref):
    np.testing.assert_allclose(got[2], np.asarray(ref[2]), rtol=1e-4)
    for g, r in zip(got[:2], ref[:2]):
        assert max_rel(g, r) <= 1e-3


@pytest.mark.parametrize("implicit", [True, False])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_half_step_matches_jax(ratings, layout, implicit):
    """One half-step of every worker from the same replicated factor, W=4:
    the port's stacked half-step against the JAX one, worker by worker."""
    rows, cols, vals = ratings
    vals = _vals(vals, implicit)
    w, k = 4, 8
    jcfg = jals.ALSConfig(**_kw(implicit, layout, solver="cholesky"))
    tcfg = tals.ALSConfig(**_kw(implicit, layout, solver="cholesky"))
    rng = np.random.default_rng(5)
    if layout == "dense":
        plane = np.full((NU, NI), np.nan, np.float32)
        plane[rows, cols] = vals
        f = (rng.random((NI, k)) / np.sqrt(k)).astype(np.float32)
        tplane = torch.from_numpy(plane).to(torch.bfloat16).view(w, -1, NI)
        got = tals._half_step_dense(torch.from_numpy(f), tplane, tcfg)
        ref = [jals._half_step_dense(
            jnp.asarray(f), jnp.asarray(p, jnp.bfloat16), NU // w, jcfg)
            for p in plane.reshape(w, -1, NI)]
    else:
        idx, val, mask, crow, _, rpw, _ = jals.pad_csr_chunks(
            rows, cols, vals, NU, w)
        f = (rng.random((NI, k)) / np.sqrt(k)).astype(np.float32)
        t = torch.from_numpy
        got = tals._half_step(t(f), t(idx).long(), t(val), t(mask),
                              t(crow).long(), rpw, tcfg)
        ref = [jals._half_step(jnp.asarray(f), *(jnp.asarray(x[i]) for x in
                                                 (idx, val, mask, crow)),
                               rpw, jcfg) for i in range(w)]
    assert max_rel(got.numpy(), np.stack([np.asarray(r) for r in ref])
                   ) <= 1e-5


@pytest.mark.parametrize("implicit", [True, False])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("w", [1, 4])
def test_fit_matches_jax(ratings, w, layout, implicit):
    rows, cols, vals = ratings
    data = (rows, cols, _vals(vals, implicit), NU, NI, 1)
    ref = jals.ALS(JaxSession(num_workers=w),
                   jals.ALSConfig(**_kw(implicit, layout))).fit(*data)
    model = tals.ALS(TorchSession(num_workers=w, device="cpu"),
                     tals.ALSConfig(**_kw(implicit, layout)))
    got = model.fit(*data)
    assert model.last_layout_stats["layout"] == layout
    assert got[0].shape == (NU, 8) and got[1].shape == (NI, 8)
    assert got[2].shape == (3,) and np.all(np.diff(got[2]) < 0)
    check_fit(got, ref)


def test_fit_pallas_solver_matches_jax(ratings):
    """solver="pallas": the port's plain solve against the Pallas kernel
    in interpret mode, inside whole fits; and a float64 solve patched in
    for ``als._spd_solve`` moves the fit only by rounding."""
    rows, cols, vals = ratings
    data = (rows, cols, np.abs(vals), NU, NI, 2)
    kw = _kw(True, "sparse", solver="pallas")
    ref = jals.ALS(JaxSession(num_workers=1), jals.ALSConfig(**kw)).fit(*data)
    model = tals.ALS(TorchSession(num_workers=1, device="cpu"),
                     tals.ALSConfig(**kw))
    got = model.fit(*data)
    check_fit(got, ref)
    def f64_solve(a, b, _cfg):
        return torch.linalg.solve(a.double(), b.double()).float()

    with mock.patch.object(tals, "_spd_solve", f64_solve):
        check_fit(model.fit(*data), got)


def test_fit_pallas_solver_past_the_block_width_matches_jax():
    """solver="pallas" at rank 340, past the shared-memory solve's 307 (the
    global-memory kernel on the card; the plain version here) against the
    JAX package's "cholesky" fit, implicit, sparse, 2 iterations, on a
    24 x 16 rating set (the plain solve takes K steps over the whole batch,
    so the batch is kept small), under check_fit's fixed rule; and a
    float64 solve patched in for ``als._spd_solve`` moves the fit only by
    rounding. Rank 340 over 16 items leaves the normal equations' smallest
    eigenvalue at the regularizer, so lam is 1.0: at 0.1 their condition
    puts the JAX "cholesky" fit 5e-3 (U) and 8e-3 (V) from a float64-solve
    fit, past the rule, while the port's plain solve stays within 2e-3; at
    1.0 both float32 fits lie within 4e-4 of it."""
    rows, cols, vals = jdatagen.sparse_ratings(24, 16, rank=4, density=0.3,
                                               seed=5)
    data = (rows, cols, np.abs(vals), 24, 16, 2)
    kw = _kw(True, "sparse", rank=340, lam=1.0, iterations=2)
    ref = jals.ALS(JaxSession(num_workers=1),
                   jals.ALSConfig(**kw, solver="cholesky")).fit(*data)
    model = tals.ALS(TorchSession(num_workers=1, device="cpu"),
                     tals.ALSConfig(**kw, solver="pallas"))
    got = model.fit(*data)
    assert got[0].shape == (24, 340) and got[1].shape == (16, 340)
    check_fit(got, ref)

    def f64_solve(a, b, _cfg):
        return torch.linalg.solve(a.double(), b.double()).float()

    with mock.patch.object(tals, "_spd_solve", f64_solve):
        check_fit(model.fit(*data), got)


def test_prepare_checks_match_jax(ratings):
    rows, cols, vals = ratings
    tsess = TorchSession(num_workers=2, device="cpu")
    jsess = JaxSession(num_workers=2)
    cfg = dict(rank=4, iterations=1)
    bad = {
        "nonnegative interaction": (rows, cols, vals, NU, NI),
        "row indices": (rows, cols, np.abs(vals), NU - 1, NI),
        "col indices": (rows, cols, np.abs(vals), NU, NI - 1),
        "NaN": (rows, cols, np.where(np.arange(len(vals)) == 3, np.nan,
                                     np.abs(vals)), NU, NI),
    }
    for match, args in bad.items():
        with pytest.raises(ValueError, match=match):
            tals.ALS(tsess, tals.ALSConfig(**cfg)).prepare(*args)
        with pytest.raises(ValueError, match=match):
            jals.ALS(jsess, jals.ALSConfig(**cfg)).prepare(*args)
    dup = (np.concatenate([rows, rows[:5]]), np.concatenate([cols, cols[:5]]),
           np.concatenate([np.abs(vals), np.abs(vals[:5]) + 1]), NU, NI)
    t = tals.ALS(tsess, tals.ALSConfig(**cfg))
    j = jals.ALS(jsess, jals.ALSConfig(**cfg))
    t.prepare(*dup)
    j.prepare(*dup)
    repeats = len(rows) - len(np.unique(rows.astype(np.int64) * NI + cols))
    assert (t.last_layout_stats["duplicates_dropped"]
            == j.last_layout_stats["duplicates_dropped"] == repeats + 5)
    # auto layout at the dense_max_bytes threshold: both planes, per worker
    per_worker = 2 * (NU // 2) * NI * 2
    for budget in (per_worker - 1, per_worker, per_worker + 1):
        for implicit in (True, False):
            kw = dict(cfg, implicit=implicit, dense_max_bytes=budget)
            got = tals.ALS(tsess, tals.ALSConfig(**kw))._pick_layout(NU, NI)
            ref = jals.ALS(jsess, jals.ALSConfig(**kw))._pick_layout(NU, NI)
            assert got == ref
    assert tals.ALS(tsess, tals.ALSConfig(
        dense_max_bytes=per_worker))._pick_layout(NU, NI) == "dense"
    assert tals.ALS(tsess, tals.ALSConfig(
        dense_max_bytes=per_worker - 1))._pick_layout(NU, NI) == "sparse"


# --------------------------------------------------------------------------- #
# State conversion
# --------------------------------------------------------------------------- #

def _jax_state_with(state, u_np, v_np, sess):
    """The JAX state with its initial factors set to ``u_np``/``v_np`` (in
    original id order), padded slots zero."""
    key, placed, u_slots, v_slots = state
    u0 = np.zeros(placed[-2].shape, np.float32)
    v0 = np.zeros(placed[-1].shape, np.float32)
    u0[u_slots], v0[v_slots] = u_np, v_np
    return (key, placed[:-2] + (sess.replicate_put(u0),
                                sess.replicate_put(v0)), u_slots, v_slots)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_convert_places_jax_factors(ratings, layout):
    rows, cols, vals = ratings
    data = (rows, cols, np.abs(vals), NU, NI, 6)
    jsess = JaxSession(num_workers=4)
    tsess = TorchSession(num_workers=4, device="cpu")
    kw = _kw(True, layout, iterations=0)
    jm = jals.ALS(jsess, jals.ALSConfig(**kw))
    u_np, v_np, _ = jm.fit(*data)
    model = tals.ALS(tsess, tals.ALSConfig(**kw))
    state = model.prepare(*data)
    cfg, conv = convert.als_state_from_jax(model, state, u_np, v_np,
                                           dataclasses.asdict(jm.config))
    assert cfg == model.config
    u_back, v_back, rmse = model.fit_prepared(conv)
    assert rmse.shape == (0,)
    np.testing.assert_array_equal(u_back, u_np)
    np.testing.assert_array_equal(v_back, v_np)
    for t, slots in zip(conv[1][-2:], conv[2:]):   # padded slots stay 0
        rest = np.ones(len(t), bool)
        rest[slots] = False
        assert not t.numpy()[rest].any()

    # two more iterations from other factors given to both packages
    rng = np.random.default_rng(0)
    u2 = rng.random(u_np.shape).astype(np.float32) / 3
    v2 = rng.random(v_np.shape).astype(np.float32) / 3
    kw2 = dict(kw, iterations=2)
    jm2 = jals.ALS(jsess, jals.ALSConfig(**kw2))
    ref = jm2.fit_prepared(_jax_state_with(jm2.prepare(*data), u2, v2, jsess))
    model2 = tals.ALS(tsess, tals.ALSConfig(**kw2))
    _, conv2 = convert.als_state_from_jax(model2, model2.prepare(*data), u2,
                                          v2, dataclasses.asdict(jm2.config))
    check_fit(model2.fit_prepared(conv2), ref)

    with pytest.raises(ValueError, match="unknown ALSConfig"):
        convert.als_state_from_jax(model, state, u_np, v_np,
                                   dict(dataclasses.asdict(jm.config), x=1))
    with pytest.raises(ValueError, match="does not match"):
        convert.als_state_from_jax(model, state, u_np, v_np,
                                   dataclasses.asdict(jm2.config))


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #

def test_cli_als_on_cpu(capsys, tmp_path):
    path = str(REPO / "datasets/als")
    assert trun.main(["als", "--device", "cpu", "--ratings-file", path,
                      "--rank", "8", "--iterations", "4", "--work-dir",
                      str(tmp_path)]) == 0
    out = capsys.readouterr().out
    rows, cols, vals = jloaders.load_coo(jloaders.list_files(path))
    assert out.startswith(f"als[implicit] workers=1 nnz={len(vals)} rank=8:")
    first, last = (float(x) for x in out.split("rmse ")[1].split(" -> "))
    assert last < first
    nu, ni = int(rows.max()) + 1, int(cols.max()) + 1
    assert np.loadtxt(tmp_path / "u.csv", delimiter=",").shape == (nu, 8)
    assert np.loadtxt(tmp_path / "v.csv", delimiter=",").shape == (ni, 8)
    assert trun.main(["als", "--device", "cpu", "--num-users", "300",
                      "--num-items", "200", "--rank", "8", "--implicit",
                      "no", "--num-workers", "2", "--iterations", "3"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("als[explicit] workers=2 nnz=600 rank=8:")
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, "-m", "harp_tpu_torch.run",
                               "als", "--device", "cuda"], cwd=REPO,
                              capture_output=True, text=True)
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr
