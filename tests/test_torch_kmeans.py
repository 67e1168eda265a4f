"""The port's K-means slice against the JAX package's, on the CPU.

Same numpy inputs (made from a seed) go through ``harp_tpu`` and its
counterpart in ``harp_tpu_torch``: the E-step ops, the fused E-step's plain
version (against the Pallas kernel in interpret mode and the XLA path, also
at the widths the card takes only through the wide variant), the whole
``KMeans`` model in all five comm variants (and at K = 300, D = 900), the
CLI and the state converter. Tolerances: f32 E-step sums rtol/atol 1e-4 with exact counts,
bf16 counts atol 1 and sums rtol 2e-2 (the JAX package's own kernel test,
tests/test_aux_sp.py), whole fits rtol 1e-5 (the two packages round the
score matmul and the cross-worker sums in different orders).
"""

import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.io import datagen as jdatagen
from harp_tpu.models import kmeans as jkm
from harp_tpu.ops import distance as jdist
from harp_tpu.ops import lane_pack as jlp
from harp_tpu.ops import pallas_kernels as jpk
from harp_tpu.session import HarpSession as JaxSession
from harp_tpu_torch import convert
from harp_tpu_torch import run as trun
from harp_tpu_torch.io import datagen as tdatagen
from harp_tpu_torch.models import kmeans as tkm
from harp_tpu_torch.ops import distance as tdist
from harp_tpu_torch.ops import lane_pack as tlp
from harp_tpu_torch.ops import pallas_kernels as tpk
from harp_tpu_torch.session import HarpSession as TorchSession

REPO = pathlib.Path(__file__).resolve().parent.parent
K, D, N, ITERS = 6, 8, 512, 5


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def data():
    pts = jdatagen.dense_points(N, D, seed=7, num_clusters=K)
    cen0 = jdatagen.initial_centroids(pts, K, seed=3)
    return pts, cen0


# --------------------------------------------------------------------------- #
# E-step ops
# --------------------------------------------------------------------------- #

def test_datagen_matches_jax():
    a = tdatagen.dense_points(300, 5, seed=4, num_clusters=3)
    np.testing.assert_array_equal(a, jdatagen.dense_points(300, 5, seed=4,
                                                          num_clusters=3))
    np.testing.assert_array_equal(tdatagen.initial_centroids(a, 4, seed=2),
                                  jdatagen.initial_centroids(a, 4, seed=2))


def test_lane_pack_helpers_match_jax():
    for n, m in ((1, 8), (100, 128), (129, 128)):
        assert tlp.round_up(n, m) == jlp.round_up(n, m)
    for n, w in ((100, 1), (100, 3), (300, 8)):
        assert tlp.lane_target(n, w) == jlp.lane_target(n, w)
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(tlp.pad_rows(torch.from_numpy(a), 5).numpy(),
                                  np.asarray(jlp.pad_rows(jnp.asarray(a), 5)))
    np.testing.assert_array_equal(tlp.pad_cols(torch.from_numpy(a), 7).numpy(),
                                  np.asarray(jlp.pad_cols(jnp.asarray(a), 7)))
    np.testing.assert_array_equal(
        tlp.mask_phantom_cols(torch.from_numpy(a), 2).numpy(),
        np.asarray(jlp.mask_phantom_cols(jnp.asarray(a), 2)))


@pytest.mark.parametrize("fn", ["pairwise_sq_dist", "pairwise_scores",
                                "assign_clusters"])
def test_distance_ops_match_jax(fn):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 12)).astype(np.float32)
    c = rng.standard_normal((5, 12)).astype(np.float32)
    got = getattr(tdist, fn)(torch.from_numpy(x), torch.from_numpy(c))
    ref = getattr(jdist, fn)(jnp.asarray(x), jnp.asarray(c))
    if fn == "assign_clusters":
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid_k", [None, 6])
def test_kmeans_stats_plain_matches_pallas_and_xla(dtype, valid_k):
    """kmeans_stats_plain against the TPU kernel run in interpret mode and
    against the XLA path, with and without phantom centroid rows."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((256, 16)).astype(np.float32)
    c = rng.standard_normal((8, 16)).astype(np.float32)
    _check_stats_against_jax(x, c, dtype, valid_k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,valid_k,d", [(264, 250, 100), (16, None, 900)])
def test_kmeans_stats_plain_matches_pallas_and_xla_wide(dtype, k, valid_k,
                                                         d):
    """The same at the widths the card's wide variant takes: K past one
    block's shared memory at D = 100 (with phantom rows), and D past 824."""
    rng = np.random.default_rng(k + d)
    x = rng.standard_normal((512, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    assert tpk.kmeans_smem_bytes(d, k) > tpk.MAX_SMEM_BYTES
    _check_stats_against_jax(x, c, dtype, valid_k)


def _check_stats_against_jax(x, c, dtype, valid_k):
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    sums, counts, cost = tpk.kmeans_stats_plain(xt, torch.from_numpy(c),
                                                valid_k=valid_k)
    pallas = jpk.kmeans_stats_pallas(xj, jnp.asarray(c), block_n=64,
                                     interpret=True, valid_k=valid_k)
    xla = jdist.partial_sums_counts(
        xj, jnp.asarray(c), compute_dtype=None if dtype == "float32"
        else jnp.bfloat16, valid_k=valid_k)
    if valid_k is not None:
        assert float(counts[valid_k:].sum()) == 0.0
        assert float(sums[valid_k:].abs().sum()) == 0.0
    assert float(counts.sum()) == x.shape[0]
    for s_ref, c_ref, cost_ref in (pallas, xla):
        if dtype == "float32":
            np.testing.assert_array_equal(counts.numpy(), np.asarray(c_ref))
            np.testing.assert_allclose(sums.numpy(), np.asarray(s_ref),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(float(cost), float(cost_ref), rtol=1e-4)
        else:
            np.testing.assert_allclose(counts.numpy(), np.asarray(c_ref),
                                       atol=1)
            np.testing.assert_allclose(sums.numpy(), np.asarray(s_ref),
                                       rtol=2e-2, atol=0.2)
            np.testing.assert_allclose(float(cost), float(cost_ref), rtol=2e-2)


def test_kmeans_stats_stacked_matches_per_worker():
    """A stacked (W, N, D) call equals W separate calls, shared or
    per-worker centroid tables alike."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 40, 6)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    sums, counts, cost = tpk.kmeans_stats_plain(x, c, valid_k=3)
    per = tpk.kmeans_stats_plain(x, c.expand(3, -1, -1).contiguous(), valid_k=3)
    for a, b in zip((sums, counts, cost), per):
        assert torch.equal(a, b)
    for i in range(3):
        s, n, q = tpk.kmeans_stats_plain(x[i], c, valid_k=3)
        np.testing.assert_allclose(sums[i].numpy(), s.numpy(), rtol=1e-6)
        np.testing.assert_array_equal(counts[i].numpy(), n.numpy())
        np.testing.assert_allclose(float(cost[i]), float(q), rtol=1e-6)


def test_dispatcher_sends_cpu_tensors_to_plain():
    x = torch.zeros(10, 3)
    c = torch.ones(2, 3)
    before = dict(tpk.launches)
    out = tpk.kmeans_stats(x, c)
    ref = tpk.kmeans_stats_plain(x, c)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert tpk.launches == before           # no kernel launched on the CPU
    with pytest.raises(ValueError, match="CUDA device"):
        tpk.kmeans_stats_cuda(x, c)


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #

_JAX_FITS = {}


def jax_fit(w, comm, pts, cen0, **kw):
    key = (w, comm, tuple(sorted(kw.items())))
    if key not in _JAX_FITS:
        model = jkm.KMeans(JaxSession(num_workers=w),
                           jkm.KMeansConfig(K, D, ITERS, comm, **kw))
        cen, costs = model.fit(pts, cen0)
        _JAX_FITS[key] = (np.asarray(cen), np.asarray(costs), model.config)
    return _JAX_FITS[key]


def torch_fit(w, cfg, pts, cen0):
    model = tkm.KMeans(TorchSession(num_workers=w, device="cpu"), cfg)
    cen, costs = model.fit(pts, cen0)
    return cen.numpy(), costs.numpy()


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("comm", tkm.COMM_VARIANTS)
def test_fit_matches_jax(data, w, comm):
    """Port and JAX fits from the same state (converted by convert.py) agree
    within rtol 1e-5, and both follow the numpy Lloyd reference."""
    pts, cen0 = data
    jcen, jcosts, jcfg = jax_fit(w, comm, pts, cen0)
    cfg, tcen0 = convert.kmeans_state_from_jax(cen0, dataclasses.asdict(jcfg))
    assert cfg.comm == comm and cfg.iterations == ITERS
    cen, costs = torch_fit(w, cfg, pts, tcen0)
    np.testing.assert_allclose(cen, jcen, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(costs, jcosts, rtol=1e-5)
    ref = tkm.numpy_reference(pts.astype(np.float64), cen0.astype(np.float64),
                              ITERS)
    np.testing.assert_allclose(cen, ref, rtol=1e-4, atol=1e-5)
    assert np.all(np.diff(costs) <= 1e-5 * np.abs(costs[:-1])), costs


def test_wide_fit_matches_jax():
    """A fit at widths the card's E-step takes only through its wide
    variant (K = 300, D = 900), W = 4, regroupallgather, 3 iterations:
    within the fit tolerances above of the JAX fit from the same state."""
    k, d, iters = 300, 900, 3
    pts = jdatagen.dense_points(2048, d, seed=9, num_clusters=k)
    cen0 = jdatagen.initial_centroids(pts, k, seed=10)
    assert tpk.kmeans_smem_bytes(d, k) > tpk.MAX_SMEM_BYTES
    jmodel = jkm.KMeans(JaxSession(num_workers=4),
                        jkm.KMeansConfig(k, d, iters, "regroupallgather"))
    jcen, jcosts = (np.asarray(a) for a in jmodel.fit(pts, cen0))
    cfg, tcen0 = convert.kmeans_state_from_jax(
        cen0, dataclasses.asdict(jmodel.config))
    cen, costs = torch_fit(4, cfg, pts, tcen0)
    np.testing.assert_allclose(cen, jcen, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(costs, jcosts, rtol=1e-5)


def test_fit_hands_the_kernel_its_wide_operands(monkeypatch):
    """Evaluated as on the card, a W = 4 fit at K = 1030, D = 1024 calls
    the kernel's wrapper once an iteration with the stacked points (4, N/4,
    D), the centroids padded to k_pad = round_up(K, W) = 1032 rows and
    valid_k = K: the shapes that send it to the wide variant. (The wrapper
    is spied on and answers with the plain version.)"""
    seen = []

    def spy(x, c, valid_k=None):
        seen.append((tuple(x.shape), tuple(c.shape), valid_k))
        return tpk.kmeans_stats_plain(x, c, valid_k)

    monkeypatch.setattr(tpk, "_on_card", lambda device: True)
    monkeypatch.setattr(tpk, "kmeans_stats_cuda", spy)
    pts = tdatagen.dense_points(2048, 1024, seed=2, num_clusters=8)
    cen0 = tdatagen.initial_centroids(pts, 1030, seed=3)
    before = dict(tpk.plain_on_card)
    torch_fit(4, tkm.KMeansConfig(1030, 1024, 2), pts, cen0)
    assert seen == [((4, 512, 1024), (1032, 1024), 1030)] * 2
    assert tpk.kmeans_smem_bytes(1024, 1032) > tpk.MAX_SMEM_BYTES
    assert tpk.plain_on_card == before


def test_variants_bitwise_equal(data):
    """All five comm variants give bit-identical trajectories (kmeans.py
    module doc), at W=4."""
    pts, cen0 = data
    outs = {comm: torch_fit(4, tkm.KMeansConfig(K, D, ITERS, comm), pts, cen0)
            for comm in tkm.COMM_VARIANTS}
    base_c, base_cost = outs["regroupallgather"]
    for comm, (c, cost) in outs.items():
        np.testing.assert_array_equal(c, base_c, err_msg=comm)
        np.testing.assert_array_equal(cost, base_cost, err_msg=comm)


def test_bf16_fit_and_lane_pad_flag(data):
    """compute_dtype="bfloat16" stores the points in bf16 and tracks the
    JAX bf16 fit; lane_pad does not change the port's results."""
    pts, cen0 = data
    jcen, jcosts, _ = jax_fit(4, "regroupallgather", pts, cen0,
                              compute_dtype="bfloat16")
    cen, costs = torch_fit(4, tkm.KMeansConfig(K, D, ITERS,
                                               compute_dtype="bfloat16"),
                           pts, cen0)
    np.testing.assert_allclose(cen, jcen, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(costs, jcosts, rtol=1e-4)
    on = torch_fit(4, tkm.KMeansConfig(K, D, ITERS, lane_pad=True), pts, cen0)
    off = torch_fit(4, tkm.KMeansConfig(K, D, ITERS, lane_pad=False), pts, cen0)
    np.testing.assert_array_equal(on[0], off[0])


def test_empty_cluster_goes_to_zero():
    """A centroid no point is nearest to averages to 0 (sums / max(count, 1)),
    as in the JAX package."""
    pts = jdatagen.dense_points(64, 4, seed=1, num_clusters=2)
    cen0 = np.concatenate([pts[:2], np.full((2, 4), 1e3, np.float32)])
    jcen, _ = jkm.KMeans(JaxSession(num_workers=2),
                         jkm.KMeansConfig(4, 4, 2)).fit(pts, cen0)
    cen, _ = tkm.KMeans(TorchSession(num_workers=2, device="cpu"),
                        tkm.KMeansConfig(4, 4, 2)).fit(pts, cen0)
    np.testing.assert_array_equal(cen.numpy()[2:], 0.0)
    np.testing.assert_allclose(cen.numpy(), np.asarray(jcen), rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------------------------- #
# Entry points, conversion, import boundary
# --------------------------------------------------------------------------- #

def test_session_needs_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchSession()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchSession(num_workers=2, device="cuda")
    assert TorchSession(device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trun.main(["kmeans", "--num-points", "64"])


def test_cli_kmeans_on_cpu(capsys, tmp_path):
    assert trun.main(["kmeans", "--device", "cpu", "--num-points", "400",
                      "--num-workers", "4", "--num-centroids", "5", "--dim",
                      "6", "--iterations", "3", "--work-dir",
                      str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("kmeans[regroupallgather] workers=4 n=400 k=5 d=6:")
    assert np.loadtxt(tmp_path / "centroids.csv", delimiter=",").shape == (5, 6)
    csv = tmp_path / "pts.csv"
    np.savetxt(csv, jdatagen.dense_points(41, 3, seed=2), delimiter=",")
    assert trun.main(["kmeans", "--device", "cpu", "--points-file", str(csv),
                      "--num-workers", "4", "--num-centroids", "2",
                      "--iterations", "2"]) == 0
    assert "n=40 k=2 d=3" in capsys.readouterr().out
    # --stream is ported (tests/test_torch_pipeline.py holds it to the JAX
    # CLI); it streams part-files, so it needs --points-file
    with pytest.raises(SystemExit):
        trun.main(["kmeans", "--device", "cpu", "--stream"])
    assert "requires --points-file" in capsys.readouterr().err
    # --save-every is ported (tests/test_torch_lda.py holds it to the JAX
    # CLI); without --work-dir there is nowhere to checkpoint
    with pytest.raises(SystemExit):
        trun.main(["kmeans", "--device", "cpu", "--save-every", "2"])
    assert "requires --work-dir" in capsys.readouterr().err
    # --quant is ported (tests/test_torch_quantize.py holds it to the JAX
    # CLI); an unknown codec is refused
    assert trun.main(["kmeans", "--device", "cpu", "--num-points", "400",
                      "--num-workers", "4", "--num-centroids", "5", "--dim",
                      "6", "--iterations", "2", "--quant", "bf16"]) == 0
    assert capsys.readouterr().out.startswith(
        "kmeans[regroupallgather] workers=4 n=400 k=5 d=6:")
    with pytest.raises(ValueError, match="quant must be one of"):
        trun.main(["kmeans", "--device", "cpu", "--quant", "int4"])
    # --format csr is ported: synthetic sparse points through SparseKMeans
    assert trun.main(["kmeans", "--device", "cpu", "--format", "csr",
                      "--num-points", "400", "--num-workers", "4",
                      "--num-centroids", "5", "--dim", "6",
                      "--iterations", "2"]) == 0
    assert capsys.readouterr().out.startswith(
        "kmeans[csr-allreduce] workers=4 n=400 k=5 d=6")
    with pytest.raises(SystemExit):
        trun.main(["kmeans", "--device", "cpu", "--format", "csr",
                   "--points-file", str(csv)])
    assert "--format csr supports synthetic data" in capsys.readouterr().err


def test_cli_kmeans_reads_a_part_file_directory(capsys, monkeypatch):
    """--points-file on the bundled directory reads the 512 x 16 points the
    JAX loader reads: part-files in path order, _README skipped."""
    from harp_tpu.io import loaders as jloaders

    spec = str(REPO / "datasets" / "kmeans")
    ref = jloaders.load_dense_csv(jloaders.list_files(spec))
    assert ref.shape == (512, 16)
    seen = []
    load = trun._load_points
    monkeypatch.setattr(trun, "_load_points",
                        lambda s: seen.append(load(s)) or seen[-1])
    assert trun.main(["kmeans", "--device", "cpu", "--points-file", spec,
                      "--num-centroids", "4", "--iterations", "2"]) == 0
    np.testing.assert_array_equal(seen[0], ref)
    assert "n=512 k=4 d=16" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [[], ["--num-centroids", "7", "--dim", "3",
                                   "--comm", "rotation", "--lane-pad", "no"]])
def test_config_parse_into_matches_jax(argv):
    """One --flag per config field, parsed as the JAX package parses it."""
    from harp_tpu import config as jcfg
    from harp_tpu_torch import config as tcfg

    t = tcfg.parse_into(tkm.KMeansConfig, argv, iterations=4)
    j = jcfg.parse_into(jkm.KMeansConfig, argv, iterations=4)
    for f in dataclasses.fields(tkm.KMeansConfig):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    # the port keeps every runtime field but XLA's buffer donation
    for f in dataclasses.fields(tcfg.RuntimeConfig):
        assert (getattr(tcfg.DEFAULT_RUNTIME, f.name)
                == getattr(jcfg.DEFAULT_RUNTIME, f.name)), f.name


def test_convert_rejects_what_is_not_ported():
    # quant is ported: it carries across as it is
    cfg = dataclasses.asdict(jkm.KMeansConfig(3, 2, 1, quant="int8"))
    assert convert.kmeans_state_from_jax(np.zeros((3, 2)),
                                         cfg)[0].quant == "int8"
    cfg = dict(dataclasses.asdict(jkm.KMeansConfig(3, 2, 1)),
               no_such_field=1)
    with pytest.raises(ValueError, match="unknown KMeansConfig fields"):
        convert.kmeans_state_from_jax(np.zeros((3, 2)), cfg)
    cfg = dataclasses.asdict(jkm.KMeansConfig(3, 2, 1))
    with pytest.raises(ValueError, match="do not match"):
        convert.kmeans_state_from_jax(np.zeros((4, 2)), cfg)


def test_port_imports_no_jax():
    """No module of harp_tpu_torch, and not chip_smoke.py, imports jax or
    anything of harp_tpu."""
    files = sorted((REPO / "harp_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{path.relative_to(REPO)}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "harp_tpu")]
    assert not bad, bad
