"""The port's telemetry against the JAX package's, on the CPU.

Each test runs the same inputs (made from a seed) through ``harp_tpu.
telemetry`` and ``harp_tpu_torch.telemetry``, or through a JAX fit and its
port with telemetry on, and compares what they write:

* the step log: ``steps.jsonl`` field for field, apart from ``ts``,
  ``step_s`` and ``chunk_wall_s`` (wall clocks); the ring bound and its
  drops, the flush cadence, ``phase`` and ``record_timing``;
* the comm ledger: every row of the port's price table against what the
  JAX package's own ``CommLedger(target)`` prices, ``manifest_target`` over
  every model, comm and quant, the gauges;
* the model hooks: ``KMeans.comm_scale`` over a grid of (k, d, W); the
  K-means, SGD-MF, ALS, NN and LDA fits' events (losses within the fits'
  existing tolerances, everything else exact), ``flush_stage_timings`` and
  ``run kmeans --telemetry-dir``; a fit with telemetry on is bitwise the
  same fit with it off;
* the profiler window (trigger file, event, closed by ``StepLog.close``),
  ``prometheus_text``, ``aggregate_snapshots``, ``straggler_report`` (with
  the bsp, cold-rank and min-gap cases) and a live exporter.

No test asserts on a measured time: straggler inputs are scripted p50s.
The gloo exchange across processes runs in the gangs of
``tests/test_torch_ring_dma.py`` (``parallel/mp_smoke.event_telemetry_checks``).
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from harp_tpu import run as jrun
from harp_tpu import telemetry as jtel
from harp_tpu.io import datagen as jdatagen
from harp_tpu.models import als as jals
from harp_tpu.models import kmeans as jkm
from harp_tpu.models import lda as jlda
from harp_tpu.models import nn as jnn
from harp_tpu.models import sgd_mf as jmf
from harp_tpu.session import HarpSession as JaxSession
from harp_tpu.telemetry import comm_ledger as jcl
from harp_tpu.telemetry import exporter as jexp
from harp_tpu.telemetry import gang as jgang
from harp_tpu.telemetry import step_log as jsl
from harp_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from harp_tpu.utils.metrics import Metrics as JMetrics
from harp_tpu.io import pipeline as jpl
from harp_tpu_torch import run as trun
from harp_tpu_torch import telemetry as ttel
from harp_tpu_torch.io import pipeline as tpl
from harp_tpu_torch.models import als as tals
from harp_tpu_torch.models import kmeans as tkm
from harp_tpu_torch.models import lda as tlda
from harp_tpu_torch.models import nn as tnn
from harp_tpu_torch.models import sgd_mf as tmf
from harp_tpu_torch.session import HarpSession as TorchSession
from harp_tpu_torch.telemetry import comm_ledger as tcl
from harp_tpu_torch.telemetry import exporter as texp
from harp_tpu_torch.telemetry import gang as tgang
from harp_tpu_torch.telemetry import step_log as tsl
from harp_tpu_torch.telemetry import xprof as txprof
from harp_tpu_torch.utils.checkpoint import Checkpointer
from harp_tpu_torch.utils.metrics import Metrics as TMetrics

WALL = ("ts", "step_s", "chunk_wall_s")


@pytest.fixture(autouse=True)
def _telemetry_off():
    """Every test starts and ends with both packages' telemetry off."""
    jtel.disable()
    ttel.disable()
    yield
    jtel.disable()
    ttel.disable()


def _read(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f.read().strip().splitlines()]


def _strip(events, drop=WALL):
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


def _same_events(got, want, loss_rtol=0.0):
    """Field for field, apart from the wall clocks; losses within
    ``loss_rtol`` (0: exact)."""
    assert len(got) == len(want) and got
    assert _strip(got, WALL + ("loss",)) == _strip(want, WALL + ("loss",))
    assert [("loss" in e) for e in got] == [("loss" in e) for e in want]
    gl = [e["loss"] for e in got if "loss" in e]
    wl = [e["loss"] for e in want if "loss" in e]
    if loss_rtol:
        np.testing.assert_allclose(gl, wl, rtol=loss_rtol)
    else:
        assert gl == wl


def _no_wall(gauges):
    return {k: v for k, v in gauges.items() if not k.endswith("busbw_gbps")}


# --------------------------------------------------------------------------- #
# The step log
# --------------------------------------------------------------------------- #

def test_record_chunk_is_noop_when_disabled():
    for tel in (jtel, ttel):
        tel.record_chunk("kmeans", start=0, losses=[1.0], wall_s=0.1)
        tel.record_timing("x", metrics=TMetrics())
        with tel.phase("x"):
            pass
        assert tel.active() is None
        assert tel.ledger_for("kmeans", comm="allreduce") is None


def _step_script(tel, metrics_cls, directory):
    m = metrics_cls()
    tel.configure(directory, interval=2, metrics=m, rank=3)
    tel.record_chunk("kmeans", start=4, losses=[9.0, 8.0], wall_s=0.2,
                     extra={"comm": "allreduce"},
                     ledger=tel.ledger_for("kmeans", comm="allreduce",
                                           scale=1.5))
    tel.record_chunk("sgd_mf", start=0, losses=[0.5], wall_s=0.01,
                     ledger=tel.ledger_for("sgd_mf", quant="int8"))
    tel.record_chunk("lda", start=2, losses=[-3.0, -2.5, -2.25],
                     ledger=tel.ledger_for("lda", sub_block=True))
    tel.record_chunk("m", start=0, steps=3)
    tel.record_chunk("m", start=3, steps=0)             # no step: a no-op
    with tel.phase("x.checkpoint"):
        pass
    reg = metrics_cls()
    tel.record_timing("serve.latency.mixed", metrics=reg)   # no samples
    for v in (0.001, 0.002, 0.003, 0.0005):
        reg.observe("serve.latency.mixed", v)
    tel.record_timing("serve.latency.mixed", metrics=reg,
                      extra={"mix": "mixed", "qps": 123.0})
    tel.record_timing("alias", timer="serve.latency.mixed", metrics=reg)
    path = tel.active().path
    tel.disable()                                  # flushes the tail
    snap = m.snapshot()
    return _read(path), snap


def test_step_log_script_matches_jax(tmp_path):
    got, tsnap = _step_script(ttel, TMetrics, str(tmp_path / "t"))
    want, jsnap = _step_script(jtel, JMetrics, str(tmp_path / "j"))
    _same_events(got, want)
    assert [e.get("kind", "step") for e in got].count("timing") == 2
    assert tsnap["counters"] == jsnap["counters"]
    assert _no_wall(tsnap["gauges"]) == _no_wall(jsnap["gauges"])
    assert set(tsnap["timers"]) == set(jsnap["timers"])
    for name, t in tsnap["timers"].items():
        assert t["count"] == jsnap["timers"][name]["count"], name
    assert tsl.EVENT_VERSION == jsl.EVENT_VERSION
    assert (tsl.DEFAULT_CAPACITY, tsl.DEFAULT_INTERVAL, tsl.ENV_DIR,
            tsl.ENV_INTERVAL) == (jsl.DEFAULT_CAPACITY, jsl.DEFAULT_INTERVAL,
                                  jsl.ENV_DIR, jsl.ENV_INTERVAL)


@pytest.mark.parametrize("capacity", [1, 8, 32])
def test_ring_bound_and_drops_match_jax(tmp_path, capacity):
    out = []
    for mod, mcls in ((tsl, TMetrics), (jsl, JMetrics)):
        m = mcls()
        log = mod.StepLog(str(tmp_path / mod.__name__), capacity=capacity,
                          rank=0, metrics=m)
        for i in range(20):
            log.emit({"step": i})
        log.flush()
        out.append((log.dropped, dict(m.counters), _read(log.path)))
    assert out[0] == out[1]
    assert out[0][0] == max(0, 20 - capacity)
    assert [e["step"] for e in out[0][2]] == list(range(20 - min(capacity,
                                                                 20), 20))


def test_flush_cadence_and_env_config_match_jax(tmp_path, monkeypatch):
    for tel in (ttel, jtel):
        d = tmp_path / tel.__name__
        tel.configure(str(d), interval=3, metrics=TMetrics())
        for i in range(2):
            tel.record_chunk("m", start=i, losses=[0.0])
        assert not os.path.exists(tel.active().path)     # below cadence
        tel.record_chunk("m", start=2, losses=[0.0])     # 3rd boundary
        assert len(_read(tel.active().path)) == 3
        tel.disable()
    # the environment: directory, cadence and the launcher's rank
    monkeypatch.setenv("HARP_TELEMETRY_DIR", str(tmp_path / "env"))
    monkeypatch.setenv("HARP_TELEMETRY_INTERVAL", "5")
    monkeypatch.setenv("HARP_PROCESS_ID", "2")
    logs = []
    for tel in (ttel, jtel):
        tel.step_log._env_checked = False
        log = tel.active()
        logs.append((log.interval, log.rank, os.path.relpath(
            log.path, str(tmp_path / "env"))))
        tel.disable()
    assert logs[0] == logs[1] == (5, 2, os.path.join("rank2",
                                                     "steps.jsonl"))


def test_phase_timer_records_only_when_enabled(tmp_path):
    with ttel.phase("x.checkpoint"):
        pass
    m = TMetrics()
    ttel.configure(str(tmp_path), metrics=m)
    with ttel.phase("x.checkpoint"):
        pass
    with pytest.raises(KeyError):
        with ttel.phase("x.checkpoint"):
            raise KeyError("the timer still records")
    assert m.timing("telemetry.phase.x.checkpoint")["count"] == 2


# --------------------------------------------------------------------------- #
# The comm ledger
# --------------------------------------------------------------------------- #

PORT_ROWS = sorted(tcl.load_manifest()["targets"])


@pytest.mark.parametrize("target", PORT_ROWS)
def test_price_row_is_what_the_jax_ledger_prices(target):
    row = tcl.load_manifest()["targets"][target]
    tl, jl = tcl.CommLedger(target), jcl.CommLedger(target)
    assert tl.bytes_per_step == jl.bytes_per_step is not None
    assert tl.bytes_by_kind == jl.bytes_by_kind
    assert row["collectives"] == \
        jcl.load_manifest()["targets"][target]["collectives"]
    scaled = (tcl.CommLedger(target, scale=2.5, exact=True).snapshot(),
              jcl.CommLedger(target, scale=2.5, exact=True).snapshot())
    assert scaled[0] == scaled[1]


def _grid():
    for model in ("kmeans", "lda", "sgd_mf", "als", "nn", "pagerank",
                  "pca", "nonsuch"):
        for comm in (None,) + tkm.COMM_VARIANTS:
            for quant in (None, "int8", "bf16"):
                for sub_block in (False, True):
                    yield model, comm, quant, sub_block


def test_manifest_target_resolves_as_jax_and_the_table_holds_each_row():
    resolved = set()
    for model, comm, quant, sub_block in _grid():
        kw = dict(comm=comm, quant=quant, sub_block=sub_block)
        t = tcl.manifest_target(model, **kw)
        assert t == jcl.manifest_target(model, **kw), (model, kw)
        if t is not None:
            resolved.add(t)
    assert resolved == set(PORT_ROWS)
    assert tcl.manifest_target("kmeans", comm="allreduce", quant="int8") \
        == "kmeans_allreduce_int8"
    assert tcl.manifest_target("kmeans", comm="rotation", quant="int8") \
        == "kmeans_rotation"


def test_ledger_gauges_match_jax(tmp_path):
    gauges = []
    for cl, mcls in ((tcl, TMetrics), (jcl, JMetrics)):
        m = mcls()
        led = cl.CommLedger("kmeans_regroupallgather", scale=0.75,
                            metrics=m)
        led.on_steps(10, wall_s=2.0)
        led.on_steps(3)
        led.on_steps(0, wall_s=1.0)
        inert = cl.CommLedger("no_such_row", metrics=m)
        inert.on_steps(5, wall_s=1.0)
        gauges.append((dict(m.gauges), led.snapshot(), inert.bytes_per_step))
    assert gauges[0] == gauges[1]
    g = gauges[0][0]
    assert g["comm.kmeans_regroupallgather.pricing_exact"] == 0.0
    assert g["comm.kmeans_regroupallgather.busbw_gbps"] == pytest.approx(
        74244 * 0.75 * 13 / 2.0 / 1e9)


def test_price_table_is_read_from_the_port_not_the_jax_tools(tmp_path):
    assert os.path.dirname(tcl.MANIFEST_PATH) == os.path.dirname(
        os.path.abspath(tcl.__file__))
    empty = tcl.load_manifest(str(tmp_path / "missing.json"))
    assert empty == {"targets": {}}
    assert tcl.CommLedger("kmeans_allreduce",
                          manifest_path=str(tmp_path / "missing.json")
                          ).bytes_per_step is None


# --------------------------------------------------------------------------- #
# The model hooks
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("lane_pad", [True, False])
@pytest.mark.parametrize("w", [1, 4, 8])
def test_comm_scale_matches_jax(w, lane_pad):
    js, ts = JaxSession(num_workers=w), TorchSession(num_workers=w,
                                                     device="cpu")
    for k in (1, 8, 100, 300):
        for d in (16, 100, 129):
            kw = dict(num_centroids=k, dim=d, lane_pad=lane_pad)
            got = tkm.KMeans(ts, tkm.KMeansConfig(**kw)).comm_scale()
            want = jkm.KMeans(js, jkm.KMeansConfig(**kw)).comm_scale()
            assert got == want, (k, d, w, lane_pad)
    assert tkm.TRACE_WORKERS == jkm.TRACE_WORKERS


KM = dict(n=512, k=6, d=8, iterations=5, save_every=2)


@pytest.fixture(scope="module")
def km_data():
    pts = jdatagen.dense_points(KM["n"], KM["d"], seed=7, num_clusters=KM["k"])
    return pts, jdatagen.initial_centroids(pts, KM["k"], seed=3)


def _km_fit(pkg, w, data, root, metrics=None, **cfg_kw):
    pts, cen0 = data
    if pkg == "jax":
        tel, mod, sess, ck = (jtel, jkm, JaxSession(num_workers=w),
                              JaxCheckpointer(str(root / "ck"),
                                              use_orbax=False))
    else:
        tel, mod, sess, ck = (ttel, tkm, TorchSession(num_workers=w,
                                                      device="cpu"),
                              Checkpointer(str(root / "ck")))
    if metrics is not None:
        tel.configure(str(root / "tele"), interval=1, metrics=metrics)
    model = mod.KMeans(sess, mod.KMeansConfig(KM["k"], KM["d"],
                                              KM["iterations"], **cfg_kw))
    p, c = model.prepare(pts, cen0)
    cen, costs, _ = model.fit_checkpointed(p, c, ck,
                                           save_every=KM["save_every"])
    tel.disable()
    return np.asarray(cen), np.asarray(costs)


@pytest.mark.parametrize("w", [1, 4, 8])
def test_kmeans_fit_checkpointed_events_match_jax(tmp_path, km_data, w):
    tm, jm = TMetrics(), JMetrics()
    _, tcosts = _km_fit("torch", w, km_data, tmp_path / "t", tm)
    _, jcosts = _km_fit("jax", w, km_data, tmp_path / "j", jm)
    got = _read(tmp_path / "t" / "tele" / "rank0" / "steps.jsonl")
    want = _read(tmp_path / "j" / "tele" / "rank0" / "steps.jsonl")
    _same_events(got, want, loss_rtol=1e-5)     # the fits' tolerance
    assert [e["step"] for e in got] == list(range(KM["iterations"]))
    assert [e["chunk_steps"] for e in got] == [2, 2, 2, 2, 1]
    assert [e["loss"] for e in got] == tcosts.tolist()
    assert all(e["wire_pricing"] == ("scaled" if w == 8 else "traced_shape")
               for e in got)
    assert _no_wall(tm.gauges) == _no_wall(jm.gauges)
    assert tm.timing("telemetry.phase.kmeans.checkpoint")["count"] == 3
    assert tm.timing("telemetry.step.kmeans")["count"] == KM["iterations"]


@pytest.mark.parametrize("comm", ["allreduce", "rotation"])
def test_kmeans_fit_with_telemetry_is_bitwise_the_fit_without(tmp_path,
                                                              km_data, comm):
    off = _km_fit("torch", 4, km_data, tmp_path / "off", comm=comm)
    on = _km_fit("torch", 4, km_data, tmp_path / "on", TMetrics(), comm=comm)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    assert len(_read(tmp_path / "on" / "tele" / "rank0" / "steps.jsonl")) \
        == KM["iterations"]


NU, NI = 128, 96


@pytest.fixture(scope="module")
def ratings():
    return jdatagen.sparse_ratings(NU, NI, rank=4, density=0.1, seed=3)


def _two_fits(tmp_path, fit):
    """``fit(pkg)`` with each package's telemetry on into its own
    directory; returns both JSONL event lists and both gauge dicts."""
    out = []
    for pkg, tel, mcls in (("torch", ttel, TMetrics), ("jax", jtel,
                                                       JMetrics)):
        m = mcls()
        tel.configure(str(tmp_path / pkg), interval=1, metrics=m)
        res = fit(pkg)
        tel.disable()
        out.append((_read(tmp_path / pkg / "rank0" / "steps.jsonl"),
                    _no_wall(dict(m.gauges)), res))
    return out


# the quantized fit on tests/test_torch_quantize.py's ratings and config,
# where that test holds the two packages' RMSEs within 1e-5
_RNG = np.random.default_rng(42)
QUANT_RATINGS = (_RNG.integers(0, 64, size=400),
                 _RNG.integers(0, 48, size=400),
                 _RNG.normal(size=400).astype(np.float32))
SGD_MF_CASES = {
    None: dict(cfg=dict(rank=8, lam=0.01, lr=0.05, epochs=3,
                        minibatches_per_hop=4), w=2, loss=("rtol", 1e-5)),
    "int8": dict(cfg=dict(rank=8, epochs=3, minibatches_per_hop=2,
                          quant="int8"), w=4, loss=("atol", 1e-5)),
}


@pytest.mark.parametrize("quant", [None, "int8"])
def test_sgd_mf_fits_events_match_jax(tmp_path, ratings, quant):
    case = SGD_MF_CASES[quant]
    rows, cols, vals = ratings if quant is None else QUANT_RATINGS
    nu, ni = (NU, NI) if quant is None else (64, 48)
    kw, w = case["cfg"], case["w"]

    def fit(pkg):
        if pkg == "jax":
            model = jmf.SGDMF(JaxSession(num_workers=w), jmf.SGDMFConfig(**kw))
            ck = JaxCheckpointer(str(tmp_path / "jck"), use_orbax=False)
        else:
            model = tmf.SGDMF(TorchSession(num_workers=w, device="cpu"),
                              tmf.SGDMFConfig(**kw))
            ck = Checkpointer(str(tmp_path / "tck"))
        state = model.prepare(rows, cols, vals, nu, ni, seed=1)
        r1 = model.fit_prepared(state)[2]
        r2 = model.fit_checkpointed(state, ck, save_every=2)[2]
        return np.asarray(r1), np.asarray(r2)

    (got, tg, (tr1, tr2)), (want, jg, _) = _two_fits(tmp_path, fit)
    kind, tol = case["loss"]
    if kind == "rtol":
        _same_events(got, want, loss_rtol=tol)
    else:
        _same_events(got, want, loss_rtol=1.0)     # shapes and fields
        np.testing.assert_allclose([e["loss"] for e in got],
                                   [e["loss"] for e in want], rtol=0,
                                   atol=tol)
    assert got[0]["wire_bytes_per_step"] == tcl.CommLedger(
        tcl.manifest_target("sgd_mf", quant=quant)).bytes_per_step
    assert len(got) == 6 and tg == jg
    assert [e["loss"] for e in got] == tr1.tolist() + tr2.tolist()
    assert {e["wire_pricing"] for e in got} == {"traced_shape"}


@pytest.mark.parametrize("implicit", [True, False])
def test_als_fit_events_match_jax(tmp_path, ratings, implicit):
    rows, cols, vals = ratings
    vals = np.abs(vals) if implicit else vals
    kw = dict(rank=8, lam=0.1, alpha=40.0, iterations=3, implicit=implicit,
              layout="sparse")

    def fit(pkg):
        mod, sess = ((jals, JaxSession(num_workers=4)) if pkg == "jax" else
                     (tals, TorchSession(num_workers=4, device="cpu")))
        return mod.ALS(sess, mod.ALSConfig(**kw)).fit(rows, cols, vals, NU,
                                                      NI, 1)[2]

    (got, tg, rmse), (want, jg, _) = _two_fits(tmp_path, fit)
    _same_events(got, want, loss_rtol=1e-4)     # test_torch_als's RMSE rtol
    assert [e["loss"] for e in got] == np.asarray(rmse).tolist()
    assert tg == jg
    assert ("wire_bytes_per_step" in got[0]) is (not implicit)


def test_nn_fit_events_match_jax(tmp_path):
    x, y = jdatagen.classification_data(256, 12, 4, seed=3)
    kw = dict(layers=(16, 8), num_classes=4, lr=0.05, batch_size=20,
              epochs=3)

    def fit(pkg):
        mod, sess = ((jnn, JaxSession(num_workers=4)) if pkg == "jax" else
                     (tnn, TorchSession(num_workers=4, device="cpu")))
        return mod.MLPClassifier(sess, mod.NNConfig(**kw)).fit(x, y, seed=1)

    (got, tg, losses), (want, jg, _) = _two_fits(tmp_path, fit)
    _same_events(got, want, loss_rtol=1e-5)
    assert [e["loss"] for e in got] == losses.tolist() and tg == jg


@pytest.mark.parametrize("sub_block", [0, 16])
def test_lda_fits_events_match_jax(tmp_path, sub_block):
    docs = jdatagen.lda_corpus(32, 60, 4, 16, seed=5)
    kw = dict(num_topics=8, vocab=60, epochs=3, vocab_sub_block=sub_block)

    def fit(pkg):
        if pkg == "jax":
            model = jlda.LDA(JaxSession(num_workers=4), jlda.LDAConfig(**kw))
            ck = JaxCheckpointer(str(tmp_path / "jck"), use_orbax=False)
        else:
            model = tlda.LDA(TorchSession(num_workers=4, device="cpu"),
                             tlda.LDAConfig(**kw))
            ck = Checkpointer(str(tmp_path / "tck"))
        ll1 = model.fit(docs, seed=0)[2]
        ll2 = model.fit_checkpointed(model.prepare(docs, seed=1), ck,
                                     save_every=2)[2]
        return np.asarray(ll1), np.asarray(ll2)

    (got, tg, (l1, l2)), (want, jg, _) = _two_fits(tmp_path, fit)
    _same_events(got, want, loss_rtol=1e-6)     # test_torch_lda's ll rtol
    assert [e["loss"] for e in got] == l1.tolist() + l2.tolist()
    assert tg == jg and len(got) == 6


def test_flush_stage_timings_match_jax(tmp_path):
    out = []
    for tel, pl, mcls in ((ttel, tpl, TMetrics), (jtel, jpl, JMetrics)):
        assert pl.STAGES == jpl.STAGES
        reg = mcls()
        for i, stage in enumerate(pl.STAGES[::2]):
            for v in range(i + 1):
                reg.observe(stage, 0.001 * (v + 1))
        pl.flush_stage_timings(reg, extra={"bench": "ingest"})   # off: no-op
        tel.configure(str(tmp_path / tel.__name__), interval=100)
        pl.flush_stage_timings(reg, extra={"bench": "ingest"})
        path = tel.active().path
        tel.disable()
        out.append(_read(path))
    _same_events(out[0], out[1])
    assert [e["name"] for e in out[0]] == list(tpl.STAGES[::2])


def test_run_kmeans_telemetry_dir_matches_jax(tmp_path, capsys):
    argv = ["kmeans", "--num-points", "512", "--num-centroids", "6",
            "--dim", "8", "--iterations", "5", "--num-workers", "4",
            "--save-every", "2"]
    assert trun.main(argv + ["--device", "cpu", "--work-dir",
                             str(tmp_path / "tw"), "--telemetry-dir",
                             str(tmp_path / "tt")]) == 0
    ttel.disable()
    assert jrun.main(argv + ["--work-dir", str(tmp_path / "jw"),
                             "--telemetry-dir", str(tmp_path / "jt")]) == 0
    jtel.disable()
    capsys.readouterr()
    got = _read(tmp_path / "tt" / "rank0" / "steps.jsonl")
    want = _read(tmp_path / "jt" / "rank0" / "steps.jsonl")
    _same_events(got, want, loss_rtol=1e-5)
    assert len(got) == 5


def test_run_takes_the_telemetry_flags_but_not_the_slo_ones(capsys):
    with pytest.raises(SystemExit):
        trun.main(["stats", "--device", "cpu", "--slo-p99-ms", "5"])
    assert "unrecognized arguments: --slo-p99-ms" in capsys.readouterr().err
    assert trun.main(["stats", "--device", "cpu", "--num-points", "64",
                      "--dim", "4", "--metrics-port", "0"]) == 0
    err = capsys.readouterr().err
    assert "metrics exporter on http://127.0.0.1:" in err


# --------------------------------------------------------------------------- #
# The profiler window
# --------------------------------------------------------------------------- #

def _trace_files(ctrl):
    return [os.path.join(r, f) for r, _, fs in os.walk(ctrl.trace_dir)
            for f in fs]


def test_xprof_window_from_an_event(tmp_path):
    sess = TorchSession(device="cpu")
    ctrl = txprof.XprofController(sess, rank=0)
    try:
        txprof.request_xprof(sess, steps=2, directory=str(tmp_path / "x"))
        ctrl(1)
        assert ctrl.tracing
        torch.square(torch.arange(64.0))          # something to trace
        ctrl(2)
        assert ctrl.tracing
        ctrl(3)
        assert not ctrl.tracing
        assert ctrl.trace_dir == str(tmp_path / "x" / "rank0")
        files = _trace_files(ctrl)
        assert files == [ctrl.trace_path]
        with open(ctrl.trace_path) as f:
            assert "traceEvents" in json.load(f)
    finally:
        ctrl.close()
        sess.close_events()


def test_xprof_trigger_file_operator_path(tmp_path, capsys):
    """A file there before startup is ignored, a malformed one is reported
    and not fatal, a rewrite re-arms, the same content is consumed once,
    and a request that arrives mid-window is dropped with a note."""
    sess = TorchSession(device="cpu")
    trig = tmp_path / "xprof_request.json"
    trig.write_text(json.dumps({"steps": 1}))       # stale
    ctrl = txprof.XprofController(sess, rank=0, trigger_path=str(trig),
                                  default_dir=str(tmp_path / "xprof"))
    try:
        ctrl(1)
        assert not ctrl.tracing
        trig.write_text("{not json")
        ctrl(2)
        assert not ctrl.tracing
        assert "bad xprof trigger file" in capsys.readouterr().err
        trig.write_text(json.dumps({"steps": 2}))
        ctrl(3)
        assert ctrl.tracing
        txprof.request_xprof(sess, steps=5, directory=str(tmp_path / "y"))
        ctrl(4)
        assert ctrl.tracing and "request ignored" in capsys.readouterr().err
        ctrl(5)
        assert not ctrl.tracing and _trace_files(ctrl)
        assert ctrl.trace_dir == str(tmp_path / "xprof" / "rank0")
        ctrl(6)
        assert not ctrl.tracing                      # consumed
        trig.write_text(json.dumps({"step": 2}))     # no "steps"
        ctrl(7)
        assert not ctrl.tracing
    finally:
        ctrl.close()
        sess.close_events()


def test_xprof_window_left_open_is_closed_by_steplog_close(tmp_path):
    sess = TorchSession(device="cpu")
    log = ttel.configure(str(tmp_path), interval=100, metrics=TMetrics())
    ctrl = txprof.XprofController(sess, rank=0)
    log.add_boundary_hook(ctrl)
    try:
        txprof.request_xprof(sess, steps=50, directory=str(tmp_path / "x"))
        ttel.record_chunk("m", start=0, losses=[0.0])
        assert ctrl.tracing
        ttel.disable()                               # as at exit
        assert not ctrl.tracing and _trace_files(ctrl)
    finally:
        ctrl.close()
        sess.close_events()


def test_xprof_other_events_go_back_on_the_queue():
    sess = TorchSession(device="cpu")
    try:
        sess.send_event({"note": "operator-ping"})
        sess.send_event(("other", 1))
        ctrl = txprof.XprofController(sess, rank=0)
        ctrl(1)
        assert not ctrl.tracing
        got = [sess.get_event().payload, sess.get_event().payload]
        assert got == [{"note": "operator-ping"}, ("other", 1)]
    finally:
        sess.close_events()


# --------------------------------------------------------------------------- #
# Gang aggregation, the straggler report and the exporter
# --------------------------------------------------------------------------- #

def _metrics_pair(seed):
    out = []
    for mcls in (TMetrics, JMetrics):
        m = mcls()
        rng = np.random.default_rng(seed)
        for i in range(50):
            m.observe("telemetry.step.kmeans", float(rng.uniform(0.001, 0.01)))
            m.count("serve.requests")
        m.count("telemetry.events_dropped", 3)
        m.gauge("comm.kmeans_regroupallgather.cumulative_gb", 0.25 + seed)
        m.gauge("serve.queue_depth.topk", 7)
        m.observe("ingest.parse", 0.5)
        out.append(m.snapshot())
    return out


def test_prometheus_text_and_aggregate_match_jax():
    pairs = {r: _metrics_pair(r) for r in (0, 1, 3)}
    for r, (ts_, js_) in pairs.items():
        assert ts_ == js_
        assert texp.prometheus_text(ts_) == jexp.prometheus_text(js_)
    text = texp.prometheus_text(pairs[1][0])
    assert "# TYPE harp_comm_kmeans_regroupallgather_cumulative_gb gauge" \
        in text
    assert 'harp_telemetry_step_kmeans_seconds{quantile="0.99"}' in text
    assert texp.prometheus_text({}) == jexp.prometheus_text({}) == "\n"
    assert texp.aggregate_snapshots({r: p[0] for r, p in pairs.items()}) \
        == jexp.aggregate_snapshots({r: p[1] for r, p in pairs.items()})


def _snap(p50, count=10):
    return {"timers": {"telemetry.step.kmeans":
                       {"count": count, "p50_s": p50, "p99_s": p50 * 1.2}}}


STRAGGLER_CASES = {
    "slow_rank": ({**{r: _snap(0.010) for r in range(8)},
                   5: _snap(0.055)}, {}),
    "bsp": ({0: _snap(0.131), 1: _snap(0.015), 2: _snap(0.136)}, {}),
    "spread_below_k": ({r: _snap(0.010 + 0.001 * r) for r in range(8)}, {}),
    "min_gap": ({0: _snap(1e-6), 1: _snap(1e-6), 2: _snap(3e-6)}, {}),
    "cold_rank": ({**{r: _snap(0.010) for r in range(4)},
                   2: _snap(0.500, count=1)}, dict(min_samples=3)),
    "single_rank": ({0: _snap(0.01)}, {}),
    "two_ranks_k15": ({0: _snap(0.001), 1: _snap(0.060)}, dict(k=1.5)),
    "no_step_timer": ({0: {"timers": {}}, 1: _snap(0.01), 2: _snap(0.02)},
                      dict(min_gap_s=0.0)),
}


@pytest.mark.parametrize("case", sorted(STRAGGLER_CASES))
def test_straggler_report_matches_jax(case):
    snaps, kw = STRAGGLER_CASES[case]
    got = tgang.straggler_report(snaps, **kw)
    want = jgang.straggler_report(snaps, **kw)
    got.pop("ts"), want.pop("ts")
    assert got == want
    expect = {"slow_rank": ([5], []), "bsp": ([], [1]),
              "cold_rank": ([], []), "min_gap": ([], []),
              "two_ranks_k15": ([1], [0])}
    if case in expect:
        assert (got["suspects"], got["bsp_suspects"]) == expect[case]


def test_publish_gather_and_collector_single_process(tmp_path):
    sess = TorchSession(device="cpu")
    m = TMetrics()
    for wall in (0.01, 0.02, 0.03):
        m.observe("telemetry.step.fake", wall)
    snaps = tgang.gather_snapshots(sess, metrics=m)
    assert list(snaps) == [0] and snaps[0] == m.snapshot()
    assert tgang.read_straggler_report(str(tmp_path)) is None
    rep = tgang.publish_straggler_report(sess, str(tmp_path), metrics=m)
    on_disk = tgang.read_straggler_report(str(tmp_path))
    assert on_disk == json.loads(json.dumps(rep))
    want = jgang.straggler_report(snaps)
    assert {k: v for k, v in rep.items() if k != "ts"} == \
        {k: v for k, v in want.items() if k != "ts"}
    assert m.gauges["telemetry.straggler_suspects"] == 0
    (tmp_path / tgang.REPORT_NAME).write_text("{torn")
    assert tgang.read_straggler_report(str(tmp_path)) is None
    log = ttel.configure(str(tmp_path), interval=2, rank=0, metrics=m)
    col = tgang.GangCollector(sess, str(tmp_path / "g"), every=1)
    col(1, log)
    assert col.last_exchange() == (None, None)      # off the cadence
    col(2, log)
    snaps, report = col.last_exchange()
    assert snaps[0]["timers"]["telemetry.step.fake"]["count"] == 3
    assert report["num_ranks"] == 1 and col.snapshots() is snaps
    assert m.timing("telemetry.phase.gang.straggler_publish")["count"] == 1
    sess.close_events()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, ""


def test_live_exporter_on_an_ephemeral_port():
    m = TMetrics()
    m.count("telemetry.events_dropped", 2)
    m.gauge("comm.kmeans_regroupallgather.wire_bytes_per_step", 74244.0)
    m.observe("telemetry.step.kmeans", 0.004)
    gang = {0: m.snapshot(), 1: _snap(0.01)}
    with texp.MetricsExporter(m, port=0, rank=3) as ex:
        assert ex.host == "127.0.0.1" and ex.port > 0
        base = f"http://{ex.host}:{ex.port}"
        status, text = _get(base + "/metrics")
        assert status == 200 and text == texp.prometheus_text(m.snapshot())
        assert "harp_comm_kmeans_regroupallgather_wire_bytes_per_step " \
               "74244" in text
        status, body = _get(base + "/snapshot?x=1")
        snap = json.loads(body)
        assert status == 200 and snap["rank"] == 3
        assert snap["gauges"] == m.snapshot()["gauges"]
        assert _get(base + "/gang")[0] == 404        # no source wired
        assert _get(base + "/nonsuch")[0] == 404
    with texp.MetricsExporter(m, port=0, gang=lambda: gang) as ex:
        status, body = _get(f"http://{ex.host}:{ex.port}/gang")
        view = json.loads(body)
        assert status == 200 and sorted(view["ranks"]) == ["0", "1"]
        assert view["aggregated"] == json.loads(json.dumps(
            jexp.aggregate_snapshots(gang)))
    ex.close()                                       # idempotent
