"""The port's metrics registry and profiler hooks against the JAX package's.

``TimerReservoir``, ``_nearest_rank`` and ``Metrics`` give the JAX
package's counts, totals and percentiles on the same samples (the reservoir
is seeded, so even past its cap the kept samples are the same); ``trace``
writes a trace into its directory and closes on an exception; ``annotate``
works as a decorator and as a context manager; the device-memory hooks state
that the CPU has no device counters.
"""

import json
import os

import numpy as np
import pytest
import torch

from harp_tpu.utils import metrics as jm
from harp_tpu_torch.utils import metrics as tm
from harp_tpu_torch.utils import tracing as tt


@pytest.mark.parametrize("n,cap", [(10, 2048), (500, 64), (3000, 2048)])
def test_reservoir_and_percentiles_match_jax(n, cap):
    samples = np.random.default_rng(n).exponential(size=n).tolist()
    jr, tr = jm.TimerReservoir(cap=cap, seed=3), tm.TimerReservoir(cap=cap,
                                                                  seed=3)
    for v in samples:
        jr.add(v)
        tr.add(v)
    assert (tr.count, tr.total, tr.last) == (jr.count, jr.total, jr.last)
    assert tr.samples == jr.samples
    qs = [0.0, 0.25, 0.5, 0.9, 0.99, 1.0]
    assert tr.percentiles(qs) == jr.percentiles(qs)
    assert tm._nearest_rank(samples, qs) == jm._nearest_rank(samples, qs)
    assert np.isnan(tm._nearest_rank([], [0.5])[0])
    other_j, other_t = jm.TimerReservoir(cap=cap), tm.TimerReservoir(cap=cap)
    for v in samples[: n // 2]:
        other_j.add(v)
        other_t.add(v)
    jr.merge(other_j)
    tr.merge(other_t)
    assert tr.samples == jr.samples and tr.count == jr.count


def test_metrics_registry_matches_jax(tmp_path):
    regs = (jm.Metrics(), tm.Metrics())
    for r in regs:
        r.count("hops", 3)
        r.count("hops")
        r.gauge("rate", 2.5)
        for v in (0.3, 0.1, 0.2, 0.4):
            r.observe("epoch", v)
        with r.timer("phase"):
            pass
    js, ts = (r.snapshot() for r in regs)
    assert ts["counters"] == js["counters"] and ts["gauges"] == js["gauges"]
    assert ts["timers"]["epoch"] == js["timers"]["epoch"]
    assert ts["timers"]["phase"]["count"] == 1
    regs[1].dump(str(tmp_path / "m.json"))
    assert json.load(open(tmp_path / "m.json"))["counters"]["hops"] == 4.0
    assert tm.DEFAULT is not None and isinstance(tm.DEFAULT, tm.Metrics)


def test_device_mem_usage_states_its_counters(tmp_path):
    reg = tm.Metrics()
    out = tm.log_device_mem_usage(reg)
    if torch.cuda.is_available():
        assert set(out) == {f"cuda:{i}"
                            for i in range(torch.cuda.device_count())}
        assert "device.0.bytes_in_use" in reg.snapshot()["gauges"]
        tt.device_memory_profile(str(tmp_path / "mem.pickle"))
        assert (tmp_path / "mem.pickle").stat().st_size > 0
        return
    # without CUDA there are no device counters and no allocator to dump
    assert out == {} and reg.snapshot()["gauges"] == {}
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tt.device_memory_profile(str(tmp_path / "mem.pickle"))


def test_trace_writes_a_directory_and_closes_on_error(tmp_path):
    out = tmp_path / "tr"
    with tt.trace(str(out)):
        with tt.annotate("step"):
            torch.ones(8).sum()
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    assert "step" in (out / files[0]).read_text()
    with pytest.raises(ValueError, match="inside"):
        with tt.trace(str(tmp_path / "tr2")):
            raise ValueError("inside")
    # the capture was closed: a new one opens
    tt.start_trace(str(tmp_path / "tr3"))
    path = tt.stop_trace()
    assert os.path.exists(path)
    with pytest.raises(RuntimeError, match="no trace is open"):
        tt.stop_trace()


def test_annotate_as_decorator_and_context(tmp_path):
    @tt.annotate("decorated")
    def f(x):
        return x * 2

    with tt.trace(str(tmp_path)):
        assert int(f(torch.tensor(3))) == 6
        with tt.annotate("ctx"):
            torch.zeros(2)
    text = open(os.path.join(tmp_path, os.listdir(tmp_path)[0])).read()
    assert "decorated" in text and "ctx" in text
