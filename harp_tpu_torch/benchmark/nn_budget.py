"""Per-step budget of mini-batch NN training on the card.

Port of ``harp_tpu/benchmark/nn_budget.py``. The bench row (n = 65,536,
d = 128, layers 256 x 128, 16 classes, batch 512; ``bench.py``'s
``tpu_nn``) runs 128 minibatches an epoch of small GEMMs. This harness
measures, all two-point (``benchmark/timing.py``: the fixed cost of a
call cancels):

* a batch-size sweep at the bench model (512 -> 4096 -> the full batch):
  µs a step against the step's FLOPs separates the fixed cost a step (the
  host's launches, the optimizer, the allreduce) from the compute: if µs a
  step stays flat while the FLOPs grow 8x, the 512 batch sits at that
  floor;
* the compute-bound config (d = 512, layers 2048 x 1024, batch 8192),
  ``bench.py``'s second NN row, with its float32 bound (6 FLOPs a weight a
  sample over the card's float32 peak): three two-point readings and their
  median, with the SM clock and power draw that ``nvidia-smi`` samples
  while they run;
* the allreduce share: a full step against ``ablate_allreduce=True`` on a
  stacked group of 8 workers on the card (the port has no virtual mesh),
  timed in turns (full, ablated, ablated, full). The share is signed and
  printed beside the spread of each config's two readings: where it is
  not larger than that spread (``resolved`` false), the readings cannot
  tell the allreduce from noise.

Run::

    python -m harp_tpu_torch.benchmark.nn_budget [--device cuda]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess

# the card's float32 peak on the CUDA cores (H100 SXM data sheet)
PEAK_F32_FLOPS = 67e12
BENCH = dict(n=65536, d=128, layers=(256, 128), classes=16, lr=0.05)
COMPUTE = dict(n=65536, d=512, layers=(2048, 1024), batch=8192)


def weight_mults(d: int, layers, classes: int = 16) -> int:
    """Multiply-adds a sample of one forward pass: the sum of a * b over the
    weight matrices."""
    dims = [d, *layers, classes]
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def two_point_epoch_s(sess, n, d, layers, batch, epochs, reps=3,
                      data=None, **cfg_kw):
    """Two-point seconds an epoch of one NN config (``epochs`` = (lo, hi)),
    with its data placed once; ``data`` = (x, y) placed tensors to reuse."""
    from harp_tpu_torch.benchmark.timing import two_point
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import nn

    if data is None:
        x, y = datagen.classification_data(n, d, BENCH["classes"], seed=4)
        data = (sess.scatter(x), sess.scatter(y))
    x_dev, y_dev = data

    def build(ne):
        cfg = nn.NNConfig(layers=tuple(layers), num_classes=BENCH["classes"],
                          lr=BENCH["lr"], batch_size=batch, epochs=ne,
                          **cfg_kw)
        m = nn.MLPClassifier(sess, cfg)
        m.fit(x_dev, y_dev, seed=0)              # warm-up

        def timer():
            m.fit(x_dev, y_dev, seed=0)          # fetches the losses
        return timer

    lo, hi = epochs
    tp = two_point(build, lo, hi, 1.0, reps=reps, device=sess.device)
    return tp["per_iter_ms"] / 1e3


def _row(n, mults, batch, steps, eps):
    flops_step = 6.0 * mults * batch
    return {"us_per_step": eps / steps * 1e6,
            "mflop_per_step": flops_step / 1e6,
            "achieved_tflops": flops_step * steps / eps / 1e12,
            "samples_per_sec": n / eps,
            "epoch_ms": eps * 1e3}


@contextlib.contextmanager
def card_samples():
    """(SM clock MHz, power draw W) pairs that ``nvidia-smi`` reads every
    50 ms while the block runs; none where ``nvidia-smi`` is missing."""
    out = []
    try:
        proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        proc = None
    try:
        yield out
    finally:
        if proc is not None:
            proc.terminate()
            for line in proc.communicate(timeout=10)[0].splitlines():
                try:
                    mhz, watts = (float(v) for v in line.split(","))
                except ValueError:
                    continue
                out.append((mhz, watts))


def compute_row(sess, data=None) -> dict:
    """The compute-bound config at W=1 on ``sess``: three two-point
    readings of ms an epoch (2 vs 8 epochs), their median, the f32 bound,
    and the SM clock and power draw sampled while they ran."""
    c = COMPUTE
    mults = weight_mults(c["d"], c["layers"])
    if data is None:
        from harp_tpu_torch.io import datagen

        x, y = datagen.classification_data(c["n"], c["d"], BENCH["classes"],
                                           seed=4)
        data = (sess.scatter(x), sess.scatter(y))
    with card_samples() as samples:
        eps = [two_point_epoch_s(sess, c["n"], c["d"], c["layers"],
                                 c["batch"], (2, 8), data=data)
               for _ in range(3)]
    row = _row(c["n"], mults, c["batch"], -(-c["n"] // c["batch"]),
               statistics.median(eps))
    row["epoch_ms_reads"] = [e * 1e3 for e in eps]
    row["bound_ms"] = 6.0 * mults * c["n"] / PEAK_F32_FLOPS * 1e3
    if samples:
        mhz = [m for m, _ in samples]
        row["sm_mhz_min_median_max"] = [min(mhz), statistics.median(mhz),
                                        max(mhz)]
        row["power_w_max"] = max(w for _, w in samples)
    return row


def measure_chip(device="cuda") -> dict:
    """The batch sweep at the bench model and the compute-bound config, W=1
    on ``device``."""
    from harp_tpu_torch.session import HarpSession

    sess = HarpSession(device=device)
    n, d, layers = BENCH["n"], BENCH["d"], BENCH["layers"]
    mults = weight_mults(d, layers)
    rows = {}
    for batch, epochs in ((512, (2, 8)), (4096, (4, 16)), (n, (8, 32))):
        eps = two_point_epoch_s(sess, n, d, layers, batch, epochs)
        rows[f"batch{batch}"] = _row(n, mults, batch, -(-n // batch), eps)
    rows["compute_bound_d512_2048x1024_b8192"] = compute_row(sess)
    return rows


def measure_allreduce_share(device="cuda", workers: int = 8) -> dict:
    """The allreduce's share of an epoch at the bench model on a stacked
    group of ``workers``: a full step against ``ablate_allreduce=True``,
    in turns; the signed share beside each config's spread."""
    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.session import HarpSession

    sess = HarpSession(num_workers=workers, device=device)
    n, d, layers = BENCH["n"], BENCH["d"], BENCH["layers"]
    x, y = datagen.classification_data(n, d, BENCH["classes"], seed=4)
    data = (sess.scatter(x), sess.scatter(y))
    ms = {False: [], True: []}
    for ablate in (False, True, True, False):
        ms[ablate].append(1e3 * two_point_epoch_s(
            sess, n, d, layers, 512, (2, 8), data=data,
            ablate_allreduce=ablate))
    full, nops = statistics.mean(ms[False]), statistics.mean(ms[True])
    spread = max(max(v) - min(v) for v in ms.values())
    return {"workers": workers, "epoch_ms_full": ms[False],
            "epoch_ms_no_allreduce": ms[True],
            "allreduce_ms": full - nops,
            "allreduce_share_pct": 100 * (full - nops) / full,
            "spread_ms": spread, "resolved": abs(full - nops) > spread}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m harp_tpu_torch.benchmark."
                                     "nn_budget")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(json.dumps({"chip": measure_chip(args.device),
                      "allreduce": measure_allreduce_share(args.device)}))


if __name__ == "__main__":
    main()
