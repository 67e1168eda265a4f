"""Where an LDA epoch's time goes on the card.

One CGS epoch of bench.py's clueweb-regime row (``lda_corpus(8192, 8000,
32, 256, seed=3)``, K = 64, W = 1; ``--sub-block 128`` for its sub-block
row) on a stacked worker group:

* a ``torch.profiler`` profile of one epoch (after a warm epoch): the
  epoch's wall, the device's busy time (the sum of its kernels' times) and
  share, the kernel launches, and the kernels that take the most device
  time;
* the count write's one-hot budget: the epoch timed (CUDA events, median of
  three) with ``lane_pack.scatter_chunk``'s budget at the JAX package's
  64 MiB (the port's default) and at larger budgets, fewer and larger
  one-hot GEMM chunks; the counts are exact integers either way, and the
  word-topic table must come out bitwise the same;
* the write path: the flat row's epoch again with ``wt_access="gather"``
  (a row gather and an ``index_add_``: float32 sums of +-1 are exact in any
  order, so its table too must be bitwise the same), against the
  ``"auto"`` choice (the one-hot GEMM).

Run::

    python -m harp_tpu_torch.benchmark.lda_budget [--sub-block 128]

Prints one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import statistics
import subprocess

ROW = dict(docs=8192, vocab=8000, doc_len=256, topics=64)
BUDGETS = (64 << 20, 256 << 20, 1 << 30)


def _epoch_ms(fn, reps: int = 3) -> float:
    import torch

    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def measure(docs: int, vocab: int, doc_len: int, topics: int,
            sub_block: int = 0) -> dict:
    import torch

    from harp_tpu_torch.io import datagen
    from harp_tpu_torch.models import lda
    from harp_tpu_torch.ops import lane_pack
    from harp_tpu_torch.session import HarpSession

    sess = HarpSession(num_workers=1)
    corpus = datagen.lda_corpus(docs, vocab, max(2, topics // 2), doc_len,
                                seed=3)
    cfg = lda.LDAConfig(num_topics=topics, vocab=vocab, epochs=1,
                        vocab_sub_block=sub_block)
    real_chunk = lane_pack.scatter_chunk
    out = {"row": dict(docs=docs, vocab=vocab, doc_len=doc_len,
                       topics=topics, sub_block=sub_block),
           "budgets": {}}
    ref = None
    for budget in BUDGETS:
        lane_pack.scatter_chunk = functools.partial(real_chunk,
                                                    budget_bytes=budget)
        try:
            model = lda.LDA(sess, cfg)
            state = model.prepare(corpus, seed=1)
        finally:
            lane_pack.scatter_chunk = real_chunk
        key = state[0]

        def epoch():
            return model._fns[key](*state[1], state[2])

        wt = epoch()[1]                          # warm
        if ref is None:
            ref = wt
            out["padding"] = model.last_layout_stats["overhead"]
            out["wt_path"] = model.last_layout_stats["wt_path"]
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                epoch()
                end.record()
                end.synchronize()
            wall = start.elapsed_time(end)
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in kernels) / 1e3
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
            out["profile"] = {
                "epoch_ms": wall, "device_busy_ms": busy,
                "device_busy_pct": 100 * busy / wall,
                "kernel_launches": sum(e.count for e in kernels),
                "top_ms": {e.key[:80]: e.self_device_time_total / 1e3
                           for e in top}}
        chunks = [0]
        real_bmm = lane_pack._bmm_f32

        def counted(a, b):
            chunks[0] += 1
            return real_bmm(a, b)

        lane_pack._bmm_f32 = counted
        try:
            epoch()
        finally:
            lane_pack._bmm_f32 = real_bmm
        out["budgets"][budget] = {"epoch_ms": _epoch_ms(epoch),
                                  "one_hot_chunks_an_epoch": chunks[0],
                                  "bitwise": bool(torch.equal(wt, ref))}
    if not sub_block:
        model = lda.LDA(sess, dataclasses.replace(cfg, wt_access="gather"))
        state = model.prepare(corpus, seed=1)
        key = state[0]
        wt = model._fns[key](*state[1], state[2])[1]
        out["gather"] = {"epoch_ms": _epoch_ms(
            lambda: model._fns[key](*state[1], state[2])),
            "bitwise": bool(torch.equal(wt, ref))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    out["card"] = smi.stdout.strip().splitlines()[0]
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m harp_tpu_torch.benchmark."
                                     "lda_budget")
    p.add_argument("--sub-block", type=int, default=0)
    args = p.parse_args(argv)
    print(json.dumps(measure(**ROW, sub_block=args.sub_block)), flush=True)


if __name__ == "__main__":
    main()
