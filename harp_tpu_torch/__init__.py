"""harp_tpu_torch: the PyTorch/CUDA port of harp_tpu, for one NVIDIA H100.

The JAX package ``harp_tpu`` is the reference; each module here mirrors the
module of the same path there (``harp_tpu/X.py`` -> ``harp_tpu_torch/X.py``)
and is tested against it on the CPU. This package imports ``torch`` and
numpy, never ``jax`` and nothing of ``harp_tpu``.

Worker model: a *stacked worker group*. A sharded array is one tensor with a
leading worker axis ``(W, rows/W, ...)`` on one device, a replicated array is
held once, and every collective is an exact tensor op over the worker axis
(:mod:`harp_tpu_torch.collectives.lax_ops`). A process group
(``HarpSession(distributed=True)``, ``parallel/distributed.py``) splits the
workers over several processes, each holding its workers stacked. Entry
points run on CUDA unless the caller passes ``device="cpu"``.

Ported so far: K-means regroupallgather, SGD-MF rotation, ALS and LDA
(``python -m harp_tpu_torch.run kmeans|sgd_mf|als|lda``, checkpointed with
``--save-every``), blocked, ring and Ulysses attention
(``parallel/ring_attention.py``) and the process group with the fused
ring-DMA engine (``ops/ring_dma.py``), through the hand-written kernels in
``csrc/`` (E-step, SGD-MF hop, SPD solve, flash attention, ring hop and
ring allgather), and the statistics path, NN, the solvers, the
quantized wire and host IO with streamed K-means (``sched/``,
``io/loaders.py``, the native loader, ``io/pipeline.py``);
``ROADMAP.md`` lists the rest.
"""

from harp_tpu_torch import combiner, partitioner
from harp_tpu_torch.combiner import AVG, MAX, MIN, MINUS, MULTIPLY, SUM, Combiner, Op
from harp_tpu_torch.parallel.mesh import WORKERS, WorkerGroup
from harp_tpu_torch.session import HarpSession
from harp_tpu_torch.table import Dist, Table

__all__ = [
    "AVG", "MAX", "MIN", "MINUS", "MULTIPLY", "SUM",
    "Combiner", "Op", "Dist", "Table", "HarpSession",
    "WORKERS", "WorkerGroup", "combiner", "partitioner",
]
