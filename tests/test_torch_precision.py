"""The port's matmul precision switch, on the CPU.

Every float32 product of the port that needs full float32 switches TF32 off
through one helper, ``ops/precision.full_f32_matmul``, which gives the
caller's ``torch.backends.cuda.matmul.allow_tf32`` back on exit. Each path
below runs with the flag set True by the caller and must leave it True (and
with it False, False): the plain E-step's products (``distance._cross``),
the statistics GEMM (``linalg._matmul``), the CSR products
(``sparse._mm``), ALS's Newton solve, an NN fit and a solver run. The
flag is a host setting, so the CPU build reads and writes it as the card's
does.
"""

import numpy as np
import pytest
import torch

from harp_tpu_torch.io import datagen
from harp_tpu_torch.models import als, nn, solvers, sparse
from harp_tpu_torch.ops import distance, linalg, precision
from harp_tpu_torch.session import HarpSession


def _estep():
    x = torch.from_numpy(datagen.dense_points(64, 5, seed=1))
    distance.pairwise_scores(x, x[:4])


def _gram():
    x = torch.from_numpy(datagen.dense_points(32, 4, seed=2))
    linalg._matmul(x.T, x)


def _csr():
    a = torch.ones(3, 4)
    sparse._mm(a, a.T)


def _newton():
    a = torch.eye(3)[None] * 2.0
    cfg = als.ALSConfig(rank=3, solver="newton")
    als._spd_solve(a, torch.ones(1, 3), cfg)


def _nn_fit():
    x, y = datagen.classification_data(64, 6, 3, seed=3)
    nn.MLPClassifier(HarpSession(num_workers=2, device="cpu"), nn.NNConfig(
        layers=(5,), num_classes=3, batch_size=8, epochs=1)).fit(x, y)


def _solver_run():
    x, y, _ = datagen.regression_data(64, 4, seed=4)
    solvers.Solver(HarpSession(num_workers=2, device="cpu"), "lbfgs",
                   solvers.SolverConfig(iterations=3)).minimize(
        solvers.mse_objective, x, y.reshape(-1), np.zeros(4, np.float32))


PATHS = {"distance._cross": _estep, "linalg._matmul": _gram,
         "sparse._mm": _csr, "als Newton solve": _newton, "nn fit": _nn_fit,
         "solver run": _solver_run}


@pytest.fixture()
def tf32_flag():
    before = torch.backends.cuda.matmul.allow_tf32
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("setting", [True, False])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_tf32_setting_is_restored_after_each_path(tf32_flag, path, setting):
    torch.backends.cuda.matmul.allow_tf32 = setting
    PATHS[path]()
    assert torch.backends.cuda.matmul.allow_tf32 is setting, path


def test_helper_switches_tf32_off_inside_and_restores_on_error(tf32_flag):
    torch.backends.cuda.matmul.allow_tf32 = True
    with precision.full_f32_matmul():
        assert torch.backends.cuda.matmul.allow_tf32 is False
        with precision.full_f32_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is True
    with pytest.raises(RuntimeError, match="inside"):
        with precision.full_f32_matmul():
            raise RuntimeError("inside")
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_one_helper_serves_every_site():
    """The four sites of the fault and the new products take the shared
    helper; none writes the flag itself."""
    import inspect

    from harp_tpu_torch.models import als as als_mod

    for mod in (distance, linalg, sparse, als_mod, nn, solvers):
        src = inspect.getsource(mod)
        assert "full_f32_matmul" in src, mod.__name__
        assert "allow_tf32 =" not in src, mod.__name__
