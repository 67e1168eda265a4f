"""The port's mini-batch NN and gradient solvers against the JAX package's,
on the CPU.

The same numpy data (``io/datagen``'s classification and regression sets,
bitwise the JAX generators') and the same starting parameters
(``init_params`` draws with numpy, bitwise) go through
``harp_tpu.models.nn``/``solvers`` on the virtual mesh and
``harp_tpu_torch.models.nn``/``solvers`` on a stacked CPU group, at W=1
and W=4. Both run float32; they differ only in the order of a GEMM's or a
reduction's sums, so losses and parameters agree to a few float32 ulps
after tens of steps: the tests hold them within 1e-5 of the largest entry
(losses: relative), and ``predict`` equal. ``run nn`` and ``run solver``
go against ``harp_tpu.run`` in subprocesses.
"""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.io import datagen as jdatagen
from harp_tpu.models import nn as jnn
from harp_tpu.models import solvers as jsol
from harp_tpu.session import HarpSession as JaxSession
from harp_tpu_torch import convert
from harp_tpu_torch import run as trun
from harp_tpu_torch.io import datagen as tdatagen
from harp_tpu_torch.models import nn as tnn
from harp_tpu_torch.models import solvers as tsol
from harp_tpu_torch.session import HarpSession as TorchSession

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
_SESSIONS = {}


def sessions(w):
    if w not in _SESSIONS:
        _SESSIONS[w] = (JaxSession(num_workers=w),
                        TorchSession(num_workers=w, device="cpu"))
    return _SESSIONS[w]


def close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(float(np.abs(a).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= tol * scale, (
        float(np.abs(a - b).max()), scale)


def leaves(params):
    return [np.asarray(t) for wb in params for t in wb]


# --------------------------------------------------------------------------- #
# Data and parameters
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", [0, 7])
def test_datagen_matches_jax(seed):
    for t, j in zip(tdatagen.classification_data(300, 9, 5, seed=seed),
                    jdatagen.classification_data(300, 9, 5, seed=seed)):
        assert t.dtype == j.dtype and np.array_equal(t, j)
    for t, j in zip(tdatagen.regression_data(300, 9, 2, seed=seed),
                    jdatagen.regression_data(300, 9, 2, seed=seed)):
        assert t.dtype == j.dtype and np.array_equal(t, j)


def test_init_params_bitwise_and_converter():
    dims = (12, 16, 8, 4)
    t, j = tnn.init_params(dims, seed=3), jnn.init_params(dims, seed=3)
    for a, b in zip(leaves(t), leaves(j)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    conv = convert.nn_params_from_jax(j)
    for a, b in zip(leaves(conv), leaves(t)):
        assert np.array_equal(a, b)
    back = convert.nn_params_to_jax(conv)
    for a, b in zip(leaves(back), leaves(j)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="do not chain"):
        convert.nn_params_from_jax([j[0], j[2]])
    theta = np.arange(5, dtype=np.float32) / 3
    assert np.array_equal(convert.solver_theta_to_jax(
        convert.solver_theta_from_jax(jnp.asarray(theta))), theta)
    with pytest.raises(ValueError, match="flat vector"):
        convert.solver_theta_from_jax(np.zeros((2, 2)))


# --------------------------------------------------------------------------- #
# The NN
# --------------------------------------------------------------------------- #

NN_DATA = tdatagen.classification_data(256, 12, 4, seed=3)
NN_CFG = dict(layers=(16, 8), num_classes=4, lr=0.05, batch_size=20,
              epochs=3)


@pytest.mark.parametrize("ablate", [False, True])
@pytest.mark.parametrize("w", [1, 4])
def test_nn_fit_matches_jax(w, ablate):
    """Per-epoch losses, parameters and ``predict``; n_local = 64 with
    batch 20 wraps its last batch. Under ``ablate_allreduce`` the rows
    diverge and both hand back worker 0's."""
    x, y = NN_DATA
    js, ts = sessions(w)
    jm = jnn.MLPClassifier(js, jnn.NNConfig(**NN_CFG,
                                            ablate_allreduce=ablate))
    tm = tnn.MLPClassifier(ts, tnn.NNConfig(**NN_CFG,
                                            ablate_allreduce=ablate))
    jl, tl = jm.fit(x, y, seed=1), tm.fit(x, y, seed=1)
    assert tl.shape == (NN_CFG["epochs"],) and tl.dtype == np.float32
    close(jl, tl)
    assert tl[-1] < tl[0]
    for a, b in zip(leaves(jm.params), leaves(tm.params)):
        close(a, b)
    assert np.array_equal(jm.predict(x), tm.predict(x))


def test_nn_ablation_differs_from_the_fit_at_w4():
    x, y = NN_DATA
    ts = sessions(4)[1]
    full = tnn.MLPClassifier(ts, tnn.NNConfig(**NN_CFG)).fit(x, y)
    abl = tnn.MLPClassifier(ts, tnn.NNConfig(
        **NN_CFG, ablate_allreduce=True)).fit(x, y)
    assert not np.array_equal(full, abl)


def test_nn_fit_takes_placed_tensors_and_float64():
    """``fit`` takes tensors placed by ``session.scatter`` (the bench's
    form) with the same result, and a placed float64 ``x`` runs the fit in
    float64 (the card's yardstick), within float32's distance of it."""
    x, y = NN_DATA
    ts = sessions(4)[1]
    m = tnn.MLPClassifier(ts, tnn.NNConfig(**NN_CFG))
    host = m.fit(x, y, seed=2)
    placed = m.fit(ts.scatter(x), ts.scatter(y), seed=2)
    assert np.array_equal(host, placed)
    wide = m.fit(ts.scatter(x.astype(np.float64)), ts.scatter(y), seed=2)
    assert m.params[0][0].dtype == torch.float64
    close(wide, host, 1e-5)


def test_nn_process_rows_are_independent():
    """A row's gradient is its own: the fit of 4 workers in one stacked
    group equals 4 one-row groups' gradients combined in worker order,
    which is what a process group computes (checked bitwise across
    processes in ``parallel/mp_smoke.py``)."""
    x, y = NN_DATA
    dims = (12, 16, 8, 4)
    p0 = tnn.init_params(dims, 1)
    flat = tnn._flatten(p0)
    xs, ys = torch.from_numpy(x).reshape(4, 64, 12), torch.from_numpy(
        y).reshape(4, 64).long()
    grads = []
    for r in range(4):
        leaf = flat.clone().requires_grad_(True)
        loss = tnn._loss(tnn._unflatten(leaf, tnn._shapes(p0)), xs[r, :20],
                         ys[r, :20], 4)
        grads.append(torch.autograd.grad(loss, leaf)[0])
    cfg = tnn.NNConfig(**dict(NN_CFG, epochs=1, lr=1.0, momentum=0.0))
    sess = sessions(4)[1]
    # one step of lr 1, momentum 0 from p0: p1 = p0 - mean of the grads
    x1 = torch.from_numpy(x).reshape(4, 64, 12)[:, :20].reshape(80, 12)
    y1 = torch.from_numpy(y).reshape(4, 64)[:, :20].reshape(80)
    params, _ = sess.run(lambda a, t, p: tnn._train(
        a, t, p, dataclasses.replace(cfg, batch_size=20)), x1, y1, p0,
        in_specs=(sess.shard(), sess.shard(), sess.replicate()),
        out_specs=(sess.replicate(), sess.replicate()))
    want = flat - (((grads[0] + grads[1]) + grads[2]) + grads[3]) / 4
    assert torch.equal(tnn._flatten(params), want)


# --------------------------------------------------------------------------- #
# The solvers
# --------------------------------------------------------------------------- #

REG = tdatagen.regression_data(400, 8, seed=2)
KINDS = ["sgd", "sgd_minibatch", "sgd_momentum", "adagrad", "lbfgs"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("w", [1, 4])
def test_solver_matches_jax(w, kind):
    """``mse_objective`` at W=1 and W=4; ``sgd_minibatch`` with batch 30 of
    100 rows a worker at W=4 (a ragged last batch, wrapped)."""
    x, y, _ = REG
    y = y.reshape(-1)
    cfg = dict(iterations=30, batch_size=30)
    js, ts = sessions(w)
    jt, jl = jsol.Solver(js, kind, jsol.SolverConfig(**cfg)).minimize(
        jsol.mse_objective, x, y, np.zeros(8, np.float32))
    tt, tl = tsol.Solver(ts, kind, tsol.SolverConfig(**cfg)).minimize(
        tsol.mse_objective, x, y, np.zeros(8, np.float32))
    assert tt.dtype == np.float32 and tl.shape == (30,)
    close(jl, tl)
    close(jt, tt)
    assert tl[-1] < tl[0]


def _band_jax(theta, x, y):
    r = jnp.abs(x @ theta - y)
    return jnp.mean(jnp.maximum(r - 1.0, 0.0) ** 2)


def _band_torch(theta, x, y):
    r = torch.abs(x @ theta - y)
    return torch.mean(torch.clamp(r - 1.0, min=0.0) ** 2)


@pytest.mark.parametrize("w", [1, 4])
def test_lbfgs_steps_that_fail_the_sy_test_match_jax(w):
    """A squared dead-band loss (residuals within 1 cost nothing): once
    every residual is inside the band the gradient stops changing, s.y =
    0 and the step fails the s.y > 1e-10 test, leaving the history as it
    was (the ``valid`` mask); before that the steps enter a ring of 3
    slots whose head wraps."""
    x, y, _ = REG
    y = y.reshape(-1)
    cfg = dict(iterations=25, history=3, lr=0.5)
    js, ts = sessions(w)
    theta0 = np.zeros(8, np.float32)
    seen = []

    def recorded(theta, a, b):
        seen.append(theta.detach().clone())
        return _band_torch(theta, a, b)

    jt, jl = jsol.Solver(js, "lbfgs", jsol.SolverConfig(**cfg)).minimize(
        _band_jax, x, y, theta0)
    tt, tl = tsol.Solver(ts, "lbfgs", tsol.SolverConfig(**cfg)).minimize(
        recorded, x, y, theta0)
    close(jl, tl)
    close(jt, tt)
    # the steps' (s, y) pairs from the thetas the objective saw (one call a
    # worker a step): some pass the test, some fail it
    thetas = seen[::w]
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    grads = []
    for th in thetas:
        leaf = th.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(_band_torch(leaf, xt, yt), leaf)[0])
    sy = [float(torch.dot(thetas[i] - thetas[i - 1], grads[i] - grads[i - 1]))
          for i in range(1, len(thetas))]
    assert sum(v > 1e-10 for v in sy) > 3 and sum(v <= 1e-10 for v in sy) > 0


def test_solver_rejects_an_unknown_kind_and_takes_float64():
    ts = sessions(1)[1]
    with pytest.raises(ValueError, match="kind must be one of"):
        tsol.Solver(ts, "newton")
    x, y, _ = REG
    y = y.reshape(-1)
    s = tsol.Solver(ts, "sgd", tsol.SolverConfig(iterations=10))
    t32, l32 = s.minimize(tsol.mse_objective, x, y, np.zeros(8))
    t64, l64 = s.minimize(tsol.mse_objective, ts.scatter(x.astype(
        np.float64)), ts.scatter(y.astype(np.float64)), np.zeros(8))
    assert t32.dtype == np.float32 and t64.dtype == np.float64
    close(t64, t32)


# --------------------------------------------------------------------------- #
# The CLI and the budget harness
# --------------------------------------------------------------------------- #

def _jax_cli(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "harp_tpu.run", *args,
                          "--cpu-mesh"], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def _numbers(line):
    return [float(v) for v in re.findall(r"-?\d+\.\d+", line)]


def test_run_nn_matches_jax(capsys):
    args = ["nn", "--num-points", "1024", "--dim", "16", "--epochs", "2",
            "--num-workers", "4", "--batch-size", "64"]
    jline = _jax_cli(args)
    assert trun.main([*args, "--device", "cpu"]) == 0
    tline = capsys.readouterr().out.strip().splitlines()[-1]
    head = "nn workers=4 n=1024 d=16 layers=(64, 32): "
    assert jline.startswith(head) and tline.startswith(head)
    # loss first -> last and the train accuracy (the rate differs)
    np.testing.assert_allclose(_numbers(tline)[-3:], _numbers(jline)[-3:],
                               atol=2e-4)
    # the port reads --layers (the JAX CLI drops it)
    assert trun.main(["nn", "--device", "cpu", "--num-points", "256",
                      "--dim", "8", "--epochs", "1", "--layers",
                      "12,6"]) == 0
    assert "layers=(12, 6)" in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["lbfgs", "sgd_momentum"])
def test_run_solver_matches_jax(capsys, kind):
    args = ["solver", "--kind", kind, "--num-workers", "4",
            "--iterations", "40"]
    jline = _jax_cli(args)
    assert trun.main([*args, "--device", "cpu"]) == 0
    tline = capsys.readouterr().out.strip().splitlines()[-1]
    head = f"solver[{kind}] workers=4 n=4096 d=32: "
    assert jline.startswith(head) and tline.startswith(head)
    np.testing.assert_allclose(_numbers(tline)[-2:], _numbers(jline)[-2:],
                               rtol=1e-4, atol=2e-6)


def test_nn_budget_runs_on_a_small_group():
    from harp_tpu_torch.benchmark import nn_budget

    ts = TorchSession(num_workers=2, device="cpu")
    eps = nn_budget.two_point_epoch_s(ts, 512, 16, (8,), 64, (1, 2), reps=1)
    assert eps > 0
    assert nn_budget.weight_mults(128, (256, 128)) == (
        128 * 256 + 256 * 128 + 128 * 16)
