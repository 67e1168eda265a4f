"""The port's native loader (``io/native_build.py``, ``io/native_bridge.py``)
against the JAX package's, on the CPU.

Mirrors ``tests/test_native.py``: the port compiles the repository's shared
``native/loader.cpp`` into ``build/harp_tpu_torch_native/`` (never under
``native/``), and every parse and COO->CSR sort is bitwise the JAX
package's on the same files. The JAX package's native path is its own
library where that is built (``native/libharp_native.so``), else the same
source's build pointed at by ``HARP_NATIVE_LIB``.

The parse test of the port's CSV loads writes 200,000 decimal strings of 17
significant digits placed next to float32 midpoints: the port's
``load_dense_csv`` (and ``run._load_points``) must load the JAX package's
bits on all of them and, where the native parser hands the field to
``strtof`` (exponent notation), bitwise an oracle that rounds each decimal
once (``fractions.Fraction`` against the two neighbouring float32 values).
``numpy.loadtxt``, the port's parse before, rounds twice (through float64)
and misses the oracle on thousands of them. The native parser's own fast
path for plain decimals of at most 17 digits also rounds twice (the digits
summed and scaled in float64); the port keeps the JAX package's bits there.
"""

import decimal
import os
from fractions import Fraction

import numpy as np
import pytest

from harp_tpu.io import loaders as jloaders
from harp_tpu.io import native_bridge as jbridge
from harp_tpu_torch import run as trun
from harp_tpu_torch.io import loaders, native_bridge, native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native_lib():
    path = native_build.build()
    if path is None:
        pytest.skip("no C++ compiler available")
    native_bridge.reset()
    assert native_bridge.available()
    return path


@pytest.fixture()
def jax_native(native_lib, monkeypatch):
    """The JAX package's bridge with its native library loaded: its own
    build where present, else the port's build of the same source."""
    jbridge.reset()
    if not jbridge.available():
        monkeypatch.setenv("HARP_NATIVE_LIB", native_lib)
        jbridge.reset()
    assert jbridge.available()
    yield
    monkeypatch.delenv("HARP_NATIVE_LIB", raising=False)
    jbridge.reset()


def _write(tmp, name, text):
    p = os.path.join(str(tmp), name)
    with open(p, "w") as f:
        f.write(text)
    return p


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def test_build_lands_in_build_keyed_by_source(native_lib):
    path = os.path.realpath(native_lib)
    assert path.startswith(os.path.realpath(
        os.path.join(REPO, "build", "harp_tpu_torch_native")) + os.sep)
    assert os.path.basename(path) == native_build.lib_path().name
    assert native_build.SOURCE == native_build.REPO / "native" / "loader.cpp"
    # an unchanged source is reused, not rebuilt
    mtime = os.path.getmtime(path)
    assert native_build.build() == native_lib
    assert os.path.getmtime(path) == mtime
    assert native_build.FLAGS == ["-O3", "-std=c++17", "-fPIC", "-pthread",
                                  "-shared"]


def test_parse_csv_matches_numpy_and_jax(native_lib, jax_native, tmp_path):
    rng = np.random.default_rng(5)
    mat = (rng.standard_normal((37, 11)) * 100).astype(np.float32)
    lines = "\n".join(",".join(f"{v:.6g}" for v in row) for row in mat)
    p = _write(tmp_path, "m.csv", lines + "\n")
    got = native_bridge.parse_csv(p, ",")
    assert got is not None and got.shape == (37, 11)
    ref = np.loadtxt(p, delimiter=",", dtype=np.float32, ndmin=2)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_array_equal(_bits(got), _bits(jbridge.parse_csv(p)))
    assert native_bridge.count_csv(p) == jbridge.count_csv(p) == (37, 11)


def test_parse_csv_no_trailing_newline_and_exponents(native_lib, tmp_path):
    p = _write(tmp_path, "e.csv", "1.5e2,-3,0.25\n-1e-3,4,5")
    got = native_bridge.parse_csv(p, ",")
    np.testing.assert_allclose(
        got, np.array([[150.0, -3.0, 0.25], [-0.001, 4.0, 5.0]], np.float32))


def test_parse_coo_matches_numpy_and_jax(native_lib, jax_native, tmp_path):
    rng = np.random.default_rng(6)
    n = 500
    rows = rng.integers(0, 1000, n)
    cols = rng.integers(0, 800, n)
    vals = rng.standard_normal(n).astype(np.float32)
    text = "\n".join(f"{r} {c} {v:.6g}" for r, c, v in zip(rows, cols, vals))
    p = _write(tmp_path, "c.coo", text + "\n")
    triple = native_bridge.parse_coo(p)
    assert triple is not None
    np.testing.assert_array_equal(triple[0], rows)
    np.testing.assert_array_equal(triple[1], cols)
    np.testing.assert_allclose(triple[2], vals, rtol=1e-5)
    jt = jbridge.parse_coo(p)
    for a, b in zip(triple, jt):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    assert native_bridge.count_lines(p) == jbridge.count_lines(p) == n
    assert native_bridge.parse_coo(p, sep=",") is None


def test_loaders_use_native_path_and_count_it(native_lib, tmp_path):
    mats, paths = [], []
    for i in range(3):
        m = np.full((4, 3), float(i), np.float32)
        mats.append(m)
        paths.append(_write(tmp_path, f"f{i}.csv", "\n".join(
            ",".join(map(str, r)) for r in m) + "\n"))
    before = dict(native_bridge.parses)
    out = loaders.load_dense_csv(paths, num_threads=2)
    np.testing.assert_allclose(out, np.concatenate(mats, axis=0))
    assert native_bridge.parses["csv"] - before["csv"] == 3
    coo = _write(tmp_path, "a.coo", "0 1 2.5\n3 4 1.5\n")
    loaders.load_coo([coo, coo])
    assert native_bridge.parses["coo"] - before["coo"] == 2


def test_csr_roundtrip():
    rows = np.array([2, 0, 1, 0, 2], np.int64)
    cols = np.array([1, 0, 2, 1, 0], np.int64)
    vals = np.array([5, 1, 3, 2, 4], np.float32)
    indptr, idx, v = loaders.coo_to_csr(rows, cols, vals)
    assert indptr.tolist() == [0, 2, 3, 5]
    np.testing.assert_array_equal(np.sort(idx[0:2]), [0, 1])
    for a, b in zip((indptr, idx, v), jloaders.coo_to_csr(rows, cols, vals)):
        np.testing.assert_array_equal(a, b)


def test_native_coo_to_csr_matches_numpy_and_is_stable(native_lib,
                                                       jax_native):
    rng = np.random.default_rng(4)
    n, r = 50000, 700
    rows = rng.integers(0, r, n)
    cols = rng.integers(0, 900, n)
    vals = rng.random(n).astype(np.float32)
    before = native_bridge.parses["coo_to_csr"]
    out = native_bridge.coo_to_csr(rows, cols, vals, r)
    assert out is not None
    assert native_bridge.parses["coo_to_csr"] == before + 1
    indptr, idx, v = out
    order = np.argsort(rows, kind="stable")       # the stability oracle
    ref_ptr = np.zeros(r + 1, np.int64)
    np.add.at(ref_ptr, rows + 1, 1)
    np.cumsum(ref_ptr, out=ref_ptr)
    np.testing.assert_array_equal(indptr, ref_ptr)
    np.testing.assert_array_equal(idx, cols[order])
    np.testing.assert_array_equal(v, vals[order])
    for a, b in zip(out, jbridge.coo_to_csr(rows, cols, vals, r)):
        np.testing.assert_array_equal(a, b)


def test_native_coo_to_csr_rejects_out_of_range(native_lib):
    rows = np.array([0, 7], np.int64)
    cols = np.array([0, 0], np.int64)
    vals = np.ones(2, np.float32)
    assert native_bridge.coo_to_csr(rows, cols, vals, 7) is None   # row == R
    assert native_bridge.coo_to_csr(-rows, cols, vals, 7) is None  # negative


def test_load_coo_multi_file_pool(native_lib, tmp_path):
    """MTReader parity: files read by the thread pool, concatenated in path
    order whatever the completion order."""
    paths = []
    for i in range(5):
        lines = "\n".join(f"{i} {j} {i}.5" for j in range(4)) + "\n"
        paths.append(_write(tmp_path, f"c{i}.coo", lines))
    rows, cols, vals = loaders.load_coo(paths, num_threads=3)
    assert rows.tolist() == sum(([i] * 4 for i in range(5)), [])
    assert cols.tolist() == list(range(4)) * 5
    np.testing.assert_allclose(vals, np.repeat(np.arange(5) + 0.5, 4))


def test_override_env_and_missing_compiler_fall_back(native_lib, tmp_path,
                                                     monkeypatch):
    """HARP_NATIVE_LIB wins; with no library and no compiler the loaders
    parse with numpy (the JAX package's contract) and count no native
    parse."""
    p = _write(tmp_path, "x.csv", "1.25,2\n3,4.5\n")
    try:
        monkeypatch.setenv("HARP_NATIVE_LIB", native_lib)
        native_bridge.reset()
        assert native_bridge.available()
        monkeypatch.setenv("HARP_NATIVE_LIB", str(tmp_path / "none.so"))
        native_bridge.reset()
        assert not native_bridge.available()
        monkeypatch.delenv("HARP_NATIVE_LIB")
        monkeypatch.setattr(native_build, "_compiler", lambda: None)
        monkeypatch.setattr(native_build, "lib_path",
                            lambda: tmp_path / "libmissing.so")
        native_bridge.reset()
        assert not native_bridge.available()
        before = dict(native_bridge.parses)
        np.testing.assert_array_equal(
            loaders.load_dense_csv([p]),
            np.array([[1.25, 2], [3, 4.5]], np.float32))
        assert loaders.load_coo([_write(tmp_path, "c.coo", "1 2 0.5\n")]
                                )[0].tolist() == [1]
        assert native_bridge.parses == before
    finally:
        monkeypatch.undo()
        native_bridge.reset()
    assert native_bridge.available()


def _round_once(s: str) -> np.float32:
    """The float32 nearest the decimal ``s`` (ties to even): one rounding."""
    q = Fraction(s)
    a = np.float32(float(q))
    if Fraction(float(a)) > q:
        a, b = np.nextafter(a, np.float32(-np.inf)), a
    else:
        b = np.nextafter(a, np.float32(np.inf))
    da, db = q - Fraction(float(a)), Fraction(float(b)) - q
    if da != db:
        return a if da < db else b
    return a if int(a.view(np.int32)) % 2 == 0 else b


def test_port_csv_loads_round_once_and_match_jax(native_lib, jax_native,
                                                 tmp_path):
    """200,000 decimals of 17 significant digits, each the nearest such
    decimal to a float32 midpoint: half in exponent notation (the native
    parser's strtof path: one rounding), half plain with 17 digits (the
    native fast path). The port's loads are the JAX package's bits on all,
    and the oracle's on the exponent half, where numpy.loadtxt (the port's
    parse before, still the fallback without a compiler) misses it."""
    rng = np.random.default_rng(2026)
    n = 100_000
    f = (rng.uniform(1, 10, n) * 10.0 ** rng.integers(-4, 6, n)).astype(
        np.float32)
    mid = (f.astype(np.float64)
           + np.nextafter(f, np.float32(np.inf)).astype(np.float64)) / 2
    sci = ["%.16e" % m for m in mid]
    ctx = decimal.Context(prec=17)
    g = (rng.uniform(1, 10, n) * 10.0 ** rng.integers(0, 6, n)).astype(
        np.float32)
    gmid = (g.astype(np.float64)
            + np.nextafter(g, np.float32(np.inf)).astype(np.float64)) / 2
    plain = [format(ctx.plus(decimal.Decimal(float(m))), "f") for m in gmid]
    strs = np.array(sci + plain).reshape(-1, 8)     # 8 columns a row
    half = len(strs) // 2
    paths = []
    for i, block in enumerate((strs[:half], strs[half:])):
        paths.append(_write(tmp_path, f"part-{i}", "\n".join(
            ",".join(row) for row in block) + "\n"))
    oracle = np.array([_round_once(s) for s in sci], np.float32)

    got = loaders.load_dense_csv(paths)
    assert got.shape == (2 * n // 8, 8)
    jgot = jloaders.load_dense_csv(paths)
    np.testing.assert_array_equal(_bits(got), _bits(jgot))
    np.testing.assert_array_equal(_bits(got[:half].reshape(-1)),
                                  _bits(oracle))
    np.testing.assert_array_equal(_bits(jgot[:half].reshape(-1)),
                                  _bits(oracle))
    np.testing.assert_array_equal(_bits(trun._load_points(str(tmp_path))),
                                  _bits(got))
    # the file has teeth: rounding through float64 misses the oracle
    twice = np.loadtxt(paths[0], delimiter=",", dtype=np.float32).reshape(-1)
    assert int((_bits(twice) != _bits(oracle)).sum()) > 1000
