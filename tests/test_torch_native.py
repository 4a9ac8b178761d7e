"""The port's native host kernels (``raydp_tpu_torch/native``) against the
JAX package's (``raydp_tpu/native``) and numpy.

* ``hash_bucket`` over every supported numeric dtype, with the validity
  columns the hash exchange adds for nulls: bit-exact against
  ``raydp_tpu.native.lib.hash_bucket``, through the library and through
  the port's numpy twin.
* ``gather_matrix`` (float32 and int32 out) and ``gather_rows``: equal
  to numpy fancy indexing and casting, through both routes.
* The build: ``g++`` into ``raydp_tpu_torch/_build/``, the library's name
  keyed by a hash of the sources (an edited source gets a new name), a
  single-threaded build where g++ refuses ``-fopenmp``, a failed build
  raised and logged, ``native=True`` raising where the library is
  disabled. These need ``g++`` here and skip without it.
"""
import logging
import os
import shutil

import numpy as np
import pytest

from raydp_tpu.native import lib as jax_native
from raydp_tpu_torch.native import build
from raydp_tpu_torch.native import lib as native

DTYPES = ["float32", "float64", "int64", "int32", "int16", "uint8"]


@pytest.fixture()
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ here: the native library is built from source")
    assert native.native_available()


def _column(rng, dtype, n):
    if dtype.startswith("float"):
        vals = rng.standard_normal(n) * 100
        vals[rng.random(n) < 0.05] = 0.0
        vals[rng.random(n) < 0.05] = -0.0  # hashed as +0.0
        return vals.astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)


@pytest.mark.parametrize("n_buckets", [2, 13, 200])
@pytest.mark.parametrize("dtype", DTYPES)
def test_hash_bucket_bit_exact(gxx, dtype, n_buckets):
    rng = np.random.default_rng(DTYPES.index(dtype))
    n = 20_000
    values = _column(rng, dtype, n)
    valid = (rng.random(n) > 0.1).astype(np.uint8)
    values[valid == 0] = 0  # the exchange hashes a typed zero for a null
    other = rng.integers(-5, 5, n)
    cols = [values, other, valid, np.ones(n, np.uint8)]
    want = jax_native._hash_bucket_numpy(cols, n_buckets)
    np.testing.assert_array_equal(jax_native.hash_bucket(cols, n_buckets),
                                  want)
    for route in (True, False):
        np.testing.assert_array_equal(
            native.hash_bucket(cols, n_buckets, native=route), want)


def test_hash_bucket_declines_other_dtypes():
    assert native.hash_bucket([np.array(["a", "b"], dtype=object)], 4) is None
    assert native.hash_bucket([np.zeros(3), np.zeros(4)], 4) is None
    assert native.hash_bucket([], 4) is None


@pytest.mark.parametrize("out_dtype", [np.float32, np.int32])
def test_gather_matrix_equals_numpy(gxx, out_dtype):
    rng = np.random.default_rng(5)
    n = 3000
    cols = [_column(rng, d, n) for d in DTYPES]
    if out_dtype is np.int32:  # float to int: values in range
        cols[0] = np.round(cols[0]).astype(np.float32)
        cols[1] = np.round(cols[1])
    idx = rng.permutation(n)[:1234]
    want = np.stack([c[idx].astype(out_dtype) for c in cols], axis=1)
    for route in (True, False):
        got = native.gather_matrix(cols, idx, out_dtype=out_dtype,
                                   native=route)
        np.testing.assert_array_equal(got, want)
    out = np.empty((len(idx), len(cols)), dtype=out_dtype)
    assert native.gather_matrix(cols, idx, out_dtype, out=out) is out
    np.testing.assert_array_equal(out, want)


def test_gather_matrix_checks_its_arguments(gxx):
    cols = [np.arange(10, dtype=np.int64)]
    with pytest.raises(IndexError, match="out of range"):
        native.gather_matrix(cols, np.array([0, 10]))
    with pytest.raises(ValueError, match="out_dtype"):
        native.gather_matrix(cols, np.array([0]), out_dtype=np.float64)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.gather_matrix(cols, np.array([0, 1]),
                             out=np.empty((2, 2), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "float64", "int16"])
def test_gather_rows_equals_numpy(gxx, dtype):
    rng = np.random.default_rng(9)
    src = _column(rng, dtype, 4000).reshape(500, 8)
    idx = rng.integers(0, 500, 777)
    for route in (True, False):
        np.testing.assert_array_equal(
            native.gather_rows(src, idx, native=route), src[idx])
    np.testing.assert_array_equal(native.gather_rows(src, idx),
                                  jax_native.gather_rows(src, idx))


def test_build_is_keyed_by_the_sources(gxx, tmp_path, monkeypatch):
    path = build.ensure_built()
    assert os.path.dirname(path) == build.BUILD_DIR
    assert os.path.basename(build.BUILD_DIR) == "_build"
    assert os.path.exists(path) and build.ensure_built() == path
    edited = tmp_path / "src"
    shutil.copytree(build.SRC_DIR, edited)
    with open(edited / "gather.cpp", "a") as f:
        f.write("\n// an edit\n")
    monkeypatch.setattr(build, "SRC_DIR", str(edited))
    assert build.lib_path() != path


def test_failed_build_is_raised_and_logged(gxx, tmp_path, monkeypatch,
                                           caplog):
    broken = tmp_path / "src"
    broken.mkdir()
    (broken / "bad.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(build, "SRC_DIR", str(broken))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    with caplog.at_level(logging.ERROR, logger=build.__name__):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            build.ensure_built()
    assert "g++ failed" in caplog.text


def test_asking_for_a_disabled_library_raises(monkeypatch):
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert not native.native_available()
    cols = [np.arange(4, dtype=np.int64)]
    with pytest.raises(RuntimeError, match="asked for"):
        native.hash_bucket(cols, 2, native=True)
    # unasked, the numpy twin runs and gives the same ids
    np.testing.assert_array_equal(native.hash_bucket(cols, 2),
                                  jax_native._hash_bucket_numpy(cols, 2))


def _gxx_without_openmp(tmp_path):
    """A g++ that fails on ``-fopenmp`` as one with no libgomp does."""
    wrapper = tmp_path / "g++"
    wrapper.write_text(
        "#!/bin/sh\n"
        'for a in "$@"; do if [ "$a" = -fopenmp ]; then\n'
        "  echo \"g++: fatal error: cannot read spec file 'libgomp.spec': "
        "No such file or directory\" >&2; exit 1; fi; done\n"
        f'exec {shutil.which("g++")} "$@"\n')
    wrapper.chmod(0o755)
    return str(wrapper)


def test_build_falls_back_without_openmp(gxx, tmp_path, monkeypatch, caplog):
    """A g++ without libgomp refuses ``-fopenmp``: the library is built
    with the next flag set, single-threaded, and the log says so."""
    no_omp = _gxx_without_openmp(tmp_path)
    monkeypatch.setattr(build, "_gxx", lambda: no_omp)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    with caplog.at_level(logging.WARNING, logger=build.__name__):
        path = build.ensure_built()
    assert path == build.lib_path(build.FLAG_SETS[1])
    assert build.built_flags() == build.FLAG_SETS[1]
    assert "single-threaded" in caplog.text and "libgomp" in caplog.text


def test_openmp_only_compile_error_is_raised(gxx, tmp_path, monkeypatch,
                                             caplog):
    """An error that shows only under ``-fopenmp`` and does not name
    libgomp is raised, not answered with a single-threaded build."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "omp_only.cpp").write_text(
        "#ifdef _OPENMP\n#error broken under OpenMP\n#endif\n"
        'extern "C" int rdp_ok() { return 1; }\n')
    monkeypatch.setattr(build, "SRC_DIR", str(src))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    with caplog.at_level(logging.ERROR, logger=build.__name__):
        with pytest.raises(RuntimeError, match="broken under OpenMP"):
            build.ensure_built()
    assert not os.path.exists(build.lib_path(build.FLAG_SETS[1]))
    assert "g++ failed" in caplog.text
