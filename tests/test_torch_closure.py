"""The closure carrier (``raydp_tpu_torch/cluster/closure.py``): each case
round-trips a function through ``dumps``/``loads`` and checks what the
loaded one returns.

The functions here live in this test module, which a worker must never
import (it imports nothing of JAX, but the rule is the same for every
test module), so each travels by value. Two cases load a blob in a
fresh interpreter that has never seen this module; the last ships
classes by value (``dumps(..., classes=True)``, the torch compat
estimator's mode), which the default refuses.
"""
import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import raydp_tpu_torch.dataframe as rdf
from raydp_tpu_torch.cluster import closure

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFFSET = 10


def _roundtrip(obj):
    return closure.loads(closure.dumps(obj))


def _scaled(x, factor=3, *, shift=1):
    """A ``__main__``-style module function: defaults and a global."""
    return x * factor + shift + OFFSET


def _fib(n):
    return n if n < 2 else _fib(n - 1) + _fib(n - 2)


def test_lambda():
    assert _roundtrip(lambda a, b: a * b + 1)(3, 4) == 13


def test_nested_closure():
    def outer(k):
        def inner(x):
            return x + k
        return inner

    assert _roundtrip(outer(5))(2) == 7


def test_self_recursive_local_function():
    def make():
        def fact(n):
            return 1 if n <= 1 else n * fact(n - 1)
        return fact

    fact = _roundtrip(make())
    assert fact(6) == 720
    assert fact.__closure__[0].cell_contents is fact


def test_self_recursive_module_function():
    fib = _roundtrip(_fib)
    assert fib is not _fib and fib(10) == 55
    assert fib.__globals__["_fib"] is fib


def test_closures_that_share_a_cell():
    def counter():
        n = 0

        def bump():
            nonlocal n
            n += 1
            return n

        def read():
            return n

        return bump, read

    bump, read = _roundtrip(counter())
    bump()
    bump()
    assert read() == 2
    assert bump.__closure__[0] is read.__closure__[0]


def test_cell_holding_none():
    def make():
        missing = None
        return lambda: missing is None

    assert _roundtrip(make())() is True


def test_closure_over_a_module():
    def make():
        import numpy as np_inner

        return lambda v: float(np_inner.sqrt(v))

    fn = _roundtrip(make())
    assert fn(81.0) == 9.0
    assert fn.__closure__[0].cell_contents is np


def test_module_function_with_globals_and_defaults():
    fn = _roundtrip(_scaled)
    assert fn is not _scaled
    assert fn(2) == 2 * 3 + 1 + OFFSET
    assert fn(2, 4, shift=0) == 8 + OFFSET
    assert fn.__qualname__ == "_scaled" and fn.__doc__ == _scaled.__doc__


def test_functions_of_one_module_share_their_globals():
    a, b = _roundtrip((_scaled, _fib))
    assert a.__globals__ is b.__globals__


def test_functools_partial():
    fn = _roundtrip(functools.partial(lambda a, b, c=0: a - b + c, 10, c=1))
    assert fn(3) == 8


def test_port_function_goes_by_reference():
    from raydp_tpu_torch.dataframe.executor import _concat

    assert _roundtrip(_concat) is _concat
    assert not closure.module_by_value("raydp_tpu_torch.dataframe.executor")
    assert not closure.module_by_value("numpy")
    assert closure.module_by_value(__name__)
    assert closure.module_by_value("__main__")


def test_udf_of_the_engine():
    @rdf.udf("double")
    def half(v):
        return v / 2 + OFFSET

    import pyarrow as pa

    t = pa.table({"v": [2.0, 4.0]})
    df = rdf.from_arrow(t).withColumn("h", _roundtrip(half)(rdf.col("v")))
    assert df.to_pandas()["h"].tolist() == [11.0, 12.0]


def test_local_class_raises_naming_it():
    class Local:
        pass

    with pytest.raises(pickle.PicklingError, match="Local"):
        closure.dumps(Local)
    with pytest.raises(pickle.PicklingError, match="Local"):
        closure.dumps(lambda: Local())


class _Point:
    """A class of this (by-value) module: a worker must not import it."""

    def __init__(self, x):
        self.x = x


def test_class_of_a_by_value_module_raises_naming_it():
    point = _Point(2)
    assert closure.module_by_value(_Point.__module__)
    with pytest.raises(pickle.PicklingError, match="_Point"):
        closure.dumps(point)
    with pytest.raises(pickle.PicklingError, match="_Point"):
        closure.dumps(lambda: point.x)
    with pytest.raises(pickle.PicklingError, match="_Point"):
        closure.dumps(_Point)


def test_fresh_interpreter_loads_without_the_defining_module(tmp_path):
    """A by-value blob of this module's functions loads in an interpreter
    that never imported this module."""
    def make():
        import numpy as np_inner

        return lambda n: int(np_inner.sum([_fib(i) for i in range(n)]))

    blob = tmp_path / "blob"
    blob.write_bytes(closure.dumps((make(), _scaled)))
    code = (
        "import pickle, sys\n"
        f"fn, scaled = pickle.loads(open({str(blob)!r}, 'rb').read())\n"
        f"assert {__name__!r} not in sys.modules\n"
        "print(fn(10), scaled(1))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(tmp_path),
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.stdout.split() == [str(sum(_fib(i) for i in range(10))),
                                  str(_scaled(1))]


class _Counter:
    """A class of this (by-value) module, with the members a user's
    class has: a ``super()`` call, class data, static, class and
    property members."""

    step = 2

    def __init__(self, start):
        super().__init__()
        self.value = start

    @staticmethod
    def double(x):
        return 2 * x

    @classmethod
    def stride(cls):
        return cls.step

    @property
    def next(self):
        return self.value + self.stride()


def test_classes_travel_by_value_when_asked(tmp_path):
    """``dumps(..., classes=True)`` ships a local class and a class of a
    by-value module by value: an interpreter that never imported this
    module loads an instance and builds new ones; the default still
    refuses both."""
    class Local(_Counter):
        def __init__(self):
            super().__init__(5)

    with pytest.raises(pickle.PicklingError, match="Local"):
        closure.dumps(Local())
    blob = tmp_path / "blob"
    blob.write_bytes(closure.dumps((Local(), lambda: Local().next),
                                   classes=True))
    code = (
        "import pickle, sys\n"
        f"obj, make = pickle.loads(open({str(blob)!r}, 'rb').read())\n"
        f"assert {__name__!r} not in sys.modules\n"
        "print(obj.value, obj.next, type(obj).double(4), make(),\n"
        "      type(obj).__mro__[1].__name__)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(tmp_path),
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.stdout.split() == ["5", "7", "8", "7", "_Counter"]
