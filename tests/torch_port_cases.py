"""Run a JAX-package test module's cases against the port.

The module's source is loaded a second time with its ``raydp_tpu.``
imports pointed at ``raydp_tpu_torch.``, so each of its test functions
holds the port to the expectations it holds the JAX package to. Not a
test module itself (no ``test_`` prefix); the ``test_torch_*`` files
parametrise over :func:`cases`.
"""
import inspect
import itertools
import os
import types

HERE = os.path.dirname(os.path.abspath(__file__))

# Modules of the JAX package whose port the cases run against.
PORTED = ("dataframe", "telemetry.progress", "utils.profiling")


def load_port_module(filename: str) -> types.ModuleType:
    """``tests/<filename>`` with its imports of the ported modules
    pointed at the port."""
    path = os.path.join(HERE, filename)
    with open(path) as f:
        src = f.read()
    for mod in PORTED:
        src = src.replace(f"raydp_tpu.{mod}", f"raydp_tpu_torch.{mod}")
    name = "port_" + os.path.splitext(filename)[0]
    module = types.ModuleType(name)
    module.__file__ = path
    exec(compile(src, f"{path} [against the port]", "exec"), module.__dict__)
    return module


def _param_sets(fn):
    """Every parameter combination of ``fn``'s parametrize marks."""
    combos = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names = mark.args[0]
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",")]
        values = [v if len(names) > 1 else (v,) for v in mark.args[1]]
        combos = [{**c, **dict(zip(names, v))}
                  for c, v in itertools.product(combos, values)]
    return combos


def cases(module, names):
    """``(id, test name, params)`` for every parameter set of each test
    in ``names``."""
    out = []
    for name in names:
        for params in _param_sets(getattr(module, name)):
            suffix = "-".join(str(v) for v in params.values())
            out.append((f"{name}[{suffix}]" if suffix else name, name,
                        params))
    return out


def run_case(module, name, params, request) -> None:
    """Call ``module.<name>`` with ``params``, the module's own fixtures
    (called directly) and pytest's (``tmp_path``, ``monkeypatch``)."""
    fn = getattr(module, name)
    kwargs = dict(params)
    for arg in inspect.signature(fn).parameters:
        if arg in kwargs:
            continue
        fixture = getattr(module, arg, None)
        if fixture is not None and hasattr(fixture, "__wrapped__"):
            kwargs[arg] = fixture.__wrapped__()
        else:
            kwargs[arg] = request.getfixturevalue(arg)
    fn(**kwargs)
