"""Run a JAX-package test module's cases against the port.

The module's source is loaded a second time with its ``raydp_tpu.``
imports pointed at ``raydp_tpu_torch.``, so each of its test functions
holds the port to the expectations it holds the JAX package to: a bare
``import raydp_tpu`` (at any indentation) becomes the port's package,
``from raydp_tpu import <m>`` the port's ``<m>`` where it is ported,
and ``from tests.<m> import ...`` takes the names from ``<m>`` loaded
the same way. Not a
test module itself (no ``test_`` prefix); the ``test_torch_*`` files
parametrise over :func:`cases`. The loaded modules are not in
``sys.modules``, so the closure carrier ships their functions to the
port's worker processes by value (``raydp_tpu_torch/cluster/closure.py``).
"""
import ast
import contextlib
import functools
import inspect
import itertools
import os
import re
import signal
import types

HERE = os.path.dirname(os.path.abspath(__file__))

# Modules of the JAX package whose port the cases run against.
PORTED = ("dataframe", "fault", "telemetry", "utils.profiling", "context",
          "cluster", "store", "config", "utils.net", "utils.memory",
          "utils.sharding", "spmd", "data")
# Test modules whose cases run whole programs in subprocesses, with the
# package named inside string literals: every ``raydp_tpu`` name in them
# points at the port, and their selected cases use ported modules only.
WHOLE_PACKAGE = ("test_client_mode.py",)

_TESTS_IMPORT = re.compile(r"^from tests\.(\w+) import (.+)$", re.MULTILINE)


def _only(src: str, names) -> str:
    """``src`` cut to the functions ``names`` and the imports they use
    (an import's unused names are dropped, so a test module whose other
    cases need an unported module still loads)."""
    tree = ast.parse(src)
    keep = [n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and n.name in names]
    used = {n.id for f in keep for n in ast.walk(f)
            if isinstance(n, ast.Name)}
    body = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            node.names = [a for a in node.names
                          if (a.asname or a.name).split(".")[0] in used]
            if node.names:
                body.append(node)
    tree.body = body + keep
    return ast.unparse(tree)


@functools.lru_cache(maxsize=None)
def load_port_module(filename: str, only=None) -> types.ModuleType:
    """``tests/<filename>`` with its imports of the ported modules
    pointed at the port; with ``only`` (a tuple of names), just those
    functions and the imports they use."""
    path = os.path.join(HERE, filename)
    with open(path) as f:
        src = f.read()
    if only is not None:
        src = _only(src, set(only))
    for mod in PORTED:
        src = src.replace(f"raydp_tpu.{mod}", f"raydp_tpu_torch.{mod}")
    if filename in WHOLE_PACKAGE:
        src = re.sub(r"\braydp_tpu\b", "raydp_tpu_torch", src)
    src = re.sub(r"^(\s*)import raydp_tpu$",
                 r"\1import raydp_tpu_torch as raydp_tpu",
                 src, flags=re.MULTILINE)
    src = re.sub(r"^(\s*)from raydp_tpu import (\w+)",
                 lambda m: (f"{m.group(1)}from raydp_tpu_torch import "
                            f"{m.group(2)}" if m.group(2) in PORTED
                            else m.group(0)),
                 src, flags=re.MULTILINE)
    src = _TESTS_IMPORT.sub(
        lambda m: (f"{m.group(2)} = _port_names({m.group(1)!r}, "
                   f"{m.group(2)!r})"), src)
    name = "port_" + os.path.splitext(filename)[0]
    module = types.ModuleType(name)
    module.__file__ = path
    module._port_names = _port_names
    exec(compile(src, f"{path} [against the port]", "exec"), module.__dict__)
    return module


def _port_names(module: str, names: str):
    """The objects ``names`` (comma-separated) of ``tests/<module>.py``
    loaded against the port."""
    loaded = load_port_module(module + ".py")
    values = [getattr(loaded, n.strip()) for n in names.split(",")]
    return values[0] if len(values) == 1 else values


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


def run_case(module, name, params, request, fixtures=None) -> None:
    """Call ``module.<name>`` with ``params``, ``fixtures`` (values for
    fixture names the caller provides, e.g. a module-scoped session), the
    module's own fixtures (called directly; a generator fixture is set
    up before the call and torn down after it) and pytest's
    (``tmp_path``, ``monkeypatch``)."""
    fn = getattr(module, name)
    kwargs = dict(params)
    provided = dict(fixtures or {})
    generators = []
    try:
        for arg in inspect.signature(fn).parameters:
            if arg in kwargs:
                continue
            if arg in provided:
                kwargs[arg] = provided[arg]
                continue
            fixture = getattr(module, arg, None)
            if fixture is not None and hasattr(fixture, "__wrapped__"):
                value = fixture.__wrapped__()
                if inspect.isgenerator(value):
                    generators.append(value)
                    value = next(value)
                kwargs[arg] = value
            else:
                kwargs[arg] = request.getfixturevalue(arg)
        fn(**kwargs)
    finally:
        for gen in reversed(generators):
            next(gen, None)  # the fixture's teardown


@contextlib.contextmanager
def time_limit(seconds: int):
    """Raise ``TimeoutError`` in the main thread (the test's) once
    ``seconds`` have passed inside the block: a test that starts
    processes fails on its own limit instead of hanging the run."""
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds} s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
