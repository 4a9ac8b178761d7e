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
PORTED = ("dataframe", "fault", "telemetry", "utils", "context", "cluster",
          "store", "config", "spmd", "data", "control", "loadgen", "sim",
          "serve", "analysis")
# Single modules of packages the port has not taken whole: only these
# ``raydp_tpu.<package>.<module>`` imports point at the port.
PORTED_MODULES = ("train.torch_estimator",)
# Test modules whose cases run whole programs in subprocesses, with the
# package named inside string literals: every ``raydp_tpu`` name in them
# points at the port, and their selected cases use ported modules only.
WHOLE_PACKAGE = ("test_client_mode.py", "test_slo.py")
# Test modules that name the package's directory in string literals (a
# fixture's path, the tree a checker runs over): there ``"raydp_tpu"``
# and ``"raydp_tpu/..."`` name the port's directory.
PACKAGE_PATHS = ("test_analysis.py", "test_sim.py")

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
    for mod in PORTED + PORTED_MODULES:
        src = src.replace(f"raydp_tpu.{mod}", f"raydp_tpu_torch.{mod}")
    if filename in WHOLE_PACKAGE:
        src = re.sub(r"\braydp_tpu\b", "raydp_tpu_torch", src)
    if filename in PACKAGE_PATHS:
        src = re.sub(r"([\"'])raydp_tpu(?=[\"'/])", r"\1raydp_tpu_torch", src)
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


# Key prefix, in a case's params, of a parametrized fixture's value.
FIXTURE_PARAM = "fixture:"


def _module_fixture(module, name):
    """``module``'s own fixture ``name``, or None."""
    fixture = getattr(module, name, None)
    return fixture if hasattr(fixture, "__wrapped__") else None


def _fixture_param_sets(module, fn, seen=()):
    """Every combination of the params of the parametrized module
    fixtures ``fn`` reaches, through its arguments and theirs."""
    combos = [{}]
    for arg in inspect.signature(fn).parameters:
        fixture = _module_fixture(module, arg)
        if fixture is None or arg in seen:
            continue
        marker = getattr(fixture, "_fixture_function_marker", None)
        params = getattr(marker, "params", None)
        own = ([{FIXTURE_PARAM + arg: p} for p in params] if params
               else [{}])
        inner = _fixture_param_sets(module, fixture.__wrapped__,
                                    seen + (arg,))
        combos = [{**c, **o, **i} for c, o, i
                  in itertools.product(combos, own, inner)]
    return combos


def cases(module, names):
    """``(id, test name, params)`` for every parameter set of each test
    in ``names``: its parametrize marks times the params of the
    parametrized fixtures it uses."""
    out = []
    for name in names:
        fn = getattr(module, name)
        for params in _param_sets(fn):
            for fixed in _fixture_param_sets(module, fn):
                params_all = {**params, **fixed}
                suffix = "-".join(str(v) for v in params_all.values())
                out.append((f"{name}[{suffix}]" if suffix else name, name,
                            params_all))
    return out


def case_params(module, case_list):
    """``case_list`` (from :func:`cases`) as ``pytest.param``s of
    ``(name, params)``, each carrying its case id and the reference
    test's ``slow`` mark where it has one (a slow case stays slow)."""
    import pytest

    out = []
    for case_id, name, params in case_list:
        marks = [m for m in getattr(getattr(module, name), "pytestmark", [])
                 if m.name == "slow"]
        out.append(pytest.param(name, params, id=case_id,
                                marks=[pytest.mark.slow] if marks else []))
    return out


class _ParamRequest:
    """pytest's ``request`` for a parametrized fixture: ``param`` is the
    case's value, everything else the test's own request."""

    def __init__(self, request, param):
        self._request = request
        self.param = param

    def __getattr__(self, name):
        return getattr(self._request, name)


def run_case(module, name, params, request, fixtures=None) -> None:
    """Call ``module.<name>`` with ``params``, ``fixtures`` (values for
    fixture names the caller provides, e.g. a module-scoped session), the
    module's own fixtures and pytest's (``tmp_path``, ``monkeypatch``).
    A module fixture's own arguments resolve the same way, recursively:
    another module fixture, pytest's through ``request.getfixturevalue``,
    and ``request`` itself with the case's ``param`` for a parametrized
    one. A generator fixture is set up before the call and torn down
    after it, in reverse order; each fixture is made once a case."""
    fn = getattr(module, name)
    kwargs = {k: v for k, v in params.items()
              if not k.startswith(FIXTURE_PARAM)}
    provided = dict(fixtures or {})
    made = {}
    generators = []

    def resolve(arg):
        if arg in provided:
            return provided[arg]
        if arg in made:
            return made[arg]
        fixture = _module_fixture(module, arg)
        if fixture is None:
            return request.getfixturevalue(arg)
        body = fixture.__wrapped__
        args = {}
        for inner in inspect.signature(body).parameters:
            if inner == "request" and FIXTURE_PARAM + arg in params:
                args[inner] = _ParamRequest(request,
                                            params[FIXTURE_PARAM + arg])
            else:
                args[inner] = resolve(inner)
        value = body(**args)
        if inspect.isgenerator(value):
            generators.append(value)
            value = next(value)
        made[arg] = value
        return value

    try:
        for arg in inspect.signature(fn).parameters:
            if arg not in kwargs:
                kwargs[arg] = resolve(arg)
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
