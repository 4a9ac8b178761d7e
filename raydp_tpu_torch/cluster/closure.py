"""The closure carrier: tasks' functions as bytes, on the standard library.

The reference ships every task as a cloudpickled callable
(``raydp_tpu/cluster/cluster.py:847, 1134``; ``worker_main.py:245,
323``): the DataFrame engine wraps each stage function in a local
``task(ctx, ref)``, and users' udfs ride inside it. Standard-library
``pickle`` refuses lambdas and local functions, and the hosts the port
runs on need not have cloudpickle, so :func:`dumps` and
:func:`loads` do what cloudpickle does for such functions with
``pickle.Pickler.reducer_override``:

* **By value**: a function whose module is ``__main__``, is not in
  ``sys.modules``, or is neither the port's nor an installed package's
  (a user script, a test module), and any function that cannot be found
  again by its qualified name (a lambda, a function defined inside a
  function). It travels as its code (``marshal``), name, qualified
  name, defaults, keyword defaults, ``__dict__`` and closure cells.
  Where its module may go by reference, its globals are that module's
  own on the loading side; otherwise it carries only the globals its
  code names (walked through nested code objects), in one dict per
  original globals dict, so two functions of one script share theirs.
  The function is rebuilt as a skeleton first and filled after (the
  six-item reduce with a ``state_setter``), and cells travel as objects
  of their own, so a function that calls itself and closures that share
  a cell round-trip through pickle's memo.
* **By reference**: a function of the port (``raydp_tpu_torch``) or of
  an installed package or the standard library that its module holds
  under its qualified name. A worker imports it. A function of a test
  module never goes by reference, so a worker never imports a test
  module (and, through it, whatever that module imports).
* **Modules** go by name (``importlib.import_module``): a udf that
  imported numpy inside its enclosing function holds the module in a
  cell.
* **Classes** go by reference, and so do their instances. A class
  defined inside a function, or in a module whose functions go by value
  (``__main__``, a script, a test module), raises a
  :class:`pickle.PicklingError` that names it: shipping it by reference
  would make a worker import that module. ``dumps(obj, classes=True)``
  ships such a class by value instead, as cloudpickle does: its name,
  bases and namespace (methods by value, ``staticmethod``,
  ``classmethod`` and ``property`` members rebuilt from their
  functions), the class made first and its namespace set after, so
  methods that name it (``super()``'s cell, a global) load. The torch
  compat estimator uses it for a user's ``nn.Module`` classes
  (``train/torch_estimator.py``); a metaclass other than the bases'
  and ``__slots__`` are not carried.

``marshal``'s format is the interpreter's own: a blob loads only in the
same Python version. The cluster's workers are started with
``sys.executable`` on the same host, so both sides always agree.
Annotations are not carried.
"""
from __future__ import annotations

import builtins
import importlib
import io
import marshal
import os
import pickle
import site
import sys
import sysconfig
import types
from typing import Any, Dict, Set

_PORT_PACKAGE = __name__.split(".")[0]
_INSTALL_DIRS = tuple(
    os.path.realpath(p) + os.sep
    for p in ({sysconfig.get_paths().get(k)
               for k in ("stdlib", "platstdlib", "purelib", "platlib")}
              | set(site.getsitepackages())
              | {site.getusersitepackages()})
    if p)
_by_value_cache: Dict[str, bool] = {}


def module_by_value(name: str) -> bool:
    """Whether functions of module ``name`` travel by value: True for
    ``__main__``, a module not in ``sys.modules``, and any module that is
    neither the port's nor under an install directory of this
    interpreter (standard library, site and user site-packages)."""
    cached = _by_value_cache.get(name)
    if cached is not None:
        return cached
    module = sys.modules.get(name)
    if name == "__main__" or module is None:
        return True  # not cached: the module may be imported later
    if name.split(".")[0] == _PORT_PACKAGE:
        by_value = False
    else:
        path = getattr(module, "__file__", None)
        by_value = (path is not None and not os.path.realpath(path)
                    .startswith(_INSTALL_DIRS))
    _by_value_cache[name] = by_value
    return by_value


def _lookup(module: types.ModuleType, qualname: str):
    obj = module
    for part in qualname.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def _by_reference(fn: types.FunctionType) -> bool:
    name = fn.__module__
    if name is None or module_by_value(name):
        return False
    return _lookup(sys.modules[name], fn.__qualname__) is fn


def _code_names(code: types.CodeType) -> Set[str]:
    names = set(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _code_names(const)
    return names


# -- the loading side ---------------------------------------------------

def _import(name: str) -> types.ModuleType:
    return importlib.import_module(name)


def _make_cell() -> types.CellType:
    return types.CellType()


def _fill_cell(cell: types.CellType, state: tuple) -> types.CellType:
    cell.cell_contents = state[0]
    return cell


def _make_globals(module_name: str) -> dict:
    """The globals of by-value functions whose module cannot be imported
    here: filled by :func:`_fill_function`."""
    return {"__name__": module_name, "__builtins__": builtins}


def _make_function(code: bytes, base_globals, name: str, closure):
    if isinstance(base_globals, str):
        base_globals = importlib.import_module(base_globals).__dict__
    return types.FunctionType(marshal.loads(code), base_globals, name, None,
                              closure)


# Class attributes that the class statement makes itself.
_CLASS_SKIP = frozenset(("__dict__", "__weakref__", "__module__",
                         "__qualname__", "__doc__", "_abc_impl"))


def _make_class(name: str, bases: tuple, base_ns: dict) -> type:
    return types.new_class(name, bases, None,
                           lambda ns: ns.update(base_ns))


def _fill_class(cls: type, state: dict) -> type:
    for key, value in state.items():
        setattr(cls, key, value)
    return cls


def _fill_function(fn: types.FunctionType, state: dict):
    for key, value in state["globals"].items():
        fn.__globals__.setdefault(key, value)
    fn.__defaults__ = state["defaults"]
    fn.__kwdefaults__ = state["kwdefaults"]
    fn.__qualname__ = state["qualname"]
    fn.__module__ = state["module"]
    fn.__doc__ = state["doc"]
    fn.__dict__.update(state["dict"])
    return fn


# -- the pickling side --------------------------------------------------

class _Pickler(pickle.Pickler):
    def __init__(self, file, classes: bool = False):
        super().__init__(file, protocol=pickle.HIGHEST_PROTOCOL)
        self._classes = classes
        # id(original globals dict) -> the stub shipped in its place, so
        # every function of one script shares one globals dict on load.
        self._globals: Dict[int, "_GlobalsStub"] = {}

    def reducer_override(self, obj):
        if isinstance(obj, types.FunctionType):
            if _by_reference(obj):
                return NotImplemented
            return self._function_reduce(obj)
        if isinstance(obj, types.ModuleType):
            return _import, (obj.__name__,)
        if isinstance(obj, types.CellType):
            try:
                contents = obj.cell_contents
            except ValueError:  # an empty cell (a name not yet bound)
                return _make_cell, ()
            # Wrapped: pickle skips a state of None, and a cell may
            # hold None.
            return _make_cell, (), (contents,), None, None, _fill_cell
        if self._classes:
            if isinstance(obj, (staticmethod, classmethod)):
                return type(obj), (obj.__func__,)
            if isinstance(obj, property):
                return property, (obj.fget, obj.fset, obj.fdel, obj.__doc__)
        if isinstance(obj, type):
            qualname = getattr(obj, "__qualname__", obj.__name__)
            module = getattr(obj, "__module__", None)
            if "<locals>" in qualname or (module is not None
                                          and module_by_value(module)):
                if self._classes:
                    return self._class_reduce(obj)
                raise pickle.PicklingError(
                    f"class {module}.{qualname} cannot be shipped: it is "
                    "defined inside a function or in a module whose "
                    "functions go by value (__main__, a script, a test "
                    "module), which a worker does not import; define it "
                    "in the port or an installed package")
        return NotImplemented

    def _class_reduce(self, cls: type):
        base_ns = {"__module__": cls.__module__,
                   "__qualname__": cls.__qualname__, "__doc__": cls.__doc__}
        state = {k: v for k, v in vars(cls).items() if k not in _CLASS_SKIP}
        return (_make_class, (cls.__name__, cls.__bases__, base_ns), state,
                None, None, _fill_class)

    def _function_reduce(self, fn: types.FunctionType):
        module = fn.__module__
        shipped: Dict[str, Any] = {}
        if module is not None and not module_by_value(module):
            base_globals: Any = module  # the worker's own module dict
        else:
            key = id(fn.__globals__)
            base_globals = self._globals.get(key)
            if base_globals is None:
                base_globals = self._globals[key] = _GlobalsStub(
                    module or "__main__")
            g = fn.__globals__
            shipped = {n: g[n] for n in sorted(_code_names(fn.__code__))
                       if n in g}
        state = {
            "globals": shipped,
            "defaults": fn.__defaults__,
            "kwdefaults": fn.__kwdefaults__,
            "qualname": fn.__qualname__,
            "module": module,
            "doc": fn.__doc__,
            "dict": dict(fn.__dict__),
        }
        args = (marshal.dumps(fn.__code__), base_globals, fn.__name__,
                fn.__closure__)
        return _make_function, args, state, None, None, _fill_function


class _GlobalsStub:
    """Stands for a by-value function's globals dict while pickling; it
    loads as an empty dict (:func:`_make_globals`), the same one for
    every function that shares it, thanks to pickle's memo."""

    def __init__(self, module_name: str):
        self.module_name = module_name

    def __reduce__(self):
        return _make_globals, (self.module_name,)


def dumps(obj, classes: bool = False) -> bytes:
    """``obj`` as bytes, its functions by value or by reference as the
    module docstring says; with ``classes``, also the classes that would
    otherwise raise."""
    buf = io.BytesIO()
    _Pickler(buf, classes=classes).dump(obj)
    return buf.getvalue()


def loads(data: bytes):
    """The object :func:`dumps` wrote."""
    return pickle.loads(data)
