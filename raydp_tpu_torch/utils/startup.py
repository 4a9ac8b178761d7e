"""Where a process's start goes: its parts on the host clock.

With ``RAYDP_TPU_START_LOG`` naming a directory, every process of the
port that inherits it (SPMD ranks, replicas, ETL workers, a driver's
subprocesses) appends one JSON line a part to ``<dir>/<pid>.jsonl``:
``{"pid", "role", "part", "t0", "t1"}`` in wall-clock seconds. The parts
of a start, in order:

* ``up``: the process created (its start time in ``/proc/self/stat``)
  to the package's first line (the interpreter, ``site`` and the entry
  module's imports up to the package);
* ``torch``: ``import torch`` (the first one, by a hook on
  ``builtins.__import__`` that removes itself once torch is in);
* ``cuda``: the CUDA context, made and synchronised at the first
  ``resolve_device`` of a card;
* ``dist``: joining the gang's ``torch.distributed`` group (the wait for
  the slowest peer included);
* ``kernels``: the first kernel library loaded (``ops/_build.load``;
  built already, or built here);
* ``model``: the model built and on its device (the model classes'
  constructors, :func:`timed`);
* ``optimizer``: the estimator's optimizer built (building AdamW imports
  ``torch._dynamo``);
* ``first_step``: the first train step, synchronised.

Each part is kept once a process, the first time. Off (the variable
unset), :func:`part` and :func:`mark_up` cost one environment lookup.
:func:`read_starts` reads the directory back: one row a process with
each part's seconds and the rest (``other``: registration, the port's
own imports, waits, data) up to its first step's end. Standard library only: a torch-free worker loads
it.
"""
from __future__ import annotations

import builtins
import contextlib
import functools
import json
import os
import sys
import time
from typing import Callable, Dict, Iterator, List, Optional

ENV = "RAYDP_TPU_START_LOG"
PARTS = ("up", "torch", "cuda", "dist", "kernels", "model", "optimizer",
         "first_step")

_done: set = set()
_hook = {"orig": None}


def enabled() -> bool:
    return bool(os.environ.get(ENV))


def pending(name: str) -> bool:
    """Whether part ``name`` is still to be kept in this process."""
    return enabled() and name not in _done


_ROLES = {"raydp_tpu_torch.spmd.worker_main": "rank",
          "raydp_tpu_torch.cluster.worker_main": "etl-worker",
          "raydp_tpu_torch.serve.replica_main": "replica"}


def _role() -> str:
    """What the process is, from its command line (``python -m
    <module>``, ``-c``, or a script)."""
    argv = list(getattr(sys, "orig_argv", sys.argv))
    if "-m" in argv[:-1]:
        module = argv[argv.index("-m") + 1]
        return _ROLES.get(module, module)
    if "-c" in argv:
        return "python -c"
    script = next((a for a in argv[1:] if a.endswith(".py")), "")
    return os.path.basename(script) or "python"


def record(name: str, t0: float, t1: float) -> None:
    """Keep part ``name`` (the first time in this process)."""
    path = os.environ.get(ENV)
    if not path or name in _done:
        return
    _done.add(name)
    line = json.dumps({"pid": os.getpid(), "role": _role(), "part": name,
                       "t0": t0, "t1": t1})
    try:
        with open(os.path.join(path, f"{os.getpid()}.jsonl"), "a") as f:
            f.write(line + "\n")
    except OSError:
        pass


@contextlib.contextmanager
def part(name: str, sync: Optional[Callable[[], None]] = None
         ) -> Iterator[None]:
    """Time the block as part ``name`` (when the log is on and the part
    is not kept yet), calling ``sync`` (a device synchronise) at its end."""
    if not pending(name):
        yield
        return
    t0 = time.time()
    yield
    if sync is not None:
        sync()
    record(name, t0, time.time())


def timed(name: str) -> Callable:
    """Decorate a function (a model's ``__init__``) as part ``name``."""
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with part(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def process_start() -> Optional[float]:
    """This process's creation on the wall clock (Linux ``/proc``)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rpartition(")")[2].split()
        ticks = int(fields[19])         # starttime, field 22
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return None


def mark_up() -> None:
    """The ``up`` part, and the hook that times ``import torch``."""
    if not enabled():
        return
    start = process_start()
    now = time.time()
    record("up", start if start is not None else now, now)
    if "torch" not in sys.modules and _hook["orig"] is None:
        _hook["orig"] = builtins.__import__
        builtins.__import__ = _timed_import


def _timed_import(name, *args, **kwargs):
    orig = _hook["orig"]
    if orig is None or not (name == "torch" or name.startswith("torch.")):
        return (orig or builtins.__import__)(name, *args, **kwargs)
    builtins.__import__ = orig
    _hook["orig"] = None
    t0 = time.time()
    try:
        return orig(name, *args, **kwargs)
    finally:
        record("torch", t0, time.time())


def read_starts(path: str, exclude=()) -> List[Dict[str, float]]:
    """One row a process logged under ``path`` (but ``exclude``'s pids):
    ``pid``, ``role``, ``total`` (creation to the first step's end, or
    to the last part's where no step ran), each part begun by then with
    its seconds (and under ``<part>@`` its start, seconds after the
    creation) and ``other`` (the total less the parts)."""
    rows = []
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".jsonl"):
            continue
        parts: Dict[str, dict] = {}
        with open(os.path.join(path, fname)) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                parts.setdefault(rec["part"], rec)
        if not parts or "up" not in parts:
            continue
        pid = next(iter(parts.values()))["pid"]
        if pid in exclude:
            continue
        start = parts["up"]["t0"]
        end = parts["first_step"]["t1"] if "first_step" in parts \
            else max(r["t1"] for r in parts.values())
        # A part begun after the start's end (a kernel library a later
        # phase loads) is not the start's.
        parts = {n: r for n, r in parts.items() if r["t0"] < end}
        row = {"pid": pid, "role": parts["up"]["role"], "start": start,
               "total": end - start}
        for name in PARTS:
            if name in parts:
                row[name] = _exclusive(parts[name], parts.values())
                row[name + "@"] = parts[name]["t0"] - start
        row["other"] = row["total"] - sum(row.get(n, 0.0) for n in PARTS)
        rows.append(row)
    return rows


def _exclusive(rec: dict, recs) -> float:
    """``rec``'s seconds less those of the parts nested in it (the CUDA
    context made inside a model's construction counts as ``cuda``)."""
    inner = sum(r["t1"] - r["t0"] for r in recs if r is not rec
                and r["t0"] >= rec["t0"] and r["t1"] <= rec["t1"])
    return rec["t1"] - rec["t0"] - inner
