"""The port imports nothing of JAX or of the JAX package.

Checked statically over the source: a process here may already hold jax
in ``sys.modules`` before any test runs, so a runtime check would say
nothing. The ETL worker and gang rank mains, with the telemetry they
arm, load without torch (checked in a fresh interpreter).
"""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "raydp_tpu"}
# The card machine has neither: the port's RPC layer uses the standard
# library's sockets and pickle instead.
NOT_ON_THE_CARD_MACHINE = {"grpc", "cloudpickle"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "raydp_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_port_files_exist():
    for rel in ("chip_smoke.py", "raydp_tpu_torch/__init__.py",
                "raydp_tpu_torch/ops/flash_attention.py",
                "raydp_tpu_torch/models/dropout.py",
                "raydp_tpu_torch/models/mlp.py",
                "raydp_tpu_torch/models/moe.py",
                "raydp_tpu_torch/models/dlrm.py",
                "raydp_tpu_torch/utils/startup.py",
                "raydp_tpu_torch/train/estimator.py",
                "raydp_tpu_torch/train/losses.py",
                "raydp_tpu_torch/train/gbt.py",
                "raydp_tpu_torch/train/tf_estimator.py",
                "raydp_tpu_torch/train/torch_estimator.py",
                "raydp_tpu_torch/data/torch_adapter.py",
                "raydp_tpu_torch/cli/submit.py",
                "raydp_tpu_torch/examples/torch_nyctaxi.py",
                "raydp_tpu_torch/data/ml_dataset.py",
                "raydp_tpu_torch/data/loader.py",
                "raydp_tpu_torch/utils/sharding.py",
                "raydp_tpu_torch/utils/clock.py",
                "raydp_tpu_torch/utils/profiling.py",
                "raydp_tpu_torch/fault/plan.py",
                "raydp_tpu_torch/fault/inject.py",
                "raydp_tpu_torch/cluster/rpc.py",
                "raydp_tpu_torch/serve/batching.py",
                "raydp_tpu_torch/serve/replica_main.py",
                "raydp_tpu_torch/serve/group.py",
                "raydp_tpu_torch/serve/frontend.py",
                "raydp_tpu_torch/native/build.py",
                "raydp_tpu_torch/native/lib.py",
                "raydp_tpu_torch/telemetry/progress.py",
                "raydp_tpu_torch/telemetry/spans.py",
                "raydp_tpu_torch/telemetry/propagation.py",
                "raydp_tpu_torch/telemetry/accounting.py",
                "raydp_tpu_torch/telemetry/events.py",
                "raydp_tpu_torch/telemetry/export.py",
                "raydp_tpu_torch/telemetry/flight_recorder.py",
                "raydp_tpu_torch/telemetry/watchdog.py",
                "raydp_tpu_torch/telemetry/logs.py",
                "raydp_tpu_torch/telemetry/overlap.py",
                "raydp_tpu_torch/telemetry/shipping.py",
                "raydp_tpu_torch/telemetry/chrome_trace.py",
                "raydp_tpu_torch/telemetry/analyze.py",
                "raydp_tpu_torch/telemetry/device_profiler.py",
                "raydp_tpu_torch/telemetry/timeseries.py",
                "raydp_tpu_torch/telemetry/slo.py",
                "raydp_tpu_torch/telemetry/dashboard.py",
                "raydp_tpu_torch/dataframe/__init__.py",
                "raydp_tpu_torch/dataframe/aqe.py",
                "raydp_tpu_torch/dataframe/dataframe.py",
                "raydp_tpu_torch/dataframe/executor.py",
                "raydp_tpu_torch/dataframe/expr.py",
                "raydp_tpu_torch/dataframe/io.py",
                "raydp_tpu_torch/dataframe/scheduler.py",
                "raydp_tpu_torch/context.py",
                "raydp_tpu_torch/config/config.py",
                "raydp_tpu_torch/utils/net.py",
                "raydp_tpu_torch/utils/memory.py",
                "raydp_tpu_torch/store/shm.py",
                "raydp_tpu_torch/store/object_store.py",
                "raydp_tpu_torch/store/directory.py",
                "raydp_tpu_torch/store/resolver.py",
                "raydp_tpu_torch/store/agent.py",
                "raydp_tpu_torch/cluster/closure.py",
                "raydp_tpu_torch/cluster/placement.py",
                "raydp_tpu_torch/cluster/launcher.py",
                "raydp_tpu_torch/cluster/master.py",
                "raydp_tpu_torch/cluster/worker_main.py",
                "raydp_tpu_torch/cluster/cluster.py",
                "raydp_tpu_torch/cluster/client.py",
                "raydp_tpu_torch/spmd/__init__.py",
                "raydp_tpu_torch/spmd/job.py",
                "raydp_tpu_torch/spmd/worker_main.py",
                "raydp_tpu_torch/dataframe/window.py",
                "raydp_tpu_torch/parallel/mesh.py",
                "raydp_tpu_torch/parallel/collectives.py",
                "raydp_tpu_torch/parallel/pipeline.py",
                "raydp_tpu_torch/models/pipelined.py",
                "raydp_tpu_torch/train/spmd_fit.py",
                "raydp_tpu_torch/control/__init__.py",
                "raydp_tpu_torch/control/arbiter.py",
                "raydp_tpu_torch/control/autoscaler.py",
                "raydp_tpu_torch/loadgen/__init__.py",
                "raydp_tpu_torch/loadgen/__main__.py",
                "raydp_tpu_torch/loadgen/schedules.py",
                "raydp_tpu_torch/loadgen/trace.py",
                "raydp_tpu_torch/loadgen/runner.py",
                "raydp_tpu_torch/loadgen/knee.py",
                "raydp_tpu_torch/sim/__init__.py",
                "raydp_tpu_torch/sim/__main__.py",
                "raydp_tpu_torch/sim/vclock.py",
                "raydp_tpu_torch/sim/cluster.py",
                "raydp_tpu_torch/sim/monitors.py",
                "raydp_tpu_torch/sim/pathology.py",
                "raydp_tpu_torch/sim/scenario.py"):
        assert os.path.join(ROOT, rel) in _port_files(), rel
        assert os.path.exists(os.path.join(ROOT, rel)), rel
    assert os.path.exists(os.path.join(ROOT, "raydp_tpu_torch", "native",
                                       "src", "gather.cpp"))


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_no_jax_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in BANNED]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_no_grpc_or_cloudpickle_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in NOT_ON_THE_CARD_MACHINE]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_checker_catches_banned_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import jax.numpy as jnp\n"
        "from raydp_tpu.ops import attention\n"
        "from raydp_tpu_torch import ops\n"
        "import importlib\n"
        "importlib.import_module('flax.linen')\n"
    )
    found = {mod for _, mod in _imported_roots(str(src))} & BANNED
    assert found == {"jax", "raydp_tpu", "flax"}
    src.write_text("import grpc\nfrom cloudpickle import dumps\n")
    found = {mod for _, mod in _imported_roots(str(src))}
    assert found == NOT_ON_THE_CARD_MACHINE


TELEMETRY_MODULES = ("spans", "propagation", "accounting", "events",
                     "export", "flight_recorder", "watchdog", "logs",
                     "overlap", "shipping", "chrome_trace", "analyze",
                     "progress", "device_profiler", "timeseries", "slo",
                     "dashboard")


@pytest.mark.parametrize("name", TELEMETRY_MODULES)
def test_telemetry_module_imports_no_torch_at_module_level(name):
    """A telemetry module runs in torch-free processes: torch is only
    ever looked up in ``sys.modules`` there, never imported."""
    path = os.path.join(ROOT, "raydp_tpu_torch", "telemetry", f"{name}.py")
    roots = {mod for _, mod in _imported_roots(path)}
    assert "torch" not in roots, name


def test_worker_and_rank_mains_load_without_torch():
    """The ETL worker's and the gang rank's entry modules, with every
    telemetry module, the profiling gauges they sample and the control
    plane the executor's stages pass, leave torch out of
    ``sys.modules``."""
    code = (
        "import sys\n"
        "import raydp_tpu_torch.cluster.worker_main\n"
        "import raydp_tpu_torch.spmd.worker_main\n"
        "import raydp_tpu_torch.control\n"
        "from raydp_tpu_torch.dataframe import executor\n"
        "with executor._stage_span('probe', 1, 'local'):\n"
        "    pass\n"
        + "".join(f"import raydp_tpu_torch.telemetry.{m}\n"
                  for m in TELEMETRY_MODULES)
        + "from raydp_tpu_torch.utils.profiling import "
          "sample_resource_gauges\n"
        "sample_resource_gauges()\n"
        "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"], out.stdout
