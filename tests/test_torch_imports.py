"""The port imports nothing of JAX or of the JAX package.

Checked statically over the source: a process here may already hold jax
in ``sys.modules`` before any test runs, so a runtime check would say
nothing.
"""
import ast
import os

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
                "raydp_tpu_torch/train/estimator.py",
                "raydp_tpu_torch/train/losses.py",
                "raydp_tpu_torch/train/gbt.py",
                "raydp_tpu_torch/train/tf_estimator.py",
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
                "raydp_tpu_torch/serve/frontend.py"):
        assert os.path.join(ROOT, rel) in _port_files(), rel
        assert os.path.exists(os.path.join(ROOT, rel)), rel


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
