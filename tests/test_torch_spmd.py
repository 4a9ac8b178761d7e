"""The port's SPMD gang runner (``raydp_tpu_torch/spmd``) against the JAX
package's tests of the same module, and the slice as a whole against the
JAX package.

* Every case of ``tests/test_spmd.py`` runs against the port, loaded
  again with its imports pointed at the port (``tests/torch_port_cases.py``):
  real rank processes, functions shipped by the closure carrier.
* A gloo ``all_reduce`` across 2 CPU ranks through the context's
  ``init_distributed``, and a coordinator port taken by another socket
  surfacing as an error that names it.
* A dispatch over the payload hard cap raises ``DispatchPayloadError``
  (not retryable, with its size) and leaves the gang usable, as the JAX
  job's ``CompileError`` does on the same payload; the registration
  barrier's soft and hard windows equal the JAX job's, and ranks that
  are alive past the soft window are waited on.
* The rank entry imports no torch when it starts: statically over the
  module-level imports it reaches, and in a running rank.
* The slice as a whole: a 2-worker port session runs the ETL, a gang of
  2 CPU ranks scores ``MLDataset.shard_tables(r)`` of the frame with a
  tiny flash classifier (2 layers, width 64) whose weights come from the
  JAX model through ``params_from_flax`` and travel in ``per_rank_args``
  staged through the driver's blob store; the rank-ordered logits equal
  the JAX classifier's forward over the same rows (flash in interpret
  mode on the CPU) within the f32 bounds rtol 2e-4 / atol 2e-5.

Each test runs under a time limit of its own (``LIMIT_S``).
"""
import ast
import importlib.util
import os
import socket
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest

from raydp_tpu.models import transformer as jt
from raydp_tpu_torch.spmd import (
    DispatchPayloadError,
    SPMDJob,
    SPMDJobError,
    create_spmd_job,
)
from torch_port_cases import cases, load_port_module, run_case, time_limit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = load_port_module("test_spmd.py")
REFERENCE_CASES = cases(
    REFERENCE, [n for n in vars(REFERENCE) if n.startswith("test_")])
F32_TOL = dict(rtol=2e-4, atol=2e-5)
SEQ, ROWS = 32, 256
# Each test's own limit, in seconds: every test here starts processes.
LIMIT_S = 150


@pytest.fixture(autouse=True)
def _time_limit():
    with time_limit(LIMIT_S):
        yield


@pytest.mark.parametrize("name,params",
                         [(n, p) for _, n, p in REFERENCE_CASES],
                         ids=[i for i, _, _ in REFERENCE_CASES])
def test_reference_case_on_port(name, params, request):
    run_case(REFERENCE, name, params, request)


def test_cases_cover_the_reference_module():
    assert len(REFERENCE_CASES) == 8


def _sum_ranks(ctx):
    import torch
    import torch.distributed as dist

    ctx.init_distributed(device="cpu")
    ctx.init_distributed(device="cpu")  # idempotent
    x = torch.tensor([float(ctx.rank + 1), 1.0])
    dist.all_reduce(x)
    return x.tolist(), dist.get_world_size(), dist.get_backend()


def test_gloo_all_reduce_across_two_cpu_ranks():
    with create_spmd_job("t-gloo", world_size=2, timeout=45) as job:
        out = job.run(_sum_ranks)
    assert out == [([3.0, 2.0], 2, "gloo")] * 2


def test_taken_coordinator_port_names_the_port():
    """A coordinator port bound by another socket before rank 0's store
    binds it fails the gang at once with an error naming the port; it is
    not retried behind the caller's back."""
    with socket.socket() as squatter:
        squatter.bind(("0.0.0.0", 0))
        squatter.listen()
        port = squatter.getsockname()[1]
        with create_spmd_job("t-port", world_size=2, timeout=45,
                             coordinator_port=port) as job:
            with pytest.raises(SPMDJobError, match=f"port {port}"):
                job.run(lambda ctx: ctx.init_distributed(device="cpu"),
                        timeout=60)
            with pytest.raises(SPMDJobError, match="failed"):
                job.run(lambda ctx: ctx.rank)


def _refused_dispatch(create, error_type):
    """A dispatch of 6 MB a rank against a 4 MB hard cap: the error's
    (payload_bytes, retryable, names the hard cap), then a small
    dispatch's results on the same gang."""
    big = bytes(6 * 1024 * 1024)
    with create("t-capped", world_size=2, timeout=60) as job:
        with pytest.raises(error_type) as ei:
            job.run(lambda ctx, data: len(data),
                    per_rank_args=[(big,) for _ in range(2)])
        alive = job.run(lambda ctx: "alive")
    err = ei.value
    return (err.payload_bytes, err.retryable, "hard cap" in str(err)), alive


def test_hard_cap_fails_fast_with_structured_error(monkeypatch):
    """The port's ``DispatchPayloadError`` against the JAX job's
    ``CompileError`` (``tests/test_payload_staging.py``) on the same caps
    and payload: both refuse before sending, say so, and keep the gang."""
    from raydp_tpu.spmd import create_spmd_job as jax_create_spmd_job
    from raydp_tpu.utils.profiling import CompileError

    monkeypatch.setenv("RAYDP_TPU_RPC_INLINE_CAP_MB", "1")
    monkeypatch.setenv("RAYDP_TPU_RPC_PAYLOAD_HARD_CAP_MB", "4")
    (want_bytes, *want), want_alive = _refused_dispatch(
        jax_create_spmd_job, CompileError)
    (got_bytes, *got), got_alive = _refused_dispatch(
        create_spmd_job, DispatchPayloadError)
    assert got == want == [False, True]
    assert got_alive == want_alive == ["alive"] * 2
    assert got_bytes > 4 * 1024 * 1024 and want_bytes > 4 * 1024 * 1024
    # The same 6 MB argument; only the function's serialisation differs.
    assert abs(got_bytes - want_bytes) < 64 * 1024


def test_registration_windows_match_jax(monkeypatch):
    """Soft window = the job's ``timeout``; hard cap = max(10 × soft,
    300 s), as the JAX job gives with its overrides unset."""
    from raydp_tpu.spmd.job import (
        ENV_REGISTER_HARD_TIMEOUT,
        ENV_REGISTER_TIMEOUT,
    )
    from raydp_tpu.spmd.job import SPMDJob as JaxSPMDJob

    monkeypatch.delenv(ENV_REGISTER_TIMEOUT, raising=False)
    monkeypatch.delenv(ENV_REGISTER_HARD_TIMEOUT, raising=False)
    for soft, hard in ((0.5, 300.0), (5.0, 300.0), (60.0, 600.0)):
        want = JaxSPMDJob("t", world_size=1,
                          timeout=soft)._registration_timeouts()
        got = SPMDJob("t", world_size=1, timeout=soft)._registration_timeouts()
        assert got == want == (soft, hard)


def test_alive_ranks_are_waited_on_past_the_soft_window():
    """Ranks that start 3 s late against a 0.5 s soft window are alive,
    so the barrier waits on them under the hard cap and the gang runs."""
    delay = ["sh", "-c", 'sleep 3; exec "$0" "$@"']
    job = create_spmd_job("t-slow", world_size=2, timeout=0.5,
                          script_prepare_fn=lambda ctx: delay)
    t0 = time.monotonic()
    with job:
        assert time.monotonic() - t0 > 3.0
        assert job.run(lambda ctx: ctx.rank) == [0, 1]


def test_rank_nodes_name_store_nodes(monkeypatch):
    """Ranks are named by the object store's node ids, which blocks
    carry: placement's bundle nodes, else the driver's node for a rank
    on this host, else the host."""
    assert create_spmd_job("t-n", world_size=3).rank_nodes() == \
        ["node-0"] * 3
    assert create_spmd_job("t-h", world_size=2, num_procs_per_node=1,
                           hosts=["10.0.0.1", "10.0.0.2"]).rank_nodes() == \
        ["10.0.0.1", "10.0.0.2"]
    monkeypatch.setenv("RAYDP_TPU_VIRTUAL_NODES", "2")
    monkeypatch.setenv("RAYDP_TPU_NUM_CPUS", "8")
    job = create_spmd_job("t-pg", world_size=4, num_procs_per_node=2,
                          placement_strategy="STRICT_SPREAD")
    assert job.rank_nodes() == ["node-0", "node-0", "node-1", "node-1"]


def _module_imports(name):
    """The roots of the module-level imports of port module ``name`` and
    of every port module (and parent package) they reach, transitively;
    imports inside functions are not followed."""
    seen, roots, todo = set(), set(), [name]
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        parts = mod.split(".")
        todo += [".".join(parts[:i]) for i in range(1, len(parts))]
        spec = importlib.util.find_spec(mod)
        if spec is None or spec.origin is None:
            continue
        with open(spec.origin) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(ast.Module(body=[
                n for n in tree.body
                if not isinstance(n, (ast.FunctionDef, ast.ClassDef,
                                      ast.AsyncFunctionDef))],
                type_ignores=[])):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module] + [f"{node.module}.{a.name}"
                                         for a in node.names]
            else:
                continue
            for n in names:
                roots.add(n.split(".")[0])
                if n.startswith("raydp_tpu_torch") and \
                        importlib.util.find_spec(n.rsplit(".", 1)[0]):
                    try:
                        if importlib.util.find_spec(n) is not None:
                            todo.append(n)
                    except ModuleNotFoundError:
                        pass
    return roots, seen


def test_rank_entry_imports_no_torch_at_start():
    roots, reached = _module_imports("raydp_tpu_torch.spmd.worker_main")
    assert "raydp_tpu_torch.cluster.rpc" in reached
    assert "raydp_tpu_torch.spmd.job" in reached
    assert not roots & {"torch", "triton", "numpy"}, roots


def test_running_rank_holds_no_torch_until_a_function_imports_it():
    def probe(ctx):
        import sys

        before = "torch" in sys.modules
        import torch  # noqa: F401

        return before, "torch" in sys.modules

    with create_spmd_job("t-light", world_size=1, timeout=45) as job:
        assert job.run(probe) == [(False, True)]


# -- the slice as a whole against the JAX package -------------------------

def _tiny_cfgs():
    import torch

    from raydp_tpu_torch.models import transformer as tt

    kw = dict(d_model=64, n_heads=4, d_ff=128, n_layers=2, max_len=SEQ,
              attention_impl="flash")
    tkw = dict(kw, dtype=torch.float32)
    return (jt.tiny_transformer(dtype=jnp.float32, **kw),
            tt.tiny_transformer(**tkw), tkw)


def _score_shard(ctx, tables, state, cfg_kw, batch):
    """Rank body: the shard's token ids through the classifier rebuilt
    from ``state``; returns (rank, logits)."""
    import numpy as np
    import pyarrow as pa
    import torch

    from raydp_tpu_torch.models import transformer as tt

    model = tt.SequenceClassifier(tt.tiny_transformer(**cfg_kw),
                                  device="cpu").eval()
    model.load_state_dict(state)
    table = pa.concat_tables(tables)
    ids = np.stack([table.column(f"t{i}").to_numpy()
                    for i in range(cfg_kw["max_len"])], axis=1)
    out = []
    with torch.no_grad():
        for lo in range(0, len(ids), batch):
            x = torch.from_numpy(ids[lo:lo + batch]).long()
            out.append(model(x, torch.zeros_like(x)).numpy())
    return ctx.rank, np.concatenate(out)


@pytest.fixture
def port_session():
    import raydp_tpu_torch

    s = raydp_tpu_torch.init(app_name="spmd-slice", num_workers=2)
    yield s
    raydp_tpu_torch.stop()


def test_gang_scores_object_store_shards_like_jax(port_session,
                                                  monkeypatch):
    import raydp_tpu_torch.dataframe as rdf
    from raydp_tpu_torch.data import MLDataset
    from raydp_tpu_torch.dataframe.executor import ClusterExecutor
    from raydp_tpu_torch.models.convert import params_from_flax
    from raydp_tpu_torch.utils.profiling import metrics

    jcfg, tcfg, cfg_kw = _tiny_cfgs()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jcfg.vocab_size, size=(ROWS, SEQ)).astype(np.int32)
    df = rdf.from_arrow(pa.table({f"t{i}": ids[:, i] for i in range(SEQ)}),
                        num_partitions=4)
    assert isinstance(df._executor, ClusterExecutor)
    params = jax.tree_util.tree_map(np.asarray, nn.unbox(
        jt.SequenceClassifier(jcfg).init(
            jax.random.PRNGKey(0), jnp.asarray(ids[:2]),
            jnp.zeros((2, SEQ), jnp.int32)))["params"])
    state = params_from_flax(params, tcfg)

    # Every dispatch over 10 KB leaves the envelope for the blob store.
    monkeypatch.setenv("RAYDP_TPU_RPC_INLINE_CAP_MB", "0.01")
    before = metrics.snapshot()["counters"].get("spmd/oversize_dispatches", 0)
    with create_spmd_job("t-slice", world_size=2, timeout=45) as job:
        ds = MLDataset.from_df(df, num_shards=2, rank_nodes=job.rank_nodes())
        assert job.rank_nodes() == ["node-0", "node-0"]
        assert ds.locality() == 1.0
        shards = [ds.shard_tables(r) for r in range(2)]
        out = job.run(_score_shard, per_rank_args=[
            (shards[r], state, cfg_kw, 64) for r in range(2)])
    staged = metrics.snapshot()["counters"]["spmd/oversize_dispatches"]
    assert staged - before == 2

    assert [r for r, _ in out] == [0, 1]
    got = np.concatenate([logits for _, logits in out])
    rows = np.concatenate([ds.shard_global_indices(r) for r in range(2)])
    want = jt.SequenceClassifier(jcfg).apply(
        {"params": params}, jnp.asarray(ids[rows]),
        jnp.zeros((len(rows), SEQ), jnp.int32))
    assert got.shape == (2 * ds.rows_per_shard, 2)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)
