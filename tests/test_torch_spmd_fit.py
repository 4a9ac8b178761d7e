"""The port's ``fit_spmd`` and the ``Estimator``'s multi-process mode
(``raydp_tpu_torch/train/spmd_fit.py``, ``train/estimator.py``) against
the JAX package's, mirroring ``tests/test_spmd_fit.py`` on the CPU with
gloo.

* The same 1,024 rows (``tests/test_spmd_fit.py``'s ``_ds``), 2 ranks,
  ``MLP(hidden=(16,), out_dim=1)``, Adam 3e-2, batch 128 a rank, no
  shuffle, 10 epochs, through the JAX package's ``fit_spmd`` and the
  port's, the port's model starting from the JAX model's initial
  parameters (``params_from_flax``): every epoch's ``train_loss`` and
  the final parameters within the f32 gradient bound (rtol 1e-3 /
  atol 1e-4); the ranks' histories equal (rtol 1e-6) and their final
  parameters identical (equal digests).
* Store mode under a port session: each rank reads its plan's slices of
  the session's blocks itself (the driver reads none) and trains exactly
  as the in-memory run does.
* ``num_shards != world_size`` raises as in the JAX package; the
  default ``device="cuda"`` raises on a host with no card; a mesh with
  tp > 1 is not elastic and must match the world.
* Checkpoints written inside the gang (every rank enters ``save``)
  restore into a fresh single-process ``Estimator`` with the gang's
  parameters.
* A rank killed after epoch 1: the supervisor relaunches the gang once,
  it resumes from the newest checkpoint, and it ends with the
  uninterrupted run's losses and parameters.
* The collective backend rule: gloo on the CPU, a raise for a gang on
  cards with no card, and ranks per host against the host's cards.

Each test runs under a time limit of its own (``LIMIT_S``).
"""
import os

import jax
import numpy as np
import pytest
import torch

import raydp_tpu_torch
import raydp_tpu_torch.dataframe as torch_rdf
from raydp_tpu.data import MLDataset as JaxMLDataset
from raydp_tpu.models import MLP as JaxMLP
from raydp_tpu.train.spmd_fit import fit_spmd as jax_fit_spmd
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.parallel import MeshSpec
from raydp_tpu_torch.store import shm
from raydp_tpu_torch.store.object_store import ObjectRef
from raydp_tpu_torch.train import Estimator, fit_spmd
from test_spmd_fit import _ds, _make_estimator as jax_make_estimator
from torch_port_cases import time_limit

GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
RANK_RTOL = 1e-6
EPOCHS = 10
LIMIT_S = 120


def _jax_init_params():
    """The JAX estimator's initial parameters: ``model.init`` with
    ``PRNGKey(seed)`` on one row (an MLP's depend only on its shape)."""
    params = JaxMLP(hidden=(16,), out_dim=1).init(
        jax.random.PRNGKey(0), np.zeros((1, 2), np.float32))["params"]
    return params_from_flax(jax.tree_util.tree_map(np.asarray, params))


def _factory(init, epochs=EPOCHS, checkpoint_dir=None, kill_marker=None):
    """The port's counterpart of ``tests/test_spmd_fit.py``'s factory.
    With ``kill_marker``, rank 1 SIGKILLs itself at the end of epoch 1
    once (the marker file records that it did)."""
    def make_estimator():
        import signal

        import torch.distributed as dist

        model = raydp_tpu_torch.MLP(2, hidden=(16,), out_dim=1, device="cpu")
        model.load_state_dict(init)
        est = Estimator(
            model=model,
            optimizer=lambda p: torch.optim.Adam(p, lr=3e-2),
            loss="mse", num_epochs=epochs, batch_size=128,
            feature_columns=["a", "b"], label_column="y",
            mesh=MeshSpec(dp=dist.get_world_size()), seed=0, shuffle=False,
            epoch_mode="stream", checkpoint_dir=checkpoint_dir,
            device="cpu")
        if kill_marker is not None and dist.get_rank() == 1:
            finish = est._finish_epoch

            def finish_then_die(epoch, *args, **kwargs):
                out = finish(epoch, *args, **kwargs)
                if epoch == 1 and not os.path.exists(kill_marker):
                    open(kill_marker, "w").close()
                    os.kill(os.getpid(), signal.SIGKILL)
                return out

            est._finish_epoch = finish_then_die
        return est

    return make_estimator


def _port_ds(shards=2):
    _, pdf = _ds(shards=shards)
    return MLDataset.from_df(torch_rdf.from_pandas(pdf, num_partitions=4),
                             num_shards=shards)


def _assert_ranks_agree(out):
    history = out["history"]
    for other in out["per_rank_history"][1:]:
        assert [h["epoch"] for h in other] == [h["epoch"] for h in history]
        np.testing.assert_allclose([h["train_loss"] for h in other],
                                   [h["train_loss"] for h in history],
                                   rtol=RANK_RTOL)
    assert len(set(out["per_rank_params_sha256"])) == 1


@pytest.fixture(scope="module")
def in_memory():
    """One 2-rank CPU fit of the port, shared by the tests that hold it
    against the JAX package and the port's other modes."""
    init = _jax_init_params()
    with time_limit(LIMIT_S):
        return init, fit_spmd(_factory(init), _port_ds(), world_size=2,
                              device="cpu")


def test_fit_spmd_matches_jax_package(in_memory):
    init, out = in_memory
    df, _ = _ds()
    with time_limit(LIMIT_S):
        want = jax_fit_spmd(jax_make_estimator,
                            JaxMLDataset.from_df(df, num_shards=2),
                            world_size=2, env={"JAX_PLATFORMS": "cpu"})
    assert out["world_size"] == want["world_size"] == 2
    assert out["restarts"] == want["restarts"] == 0
    assert out["backend"] == "gloo"
    got_loss = [h["train_loss"] for h in out["history"]]
    want_loss = [h["train_loss"] for h in want["history"]]
    assert len(got_loss) == len(want_loss) == EPOCHS
    np.testing.assert_allclose(got_loss, want_loss, **GRAD_TOL)
    assert got_loss[-1] < got_loss[0] and got_loss[-1] < 1.0
    want_params = params_from_flax(  # the rank's variables dict
        jax.tree_util.tree_map(np.asarray, want["params"]["params"]))
    assert set(out["params"]) == set(want_params)
    for name, w in want_params.items():
        np.testing.assert_allclose(out["params"][name], w.numpy(),
                                   err_msg=name, **GRAD_TOL)
    _assert_ranks_agree(out)
    for h in out["history"]:
        assert h["samples"] == 512  # the rank's own rows
        assert h["step_ms"] > 0 and 0 < h["allreduce_ms"] < h["step_ms"]
    assert "first_step_at" in out["history"][0]


def test_fit_spmd_store_mode_on_port_session(in_memory):
    init, memory = in_memory
    session = raydp_tpu_torch.init(app_name="port-spmd-fit", num_workers=2,
                                   memory_per_worker="256MB")
    namespace = session.cluster.namespace
    try:
        with time_limit(LIMIT_S):
            ds = _port_ds()
            assert all(isinstance(b, ObjectRef) for b in ds.blocks)
            out = fit_spmd(_factory(init), ds, world_size=2, device="cpu")
            # The ranks read their slices; the driver read no block.
            assert all(isinstance(b, ObjectRef) for b in ds.blocks)
    finally:
        raydp_tpu_torch.stop()
    assert shm.list_segments(f"rdp-{namespace}-") == []
    _assert_ranks_agree(out)
    np.testing.assert_allclose([h["train_loss"] for h in out["history"]],
                               [h["train_loss"] for h in memory["history"]],
                               rtol=RANK_RTOL)
    for name, p in memory["params"].items():
        np.testing.assert_allclose(out["params"][name], p, rtol=RANK_RTOL,
                                   err_msg=name)


def test_fit_spmd_world_size_mismatch():
    with pytest.raises(ValueError, match="num_shards == world_size"):
        fit_spmd(_factory(_jax_init_params()), _port_ds(), world_size=4,
                 device="cpu")


def test_fit_spmd_defaults_to_the_card(monkeypatch):
    """``device`` defaults to ``"cuda"``: with no card the call raises
    before a rank starts, never falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_spmd(_factory(_jax_init_params()), _port_ds(), world_size=2)


def test_fit_spmd_elastic_and_wide_mesh_not_ported():
    """``elastic=True`` is ported (``tests/test_torch_fault_tolerance.py``
    runs it): it lifts the shard/world check but still validates
    ``min_world_size``. A mesh wider than data parallel is ported
    (``tests/test_torch_mesh_estimator.py``), but not elastic: a wide
    mesh with ``elastic=True`` raises, as does a world other than its
    size."""
    with pytest.raises(ValueError, match="min_world_size must be >= 1"):
        fit_spmd(_factory(_jax_init_params()), _port_ds(), world_size=1,
                 elastic=True, min_world_size=0, device="cpu")
    for axes in ({"tp": 2}, {"pp": 2}, {"sp": 2}):
        assert MeshSpec(**axes).size == 2
        with pytest.raises(ValueError, match="elastic fit runs data"):
            fit_spmd(_factory(_jax_init_params()), _port_ds(), world_size=2,
                     elastic=True, mesh=MeshSpec(**axes), device="cpu")
        with pytest.raises(ValueError, match="!= mesh size"):
            fit_spmd(_factory(_jax_init_params()), _port_ds(), world_size=4,
                     mesh=MeshSpec(**axes), device="cpu")
    assert MeshSpec(dp=4).size == 4 and MeshSpec.auto_from(2).dp == 2


def test_mesh_larger_than_the_world_raises():
    est = Estimator(model=raydp_tpu_torch.MLP(2, hidden=(4,), out_dim=1,
                                              device="cpu"),
                    feature_columns=["a", "b"], label_column="y",
                    mesh=MeshSpec(dp=2), device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices but only 1"):
        est.fit(_port_ds(shards=1))


def test_fit_spmd_checkpointing_and_restore(tmp_path):
    """Every rank enters ``save``; rank 0 writes, and the gang's
    checkpoint restores in a fresh single-process estimator with the
    gang's parameters."""
    ckpt = str(tmp_path / "ck")
    init = _jax_init_params()
    with time_limit(LIMIT_S):
        out = fit_spmd(_factory(init, epochs=2, checkpoint_dir=ckpt),
                       _port_ds(), world_size=2, device="cpu", timeout=300)
    assert len(out["history"]) == 2
    steps = sorted(p for p in os.listdir(ckpt) if p.startswith("step_"))
    assert steps == ["step_0.pt", "step_1.pt"]
    state = torch.load(os.path.join(ckpt, "step_1.pt"), weights_only=True)
    assert len(state["rank_generators"]) == 2
    est = Estimator(model=raydp_tpu_torch.MLP(2, hidden=(16,), out_dim=1,
                                              device="cpu"),
                    optimizer=lambda p: torch.optim.Adam(p, lr=3e-2),
                    loss="mse", feature_columns=["a", "b"],
                    label_column="y", device="cpu")
    est.restore(ckpt, step=1, sample_x=np.zeros((1, 2), np.float32))
    restored = est.get_model().state_dict()
    for name, p in out["params"].items():
        assert torch.equal(restored[name], torch.from_numpy(p)), name


def test_fit_spmd_relaunches_after_a_rank_dies(tmp_path, in_memory):
    """Rank 1 is SIGKILLed after epoch 1's checkpoint: one supervised
    relaunch resumes from ``step_1.pt`` and ends where the uninterrupted
    fit of the same epochs ends."""
    init, straight = in_memory
    ckpt, marker = str(tmp_path / "ck"), str(tmp_path / "killed")
    with time_limit(LIMIT_S):
        out = fit_spmd(
            _factory(init, checkpoint_dir=ckpt, kill_marker=marker),
            _port_ds(), world_size=2, device="cpu", checkpoint_dir=ckpt,
            restart_backoff_s=0.1)
    assert os.path.exists(marker)
    assert out["restarts"] == 1
    assert [h["epoch"] for h in out["history"]] == list(range(2, EPOCHS))
    np.testing.assert_allclose(
        [h["train_loss"] for h in out["history"]],
        [h["train_loss"] for h in straight["history"][2:]], rtol=RANK_RTOL)
    for name, p in straight["params"].items():
        np.testing.assert_allclose(out["params"][name], p, rtol=RANK_RTOL,
                                   err_msg=name)
    _assert_ranks_agree(out)


_CLIENT_FIT = """
import json, sys
import numpy as np, pandas as pd, torch
import torch.distributed as dist
import raydp_tpu_torch
import raydp_tpu_torch.dataframe as rdf
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.parallel import MeshSpec
from raydp_tpu_torch.train import Estimator, fit_spmd

def make_estimator():
    return Estimator(
        model=raydp_tpu_torch.MLP(2, hidden=(8,), out_dim=1, device="cpu"),
        optimizer=lambda p: torch.optim.Adam(p, lr=1e-2), loss="mse",
        num_epochs=2, batch_size=64, feature_columns=["a", "b"],
        label_column="y", mesh=MeshSpec(dp=dist.get_world_size()), seed=0,
        shuffle=False, epoch_mode="stream", device="cpu")

s = raydp_tpu_torch.connect(sys.argv[1])
rng = np.random.default_rng(0)
pdf = pd.DataFrame({"a": rng.normal(size=256), "b": rng.normal(size=256)})
pdf["y"] = pdf["a"] - pdf["b"]
ds = MLDataset.from_df(rdf.from_pandas(pdf, num_partitions=2), num_shards=1)
out = fit_spmd(make_estimator, ds, world_size=1, device="cpu")
print(json.dumps({"job_id": out["job_id"],
                  "epochs_s": sum(h["time_s"] for h in out["history"]),
                  "usage": s.cluster.usage_report()}))
raydp_tpu_torch.stop()
"""


def test_session_bills_every_fit_and_every_launch(tmp_path, monkeypatch):
    """Two fits in one session, the second relaunched after a rank dies,
    and a third from a second driver (``connect`` in a subprocess): the
    session's ``usage_report()`` bills each fit's job. A fit's chip-
    seconds equal its ranks' epochs (each epoch bills its own interval,
    and shipping loses nothing), and lie inside the world times the fit's
    ``run()`` on the driver's clock; the relaunched fit also bills its
    first launch. The exposition renders the ranks' counters but lists
    no rank as a worker, and no rank is a dead worker of the session."""
    import json
    import subprocess
    import sys
    import time

    from raydp_tpu_torch.telemetry import accounting

    # No ambient job (an earlier test's may linger in this process): each
    # fit is an accounting root of its own.
    monkeypatch.setattr(accounting, "_process_job", None)
    init = _jax_init_params()
    marker = str(tmp_path / "killed")
    session = raydp_tpu_torch.init(app_name="port-spmd-bill", num_workers=1,
                                   memory_per_worker="256MB")
    namespace = session.cluster.namespace
    try:
        with time_limit(LIMIT_S):
            cl = session.cluster
            t0 = time.perf_counter()
            first = fit_spmd(_factory(init, epochs=2), _port_ds(shards=1),
                             world_size=1, device="cpu")
            first_s = time.perf_counter() - t0
            second = fit_spmd(_factory(init, epochs=2, kill_marker=marker),
                              _port_ds(), world_size=2, device="cpu",
                              restart_backoff_s=0.1)
            proc = subprocess.run(
                [sys.executable, "-c", _CLIENT_FIT, cl.master.address],
                capture_output=True, text=True, timeout=90,
                cwd=os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__))))
            assert proc.returncode == 0, proc.stderr[-2000:]
            remote = json.loads(proc.stdout.strip().splitlines()[-1])
            usage = cl.usage_report()["jobs"]
            view = cl.metrics_snapshot()
            text = cl.prometheus_metrics()
            dead = cl.health_report()["dead_workers"]
    finally:
        raydp_tpu_torch.stop()
    assert shm.list_segments(f"rdp-{namespace}-") == []

    def billed(jobs, out):
        return jobs[out["job_id"]]["usage"]["chip_seconds"]

    ids = {first["job_id"], second["job_id"], remote["job_id"]}
    assert len(ids) == 3
    epochs_s = sum(h["time_s"] for h in first["history"])
    assert billed(usage, first) == epochs_s
    assert 0 < epochs_s <= first["run_s"] <= first_s
    assert usage[remote["job_id"]]["usage"]["chip_seconds"] == (
        remote["epochs_s"])
    # The second driver reads the bill the session's driver reads.
    for job_id in ids:
        assert remote["usage"]["jobs"].get(job_id, usage[job_id]) == (
            usage[job_id])
    assert second["restarts"] == 1 and os.path.exists(marker)
    final = sum(h["time_s"] for hist in second["per_rank_history"]
                for h in hist)
    assert final <= 2 * second["run_s"]
    # The killed launch's rank 0 shipped its epochs on its last Ping.
    assert billed(usage, second) > final
    gangs = view["gangs"]
    fit_key = next(k for k in gangs
                   if k.startswith(second["job_id"] + "/")).rsplit(
        "/launch-", 1)[0]
    assert {f"{fit_key}/launch-0/rank-0", f"{fit_key}/launch-1/rank-0",
            f"{fit_key}/launch-1/rank-1"} <= set(gangs)
    for key in gangs:
        assert key not in view["workers"] and key not in dead
        assert f'raydp_worker_up{{worker="{key}"}}' not in text
    for job_id in ids:
        assert f'raydp_job_chip_seconds_total{{job="{job_id}"' in text


def test_collective_backend_rule_on_the_cpu(monkeypatch):
    """Gloo for a gang on the CPU; a gang on cards with no card on the
    host raises rather than falling back to the CPU."""
    from raydp_tpu_torch.spmd.worker_main import collective_backend

    assert collective_backend(2, "cpu") == "gloo"
    assert collective_backend(1, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collective_backend(1, "cuda")


@pytest.mark.parametrize(
    "hosts,procs_per_node,world,cards,backend",
    [
        # Two hosts of four cards, four ranks each: a card a rank.
        (["10.0.0.1", "10.0.0.2"], 4, 8, 4, "nccl"),
        # The same gang on hosts of two cards: ranks share them.
        (["10.0.0.1", "10.0.0.2"], 4, 8, 2, "gloo"),
        # One host, one slot a host: the ranks wrap round onto it.
        (["127.0.0.1"], 1, 4, 4, "nccl"),
        (["127.0.0.1"], 1, 2, 1, "gloo"),
    ],
    ids=["2x4-on-4-cards", "2x4-on-2-cards", "1-host-wrap-4-cards",
         "1-host-wrap-1-card"])
def test_collective_backend_rule_counts_ranks_per_host(
        monkeypatch, hosts, procs_per_node, world, cards, backend):
    """The rule compares the ranks on a host, not the gang, with the
    host's cards, and every rank of the gang reaches the same choice;
    local ranks are distinct on each host, so each rank's card is its
    own where the rule picks NCCL."""
    from raydp_tpu_torch.spmd.job import host_layout
    from raydp_tpu_torch.spmd.worker_main import (
        SPMDWorkerContext,
        collective_backend,
    )

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    layout = host_layout(world, hosts, procs_per_node)
    assert [collective_backend(lw, "cuda") for _, lw in layout] == (
        [backend] * world)
    per_host = {}
    for r, (local_rank, local_world) in enumerate(layout):
        host = hosts[(r // procs_per_node) % len(hosts)]
        per_host.setdefault(host, []).append((local_rank, local_world))
        ctx = SPMDWorkerContext("t", r, world, local_rank, host, "x:1",
                                local_world_size=local_world)
        assert ctx.device("cuda") == f"cuda:{local_rank % cards}"
    for places in per_host.values():
        assert sorted(lr for lr, _ in places) == list(range(len(places)))
        assert {lw for _, lw in places} == {len(places)}
