"""The port's fault tolerance of training (``raydp_tpu_torch/fault``,
``train/estimator.py``'s drain, ``train/spmd_fit.py``'s supervisor,
``spmd/job.py``'s ``request_preemption``) against the JAX package's,
mirroring ``tests/test_fault_tolerance.py`` on the CPU with gloo.

* The grammar and hook cases of ``tests/test_fault_tolerance.py`` run
  against the port (``test_reference_case_on_port``), its ``job=`` scope
  case on the port's accounting plane, but for one: its gRPC case checks
  a gRPC status the port's standard-library RPC does not have
  (``tests/test_torch_rpc.py`` holds the port's dropped call).
* The gang cases, with a torch factory (``MLP(hidden=(16,), out_dim=1)``
  from the JAX model's initial parameters, Adam 3e-2, batch 128 a rank,
  1,024 rows, no shuffle): a rank killed at a checkpoint step and
  recovered, at world 1 and at world 2 (the port's gloo runs 2 CPU
  ranks), equal to a clean run under ``torch.equal``; an injected
  preemption drained to ``step_emergency_3.pt`` with the two counters;
  a notice that reaches the ranks a step apart, drained by both after
  the same step; an emergency checkpoint of a 2-rank gang resumed
  elastically on one rank (the skip rescaled); a registration shortfall
  that shrinks the gang 2 -> 1; the budget error; and
  ``SPMDJob.request_preemption()`` on a running 2-rank gang.
* The port's world-1 run, killed and resumed, against the JAX package's
  uninterrupted in-process fit of the same rows from the same initial
  parameters, within the f32 gradient bound (rtol 1e-3 / atol 1e-4).

Each gang test runs under a time limit of its own (``LIMIT_S``).
"""
import os
import re
import shutil
import threading
import time

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import raydp_tpu.dataframe as jax_rdf
import raydp_tpu_torch
import raydp_tpu_torch.dataframe as torch_rdf
from raydp_tpu.data import MLDataset as JaxMLDataset
from raydp_tpu.models import MLP as JaxMLP
from raydp_tpu_torch import fault
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.parallel import MeshSpec
from raydp_tpu_torch.spmd.job import SPMDJobError
from raydp_tpu_torch.train import Estimator, fit_spmd
from raydp_tpu_torch.utils.profiling import metrics
from test_fault_tolerance import _factory as jax_factory
from torch_port_cases import cases, load_port_module, run_case, time_limit

REFERENCE_NAMES = (
    "test_plan_parses_every_kind", "test_plan_job_targeting",
    "test_job_targeted_clause_fires_only_in_matching_scope",
    "test_plan_rejects_malformed",
    "test_plan_prob_arming_is_seed_deterministic",
    "test_rpc_drop_fires_on_nth_call_only", "test_rpc_delay_sleeps_once",
    "test_heartbeat_stall_window", "test_preemption_request_and_drain")
PORT_REFERENCE = load_port_module("test_fault_tolerance.py",
                                  only=REFERENCE_NAMES)
REFERENCE_CASES = cases(PORT_REFERENCE, REFERENCE_NAMES)

GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
LIMIT_S = 90
ROWS, BATCH = 1024, 128


@pytest.fixture(autouse=True)
def _clean_fault_state(monkeypatch):
    monkeypatch.delenv(fault.FAULT_PLAN_ENV, raising=False)
    monkeypatch.delenv(fault.FAULT_SEED_ENV, raising=False)
    fault.reset_for_tests()
    yield
    fault.reset_for_tests()


@pytest.mark.parametrize("name,params",
                         [(n, p) for _, n, p in REFERENCE_CASES],
                         ids=[i for i, _, _ in REFERENCE_CASES])
def test_reference_case_on_port(name, params, request):
    run_case(PORT_REFERENCE, name, params, request)


def test_train_step_hooks_are_silent_without_a_plan():
    assert not fault.active()
    assert fault.on_train_step(1) is False
    assert fault.on_heartbeat(0, rank=0) is False
    fault.on_task("w-0", 0)
    assert not fault.preemption_requested()


def test_train_step_hook_kills_and_preempts(monkeypatch):
    """``kill rank=N,step=K`` fires on rank N only; ``preempt`` without
    ``rank=`` reports that every rank got it, with ``rank=`` not."""
    died = []
    monkeypatch.setattr(fault.inject, "_die",
                        lambda c, what: died.append((c.code, what)))
    monkeypatch.setenv(fault.FAULT_PLAN_ENV,
                       "kill:rank=1,step=2,code=9;preempt:step=3,grace=0")
    fault.on_train_step(2, rank=0)
    assert died == []
    fault.on_train_step(2, rank=1)
    assert died == [(9, "rank 1 at train step 2")]
    assert fault.on_train_step(3, rank=0) is True
    assert fault.preemption_requested()
    fault.reset_for_tests()
    monkeypatch.setenv(fault.FAULT_PLAN_ENV, "preempt:rank=1,step=3,grace=0")
    assert fault.on_train_step(3, rank=0) is False
    assert not fault.preemption_requested()
    monkeypatch.setenv("RAYDP_SPMD_RANK", "1")
    assert fault.ambient_rank() == 1
    assert fault.on_train_step(3) is False  # rank-targeted: not gang-wide
    assert fault.preemption_requested()


def test_task_hook_kills_the_named_worker_at_its_task(monkeypatch):
    died = []
    monkeypatch.setattr(fault.inject, "_die",
                        lambda c, what: died.append(what))
    monkeypatch.setenv(fault.FAULT_PLAN_ENV, "kill:worker=w-1,task=2")
    for i in range(4):
        fault.on_task("w-0", i)
    fault.on_task("w-1", 1)
    assert died == []
    fault.on_task("w-1", 2)
    fault.on_task("w-1", 2)  # fires once a process
    assert died == ["worker w-1 at task 2"]


def test_job_targeted_clause_never_fires_without_the_accounting_plane(
        monkeypatch):
    """A ``job=`` clause fires only inside the job it names: with no
    ``tenant-a`` job active it never fires, as in the JAX package."""
    monkeypatch.setenv(fault.FAULT_PLAN_ENV,
                       "preempt:job=tenant-a,step=2,grace=0")
    fault.on_train_step(2)
    assert not fault.preemption_requested()


# -- the supervised gang -----------------------------------------------------

def _jax_init_params():
    params = JaxMLP(hidden=(16,), out_dim=1).init(
        jax.random.PRNGKey(0), np.zeros((1, 2), np.float32))["params"]
    return params_from_flax(jax.tree_util.tree_map(np.asarray, params))


INIT = _jax_init_params()


def _factory(ckpt_dir=None, num_epochs=2, save_every_steps=0,
             init=INIT):
    """The port's counterpart of ``tests/test_fault_tolerance.py``'s
    factory, run in each rank."""
    def make_estimator():
        import torch.distributed as dist

        model = raydp_tpu_torch.MLP(2, hidden=(16,), out_dim=1, device="cpu")
        model.load_state_dict(init)
        world = dist.get_world_size() if dist.is_initialized() else 1
        return Estimator(
            model=model, optimizer=lambda p: torch.optim.Adam(p, lr=3e-2),
            loss="mse", num_epochs=num_epochs, batch_size=BATCH,
            feature_columns=["a", "b"], label_column="y",
            mesh=MeshSpec(dp=world), seed=0, shuffle=False,
            epoch_mode="stream", checkpoint_dir=ckpt_dir,
            save_every_steps=save_every_steps, device="cpu")

    return make_estimator


def _pdf(n=ROWS):
    """``tests/test_fault_tolerance.py``'s rows."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(n)
    b = rng.standard_normal(n)
    return pd.DataFrame({"a": a, "b": b, "y": 2 * a - 3 * b + 1})


def _ds(shards, n=ROWS):
    return MLDataset.from_df(torch_rdf.from_pandas(_pdf(n),
                                                   num_partitions=4),
                             num_shards=shards)


def _fit(ckpt, world, plan=None, **kwargs):
    env = {fault.FAULT_PLAN_ENV: plan} if plan else None
    kwargs.setdefault("restart_backoff_s", 0.1)
    return fit_spmd(_factory(ckpt, save_every_steps=2), _ds(world),
                    world_size=world, env=env, timeout=120,
                    checkpoint_dir=ckpt, device="cpu", **kwargs)


def _assert_params_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(torch.from_numpy(got[name]),
                           torch.from_numpy(want[name])), name


def _drained_steps(failure):
    return [int(s) for s in re.findall(r"preempted at step (\d+)",
                                       failure["error"])]


@pytest.fixture(scope="module")
def clean_runs(tmp_path_factory):
    """Uninterrupted fits at world 1 and world 2, shared by the tests
    that hold a recovered run against them."""
    root = tmp_path_factory.mktemp("clean")
    with time_limit(2 * LIMIT_S):
        return {w: _fit(str(root / f"w{w}"), w) for w in (1, 2)}


@pytest.fixture(scope="module")
def killed_world1(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("kill1"))
    with time_limit(LIMIT_S):
        return ckpt, _fit(ckpt, 1, "kill:rank=0,step=4")


@pytest.mark.parametrize("world", [1, 2])
def test_rank_kill_recovers_equal_to_a_clean_run(world, clean_runs,
                                                 killed_world1, tmp_path):
    """The last rank is killed at step 4, right after ``step_mid_4.pt``
    commits: one relaunch resumes there (nothing replayed) and ends with
    the clean run's last-epoch loss and bit-equal parameters (same data
    order, optimizer state and generator restored). The first epoch of
    the resumed run is partial."""
    if world == 1:
        ckpt, out = killed_world1
    else:
        ckpt = str(tmp_path / "ck")
        with time_limit(LIMIT_S):
            out = _fit(ckpt, 2, "kill:rank=1,step=4")
    clean = clean_runs[world]
    assert clean["restarts"] == 0 and out["restarts"] == 1
    assert os.path.exists(os.path.join(ckpt, "step_mid_4.pt"))
    (failure,) = out["failures"]
    assert "exited with code 23" in failure["error"]
    assert not failure["preempted"] and failure["world_size"] == world
    assert out["history"][-1]["train_loss"] == (
        clean["history"][-1]["train_loss"])
    _assert_params_equal(out["params"], clean["params"])
    assert len(set(out["per_rank_params_sha256"])) == 1


def test_killed_and_resumed_fit_matches_the_jax_package(killed_world1):
    """The port's killed-and-resumed world-1 run against the JAX
    package's uninterrupted in-process fit of the same rows (its model's
    initial parameters carried across), within the f32 gradient bound."""
    _, out = killed_world1
    est = jax_factory(None)()
    with time_limit(LIMIT_S):
        want = est.fit(JaxMLDataset.from_df(
            jax_rdf.from_pandas(_pdf(), num_partitions=2), num_shards=1))
    np.testing.assert_allclose(out["history"][-1]["train_loss"],
                               want[-1]["train_loss"], **GRAD_TOL)
    want_params = params_from_flax(jax.tree_util.tree_map(  # the variables
        np.asarray, est._state.params["params"]))
    for name, w in want_params.items():
        np.testing.assert_allclose(out["params"][name], w.numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("world", [1, 2])
def test_preemption_drains_an_emergency_checkpoint(world, clean_runs,
                                                   tmp_path):
    """``preempt:step=3,grace=0`` reaches every rank at step 3: all drain
    there to ``step_emergency_3.pt`` (the writing world and the exact
    position in it), the supervisor counts a preemption and a restart,
    and the resumed run ends equal to the clean one."""
    before = metrics.snapshot().get("counters", {})
    ckpt = str(tmp_path / "ck")
    with time_limit(LIMIT_S):
        out = _fit(ckpt, world, "preempt:step=3,grace=0")
    path = os.path.join(ckpt, "step_emergency_3.pt")
    state = torch.load(path, weights_only=True)
    assert (state["data_world"], state["data_epoch"],
            state["data_batch"]) == (world, 0, 3)
    assert out["restarts"] == 1
    (failure,) = out["failures"]
    assert failure["preempted"]
    assert _drained_steps(failure) == [3] * world
    after = metrics.snapshot()["counters"]
    for name in ("preemptions/total", "restarts/total"):
        assert after[name] - before.get(name, 0) == 1, name
    _assert_params_equal(out["params"], clean_runs[world]["params"])


def test_uneven_notice_drains_both_ranks_after_the_same_step(clean_runs,
                                                             tmp_path):
    """Rank 0's notice lands at step 2, rank 1's at step 3: rank 0's
    rides step 3's gradient exchange, so both drain after step 3 (a
    rank alone in ``save`` would hang the gang) and one emergency
    checkpoint is written."""
    ckpt = str(tmp_path / "ck")
    with time_limit(LIMIT_S):
        out = _fit(ckpt, 2, "preempt:rank=0,step=2,grace=0;"
                            "preempt:rank=1,step=3,grace=0")
    (failure,) = out["failures"]
    assert _drained_steps(failure) == [3, 3]
    assert [n for n in os.listdir(ckpt) if "emergency" in n] == [
        "step_emergency_3.pt"]
    _assert_params_equal(out["params"], clean_runs[2]["params"])


def test_elastic_resume_resharded(tmp_path):
    """``tests/test_fault_tolerance.py``'s elastic case: a checkpoint of
    an in-process fit over 2 shards restores into a 1-rank gang fed the
    same blocks re-planned over 1 shard; no epochs remain, so the gang's
    parameters equal the fit's. Strict mode still rejects the
    mismatch."""
    ds = _ds(2)
    ckpt = str(tmp_path / "ck")
    est = _factory(ckpt)()
    est.fit(ds)
    local = {k: v.detach().numpy() for k, v in
             est.get_model().state_dict().items()}
    with pytest.raises(ValueError, match="num_shards == world_size"):
        fit_spmd(_factory(ckpt), ds, world_size=1, device="cpu")
    with time_limit(LIMIT_S):
        small = fit_spmd(_factory(ckpt), ds, world_size=1, elastic=True,
                         timeout=120, checkpoint_dir=ckpt, device="cpu")
    assert small["world_size"] == 1 and small["restarts"] == 0
    _assert_params_equal(small["params"], local)


def test_elastic_resume_rescales_a_two_rank_emergency_checkpoint(tmp_path):
    """A 2-rank gang drained at step 3 (3 of its 4 per-rank batches of
    epoch 0); its emergency checkpoint, alone in a fresh directory,
    resumes on one rank over the same 2-shard dataset: the skip becomes
    6 of the 8 batches at world 1, so epoch 0 trains 2 batches."""
    ckpt = str(tmp_path / "ck")
    with time_limit(LIMIT_S):
        with pytest.raises(SPMDJobError, match="PreemptionError"):
            fit_spmd(_factory(ckpt, num_epochs=1), _ds(2), world_size=2,
                     env={fault.FAULT_PLAN_ENV: "preempt:step=3,grace=0"},
                     timeout=120, checkpoint_dir=ckpt, max_restarts=0,
                     device="cpu")
        fresh = str(tmp_path / "fresh")
        os.makedirs(fresh)
        shutil.copy(os.path.join(ckpt, "step_emergency_3.pt"), fresh)
        out = fit_spmd(_factory(fresh, num_epochs=1), _ds(2), world_size=1,
                       elastic=True, timeout=120, checkpoint_dir=fresh,
                       device="cpu")
    assert out["world_size"] == 1 and out["restarts"] == 0
    (epoch,) = out["history"]
    assert epoch["samples"] == (ROWS // BATCH - 6) * BATCH
    assert np.isfinite(epoch["train_loss"])


@pytest.mark.parametrize("min_world,want_world", [(1, 1), (2, 2)])
def test_registration_shortfall_shrinks_the_gang(monkeypatch, tmp_path,
                                                 min_world, want_world):
    """The first launch of 2 ranks reports only 1 registered: with
    ``min_world_size=1`` the relaunch runs 1 rank over the same blocks
    re-planned; with ``min_world_size=2`` it keeps 2."""
    import raydp_tpu_torch.spmd as spmd

    real = spmd.create_spmd_job
    made = []

    def create(**kwargs):
        job = real(**kwargs)
        made.append(kwargs["world_size"])
        if len(made) == 1:
            def short_start():
                del job.start  # the relaunch starts for real
                job.last_registered = 1
                raise SPMDJobError(
                    f"job {job.job_name}: only 1/2 ranks registered "
                    "within 60s (stubbed)")
            job.start = short_start
        return job

    monkeypatch.setattr(spmd, "create_spmd_job", create)
    with time_limit(LIMIT_S):
        out = fit_spmd(_factory(num_epochs=1), _ds(2), world_size=2,
                       elastic=True, min_world_size=min_world, timeout=120,
                       restart_backoff_s=0.1, device="cpu")
    assert out["restarts"] == 1 and out["world_size"] == want_world
    # A new world makes a new job; the same world reuses the first.
    assert made == ([2, 1] if want_world == 1 else [2])
    assert out["history"][0]["samples"] == ROWS // want_world


def test_restart_budget_exhausts_and_names_the_last_failure(tmp_path):
    """A kill that fires in every incarnation (step 1 is behind no
    checkpoint) spends the budget; the error names the last failure."""
    with time_limit(LIMIT_S):
        with pytest.raises(SPMDJobError, match="restart budget exhausted"
                           r"(.|\n)*rank 0 exited with code 23"):
            fit_spmd(_factory(None, num_epochs=1), _ds(1, n=512),
                     world_size=1,
                     env={fault.FAULT_PLAN_ENV: "kill:rank=0,step=1"},
                     timeout=120, max_restarts=1, restart_backoff_s=0.1,
                     device="cpu")


def _train_until_preempted(ctx, tables, ckpt):
    """A gang function: join the group and train for far longer than the
    test waits (it ends by a preemption notice)."""
    ctx.init_distributed(device="cpu")
    est = _factory(ckpt, num_epochs=10_000)()
    est.fit(MLDataset(list(tables), num_shards=1))


def test_request_preemption_drains_a_running_gang(tmp_path):
    """``SPMDJob.request_preemption()`` on a 2-rank gang mid-fit: both
    ranks drain after the same step into one emergency checkpoint, and
    the call returns at once."""
    from raydp_tpu_torch.spmd import create_spmd_job

    ckpt = str(tmp_path / "ck")
    ds = _ds(2)
    job = create_spmd_job(job_name="preempt-test", world_size=2,
                          timeout=60.0)
    job.start()
    outcome = {}

    def run():
        try:
            job.run(_train_until_preempted, timeout=120,
                    per_rank_args=[(ds.shard_tables(r), ckpt)
                                   for r in range(2)])
        except SPMDJobError as exc:
            outcome["error"] = str(exc)

    try:
        with time_limit(LIMIT_S):
            runner = threading.Thread(target=run, daemon=True)
            runner.start()
            while not os.path.exists(os.path.join(ckpt, "step_0.pt")):
                time.sleep(0.05)  # an epoch done: the ranks are training
            t0 = time.perf_counter()
            job.request_preemption()
            notice_s = time.perf_counter() - t0
            runner.join()
    finally:
        job.stop()
    assert notice_s < 5.0
    steps = _drained_steps(outcome)
    assert len(steps) == 2 and steps[0] == steps[1]
    assert [n for n in os.listdir(ckpt) if "emergency" in n] == [
        f"step_emergency_{steps[0]}.pt"]
    state = torch.load(os.path.join(ckpt, f"step_emergency_{steps[0]}.pt"),
                       weights_only=True)
    assert state["step"] == steps[0] and state["data_world"] == 2
