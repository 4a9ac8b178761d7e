"""A model-parallel mesh in the port's elastic ``fit_spmd``
(``raydp_tpu_torch/train/spmd_fit.py``) against the JAX package's
elastic resume (``raydp_tpu/train/spmd_fit.py:20-22, 141-146, 376-396``;
``tests/test_fault_tolerance.py:330-385``).

A shrink drops whole dp rows: pp, sp and tp are fixed, so a shortfall of
G of W ranks relaunches on the largest multiple of ``pp·sp·tp`` at most
G, on the same mesh with a smaller dp. The relaunch restores the newest
gathered checkpoint cut onto the smaller mesh and rescales the resume
position from the checkpoint's dp. The port's ranks are gloo CPU gangs
started by ``fit_spmd`` (a dp2·tp2 launch of 4 ranks and two tp2
launches of 2); the JAX side runs jitted on the conftest's virtual CPU
devices. Cases:

* (a) a ``JAXEstimator(mesh=MeshSpec(dp=2, tp=2))`` fit's orbax
  checkpoint, converted by ``tests/torch_orbax_convert.py``, resumes
  through ``fit_spmd(mesh=MeshSpec(tp=2), elastic=True)`` over its
  2-shard dataset with no epochs left: the JAX fit's parameters at rtol
  1e-6 (``test_fit_spmd_elastic_resume_resharded`` on a mesh);
* (b) a port dp2·tp2 fit preempted mid-epoch leaves a gathered
  emergency checkpoint; a second elastic fit's first launch is stubbed
  to "only 2/4 ranks registered", and the relaunch on tp2 finishes over
  the dataset re-planned over dp 1, its skip rescaled from dp 2. Its
  epoch history is held against the JAX package's resume of the same
  state on ``MeshSpec(tp=2)`` (saved as a 2-process world wrote it, as
  ``test_checkpoint_records_world_and_rescales_resume`` does) at rtol
  1e-4, and its parameters at ``tests/test_torch_mesh_estimator.py``'s
  bounds (rtol 1e-4 / atol 1e-5; the key bias, whose gradient is zero
  in exact arithmetic, within 2·lr·steps);
* (c) the validation: a shortfall under ``pp·sp·tp`` ranks fails the
  launch, counted against the restart budget, with an error that names
  the mesh; the resized world is always a multiple of ``pp·sp·tp``; a
  factory whose estimator is not on the launch's mesh fails its ranks.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import raydp_tpu_torch.spmd as spmd
from raydp_tpu.data.ml_dataset import MLDataset as JaxMLDataset
from raydp_tpu.models import transformer as jt
from raydp_tpu.parallel import MeshSpec as JaxMeshSpec
from raydp_tpu.train import estimator as jax_est_mod
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.fault import inject as fault
from raydp_tpu_torch.models import transformer as tt
from raydp_tpu_torch.models.convert import _port_name, params_from_flax
from raydp_tpu_torch.parallel import MeshSpec
from raydp_tpu_torch.spmd.job import SPMDJobError
from raydp_tpu_torch.train import fit_spmd
from raydp_tpu_torch.train.spmd_fit import _shrink
from test_estimator_model_parallel import _estimator as jax_estimator
from test_estimator_model_parallel import _token_df
from torch_orbax_convert import convert_orbax_checkpoint
from torch_port_cases import time_limit

SEQ = 16
FEATURES = [f"t{i}" for i in range(SEQ)]
ROWS = 128
BATCH = 16
LR = 3e-4
RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
PREEMPT_STEP = 3
LIMIT_S = 240
# The gang's ranks share the host's cores.
THREADS = {"OMP_NUM_THREADS": "2"}


def _cols(seed):
    df = _token_df(ROWS, seed=seed)
    cols = {c: df[c].to_numpy().astype(np.int32) for c in FEATURES}
    cols["label"] = df["label"].to_numpy().astype(np.int32)
    return cols


def _port_ds(cols):
    """Two blocks, two shards: one a dp index of a dp2 mesh."""
    half = ROWS // 2
    return MLDataset([{k: v[:half] for k, v in cols.items()},
                      {k: v[half:] for k, v in cols.items()}], num_shards=2)


def _factory(ckpt, epochs):
    """The port's estimator on the mesh of the world it runs in: dp rows
    of tp2 (``fit_spmd``'s contract for an elastic mesh)."""
    def make_estimator():
        import numpy as np
        import torch
        import torch.distributed as dist

        from raydp_tpu_torch.models.transformer import (
            SequenceClassifier,
            tiny_transformer,
        )
        from raydp_tpu_torch.parallel import MeshSpec
        from raydp_tpu_torch.train import Estimator

        cfg = tiny_transformer(max_len=16, vocab_size=64, dropout_rate=0.0,
                               dtype=torch.float32)
        return Estimator(
            model=SequenceClassifier(cfg, device="cpu"),
            optimizer=lambda p: torch.optim.Adam(p, lr=3e-4),
            loss="softmax_ce", num_epochs=epochs, batch_size=16,
            feature_columns=[f"t{i}" for i in range(16)],
            label_column="label", feature_dtype=np.int32,
            label_dtype=np.int32,
            mesh=MeshSpec(dp=dist.get_world_size() // 2, tp=2), seed=0,
            shuffle=False, epoch_mode="stream", checkpoint_dir=ckpt,
            device="cpu")
    return make_estimator


def _jax_estimator(mesh, **kw):
    cfg = jt.tiny_transformer(max_len=SEQ, vocab_size=64, dropout_rate=0.0,
                              dtype=jnp.float32)
    return jax_estimator(mesh, model=jt.SequenceClassifier(cfg=cfg,
                                                           num_classes=2),
                         epoch_mode="stream", batch_size=BATCH, **kw)


def _cfg():
    return tt.tiny_transformer(max_len=SEQ, vocab_size=64, dropout_rate=0.0,
                               dtype=torch.float32)


def _flax_tree(state, template):
    """The port's full ``state_dict`` tensors as a flax tree shaped like
    ``template``: the inverse of ``params_from_flax`` (a kernel is the
    transposed weight, reshaped; anything else reshaped)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        t = state[_port_name(path)].numpy()
        arr = t.T if path[-1] == "kernel" else t
        return arr.reshape(node.shape).astype(node.dtype)
    return walk(template, ())


class _Shortfall:
    """``create_spmd_job`` whose first job's start reports only ``got``
    of its ranks registered; later jobs start for real (or, with
    ``every``, report the same)."""

    def __init__(self, got, every=False):
        self.got, self.every = got, every
        self.made = []
        self.real = spmd.create_spmd_job

    def __call__(self, **kwargs):
        job = self.real(**kwargs)
        self.made.append(kwargs["world_size"])
        if len(self.made) == 1 or self.every:
            world = kwargs["world_size"]

            def short_start():
                if not self.every:
                    del job.start  # the relaunch starts for real
                job.last_registered = self.got
                raise SPMDJobError(
                    f"job {job.job_name}: only {self.got}/{world} ranks "
                    "registered within 60s (stubbed)")
            job.start = short_start
        return job


def test_jax_mesh_checkpoint_resumes_on_a_smaller_mesh(
        tmp_path, eight_cpu_devices):
    """(a) The JAX dp2·tp2 fit's epoch-end checkpoint, converted, resumes
    through the port's elastic ``fit_spmd`` on tp2 with no epochs left:
    the JAX fit's parameters."""
    cols = _cols(seed=11)
    ckdir = str(tmp_path / "jax")
    jest = _jax_estimator(JaxMeshSpec(dp=2, tp=2), num_epochs=1,
                          checkpoint_dir=ckdir)
    jest.fit(JaxMLDataset([pa.table(cols)], 1))
    want = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jest._state.params["params"]), _cfg())
    template = tt.SequenceClassifier(_cfg(), device="cpu")
    port_ck = str(tmp_path / "port")
    os.makedirs(port_ck)
    convert_orbax_checkpoint(
        os.path.join(ckdir, "step_0"), os.path.join(port_ck, "step_0.pt"),
        _cfg(), template, torch.optim.Adam(template.parameters(), lr=LR))
    with time_limit(LIMIT_S):
        out = fit_spmd(_factory(port_ck, 1), _port_ds(cols), world_size=2,
                       mesh=MeshSpec(tp=2), elastic=True, env=THREADS,
                       checkpoint_dir=port_ck, timeout=LIMIT_S,
                       device="cpu")
    assert out["world_size"] == 2 and out["restarts"] == 0
    assert out["history"] == []  # no epoch left to train
    assert len(set(out["per_rank_params_sha256"])) == 1
    for name, w in want.items():
        np.testing.assert_allclose(out["params"][name], w.numpy(),
                                   rtol=1e-6, err_msg=name)


def _jax_resume(state, cols, tmp_path, monkeypatch):
    """The JAX package's resume of the port checkpoint ``state`` on
    ``MeshSpec(tp=2)``: the state put into a ``JAXEstimator``, saved as
    the dp-2 world that wrote it, and resumed by a fresh estimator (which
    rescales the per-rank skip by saved/current)."""
    from raydp_tpu_torch.models.transformer import SequenceClassifier

    x = np.stack([cols[c] for c in FEATURES], 1)
    seed_est = _jax_estimator(JaxMeshSpec(tp=2), num_epochs=2)
    seed_est._init_state(x[:1])
    st = seed_est._state
    host = jax.tree_util.tree_map(np.asarray, st.params["params"])
    names = [n for n, _ in SequenceClassifier(
        _cfg(), device="cpu").named_parameters()]
    opt = state["optimizer"]["state"]
    moment = lambda key: {n: opt[i][key] for i, n in enumerate(names)
                          if i in opt}
    adam = st.opt_state[0]
    count = int(opt[0]["step"])
    st = st.replace(
        params={"params": _flax_tree(state["model"], host)},
        opt_state=(adam._replace(
            count=jnp.asarray(count, adam.count.dtype),
            mu={"params": _flax_tree(moment("exp_avg"), host)},
            nu={"params": _flax_tree(moment("exp_avg_sq"), host)}),
        ) + tuple(st.opt_state[1:]),
        step=jnp.asarray(state["step"], st.step.dtype))
    seed_est._state = jax.device_put(st, seed_est._state_shardings)
    monkeypatch.setattr(jax_est_mod, "_data_world",
                        lambda: int(state["data_world"]))
    path = seed_est.save(str(tmp_path / "jax"),
                         step=f"emergency_{state['step']}",
                         data_position=(int(state["data_epoch"]),
                                        int(state["data_batch"])))
    monkeypatch.undo()
    jest = _jax_estimator(JaxMeshSpec(tp=2), num_epochs=2)
    hist = jest.fit(JaxMLDataset([pa.table(cols)], 1), resume_from=path)
    params = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jest._state.params["params"]), _cfg())
    return hist, params


def test_shortfall_relaunches_on_a_smaller_mesh_as_jax_resumes(
        tmp_path, monkeypatch, eight_cpu_devices):
    """(b) A port dp2·tp2 checkpoint taken mid-fit; the elastic fit's
    first launch of 4 ranks registers 2, and the relaunch on tp2 finishes
    as the JAX package's resume of the same state on tp2."""
    cols = _cols(seed=12)
    ck = str(tmp_path / "ck")
    with time_limit(LIMIT_S):
        with pytest.raises(SPMDJobError, match="PreemptionError"):
            fit_spmd(_factory(ck, 2), _port_ds(cols), world_size=4,
                     mesh=MeshSpec(dp=2, tp=2), checkpoint_dir=ck,
                     env={**THREADS, fault.FAULT_PLAN_ENV:
                          f"preempt:step={PREEMPT_STEP},grace=0"},
                     max_restarts=0, timeout=LIMIT_S, device="cpu")
        path = os.path.join(ck, f"step_emergency_{PREEMPT_STEP}.pt")
        state = torch.load(path, map_location="cpu", weights_only=True)
        assert state["data_world"] == 2
        assert (state["data_epoch"], state["data_batch"]) == (
            0, PREEMPT_STEP)
        stub = _Shortfall(got=2)
        monkeypatch.setattr(spmd, "create_spmd_job", stub)
        out = fit_spmd(_factory(ck, 2), _port_ds(cols), world_size=4,
                       mesh=MeshSpec(dp=2, tp=2), elastic=True,
                       checkpoint_dir=ck, env=THREADS,
                       restart_backoff_s=0.1, timeout=LIMIT_S,
                       device="cpu")
        monkeypatch.undo()
    assert stub.made == [4, 2]
    assert out["world_size"] == 2 and out["restarts"] == 1
    assert "only 2/4 ranks registered" in out["failures"][0]["error"]
    assert len(set(out["per_rank_params_sha256"])) == 1
    # dp 2 had run 3 of its 4 batches of epoch 0; at dp 1 the skip is 6
    # of 8, so epoch 0 trains 2 batches and epoch 1 all 8.
    per_epoch = ROWS // BATCH
    skip = PREEMPT_STEP * 2
    assert [h["samples"] for h in out["history"]] == [
        (per_epoch - skip) * BATCH, per_epoch * BATCH]

    jhist, want = _jax_resume(state, cols, tmp_path, monkeypatch)
    assert len(jhist) == len(out["history"]) == 2
    for t, j in zip(out["history"], jhist):
        assert (t["epoch"], t["samples"]) == (j["epoch"], j["samples"])
        np.testing.assert_allclose(t["train_loss"], j["train_loss"],
                                   rtol=RTOL)
    steps = (per_epoch - skip) + per_epoch
    reach = 2 * LR * (PREEMPT_STEP + steps)
    for name, w in want.items():
        g, w = out["params"][name], w.numpy()
        if name.endswith("attn.qkv.bias"):
            # The key bias: zero gradient in exact arithmetic, Adam noise
            # (tests/test_torch_mesh_estimator.py).
            k = slice(len(w) // 3, 2 * len(w) // 3)
            assert np.abs(g[k] - w[k]).max() <= reach, name
            g, w = np.delete(g, np.r_[k]), np.delete(w, np.r_[k])
        np.testing.assert_allclose(g, w, err_msg=name, **PARAM_TOL)


@pytest.mark.parametrize("axes", [dict(dp=2, tp=2), dict(dp=4, sp=2),
                                  dict(dp=3, pp=2, tp=2), dict(dp=2),
                                  dict(dp=5)])
def test_resized_world_is_whole_dp_rows(axes):
    """(c) For every shortfall: a relaunch runs whole dp rows of the same
    pp·sp·tp, as many as registered; fewer than a row (or fewer ranks
    than ``min_world_size``) is refused with a reason naming the mesh."""
    spec = MeshSpec(**axes)
    mesh = None if spec.data_parallel_only else spec
    row = spec.size // spec.dp
    for min_world in (1, row + 1):
        for got in range(spec.size):
            world, new_mesh, refusal = _shrink(spec.size, got, min_world,
                                               mesh)
            fit = got - got % row
            if fit == 0 or fit < min_world:
                assert world is None and new_mesh is mesh
                assert f"{got} of {spec.size} ranks registered" in refusal
                if mesh is not None:
                    assert str(spec.axis_sizes) in refusal
                continue
            assert refusal is None and world == fit and world % row == 0
            if mesh is not None:
                assert new_mesh.size == world
                assert (new_mesh.pp, new_mesh.sp, new_mesh.tp) == (
                    spec.pp, spec.sp, spec.tp)
                assert new_mesh.dp == world // row


def test_shortfall_under_a_dp_row_fails_the_launch(monkeypatch):
    """(c) One of 4 dp2·tp2 ranks registered: no whole dp row of 2 is
    left, so the launch counts against the budget like any failure, the
    relaunch keeps the world, and the last error names the mesh."""
    stub = _Shortfall(got=1, every=True)
    monkeypatch.setattr(spmd, "create_spmd_job", stub)
    cols = _cols(seed=13)
    with time_limit(60):
        with pytest.raises(SPMDJobError, match=r"budget exhausted(.|\n)*"
                           r"shrink refused: 1 of 4 ranks registered on "
                           r"mesh \{'dp': 2, 'pp': 1, 'sp': 1, 'tp': 2\}"):
            fit_spmd(_factory(None, 1), _port_ds(cols), world_size=4,
                     mesh=MeshSpec(dp=2, tp=2), elastic=True,
                     max_restarts=1, restart_backoff_s=0.01, device="cpu")
    assert stub.made == [4]  # the same world reuses its job


def _sp_factory():
    """An estimator on sp2: not the tp2 mesh its launch runs."""
    def make_estimator():
        import torch

        from raydp_tpu_torch.models.transformer import (
            SequenceClassifier,
            tiny_transformer,
        )
        from raydp_tpu_torch.parallel import MeshSpec
        from raydp_tpu_torch.train import Estimator

        cfg = tiny_transformer(max_len=16, vocab_size=64, dropout_rate=0.0,
                               dtype=torch.float32)
        return Estimator(model=SequenceClassifier(cfg, device="cpu"),
                         loss="softmax_ce", batch_size=16,
                         mesh=MeshSpec(sp=2), device="cpu")
    return make_estimator


def test_a_factory_off_the_launch_mesh_fails_its_ranks():
    """A rank whose estimator's mesh is not the launch's raises before it
    trains, naming both meshes and what to build."""
    with time_limit(LIMIT_S):
        with pytest.raises(SPMDJobError, match=r"runs on mesh \{'dp': 1, "
                           r"'pp': 1, 'sp': 2, 'tp': 1\}, this launch on "
                           r"\{'dp': 1, 'pp': 1, 'sp': 1, 'tp': 2\}"):
            fit_spmd(_sp_factory(), _port_ds(_cols(seed=14)), world_size=2,
                     mesh=MeshSpec(tp=2), elastic=True, max_restarts=0,
                     env=THREADS, timeout=LIMIT_S, device="cpu")
