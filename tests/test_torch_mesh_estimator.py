"""The port's ``Estimator`` and ``fit_spmd`` on a model-parallel mesh
(``raydp_tpu_torch/train/estimator.py``, ``train/spmd_fit.py``) against
``tests/test_estimator_model_parallel.py``,
``tests/test_pipelined_estimator.py`` and the JAX package's
``JAXEstimator`` on the same mesh.

The port's side runs on a gang of 4 gloo CPU ranks, one process per
mesh position (``MeshSpec(sp=2, tp=2)``, ``dp=2, tp=2``, ``dp=2, pp=2``),
each rank reading its dp index's rows; the JAX side on the conftest's
virtual CPU devices. Cases:

* the reference's four model-parallel cases on 4 processes (its
  dp2·sp2·tp2 needs 8): a fit learns with tp-cut parameters and Adam
  moments cut alike; it tracks a one-process fit (the reference's rtol
  2e-2); a checkpoint restores onto the same mesh, onto dp2·tp2 and
  onto one process with equal predictions; an MLP without logical axes
  stays replicated and learns;
* the reference's three pipelined cases: a dp2·pp2 ``PipelinedClassifier``
  fit learns with each pp rank holding its stage and the moments
  following it; its forward on the mesh equals the stages in sequence;
  the validation (``tests/test_torch_pipeline.py::test_pp_validation``);
* a port fit with ``MeshSpec(sp=2, tp=2)`` against
  ``JAXEstimator(mesh=MeshSpec(sp=2, tp=2))`` in float32 from the same
  initial parameters: epoch histories at rtol 1e-4 and the trained
  parameters at ``tests/test_torch_train.py``'s bounds (rtol 1e-4 /
  atol 1e-5; the key bias within 2·lr·steps). The same 2·lr·steps holds
  the elements where Adam's denominator in JAX's run is set by its eps,
  not the gradient (two weight elements here, one of 49,152 and one of
  16,384): the update there is the gradient over eps, so the two
  packages' f32 rounding of a cancelling sum sets it, as it sets the key
  bias's. At most one such element a tensor and ``MAX_NOISY`` in all;
* a ``JAXEstimator`` orbax checkpoint of a sp2·tp2 fit, converted by
  ``tests/torch_orbax_convert.py``, restores onto the port's sp2·tp2
  mesh and onto one process: predictions at the forward bound (2e-4 /
  2e-5) and one more fit step of both packages at rtol 1e-4;
* ``fit_spmd(..., mesh=)``: shards go to dp indices, every rank's
  gathered parameters are equal, and a second call resumes from the
  gathered checkpoint to the parameters of an uninterrupted run.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pyarrow as pa
import pytest
import torch

from raydp_tpu.data.ml_dataset import MLDataset as JaxMLDataset
from raydp_tpu.models import transformer as jt
from raydp_tpu.parallel import MeshSpec as JaxMeshSpec
from raydp_tpu_torch.models import transformer as tt
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.parallel import MeshSpec
from test_estimator_model_parallel import _estimator as jax_estimator
from test_estimator_model_parallel import _token_df
from torch_mesh_gang import gang, run
from torch_orbax_convert import convert_orbax_checkpoint

SEQ = 16
FEATURES = [f"t{i}" for i in range(SEQ)]
FWD = dict(rtol=2e-4, atol=2e-5)
RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
LR = 3e-4
# fit_spmd's ranks share the host's cores.
THREADS = {"OMP_NUM_THREADS": "2"}


@pytest.fixture(scope="module")
def job():
    with gang(4, "t-mesh-est") as j:
        yield j


def _cols(df):
    cols = {c: df[c].to_numpy().astype(np.int32) for c in FEATURES}
    cols["label"] = df["label"].to_numpy().astype(np.int32)
    return cols


def _fit_rank(ctx, axes, cols, opts):
    """Build the port's estimator on this rank (a classifier from
    ``opts["init"]`` where given, a ``PipelinedClassifier`` or an MLP by
    ``opts["model"]``), fit it on its dp index's rows and report."""
    import numpy as np
    import torch

    from raydp_tpu_torch.data import MLDataset
    from raydp_tpu_torch.models.mlp import MLP
    from raydp_tpu_torch.models.pipelined import PipelinedClassifier
    from raydp_tpu_torch.models.transformer import (
        SequenceClassifier,
        tiny_transformer,
    )
    from raydp_tpu_torch.parallel import MeshSpec
    from raydp_tpu_torch.train import Estimator

    spec = MeshSpec(**axes)
    features = opts.get("features", [f"t{i}" for i in range(16)])
    kind = opts.get("model", "classifier")
    cfg = tiny_transformer(max_len=16, vocab_size=64, dropout_rate=0.0,
                           dtype=getattr(torch, opts.get("dtype",
                                                         "bfloat16")))
    if kind == "mlp":
        model = MLP(2, hidden=(16,), out_dim=1, device="cpu")
    elif kind == "pipelined":
        model = PipelinedClassifier(cfg, spec, device="cpu")
    else:
        model = SequenceClassifier(cfg, device="cpu")
    if opts.get("init") is not None:
        model.load_state_dict(opts["init"], strict=False)
    mlp = kind == "mlp"
    est = Estimator(
        model=model, optimizer=lambda p: torch.optim.Adam(p, lr=opts.get(
            "lr", 3e-4)),
        loss="mse" if mlp else "softmax_ce",
        metrics=[] if mlp else ["categorical_accuracy"],
        num_epochs=opts.get("epochs", 1), batch_size=opts.get("batch", 64),
        feature_columns=features, label_column=opts.get("label", "label"),
        feature_dtype=np.float32 if mlp else np.int32,
        label_dtype=np.float32 if mlp else np.int32, mesh=spec, seed=0,
        shuffle=False, epoch_mode="stream",
        checkpoint_dir=opts.get("ckpt"), device="cpu")
    dp = spec.coords_of(ctx.rank)["dp"]
    n = len(cols[features[0]])
    shard = {k: v[dp * n // spec.dp:(dp + 1) * n // spec.dp]
             for k, v in cols.items()}
    out = {}
    if opts.get("restore"):
        est.restore_path(opts["restore"])
    if opts.get("epochs"):
        ds = MLDataset([shard], 1)
        out["history"] = est.fit(ds, evaluate_ds=ds if not mlp else None,
                                 resume_from=opts.get("resume"))
    placements = est.param_placements()
    out["sharded"] = {n: pl.spec for n, pl in placements.items()
                      if pl.sharded_axes}
    state = est.optimizer.state
    out["moments"] = {
        n: tuple(state[p]["exp_avg"].shape) for n, p in
        model.named_parameters() if p in state and "exp_avg" in state[p]}
    out["local"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    full = est.gathered_state_dict()
    if ctx.rank == 0:
        out["params"] = {k: v.float().numpy() for k, v in full.items()}
    if opts.get("x") is not None:
        out["preds"] = est.predict(opts["x"])
    if opts.get("save"):
        out["saved"] = est.save(opts["save"])
    return out


def test_fit_tp_sp_mesh_shards_params_and_learns(job):
    cols = _cols(_token_df())
    out = run(job, _fit_rank, dict(sp=2, tp=2), cols, dict(epochs=3))
    hist = out[0]["history"]
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    for r in out:
        # One loss, the same on every rank.
        assert [h["train_loss"] for h in r["history"]] == \
            [h["train_loss"] for h in hist]
        sharded = r["sharded"]
        assert len(sharded) >= 4, sharded
        assert any("tp" in spec for spec in sharded.values())
        # Adam's moments are shaped like the rank's blocks.
        cut = [n for n in sharded if r["moments"].get(n) == r["local"][n]]
        assert len(cut) == len(sharded)


def test_tp_matches_replicated_training(job):
    """A sp2·tp2 fit tracks a one-process fit (the reference holds its
    mesh run to a dp-only one at rtol 2e-2; bf16 compute)."""
    from raydp_tpu_torch.data import MLDataset
    from raydp_tpu_torch.train import Estimator

    cols = _cols(_token_df(256, seed=1))
    h_mp = run(job, _fit_rank, dict(sp=2, tp=2), cols,
               dict(epochs=2))[0]["history"]
    est = Estimator(
        model=tt.SequenceClassifier(tt.tiny_transformer(
            max_len=SEQ, vocab_size=64, dropout_rate=0.0), device="cpu"),
        optimizer=lambda p: torch.optim.Adam(p, lr=LR), loss="softmax_ce",
        num_epochs=2, batch_size=64, feature_columns=FEATURES,
        label_column="label", feature_dtype=np.int32, label_dtype=np.int32,
        seed=0, shuffle=False, epoch_mode="stream", device="cpu")
    h_one = est.fit(MLDataset([cols], 1))
    np.testing.assert_allclose(h_mp[-1]["train_loss"],
                               h_one[-1]["train_loss"], rtol=2e-2)


def _restore_rank(ctx, axes, path, x):
    import numpy as np
    import torch

    from raydp_tpu_torch.models.transformer import (
        SequenceClassifier,
        tiny_transformer,
    )
    from raydp_tpu_torch.parallel import MeshSpec
    from raydp_tpu_torch.train import Estimator

    cfg = tiny_transformer(max_len=16, vocab_size=64, dropout_rate=0.0,
                           dtype=torch.float32)
    est = Estimator(model=SequenceClassifier(cfg, device="cpu"),
                    loss="softmax_ce", batch_size=64,
                    feature_columns=[f"t{i}" for i in range(16)],
                    label_column="label", feature_dtype=np.int32,
                    label_dtype=np.int32, mesh=MeshSpec(**axes),
                    device="cpu")
    est.restore_path(path)
    sharded = [n for n, pl in est.param_placements().items()
               if pl.sharded_axes]
    return est.predict(x), sharded


def test_checkpoint_roundtrip_preserves_sharding(job, tmp_path):
    """A sp2·tp2 fit's gathered checkpoint restores onto the same mesh
    (cut again: the reference's rtol 1e-5), and onto dp2·tp2 and one
    process (the same parameters through other reductions: the forward
    bound), each predicting what the fit predicts. Float32, so the other
    meshes' reordered sums stay at f32 rounding."""
    from raydp_tpu_torch.train import Estimator

    cols = _cols(_token_df(128, seed=2))
    x = np.stack([_cols(_token_df(8, seed=3))[c] for c in FEATURES], 1)
    out = run(job, _fit_rank, dict(sp=2, tp=2), cols,
              dict(epochs=1, x=x, save=str(tmp_path), dtype="float32"))
    path, want = out[0]["saved"], out[0]["preds"]
    assert os.path.basename(path) == "final.pt"
    for axes, tol in ((dict(sp=2, tp=2), dict(rtol=1e-5, atol=1e-5)),
                      (dict(dp=2, tp=2), FWD)):
        for preds, sharded in run(job, _restore_rank, axes, path, x):
            assert sharded
            np.testing.assert_allclose(preds, want, **tol)
    cfg = tt.tiny_transformer(max_len=SEQ, vocab_size=64, dropout_rate=0.0,
                              dtype=torch.float32)
    one = Estimator(model=tt.SequenceClassifier(cfg, device="cpu"),
                    loss="softmax_ce", batch_size=64,
                    feature_columns=FEATURES, label_column="label",
                    feature_dtype=np.int32, label_dtype=np.int32,
                    device="cpu")
    one.restore_path(path)
    np.testing.assert_allclose(one.predict(x), want, **FWD)


def test_mlp_without_metadata_still_replicates(job):
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal(512), rng.standard_normal(512)
    cols = {"a": a.astype(np.float32), "b": b.astype(np.float32),
            "y": (2 * a - b).astype(np.float32)}
    out = run(job, _fit_rank, dict(dp=2, tp=2), cols,
              dict(model="mlp", epochs=2, batch=128, features=["a", "b"],
                   label="y", lr=1e-3))
    h = out[0]["history"]
    assert h[-1]["train_loss"] < h[0]["train_loss"]
    assert all(not r["sharded"] for r in out)


def test_pp_fit_shards_stages_and_learns(job):
    cols = {c: v for c, v in _cols(_pp_df()).items()}
    x = np.stack([_cols(_pp_df(10, seed=3))[c] for c in FEATURES], 1)
    out = run(job, _fit_rank, dict(dp=2, pp=2), cols,
              dict(model="pipelined", epochs=4, x=x))
    h = out[0]["history"]
    assert h[-1]["train_loss"] < h[0]["train_loss"]
    for r in out:
        stages = {n: s for n, s in r["sharded"].items()
                  if n.startswith("stages.")}
        assert stages and all(s[0] == "pp" for s in stages.values())
        assert all(r["local"][n][0] == 1 for n in stages)
        assert all(r["moments"][n] == r["local"][n] for n in stages)
        # Predictions come out through the pipeline, padding included.
        assert r["preds"].shape == (10, 2)
        np.testing.assert_allclose(r["preds"], out[0]["preds"], rtol=1e-6)


def _pp_df(n=512, seed=0):
    import pandas as pd

    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 60, size=(n, SEQ))
    pos = rng.random(n) < 0.5
    ids[pos, rng.integers(0, SEQ, pos.sum())] = 7
    cols = {f"t{i}": ids[:, i] for i in range(SEQ)}
    cols["label"] = pos.astype(np.int64)
    return pd.DataFrame(cols)


def _pp_forward(ctx, state, ids):
    import torch

    from raydp_tpu_torch.models.pipelined import PipelinedClassifier
    from raydp_tpu_torch.models.transformer import (
        LOGICAL_RULES,
        tiny_transformer,
    )
    from raydp_tpu_torch.parallel import MeshSpec
    from raydp_tpu_torch.parallel.mesh import shard_module

    spec = MeshSpec(dp=2, pp=2)
    cfg = tiny_transformer(max_len=16, vocab_size=64, dropout_rate=0.0,
                           dtype=torch.float32)
    model = PipelinedClassifier(cfg, spec, n_microbatches=4, device="cpu")
    model.load_state_dict(state)
    mesh = spec.build()
    shard_module(model, mesh, LOGICAL_RULES)
    dp = mesh.coords["dp"]
    with torch.no_grad():
        return dp, model(torch.from_numpy(ids[dp * 4:dp * 4 + 4])).numpy()


def test_pp_matches_sequential_blocks(job):
    """The pipelined forward on a dp2·pp2 mesh equals running the stages
    in sequence in one process."""
    from raydp_tpu_torch.models.pipelined import PipelinedClassifier

    cfg = tt.tiny_transformer(max_len=SEQ, vocab_size=64, dropout_rate=0.0,
                              dtype=torch.float32)
    model = PipelinedClassifier(cfg, MeshSpec(dp=2, pp=2), n_microbatches=4,
                                device="cpu")
    ids = np.random.default_rng(0).integers(0, 64, (8, SEQ))
    with torch.no_grad():
        want = model(torch.from_numpy(ids)).numpy()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    for dp, got in run(job, _pp_forward, state, ids):
        np.testing.assert_allclose(got, want[dp * 4:dp * 4 + 4], rtol=2e-4,
                                   atol=2e-4)


def _jax_f32_estimator(mesh, **kw):
    cfg = jt.tiny_transformer(max_len=SEQ, vocab_size=64, dropout_rate=0.0,
                              dtype=jnp.float32)
    return jax_estimator(mesh, model=jt.SequenceClassifier(cfg=cfg,
                                                           num_classes=2),
                         epoch_mode="stream", **kw)


def _jax_init(x):
    cfg = jt.tiny_transformer(max_len=SEQ, vocab_size=64, dropout_rate=0.0,
                              dtype=jnp.float32)
    import flax.linen as nn

    tree = nn.unbox(jt.SequenceClassifier(cfg=cfg, num_classes=2).init(
        jax.random.PRNGKey(0), jnp.asarray(x[:1])))["params"]
    return jax.tree_util.tree_map(np.asarray, tree)


def _adam_noise(tree, x, y, batch, steps, cfg):
    """Per parameter, the elements where Adam's denominator in JAX's own
    run is set by its eps (1e-8) and not by the gradient: 0 <
    sqrt(v_hat) < 1e-8 at some step. There the update is about g / eps,
    and g is the rounding of a sum of terms some 1e5 times larger, as for
    the key bias. The run is replayed here (the same batches in order,
    ``optax.adam``)."""
    model = jt.SequenceClassifier(cfg=jt.tiny_transformer(
        max_len=SEQ, vocab_size=64, dropout_rate=0.0, dtype=jnp.float32),
        num_classes=2)
    params = {"params": tree}
    tx = optax.adam(LR)
    opt = tx.init(params)

    def loss(p, xb, yb):
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply(p, xb), yb).mean()

    grad = jax.jit(jax.grad(loss))
    noisy = None
    n_batches = len(x) // batch
    for step in range(steps):
        b = slice((step % n_batches) * batch, (step % n_batches + 1) * batch)
        g = grad(params, jnp.asarray(x[b]), jnp.asarray(y[b]))
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
        debias = 1.0 - 0.999 ** (step + 1)

        def eps_bound(nu):
            r = np.sqrt(np.asarray(nu, np.float64) / debias)
            return (r > 0) & (r < 1e-8)

        small = jax.tree_util.tree_map(eps_bound, opt[0].nu)
        noisy = small if noisy is None else jax.tree_util.tree_map(
            np.logical_or, noisy, small)
    return {k: v.numpy().astype(bool) for k, v in params_from_flax(
        jax.tree_util.tree_map(lambda a: a.astype(np.float32),
                               noisy["params"]), cfg).items()}


# Elements held only to Adam's reach by ``_adam_noise``, at most one a
# tensor and this many in all (outside the key biases): the rule must not
# grow into a blind spot. At this seed there are two, one in block 0's
# ``qkv.weight`` and one in block 1's ``out.weight``.
MAX_NOISY = 4


def _assert_params_close(got, want, steps, noise):
    assert set(want) <= set(got)
    reach = 2 * LR * steps
    n_noisy = 0
    for name, w in want.items():
        g, w = got[name], w.numpy()
        keep = np.ones(w.shape, bool)
        if name.endswith("attn.qkv.bias"):
            # The key bias: zero gradient in exact arithmetic, Adam noise
            # (tests/test_torch_train.py).
            k = slice(len(w) // 3, 2 * len(w) // 3)
            assert np.abs(g[k] - w[k]).max() <= reach, name
            keep[k] = False
        mask = noise[name] & keep
        if mask.any():
            assert mask.sum() <= 1, (name, int(mask.sum()))
            assert np.abs(g[mask] - w[mask]).max() <= reach, name
            n_noisy += int(mask.sum())
            keep &= ~mask
        np.testing.assert_allclose(g[keep], w[keep], err_msg=name,
                                   **PARAM_TOL)
    assert n_noisy <= MAX_NOISY, n_noisy


def test_sp_tp_fit_matches_jax_estimator(job, eight_cpu_devices):
    df = _token_df(128, seed=4)
    cols = _cols(df)
    x = np.stack([cols[c] for c in FEATURES], 1)
    tree = _jax_init(x)
    cfg = tt.tiny_transformer(max_len=SEQ, vocab_size=64, dropout_rate=0.0,
                              dtype=torch.float32)
    jest = _jax_f32_estimator(JaxMeshSpec(sp=2, tp=2), num_epochs=2)
    table = pa.table(cols)
    jhist = jest.fit(JaxMLDataset([table], 1),
                     evaluate_ds=JaxMLDataset([table], 1))
    out = run(job, _fit_rank, dict(sp=2, tp=2), cols,
              dict(epochs=2, dtype="float32",
                   init=params_from_flax(tree, cfg)))
    for j, t in zip(jhist, out[0]["history"]):
        for k in ("train_loss", "eval_loss", "eval_categorical_accuracy"):
            np.testing.assert_allclose(t[k], j[k], rtol=RTOL, err_msg=k)
    want = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jest._state.params["params"]), cfg)
    noise = _adam_noise(tree, x, cols["label"], 64, 4, cfg)
    _assert_params_close(out[0]["params"], want, steps=4, noise=noise)
    assert {"encoder.blocks.0.attn.qkv.weight",
            "encoder.blocks.0.mlp_down.weight"} <= set(out[0]["sharded"])


def _orbax_rank(ctx, axes, path, x, cols):
    import numpy as np
    import torch

    from raydp_tpu_torch.data import MLDataset
    from raydp_tpu_torch.models.transformer import (
        SequenceClassifier,
        tiny_transformer,
    )
    from raydp_tpu_torch.parallel import MeshSpec
    from raydp_tpu_torch.train import Estimator

    cfg = tiny_transformer(max_len=16, vocab_size=64, dropout_rate=0.0,
                           dtype=torch.float32)
    est = Estimator(model=SequenceClassifier(cfg, device="cpu"),
                    optimizer=lambda p: torch.optim.Adam(p, lr=3e-4),
                    loss="softmax_ce", batch_size=32, num_epochs=3,
                    feature_columns=[f"t{i}" for i in range(16)],
                    label_column="label", feature_dtype=np.int32,
                    label_dtype=np.int32, mesh=MeshSpec(**axes), seed=0,
                    shuffle=False, epoch_mode="stream", device="cpu")
    est.restore_path(path)
    preds = est.predict(x)
    hist = est.fit(MLDataset([cols], 1), resume_from=path)
    return preds, hist


def test_jax_orbax_checkpoint_restores_in_the_port(job, eight_cpu_devices,
                                                   tmp_path):
    """A ``JAXEstimator`` sp2·tp2 fit's orbax checkpoint, converted,
    restores onto the port's sp2·tp2 mesh and onto one process: the
    predictions match, and one more fit step of each package matches."""
    df = _token_df(32, seed=5)
    cols = _cols(df)
    x = np.stack([cols[c] for c in FEATURES], 1)
    ckdir = str(tmp_path / "jax")
    jest = _jax_f32_estimator(JaxMeshSpec(sp=2, tp=2), num_epochs=2,
                              batch_size=32, checkpoint_dir=ckdir)
    table = pa.table(cols)
    jest.fit(JaxMLDataset([table], 1))
    jpath = os.path.join(ckdir, "step_1")
    want_preds = jest.predict(x)
    cont = _jax_f32_estimator(JaxMeshSpec(sp=2, tp=2), num_epochs=3,
                              batch_size=32)
    jhist = cont.fit(JaxMLDataset([table], 1), resume_from=jpath)

    cfg = tt.tiny_transformer(max_len=SEQ, vocab_size=64, dropout_rate=0.0,
                              dtype=torch.float32)
    template = tt.SequenceClassifier(cfg, device="cpu")
    path = convert_orbax_checkpoint(
        jpath, str(tmp_path / "port.pt"), cfg, template,
        torch.optim.Adam(template.parameters(), lr=LR))
    assert len(jhist) == 1  # the resumed fit ran epoch 2 alone: one step
    for preds, hist in run(job, _orbax_rank, dict(sp=2, tp=2), path, x,
                           cols):
        np.testing.assert_allclose(preds, want_preds, **FWD)
        np.testing.assert_allclose(hist[-1]["train_loss"],
                                   jhist[-1]["train_loss"], rtol=RTOL)
    preds, hist = _orbax_rank(type("Ctx", (), {"rank": 0})(), {}, path, x,
                              cols)
    np.testing.assert_allclose(preds, want_preds, **FWD)
    np.testing.assert_allclose(hist[-1]["train_loss"],
                               jhist[-1]["train_loss"], rtol=RTOL)


def _mesh_factory(epochs, ckpt):
    def make_estimator():
        import numpy as np
        import torch

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
            loss="softmax_ce", num_epochs=epochs, batch_size=32,
            feature_columns=[f"t{i}" for i in range(16)],
            label_column="label", feature_dtype=np.int32,
            label_dtype=np.int32, mesh=MeshSpec(dp=2, tp=2), seed=0,
            shuffle=False, epoch_mode="stream", checkpoint_dir=ckpt,
            device="cpu")
    return make_estimator


def test_fit_spmd_on_a_mesh_resumes_from_the_gathered_checkpoint(tmp_path):
    from raydp_tpu_torch.data import MLDataset
    from raydp_tpu_torch.train import fit_spmd
    from torch_port_cases import time_limit

    cols = _cols(_token_df(128, seed=6))
    ds = MLDataset([{k: v[:64] for k, v in cols.items()},
                    {k: v[64:] for k, v in cols.items()}], num_shards=2)
    mesh = MeshSpec(dp=2, tp=2)
    with time_limit(240):
        with pytest.raises(ValueError, match="num_shards == mesh.dp"):
            fit_spmd(_mesh_factory(1, None), MLDataset(
                [{k: v[i::4] for k, v in cols.items()} for i in range(4)],
                num_shards=4), 4, mesh=mesh, device="cpu")
        full = fit_spmd(_mesh_factory(2, None), ds, 4, mesh=mesh,
                        device="cpu", env=THREADS)
        ck = str(tmp_path / "ck")
        fit_spmd(_mesh_factory(1, ck), ds, 4, mesh=mesh, device="cpu", env=THREADS)
        resumed = fit_spmd(_mesh_factory(2, ck), ds, 4, mesh=mesh,
                           device="cpu", env=THREADS)
    assert len(set(full["per_rank_params_sha256"])) == 1
    assert len(set(resumed["per_rank_params_sha256"])) == 1
    qkv = full["params"]["encoder.blocks.0.attn.qkv.weight"]
    assert qkv.shape == (3 * 128, 128)  # gathered to the full shape
    for k, v in full["params"].items():
        np.testing.assert_allclose(resumed["params"][k], v, rtol=1e-6,
                                   atol=1e-7, err_msg=k)
