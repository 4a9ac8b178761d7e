"""DLRM tables over tp and MoE experts over dp on a gang's mesh
(``raydp_tpu_torch/models/dlrm.py``, ``models/moe.py``,
``parallel/collectives.py``) against the JAX package's layers and
``JAXEstimator`` on the same meshes over the conftest's virtual CPU
devices.

The port's side runs on one gang of 4 gloo CPU ranks for the file
(``tests/torch_mesh_gang.py``), one process a mesh position, each rank
fed its dp index's rows; the MoE routing case on a second gang of 2.
Cases:

* ``tiny_dlrm(embedding_impl="onehot")`` forward and gradients on tp=4
  and dp2·tp2 against ``dlrm_shardings`` on the JAX mesh; each rank
  holds ``V/tp`` rows of every table, and the ranks' blocks gather back
  to the full tree (``gather_shards``);
* ``MoELayer`` on dp2·tp2 under ``tests/test_moe.py:99-128``'s rules:
  output, aux loss and gradients; each rank holds ``E/dp`` experts and
  ``F/tp`` of their FFN, and an expert's gradient is the JAX gradient's
  block on the rank's own backward, summed over no rank;
* ``PackedDLRM`` (tables cut by ``LOGICAL_RULES``) and ``MoEClassifier``
  (``aux_losses=True``) fits on dp2·tp2 against ``JAXEstimator`` on the
  same mesh from the same parameters: train losses at rtol 1e-4, the
  gathered trained parameters at ``tests/test_torch_train.py``'s bounds,
  and each fit's gathered checkpoint restored on one process. The fits
  step by plain SGD: Adam turns an f32 rounding of a near-zero gradient
  into an update of up to its learning rate (the attention key bias of
  ``tests/test_torch_mesh_estimator.py``; here one table element of
  160,000), and these cases hold the gradients the mesh computes;
* the MoE routing over a 2-rank dp group against the JAX layer over the
  global batch (``raydp_tpu/models/moe.py:89-129``): the capacity of
  the global token count binds, so the output, the kept slots (counted
  from JAX's own router logits) and the aux loss show whether the port
  routes globally; then ``MoEClassifier`` fits on a 2-rank gang against
  ``JAXEstimator(mesh=MeshSpec(dp=2))`` with ``aux_losses=True``
  (``tests/test_moe.py:164-223``'s configuration in float32).

The JAX package's own mesh cases (``tests/test_dlrm.py::
test_sharded_tables_on_tp_mesh``, ``::test_packed_dlrm_trains``,
``tests/test_moe.py::test_expert_sharded_on_mesh``,
``::test_moe_classifier_through_estimator``) place JAX arrays with
``jax.device_put`` and read their ``.sharding``: the port-case harness
(``tests/torch_port_cases.py``) cannot run them on the port's processes,
so the cases above hold the same configurations. JAX gradients are
jitted (eager ``jax.grad`` through sharded arrays takes minutes).

Bounds: forward rtol 2e-4 / atol 2e-5, gradients and the aux loss 1e-3
/ 1e-4, histories rtol 1e-4, parameters rtol 1e-4 / atol 1e-5.
"""
import concurrent.futures

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pyarrow as pa
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from raydp_tpu.data.ml_dataset import MLDataset as JaxMLDataset
from raydp_tpu.models import dlrm as jd
from raydp_tpu.models import moe as jm
from raydp_tpu.models import transformer as jt
from raydp_tpu.parallel import MeshSpec as JaxMeshSpec
from raydp_tpu.train.estimator import JAXEstimator
from raydp_tpu_torch.models import dlrm as td
from raydp_tpu_torch.models import moe as tm
from raydp_tpu_torch.models import transformer as tt
from raydp_tpu_torch.models.convert import gather_shards, params_from_flax
from raydp_tpu_torch.parallel import MeshSpec
from torch_mesh_gang import gang, run

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)
RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
MOE_RULES = (("expert", "dp"), ("embed", None), ("mlp", "tp"))


@pytest.fixture(scope="module")
def job():
    with gang(4, "t-ep") as j:
        yield j


@pytest.fixture(scope="module")
def pair():
    with gang(2, "t-ep2") as j:
        yield j


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, nn.unbox(params))


def _jax_mesh(axes):
    return JaxMeshSpec(**axes).build(jax.devices()[:4])


def _dp_rows(n, coords, shape):
    return slice(coords["dp"] * n // shape["dp"],
                 (coords["dp"] + 1) * n // shape["dp"])


def _interleaved(cols, batch, n_dp, dp):
    """Rank ``dp``'s rows of a JAX run over global batches of
    ``batch``: its ``batch / n_dp`` rows of each, in order."""
    n = len(next(iter(cols.values())))
    per = batch // n_dp
    idx = np.concatenate([np.arange(b + dp * per, b + (dp + 1) * per)
                          for b in range(0, n, batch)])
    return {k: v[idx] for k, v in cols.items()}


def _gathered_grads(model, mesh, C):
    """Every parameter's gradient summed over the dp/pp/sp axes that
    replicate it (the estimator's rule), then gathered whole."""
    out = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        pl = model.placements[name]
        axes = [a for a in ("dp", "pp", "sp") if a in pl.replicated_axes]
        g = C.all_reduce_raw(p.grad, mesh.group(*axes)) if axes else p.grad
        out[name] = pl.gather(g).numpy()
    return out


# ----------------------------------------------------------- collectives

def _scatter_rank(ctx, x):
    import torch

    from raydp_tpu_torch.parallel import MeshSpec
    from raydp_tpu_torch.parallel import collectives as C

    mesh = MeshSpec(dp=4).build()
    me = mesh.coords["dp"]
    C.reset_stats()
    t = torch.from_numpy(x[me]).requires_grad_()
    got = C.reduce_scatter(t, 1, mesh.group("dp"))
    w = torch.arange(got.numel(), dtype=got.dtype).reshape(got.shape)
    (got * (me + 1) * w).sum().backward()
    u = torch.from_numpy(x[me][:, :2]).requires_grad_()
    whole = C.gather_from_region(u, 1, mesh.group("dp"))
    (whole * torch.arange(whole.numel(), dtype=whole.dtype)
     .reshape(whole.shape)).sum().backward()
    half = C.reduce_scatter(torch.from_numpy(x[me]).bfloat16(), 1,
                            mesh.group("dp"))
    return (got.detach().numpy(), t.grad.numpy(), whole.detach().numpy(),
            u.grad.numpy(), half.float().numpy(), C.stats())


def test_reduce_scatter_and_gather_from_region(job):
    """``reduce_scatter`` (gloo: all_to_all and a local sum) is the sum's
    block, its backward the all_gather of the blocks' gradients;
    ``gather_from_region`` gathers and keeps its block of the gradient;
    a bf16 sum is taken in float32 and cast once."""
    x = np.random.default_rng(0).standard_normal((4, 3, 8)).astype(
        np.float32)
    out = run(job, _scatter_rank, x)
    total = x.sum(0)
    w = np.arange(6, dtype=np.float32).reshape(3, 2)
    for r, (got, grad, whole, ugrad, half, stats) in enumerate(out):
        np.testing.assert_allclose(got, total[:, 2 * r:2 * r + 2],
                                   rtol=1e-6, atol=1e-6)
        want = np.concatenate([w * (q + 1) for q in range(4)], axis=1)
        np.testing.assert_array_equal(grad, want)
        np.testing.assert_array_equal(whole, np.concatenate(
            [x[q][:, :2] for q in range(4)], axis=1))
        g = np.arange(24, dtype=np.float32).reshape(3, 8)
        np.testing.assert_array_equal(ugrad, g[:, 2 * r:2 * r + 2])
        bf = torch.from_numpy(x).bfloat16().float().numpy().sum(0)
        want_half = torch.from_numpy(bf[:, 2 * r:2 * r + 2]).bfloat16()
        np.testing.assert_array_equal(half, want_half.float().numpy())
        assert stats["calls"] == 4 and stats["staged_bytes"] == 0


# ------------------------------------------------------------------ DLRM

def _jax_dlrm(axes, dense, sparse, w):
    cfg = jd.tiny_dlrm(dtype=jnp.float32, embedding_impl="onehot")
    model = jd.DLRM(cfg)
    mesh = _jax_mesh(axes)
    _, shardings = jd.dlrm_shardings(model, mesh, jnp.asarray(dense),
                                     jnp.asarray(sparse))
    variables = jax.jit(
        lambda: nn.unbox(model.init(jax.random.PRNGKey(0),
                                    jnp.asarray(dense), jnp.asarray(sparse))),
        out_shardings=shardings)()
    assert variables["params"]["emb_1"]["table"].sharding.spec[0] == "tp"
    dense_d = jax.device_put(dense, NamedSharding(mesh, P("dp")))
    sparse_d = jax.device_put(sparse, NamedSharding(mesh, P("dp")))

    def loss(p):
        return jnp.sum(model.apply({"params": p}, dense_d, sparse_d) * w)

    logits = jax.jit(model.apply)(variables, dense_d, sparse_d)
    grads = jax.jit(jax.grad(loss))(variables["params"])
    return _tree(variables["params"]), np.asarray(logits), _tree(grads)


def _dlrm_rank(ctx, axes, tree, dense, sparse, w):
    import torch

    from raydp_tpu_torch.models.convert import params_from_flax
    from raydp_tpu_torch.models.dlrm import (
        DLRM,
        LOGICAL_RULES,
        dlrm_shardings,
        tiny_dlrm,
    )
    from raydp_tpu_torch.parallel import MeshSpec
    from raydp_tpu_torch.parallel import collectives as C
    from raydp_tpu_torch.parallel.mesh import shard_module

    mesh = MeshSpec(**axes).build()
    model = DLRM(tiny_dlrm(dtype=torch.float32, embedding_impl="onehot"),
                 device="cpu")
    placements = shard_module(model, mesh, LOGICAL_RULES)
    assert placements == dlrm_shardings(model, mesh)
    model.load_state_dict(params_from_flax(tree, mesh=mesh,
                                           rules=LOGICAL_RULES))
    rows = _dp_rows(len(dense), mesh.coords, mesh.shape)
    logits = model(torch.from_numpy(dense[rows]),
                   torch.from_numpy(sparse[rows]).long())
    torch.sum(logits * torch.from_numpy(w[rows])).backward()
    tables = [tuple(t.table.shape) for t in model.emb]
    local = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return (mesh.coords, logits.detach().numpy(),
            _gathered_grads(model, mesh, C), tables,
            [t.impl for t in model.emb], local)


@pytest.mark.parametrize("axes", [dict(tp=4), dict(dp=2, tp=2)],
                         ids=["tp4", "dp2_tp2"])
def test_dlrm_tables_over_tp_match_jax(job, eight_cpu_devices, axes):
    cfg = jd.tiny_dlrm(dtype=jnp.float32, embedding_impl="onehot")
    rng = np.random.default_rng(2)
    dense = rng.standard_normal((8, cfg.dense_features)).astype(np.float32)
    sparse = np.stack([rng.integers(0, v, size=8) for v in cfg.vocab_sizes],
                      axis=1).astype(np.int32)
    w = rng.standard_normal(8).astype(np.float32)
    tree, want, gtree = _jax_dlrm(axes, dense, sparse, w)
    out = run(job, _dlrm_rank, axes, tree, dense, sparse, w)
    want_g = params_from_flax(gtree)
    tp = axes["tp"]
    for coords, logits, grads, tables, impls, _ in out:
        rows = _dp_rows(8, coords, {"dp": axes.get("dp", 1)})
        np.testing.assert_allclose(logits, want[rows], **FWD)
        assert set(grads) == set(want_g)
        for name, g in grads.items():
            np.testing.assert_allclose(g, want_g[name].numpy(),
                                       err_msg=name, **GRAD)
        assert tables == [(v // tp, cfg.embed_dim) for v in cfg.vocab_sizes]
        assert impls == ["onehot"] * cfg.n_tables
    spec = MeshSpec(**axes)
    back = gather_shards([o[-1] for o in out], None, spec,
                         rules=td.LOGICAL_RULES)
    for name, t in params_from_flax(tree).items():
        assert torch.equal(back[name], t), name


def test_auto_picks_onehot_for_a_cut_table():
    cfg = td.tiny_dlrm()
    assert [cfg.impl_for(v) for v in cfg.vocab_sizes] == ["take"] * 4
    assert [cfg.impl_for(v, sharded=True) for v in cfg.vocab_sizes] == \
        ["take", "onehot", "take", "take"]
    assert td.AUTO_ONEHOT_THRESHOLD == jd.AUTO_ONEHOT_THRESHOLD
    assert td.LOGICAL_RULES == jd.LOGICAL_RULES


# ------------------------------------------------------------------- MoE

def _moe_tokens(t, d, seed):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(
        np.float32)


def _jax_moe(cfg, axes, x, w, rules):
    layer = jm.MoELayer(cfg)
    # Only the parameters: init's sown loss would add to apply's.
    variables = {"params": nn.unbox(layer.init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"])}
    mesh = _jax_mesh(axes)
    _, shardings = jt.param_shardings(layer, mesh, jnp.asarray(x),
                                      rules=rules)
    params = jax.device_put(variables, {"params": shardings["params"]})
    xd = jax.device_put(x, NamedSharding(mesh, P("dp")))

    def run_(p, xs):
        out, state = layer.apply(p, xs, mutable=["losses"])
        return out, jm.moe_aux_loss(state)

    def loss(p):
        out, aux = run_({"params": p}, xd)
        return jnp.sum(out * w) + aux

    out, aux = jax.jit(run_)(params, xd)
    grads = jax.jit(jax.grad(loss))(params["params"])
    _, inter = layer.apply(variables, jnp.asarray(x), mutable=["losses"],
                           capture_intermediates=True)
    logits = np.asarray(inter["intermediates"]["router"]["__call__"][0])
    return (_tree(variables["params"]), np.asarray(out), float(aux),
            _tree(grads), logits)


def _kept_slots(logits, cfg):
    """The (token, choice) pairs the JAX layer keeps, from its router
    logits over the global batch."""
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    c = cfg.capacity(len(probs))
    used = np.zeros(cfg.n_experts)
    masked = probs.copy()
    kept = 0
    for _ in range(cfg.top_k):
        idx = masked.argmax(-1)
        for e in range(cfg.n_experts):
            n = int((idx == e).sum())
            take = min(n, max(0, c - int(used[e])))
            used[e] += take
            kept += take
        masked[np.arange(len(idx)), idx] = 0.0
    return kept


def _moe_rank(ctx, axes, tree, x, w, rules, cfg_kw):
    import torch

    from raydp_tpu_torch.models.moe import MoEConfig, MoELayer
    from raydp_tpu_torch.parallel import MeshSpec
    from raydp_tpu_torch.parallel import collectives as C
    from raydp_tpu_torch.parallel.mesh import shard_module

    cfg = MoEConfig(dtype=torch.float32, **cfg_kw)
    mesh = MeshSpec(**axes).build()
    layer = MoELayer(cfg)
    layer.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(
        v.T if k == "router.weight" else v)) for k, v in tree.items()})
    shard_module(layer, mesh, rules)
    rows = _dp_rows(len(x), mesh.coords, mesh.shape)
    out = layer(torch.from_numpy(x[rows]))
    (torch.sum(out * torch.from_numpy(w[rows])) + layer.aux_loss).backward()
    local = {n: p.grad.numpy().copy() for n, p in layer.named_parameters()}
    shapes = {n: tuple(p.shape) for n, p in layer.named_parameters()}
    return (mesh.coords, out.detach().numpy(), float(layer.aux_loss),
            float(layer.kept_slots), _gathered_grads(layer, mesh, C),
            local, shapes)


def _port_tree(tree):
    """The flax layer's leaves under the port's names (the router's
    kernel as the Linear's weight, transposed in the rank)."""
    return {("router.weight" if k == "router" else k):
            (v["kernel"] if k == "router" else v) for k, v in tree.items()}


def test_moe_layer_experts_over_dp_match_jax(job, eight_cpu_devices):
    kw = dict(d_model=32, d_ff=64, n_experts=4, top_k=2,
              capacity_factor=4.0)
    jcfg = jm.MoEConfig(dtype=jnp.float32, **kw)
    x = _moe_tokens(32, 32, seed=3)
    w = np.random.default_rng(4).standard_normal((32, 32)).astype(
        np.float32)
    axes = dict(dp=2, tp=2)
    tree, want, aux, gtree, _ = _jax_moe(jcfg, axes, x, w, MOE_RULES)
    out = run(job, _moe_rank, axes, _port_tree(tree), x, w, MOE_RULES, kw)
    want_g = {k: np.asarray(v) for k, v in _port_tree(gtree).items()}
    want_g["router.weight"] = want_g["router.weight"].T
    for coords, got, got_aux, _, grads, local, shapes in out:
        rows = _dp_rows(32, coords, {"dp": 2})
        np.testing.assert_allclose(got, want[rows], **FWD)
        np.testing.assert_allclose(got_aux, aux, **GRAD)
        for name, g in grads.items():
            np.testing.assert_allclose(g, want_g[name], err_msg=name, **GRAD)
        # The rank's own backward gives its experts' gradient, the JAX
        # gradient's block: no sum over dp.
        e = slice(coords["dp"] * 2, coords["dp"] * 2 + 2)
        f = slice(coords["tp"] * 32, coords["tp"] * 32 + 32)
        assert shapes["w_up"] == (2, 32, 32) and shapes["w_down"] == \
            (2, 32, 32) and shapes["b_down"] == (2, 32)
        np.testing.assert_allclose(local["w_up"], want_g["w_up"][e][:, :, f],
                                   **GRAD)
        np.testing.assert_allclose(local["w_down"],
                                   want_g["w_down"][e][:, f], **GRAD)
        np.testing.assert_allclose(local["b_down"], want_g["b_down"][e],
                                   **GRAD)


def test_moe_routing_over_a_dp_pair_matches_global_routing(
        pair, eight_cpu_devices):
    """Two ranks of 24 tokens route as the JAX layer routes the 48: one
    capacity, slot positions across the pair and the group's aux loss.
    The capacity binds (top-1, factor 1.0): a rank routing alone keeps
    other tokens."""
    kw = dict(d_model=32, d_ff=64, n_experts=4, top_k=1,
              capacity_factor=1.0)
    jcfg = jm.MoEConfig(dtype=jnp.float32, **kw)
    x = _moe_tokens(48, 32, seed=7)
    w = np.random.default_rng(8).standard_normal((48, 32)).astype(
        np.float32)
    axes = dict(dp=2)
    tree, want, aux, gtree, logits = _jax_moe(jcfg, axes, x, w,
                                              (("expert", None),))
    kept = _kept_slots(logits, jcfg)
    assert kept < 48
    out = run(pair, _moe_rank, axes, _port_tree(tree), x, w,
              (("expert", None),), kw)
    want_g = {k: np.asarray(v) for k, v in _port_tree(gtree).items()}
    want_g["router.weight"] = want_g["router.weight"].T
    for coords, got, got_aux, got_kept, grads, _, _ in out:
        assert got_kept == kept
        np.testing.assert_allclose(got_aux, aux, **GRAD)
        rows = _dp_rows(48, coords, {"dp": 2})
        np.testing.assert_allclose(got, want[rows], **FWD)
        for name, g in grads.items():
            np.testing.assert_allclose(g, want_g[name], err_msg=name, **GRAD)


# ------------------------------------------------------------------ fits

def _fit_rank(ctx, kind, axes, init, cols, opts):
    """The port's fit of ``kind`` on this rank's interleaved rows; the
    history, the gathered parameters, the placements, a prediction and a
    gathered checkpoint."""
    import numpy as np
    import torch

    from raydp_tpu_torch.data import MLDataset
    from raydp_tpu_torch.models import dlrm, moe
    from raydp_tpu_torch.models.transformer import tiny_transformer
    from raydp_tpu_torch.parallel import MeshSpec
    from raydp_tpu_torch.train import Estimator

    spec = MeshSpec(**axes)
    if kind == "dlrm":
        model = dlrm.PackedDLRM(dlrm.tiny_dlrm(dtype=torch.float32),
                                device="cpu")
        extra = dict(loss="bce", logical_rules=dlrm.LOGICAL_RULES,
                     feature_dtype=np.float32, label_dtype=np.float32)
    else:
        cfg = tiny_transformer(max_len=16, vocab_size=64, dropout_rate=0.0,
                               n_layers=2, dtype=torch.float32)
        model = moe.MoEClassifier(cfg, moe.MoEConfig(
            d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=4, top_k=1,
            capacity_factor=opts["capacity_factor"], dtype=torch.float32),
            2, device="cpu")
        extra = dict(loss="softmax_ce", aux_losses=True,
                     feature_dtype=np.int32, label_dtype=np.int32)
    model.load_state_dict(init)
    features = [c for c in cols if c != "label"]
    est = Estimator(
        model=model, optimizer=lambda p: torch.optim.SGD(p, lr=opts["lr"]),
        num_epochs=opts["epochs"], batch_size=opts["batch"] // spec.dp,
        feature_columns=features, label_column="label", mesh=spec, seed=0,
        shuffle=False, epoch_mode="stream", device="cpu", **extra)
    dp = spec.coords_of(ctx.rank)["dp"]
    shard = _interleaved(cols, opts["batch"], spec.dp, dp)
    history = est.fit(MLDataset([shard], 1))
    placements = est.param_placements()
    local = {n: tuple(p.shape) for n, p in model.named_parameters()}
    full = est.gathered_state_dict()
    x = np.stack([cols[c][:32] for c in features], 1)
    preds = est.predict(x)
    saved = est.save(opts["ckpt"])
    return dict(history=history, local=local,
                sharded={n: pl.spec for n, pl in placements.items()
                         if pl.sharded_axes},
                params={k: v.float().numpy() for k, v in full.items()}
                if ctx.rank == 0 else None, preds=preds, saved=saved)


def _ctr_cols(cfg, n, seed):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, cfg.dense_features)).astype(np.float32)
    sparse = np.stack([rng.integers(0, v, size=n) for v in cfg.vocab_sizes],
                      axis=1).astype(np.float32)
    y = ((dense[:, 0] + (sparse[:, 0] % 2) - 0.5) > 0).astype(np.float32)
    cols = {f"d{i}": dense[:, i] for i in range(cfg.dense_features)}
    cols.update({f"c{i}": sparse[:, i] for i in range(cfg.n_tables)})
    cols["label"] = y
    return cols


def _marker_cols(n, seq, vocab, seed):
    """tests/test_moe.py's rows: the label is whether token 7 appears."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, vocab, size=(n, seq))
    pos = rng.random(n) < 0.5
    ids[pos, rng.integers(0, seq, pos.sum())] = 7
    cols = {f"t{i}": ids[:, i].astype(np.int32) for i in range(seq)}
    cols["label"] = pos.astype(np.int32)
    return cols


def _jax_fit(kind, axes, cols, opts):
    """``JAXEstimator`` on the JAX mesh, from its own initial parameters:
    (initial tree, a function that fits and returns the history and the
    trained tree)."""
    features = [c for c in cols if c != "label"]
    x = np.stack([cols[c] for c in features], 1)
    if kind == "dlrm":
        model = jd.PackedDLRM(jd.tiny_dlrm(dtype=jnp.float32))
        extra = dict(loss="bce", logical_rules=jd.LOGICAL_RULES)
    else:
        cfg = jt.tiny_transformer(max_len=16, vocab_size=64, dropout_rate=0.0,
                                  n_layers=2, dtype=jnp.float32)
        model = jm.MoEClassifier(cfg=cfg, moe=jm.MoEConfig(
            d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=4, top_k=1,
            capacity_factor=opts["capacity_factor"], dtype=jnp.float32),
            num_classes=2)
        extra = dict(loss="softmax_ce", aux_losses=True,
                     feature_dtype=np.int32, label_dtype=np.int32)
    init = _tree(model.init(jax.random.PRNGKey(0),
                            jnp.asarray(x[:1]))["params"])
    est = JAXEstimator(model=model, optimizer=optax.sgd(opts["lr"]),
                       num_epochs=opts["epochs"], batch_size=opts["batch"],
                       feature_columns=features, label_column="label",
                       mesh=JaxMeshSpec(**axes), seed=0, shuffle=False,
                       epoch_mode="stream", **extra)

    def fit():
        hist = est.fit(JaxMLDataset([pa.table(cols)], 1))
        return hist, _tree(est._state.params["params"])

    return init, fit


def _port_init(kind, init):
    if kind == "dlrm":
        return params_from_flax(init)
    cfg = tt.tiny_transformer(max_len=16, vocab_size=64, n_layers=2,
                              dtype=torch.float32)
    return params_from_flax(init, cfg)


def _assert_trained_close(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w.numpy(), err_msg=name,
                                   **PARAM_TOL)


def _restored(kind, path, x):
    """A one-process estimator restored from a gang's gathered
    checkpoint: its parameters and its predictions of ``x``."""
    from raydp_tpu_torch.train import Estimator

    kw = {}
    if kind == "dlrm":
        model = td.PackedDLRM(td.tiny_dlrm(dtype=torch.float32), device="cpu")
    else:
        kw = dict(feature_dtype=np.int32)
        cfg = tt.tiny_transformer(max_len=16, vocab_size=64, n_layers=2,
                                  dropout_rate=0.0, dtype=torch.float32)
        model = tm.MoEClassifier(cfg, tm.MoEConfig(
            d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=4, top_k=1,
            dtype=torch.float32), 2, device="cpu")
    est = Estimator(model=model, device="cpu", **kw)
    est.restore_path(path)
    return est.get_model().state_dict(), est.predict(x)


FITS = {
    "dlrm": (lambda: _ctr_cols(jd.tiny_dlrm(), 128, seed=0),
             dict(lr=0.1, epochs=2, batch=64)),
    "moe": (lambda: _marker_cols(128, 16, 64, seed=0),
            dict(lr=0.05, epochs=2, batch=64, capacity_factor=2.0)),
}


def _fit_both(gang_, kind, axes, tmp_path):
    make_cols, opts = FITS[kind]
    cols = make_cols()
    opts = dict(opts, ckpt=str(tmp_path / kind))
    init, jax_fit = _jax_fit(kind, axes, cols, opts)
    # The JAX fit runs beside the gang's (the gang's time limit needs the
    # main thread's signals).
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(jax_fit)
        out = run(gang_, _fit_rank, kind, axes, _port_init(kind, init),
                  cols, opts)
        jhist, trained = jax_run.result()
    for r in out:
        for j, t in zip(jhist, r["history"]):
            np.testing.assert_allclose(t["train_loss"], j["train_loss"],
                                       rtol=RTOL)
    _assert_trained_close(out[0]["params"], _port_init(kind, trained))
    features = [c for c in cols if c != "label"]
    x = np.stack([cols[c][:32] for c in features], 1)
    state, preds = _restored(kind, out[0]["saved"], x)
    for name, want in out[0]["params"].items():
        assert np.array_equal(state[name].numpy(), want), name
    if kind == "dlrm":
        # An MoE's capacity follows its batch: one process routes these
        # rows alone, the gang's ranks route them as a dp pair.
        np.testing.assert_allclose(preds, out[0]["preds"], **FWD)
    return out


def test_packed_dlrm_fit_with_cut_tables_matches_jax_estimator(
        job, eight_cpu_devices, tmp_path):
    out = _fit_both(job, "dlrm", dict(dp=2, tp=2), tmp_path)
    cfg = td.tiny_dlrm()
    for r in out:
        for t, v in enumerate(cfg.vocab_sizes):
            assert r["local"][f"dlrm.emb.{t}.table"] == \
                (v // 2, cfg.embed_dim)
            assert r["sharded"][f"dlrm.emb.{t}.table"] == ("tp",)
        assert r["local"]["dlrm.bottom.0.weight"][0] * 2 == \
            cfg.bottom_mlp[0]


def test_moe_classifier_fit_with_experts_over_dp_matches_jax_estimator(
        job, eight_cpu_devices, tmp_path):
    out = _fit_both(job, "moe", dict(dp=2, tp=2), tmp_path)
    cfg = tt.tiny_transformer()
    for r in out:
        assert r["sharded"]["blocks.0.moe.w_up"] == ("dp", None, "tp")
        assert r["local"]["blocks.0.moe.w_up"] == \
            (2, cfg.d_model, cfg.d_ff // 2)
        assert r["sharded"]["blocks.0.attn.qkv.weight"] == (None, "tp")


def test_moe_fit_on_a_dp_gang_matches_jax_global_routing(
        pair, eight_cpu_devices, tmp_path):
    """tests/test_moe.py:164-223's classifier (top-1, capacity factor
    2.0) with ``aux_losses=True``: a 2-rank data-parallel fit against
    ``JAXEstimator(mesh=MeshSpec(dp=2))`` on the same global batches."""
    out = _fit_both(pair, "moe", dict(dp=2), tmp_path)
    assert not out[0]["sharded"]
