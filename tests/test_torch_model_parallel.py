"""The port's tensor- and sequence-parallel transformer
(``raydp_tpu_torch/models/transformer.py``) and the converter's mesh cut
(``models/convert.py``) against the JAX package's classifier on the same
mesh (``raydp_tpu/models/transformer.py:105-190, 235-246, 277-296,
342-355, 465-494``).

The same converted flax parameters and numpy ids go through the JAX
``SequenceClassifier`` on the conftest's virtual CPU devices (its
parameters placed by ``param_shardings`` on a JAX mesh) and through the
port's, built on each rank of a gang of 4 gloo CPU ranks with the
mesh's ``cfg.mesh`` (so it is cut at construction) and loaded with
``params_from_flax(..., mesh=)``: ``MeshSpec(sp=2, tp=2)`` with dense
(K/V gathered over sp), ring and Ulysses attention, and
``MeshSpec(dp=2, tp=2)`` with the flash path (its plain version on the
CPU) on each rank's heads. Logits at the forward bound (2e-4 / 2e-5);
the gradients, after the estimator's rule (the loss seeded on sp rank 0,
each gradient summed over the dp and sp axes that replicate it) and
gathered to full arrays, at the gradient bound (1e-3 / 1e-4). Each rank
holds tp blocks of ``qkv``, ``out``, ``mlp_up`` and ``mlp_down``, and
the converter's gather puts the ranks' blocks back together exactly.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raydp_tpu.models import transformer as jt
from raydp_tpu.parallel import MeshSpec as JaxMeshSpec
from raydp_tpu_torch.models import transformer as tt
from raydp_tpu_torch.models.convert import gather_shards, params_from_flax
from raydp_tpu_torch.parallel import MeshSpec
from torch_mesh_gang import gang, run

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)
B, S = 4, 16


@pytest.fixture(scope="module")
def job():
    with gang(4, "t-mp") as j:
        yield j


def _jax_case(impl, axes):
    jcfg_kw = dict(vocab_size=64, max_len=S, dropout_rate=0.0,
                   dtype=jnp.float32, n_heads=4)
    mesh = JaxMeshSpec(**axes).build(jax.devices()[:4])
    jimpl = "dense" if impl == "flash" else impl
    jcfg = jt.tiny_transformer(attention_impl=jimpl, mesh=mesh, **jcfg_kw)
    model = jt.SequenceClassifier(jcfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (B, S)).astype(np.int32)
    w = rng.standard_normal((B, 2)).astype(np.float32)
    _, shardings = jt.param_shardings(model, mesh, jnp.asarray(ids))
    variables = jax.jit(
        lambda: nn.unbox(model.init(jax.random.PRNGKey(0),
                                    jnp.asarray(ids))),
        out_shardings=shardings)()

    def loss(p):
        return jnp.sum(model.apply({"params": p}, jnp.asarray(ids)) * w)

    logits = jax.jit(model.apply)(variables, jnp.asarray(ids))
    grads = jax.jit(jax.grad(loss))(variables["params"])
    tree = jax.tree_util.tree_map(np.asarray, variables["params"])
    gtree = jax.tree_util.tree_map(np.asarray, grads)
    return ids, w, tree, np.asarray(logits), gtree


def _port_rank(ctx, impl, axes, tree, ids, w):
    import torch

    from raydp_tpu_torch.models.convert import params_from_flax
    from raydp_tpu_torch.models.transformer import (
        SequenceClassifier,
        tiny_transformer,
    )
    from raydp_tpu_torch.parallel import MeshSpec
    from raydp_tpu_torch.parallel import collectives as C

    mesh = MeshSpec(**axes).build()
    cfg = tiny_transformer(vocab_size=64, max_len=ids.shape[1],
                           dropout_rate=0.0, dtype=torch.float32, n_heads=4,
                           attention_impl=impl, mesh=mesh)
    model = SequenceClassifier(cfg, device="cpu")
    missing, unexpected = model.load_state_dict(
        params_from_flax(tree, cfg, mesh=mesh), strict=False)
    assert set(missing) <= {"encoder.seg_embed.weight"} and not unexpected
    dp, n_dp = mesh.coords["dp"], mesh.shape["dp"]
    rows = slice(dp * len(ids) // n_dp, (dp + 1) * len(ids) // n_dp)
    logits = model(torch.from_numpy(ids[rows]).long())
    seed = float(mesh.coords["sp"] == 0)
    (torch.sum(logits * torch.from_numpy(w[rows])) * seed).backward()
    grads, shapes = {}, {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        pl = model.placements[name]
        axes_r = [a for a in ("dp", "pp", "sp") if a in pl.replicated_axes]
        g = C.all_reduce_raw(p.grad, mesh.group(*axes_r)) if axes_r \
            else p.grad
        grads[name] = pl.gather(g).numpy()
        shapes[name] = tuple(p.shape)
    local = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return (mesh.coords, logits.detach().numpy(), grads, shapes, local)


@pytest.mark.parametrize("impl,axes", [
    ("dense", dict(sp=2, tp=2)),
    ("ring", dict(sp=2, tp=2)),
    ("ulysses", dict(sp=2, tp=2)),
    ("flash", dict(dp=2, tp=2)),
])
def test_classifier_on_a_mesh_matches_jax(job, eight_cpu_devices, impl,
                                          axes):
    ids, w, tree, want, gtree = _jax_case(impl, axes)
    out = run(job, _port_rank, impl, axes, tree, ids, w)
    cfg = tt.tiny_transformer(vocab_size=64, max_len=S, dropout_rate=0.0,
                              dtype=torch.float32, n_heads=4)
    want_g = params_from_flax(gtree, cfg)
    n_dp = axes.get("dp", 1)
    for coords, logits, grads, shapes, _ in out:
        rows = slice(coords["dp"] * B // n_dp, (coords["dp"] + 1) * B // n_dp)
        np.testing.assert_allclose(logits, want[rows], **FWD)
        assert set(grads) == set(want_g), set(want_g) ^ set(grads)
        for name, g in grads.items():
            np.testing.assert_allclose(g, want_g[name].numpy(),
                                       err_msg=name, **GRAD)
        # tp blocks of the four Megatron layers: half the rows (qkv,
        # mlp_up) or columns (out, mlp_down).
        full = {k: tuple(v.shape) for k, v in want_g.items()}
        for layer, dim in (("attn.qkv", 0), ("attn.out", 1),
                           ("mlp_up", 0), ("mlp_down", 1)):
            name = f"encoder.blocks.0.{layer}.weight"
            assert shapes[name][dim] * 2 == full[name][dim], name
            assert shapes[name][1 - dim] == full[name][1 - dim], name
    # The converter's inverse: the ranks' blocks gather to the full tree.
    spec = MeshSpec(**axes)
    back = gather_shards([local for *_, local in out], cfg, spec)
    full = params_from_flax(tree, cfg)
    for name, t in full.items():
        assert torch.equal(back[name], t), name


def test_params_from_flax_cuts_by_coords():
    """``params_from_flax(..., mesh=MeshSpec, coords=)`` without process
    groups: each rank's block, heads over tp."""
    cfg_j = jt.tiny_transformer(vocab_size=64, max_len=S, dtype=jnp.float32,
                                n_heads=4)
    ids = jnp.zeros((1, S), jnp.int32)
    tree = jax.tree_util.tree_map(np.asarray, nn.unbox(
        jt.SequenceClassifier(cfg_j).init(jax.random.PRNGKey(0), ids)
    )["params"])
    cfg = tt.tiny_transformer(vocab_size=64, max_len=S, dtype=torch.float32,
                              n_heads=4)
    spec = MeshSpec(sp=2, tp=2)
    full = params_from_flax(tree, cfg)
    blocks = [params_from_flax(tree, cfg, mesh=spec,
                               coords=spec.coords_of(r)) for r in range(4)]
    q = full["encoder.blocks.0.attn.qkv.weight"].reshape(3, 4, 32, 128)
    for r, blk in enumerate(blocks):
        tp = spec.coords_of(r)["tp"]
        want = q[:, 2 * tp:2 * tp + 2].reshape(-1, 128)
        assert torch.equal(blk["encoder.blocks.0.attn.qkv.weight"], want)
        assert torch.equal(blk["encoder.pos_embed.weight"],
                           full["encoder.pos_embed.weight"])
    back = gather_shards(blocks, cfg, spec)
    assert all(torch.equal(back[k], full[k]) for k in full)
    with pytest.raises(ValueError, match="coords"):
        params_from_flax(tree, cfg, mesh=spec)
