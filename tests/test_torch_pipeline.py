"""The port's GPipe pipeline (``raydp_tpu_torch/parallel/pipeline.py``)
and ``PipelinedClassifier`` (``models/pipelined.py``) against
``tests/test_pipeline.py``'s cases and the JAX package's classifier.

The pipeline runs on a gang of 4 gloo CPU ranks, one process per mesh
position, each holding its stage (``stage_sharding``) and its dp rows:
its forward and gradients equal the stages run in sequence in one
process (f32, 1e-5 as the reference holds them), with transformer blocks
as the stages at the reference's bf16 bound, and the JAX package's
``spmd_pipeline`` on the same stacked parameters. The microbatch, stack
and bubble helpers run in-process. ``PipelinedClassifier``'s logits and
gradients (after the estimator's rule: the loss seeded on the last
stage, each gradient summed over the dp and pp axes that replicate it)
match the JAX classifier's from the same stacked parameters at the
forward and gradient bounds; the validation raises as the reference's.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raydp_tpu.models.pipelined import PipelinedClassifier as JaxPipelined
from raydp_tpu.models.transformer import tiny_transformer as jax_tiny
from raydp_tpu.parallel import MeshSpec as JaxMeshSpec
from raydp_tpu.parallel.pipeline import spmd_pipeline as jax_spmd_pipeline
from raydp_tpu.parallel.pipeline import stack_stages as jax_stack_stages
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.models.pipelined import PipelinedClassifier
from raydp_tpu_torch.models.transformer import tiny_transformer
from raydp_tpu_torch.parallel import MeshSpec
from raydp_tpu_torch.parallel.pipeline import (
    microbatch,
    pipeline_bubble_fraction,
    stack_stages,
    unstack_stages,
)
from torch_mesh_gang import gang, run

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)
SEQ = 16


@pytest.fixture(scope="module")
def job():
    with gang(4, "t-pipe") as j:
        yield j


def _mlp_stages(n_stages, width, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((width, width)) * 0.3).astype(
                np.float32),
             "b": rng.standard_normal(width).astype(np.float32)}
            for _ in range(n_stages)]


def _stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _sequential(stages, x, grad_y=None):
    ps = [{k: torch.from_numpy(v).requires_grad_() for k, v in s.items()}
          for s in stages]
    out = torch.from_numpy(x)
    for p in ps:
        out = _stage_fn(p, out)
    if grad_y is not None:
        torch.mean((out - torch.from_numpy(grad_y)) ** 2).backward()
    return out.detach().numpy(), [{k: v.grad for k, v in p.items()}
                                  for p in ps]


def _port_pipeline(ctx, axes, stages, x, n_mb, y):
    """This rank's pipelined output and its stage's gradients."""
    import torch

    from raydp_tpu_torch.parallel import MeshSpec
    from raydp_tpu_torch.parallel import collectives as C
    from raydp_tpu_torch.parallel.pipeline import (
        spmd_pipeline,
        stack_stages,
        stage_sharding,
    )

    def stage_fn(params, mb):
        return torch.tanh(mb @ params["w"] + params["b"])

    mesh = MeshSpec(**axes).build()
    full = stack_stages([{k: torch.from_numpy(v) for k, v in s.items()}
                         for s in stages])
    places = stage_sharding(mesh, full)
    local = {k: places[k].shard(v).clone().requires_grad_()
             for k, v in full.items()}
    dp, n_dp = mesh.coords["dp"], mesh.shape["dp"]
    rows = slice(dp * len(x) // n_dp, (dp + 1) * len(x) // n_dp)
    out = spmd_pipeline(stage_fn, mesh, n_mb)(local,
                                              torch.from_numpy(x[rows]))
    grads = None
    if y is not None:
        last = float(mesh.coords["pp"] == mesh.shape["pp"] - 1)
        loss = torch.sum((out - torch.from_numpy(y[rows])) ** 2) / y.size
        (loss * last).backward()
        grads = {k: C.all_reduce_raw(v.grad, mesh.group("dp")).numpy()
                 for k, v in local.items()}
    return mesh.coords, out.detach().numpy(), grads


def test_pipeline_matches_sequential_forward(job, eight_cpu_devices):
    """dp2·pp2 here (the reference's dp2·pp4 needs 8 processes): each
    rank's rows of the output, against the stages in sequence and
    against the JAX package's pipeline on the same stacked stages."""
    stages = _mlp_stages(2, 16)
    x = np.random.default_rng(1).standard_normal((32, 16)).astype(
        np.float32)
    want, _ = _sequential(stages, x)
    jmesh = JaxMeshSpec(dp=2, pp=2).build(jax.devices()[:4])
    jstacked = jax_stack_stages([{k: jnp.asarray(v) for k, v in s.items()}
                                 for s in stages])
    jwant = np.asarray(jax_spmd_pipeline(
        lambda p, mb: jnp.tanh(mb @ p["w"] + p["b"]), jmesh, 8)(
            jstacked, jnp.asarray(x)))
    for coords, out, _ in run(job, _port_pipeline, dict(dp=2, pp=2),
                              stages, x, 8, None):
        rows = slice(coords["dp"] * 16, coords["dp"] * 16 + 16)
        np.testing.assert_allclose(out, want[rows], atol=1e-5)
        np.testing.assert_allclose(out, jwant[rows], atol=1e-5)


def test_pipeline_gradients_match_sequential(job):
    stages = _mlp_stages(4, 8, seed=3)
    x = np.random.default_rng(2).standard_normal((8, 8)).astype(np.float32)
    y = np.random.default_rng(4).standard_normal((8, 8)).astype(np.float32)
    _, want = _sequential(stages, x, y)
    for coords, _, grads in run(job, _port_pipeline, dict(pp=4), stages, x,
                                4, y):
        for k, g in grads.items():
            np.testing.assert_allclose(g[0], want[coords["pp"]][k].numpy(),
                                       atol=1e-5, err_msg=k)


def _port_blocks(ctx, stages, x):
    import torch

    from raydp_tpu_torch.models.transformer import (
        TransformerBlock,
        tiny_transformer,
    )
    from raydp_tpu_torch.parallel import MeshSpec
    from raydp_tpu_torch.parallel.pipeline import (
        spmd_pipeline,
        stack_stages,
        stage_sharding,
    )

    mesh = MeshSpec(dp=2, pp=2).build()
    block = TransformerBlock(tiny_transformer(n_layers=2))
    full = stack_stages([{k: torch.from_numpy(v) for k, v in s.items()}
                         for s in stages])
    places = stage_sharding(mesh, full)
    local = {k: places[k].shard(v) for k, v in full.items()}
    rows = slice(mesh.coords["dp"] * 4, mesh.coords["dp"] * 4 + 4)

    def stage_fn(params, mb):
        return torch.func.functional_call(block, params, (mb,))

    with torch.no_grad():
        out = spmd_pipeline(stage_fn, mesh, 4)(local,
                                               torch.from_numpy(x[rows]))
    return mesh.coords, out.float().numpy()


def test_pipeline_transformer_blocks(job):
    """Real stages: each pp rank runs one bf16 TransformerBlock; the
    reference's bound for its bf16 reordering (6e-2)."""
    from raydp_tpu_torch.models.transformer import (
        TransformerBlock,
        init_params,
    )

    cfg = tiny_transformer(n_layers=2)
    blocks = [TransformerBlock(cfg) for _ in range(2)]
    gen = torch.Generator().manual_seed(0)
    for b in blocks:
        init_params(b, gen)
    x = np.random.default_rng(0).standard_normal((8, 16, cfg.d_model)).astype(
        np.float32)
    with torch.no_grad():
        want = torch.from_numpy(x)
        for b in blocks:
            want = b(want)
    stages = [{k: v.numpy() for k, v in b.state_dict().items()}
              for b in blocks]
    for coords, out in run(job, _port_blocks, stages, x):
        rows = slice(coords["dp"] * 4, coords["dp"] * 4 + 4)
        np.testing.assert_allclose(out, want.float().numpy()[rows],
                                   atol=6e-2)


def test_microbatch_roundtrip():
    x = torch.arange(24.0).reshape(12, 2)
    m = microbatch(x, 3)
    assert m.shape == (3, 4, 2)
    assert torch.equal(m.reshape(12, 2), x)
    with pytest.raises(ValueError):
        microbatch(x, 5)


def test_stack_unstack_roundtrip():
    stages = [{k: torch.from_numpy(v) for k, v in s.items()}
              for s in _mlp_stages(3, 4)]
    stacked = stack_stages(stages)
    assert stacked["w"].shape == (3, 4, 4)
    for a, b in zip(stages, unstack_stages(stacked, 3)):
        assert torch.equal(a["w"], b["w"])


def test_bubble_fraction():
    assert pipeline_bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert pipeline_bubble_fraction(1, 8) == 0.0
    assert pipeline_bubble_fraction(4, 16) < 0.2


def test_pp_validation():
    cfg = tiny_transformer(dropout_rate=0.0)
    with pytest.raises(ValueError, match="pp axis"):
        PipelinedClassifier(cfg, MeshSpec(dp=2), device="cpu")
    with pytest.raises(ValueError, match="dropout"):
        PipelinedClassifier(tiny_transformer(dropout_rate=0.1),
                            MeshSpec(pp=2), device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        PipelinedClassifier(tiny_transformer(n_layers=3, dropout_rate=0.0),
                            MeshSpec(pp=2), device="cpu")


def test_pipelined_classifier_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelinedClassifier(tiny_transformer(dropout_rate=0.0),
                            MeshSpec(pp=2))


def _jax_pipelined(axes, n_mb):
    mesh = JaxMeshSpec(**axes)
    cfg = jax_tiny(max_len=SEQ, vocab_size=64, dropout_rate=0.0,
                   dtype=jnp.float32, n_layers=max(2, mesh.pp))
    model = JaxPipelined(cfg, mesh, num_classes=2, n_microbatches=n_mb)
    model._mesh = mesh.build(jax.devices()[:mesh.size])
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (8, SEQ)).astype(np.int32)
    w = rng.standard_normal((8, 2)).astype(np.float32)
    params = nn.unbox(model.init(jax.random.PRNGKey(0), jnp.asarray(ids)))
    logits = np.asarray(jax.jit(model.apply)(params, jnp.asarray(ids)))
    grads = jax.jit(jax.grad(lambda p: jnp.sum(
        model.apply(p, jnp.asarray(ids)) * w)))(params)
    strip = lambda t: {k: jax.tree_util.tree_map(np.asarray, v["params"])
                       for k, v in t.items()}
    return ids, w, strip(params), logits, strip(grads)


def _port_pipelined(ctx, axes, tree, ids, w, n_mb):
    import torch

    from raydp_tpu_torch.models.convert import params_from_flax
    from raydp_tpu_torch.models.pipelined import PipelinedClassifier
    from raydp_tpu_torch.models.transformer import tiny_transformer
    from raydp_tpu_torch.parallel import MeshSpec
    from raydp_tpu_torch.parallel import collectives as C
    from raydp_tpu_torch.parallel.mesh import shard_module
    from raydp_tpu_torch.models.transformer import LOGICAL_RULES

    spec = MeshSpec(**axes)
    cfg = tiny_transformer(max_len=ids.shape[1], vocab_size=64,
                           dropout_rate=0.0, dtype=torch.float32,
                           n_layers=max(2, spec.pp))
    model = PipelinedClassifier(cfg, spec, n_microbatches=n_mb,
                                device="cpu")
    model.load_state_dict(params_from_flax(tree, cfg))
    mesh = spec.build()
    places = shard_module(model, mesh, LOGICAL_RULES)
    dp, n_dp = mesh.coords["dp"], mesh.shape["dp"]
    rows = slice(dp * len(ids) // n_dp, (dp + 1) * len(ids) // n_dp)
    logits = model(torch.from_numpy(ids[rows]).long())
    last = float(mesh.coords["pp"] == mesh.shape["pp"] - 1)
    (torch.sum(logits * torch.from_numpy(w[rows])) * last).backward()
    grads = {}
    for name, p in model.named_parameters():
        pl = places[name]
        axes_r = [a for a in ("dp", "pp", "sp") if a in pl.replicated_axes]
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        g = C.all_reduce_raw(g, mesh.group(*axes_r)) if axes_r else g
        grads[name] = pl.gather(g).numpy()
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return mesh.coords, logits.detach().numpy(), grads, shapes


@pytest.mark.parametrize("axes,n_mb", [(dict(dp=2, pp=2), None),
                                       (dict(dp=2, pp=2), 2),
                                       (dict(pp=4), 8)])
def test_pipelined_classifier_matches_jax(job, eight_cpu_devices, axes,
                                          n_mb):
    """The same stacked parameters: logits and every gradient, stage
    parameters held a stage a pp rank."""
    ids, w, tree, want, gtree = _jax_pipelined(axes, n_mb)
    cfg = tiny_transformer(max_len=SEQ, vocab_size=64, dropout_rate=0.0,
                           dtype=torch.float32, n_layers=max(2, axes["pp"]))
    want_g = params_from_flax(gtree, cfg)
    n_dp = axes.get("dp", 1)
    for coords, logits, grads, shapes in run(job, _port_pipelined, axes,
                                             tree, ids, w, n_mb):
        rows = slice(coords["dp"] * 8 // n_dp, (coords["dp"] + 1) * 8 // n_dp)
        np.testing.assert_allclose(logits, want[rows], **FWD)
        assert set(grads) == set(want_g)
        for name, g in grads.items():
            np.testing.assert_allclose(g, want_g[name].numpy(),
                                       err_msg=name, **GRAD)
        assert shapes["stages.attn.qkv.weight"][0] == 1


def test_pipelined_classifier_unbound_runs_the_stages_in_sequence(
        eight_cpu_devices):
    """One process, no mesh: the stages in sequence equal the JAX
    classifier's pipelined logits (``test_pp_matches_sequential_blocks``
    from the other side)."""
    ids, _, tree, want, _ = _jax_pipelined(dict(pp=2), 4)
    cfg = tiny_transformer(max_len=SEQ, vocab_size=64, dropout_rate=0.0,
                           dtype=torch.float32)
    model = PipelinedClassifier(cfg, MeshSpec(pp=2), n_microbatches=4,
                                device="cpu")
    model.load_state_dict(params_from_flax(tree, cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, **FWD)
