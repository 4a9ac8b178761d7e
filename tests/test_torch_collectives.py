"""The port's mesh and collectives (``raydp_tpu_torch/parallel/mesh.py``,
``parallel/collectives.py``) against ``tests/test_parallel.py`` and
``tests/test_config.py``'s mesh cases, on a gang of 4 gloo CPU ranks.

Every autograd op of the collectives module (copy to and reduce from the
tp region, all_gather, all_to_all, the ring shift) and its gradient is
held against the same arithmetic in one process, over groups of 2 and 4
ranks; the reference's psum over dp, tp-sharded matmul and gradient
all-reduce cases run on the port's mesh; the logical rules, ``factor_devices``
and ``logical_to_spec`` equal the JAX package's. A collective on a
device its backend cannot serve raises.
"""
import numpy as np
import pytest
import torch

from raydp_tpu.parallel import MeshSpec as JaxMeshSpec
from raydp_tpu.parallel import factor_devices as jax_factor_devices
from raydp_tpu.parallel import logical_to_spec as jax_logical_to_spec
from raydp_tpu.parallel.mesh import DEFAULT_LOGICAL_RULES as JAX_RULES
from raydp_tpu.models.transformer import LOGICAL_RULES as JAX_TF_RULES
from raydp_tpu_torch.models.transformer import LOGICAL_RULES
from raydp_tpu_torch.parallel import (
    AXIS_ORDER,
    DEFAULT_LOGICAL_RULES,
    MeshSpec,
    factor_devices,
    logical_to_spec,
    named_sharding,
)
from torch_mesh_gang import gang, run

EXACT = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def job():
    with gang(4, "t-coll") as j:
        yield j


def test_rules_and_exports_match_jax():
    assert DEFAULT_LOGICAL_RULES == JAX_RULES
    assert LOGICAL_RULES == JAX_TF_RULES
    assert AXIS_ORDER == ("dp", "pp", "sp", "tp")
    for n in (1, 2, 4, 6, 8, 16):
        assert factor_devices(n).axis_sizes == \
            jax_factor_devices(n).axis_sizes


def test_factor_devices():
    spec = factor_devices(8)
    assert spec.size == 8
    assert spec.tp == 2 and spec.sp == 2
    assert factor_devices(1).size == 1
    assert factor_devices(6).size == 6


@pytest.mark.parametrize("axes,mesh", [
    (["batch", "sequence", "hidden"], dict(dp=2, tp=2, sp=2)),
    (["batch", "heads", "mlp"], dict(dp=8)),
    (["batch", "mlp"], dict(dp=2, tp=4)),
    (["embed", "heads"], dict(dp=2, tp=4)),
    (["vocab", "stage", "expert"], dict(pp=2, dp=4)),
])
def test_logical_to_spec_matches_jax(eight_cpu_devices, axes, mesh):
    """The port's tuple equals the JAX PartitionSpec's entries."""
    want = jax_logical_to_spec(axes, mesh=JaxMeshSpec(**mesh).build())
    assert logical_to_spec(axes, mesh=MeshSpec(**mesh)) == tuple(want)
    assert logical_to_spec(["batch", "sequence", "hidden"],
                           mesh=MeshSpec(dp=2, tp=2, sp=2)) == ("dp", "sp")


def test_logical_rules_tp():
    mesh = MeshSpec(dp=2, tp=4)
    assert logical_to_spec(["batch", "mlp"], mesh=mesh) == ("dp", "tp")
    assert logical_to_spec(["embed", "heads"], mesh=mesh) == (None, "tp")


def test_mesh_spec_takes_every_axis():
    spec = MeshSpec(dp=2, pp=2, sp=2, tp=2)
    assert spec.size == 16 and not spec.data_parallel_only
    # Rank r sits where arange(size).reshape(dp, pp, sp, tp) puts it.
    assert spec.coords_of(1) == dict(dp=0, pp=0, sp=0, tp=1)
    assert spec.coords_of(6) == dict(dp=0, pp=1, sp=1, tp=0)
    with pytest.raises(ValueError):
        MeshSpec(tp=0)
    with pytest.raises(ValueError, match="needs 4 processes"):
        MeshSpec(sp=4).build()


def test_placement_cuts_and_names_the_view():
    spec = MeshSpec(sp=2, tp=2)

    class At:
        shape = spec.axis_sizes
        coords = spec.coords_of(3)

    full = torch.arange(3 * 4 * 2 * 5.0).reshape(3 * 4 * 2, 5)
    pl = named_sharding(At, None, "tp", None, None)
    pl = type(pl)(At, pl.spec, (3, 4, 2, 5))
    got = pl.shard(full)
    want = full.reshape(3, 4, 2, 5)[:, 2:].reshape(12, 5)
    assert torch.equal(got, want)
    assert pl.sharded_axes == ("tp",) and pl.replicated_axes == ("sp",)


def _mesh_groups(ctx):
    from raydp_tpu_torch.parallel import MeshSpec

    m = MeshSpec(dp=2, tp=2).build()
    return (m.coords, m.members("tp"), m.members("dp"),
            m.members("dp", "tp"), m.group("pp") is None)


def test_mesh_build_lays_ranks_out_as_jax(job, eight_cpu_devices):
    out = run(job, _mesh_groups)
    grid = np.asarray(JaxMeshSpec(dp=2, tp=2).build().devices)
    ids = np.vectorize(lambda d: d.id)(grid).reshape(2, 1, 1, 2)
    for rank, (coords, tp, dp, both, no_pp) in enumerate(out):
        assert ids[coords["dp"], 0, 0, coords["tp"]] == rank
        assert tp == tuple(4 * 0 + 2 * coords["dp"] + t for t in range(2))
        assert dp == tuple(2 * d + coords["tp"] for d in range(2))
        assert both == (0, 1, 2, 3) and no_pp


def _psum_over_dp(ctx):
    import torch

    from raydp_tpu_torch.parallel import MeshSpec
    from raydp_tpu_torch.parallel import collectives as C

    m = MeshSpec(dp=4).build()
    x = torch.arange(4.0)[ctx.rank:ctx.rank + 1]
    return C.all_reduce_raw(x, m.group("dp")).numpy()


def test_psum_over_dp(job):
    out = run(job, _psum_over_dp)
    for got in out:
        np.testing.assert_allclose(got, [6.0])


def _tp_matmul(ctx, x, w):
    """Megatron: column-parallel w (x copied in), then the output
    gathered over tp; gradients of x and of the rank's w block. The tp
    peers compute the same loss from the gathered output, so one of them
    seeds it (all_gather's backward sums the peers' gradients)."""
    import torch

    from raydp_tpu_torch.parallel import MeshSpec
    from raydp_tpu_torch.parallel import collectives as C

    m = MeshSpec(dp=2, tp=2).build()
    tp, dp = m.group("tp"), m.coords["dp"]
    rows = torch.from_numpy(x).chunk(2)[dp].clone().requires_grad_()
    cols = torch.from_numpy(w).chunk(2, dim=1)[m.coords["tp"]].clone()
    cols.requires_grad_()
    out = C.all_gather(C.copy_to_region(rows, tp) @ cols, 1, tp)
    ((out * out).sum() * float(m.coords["tp"] == 0)).backward()
    return out.detach().numpy(), rows.grad.numpy(), cols.grad.numpy()


def test_tp_matmul_sharded(job):
    """Weight cut over tp, rows over dp: the product, and its gradients,
    equal one process's (``test_parallel.py::test_tp_matmul_sharded``)."""
    x = np.random.default_rng(0).standard_normal((16, 32)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((32, 64)).astype(np.float32)
    xt, wt = torch.from_numpy(x).requires_grad_(), \
        torch.from_numpy(w).requires_grad_()
    want = xt @ wt
    (want * want).sum().backward()
    for rank, (out, gx, gw) in enumerate(run(job, _tp_matmul, x, w)):
        dp, tp = divmod(rank, 2)
        np.testing.assert_allclose(out, want.detach().numpy()[dp * 8:
                                                             dp * 8 + 8],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(gx, xt.grad.numpy()[dp * 8:dp * 8 + 8],
                                   rtol=1e-4, atol=1e-3)
    # The w gradient sums over dp (each dp rank saw half the rows).
    gws = [gw for _, _, gw in run(job, _tp_matmul, x, w)]
    for tp in range(2):
        np.testing.assert_allclose(gws[tp] + gws[2 + tp],
                                   wt.grad.numpy()[:, tp * 32:tp * 32 + 32],
                                   rtol=1e-4, atol=1e-3)


def _grad_allreduce(ctx, x, y):
    import torch

    from raydp_tpu_torch.parallel import MeshSpec
    from raydp_tpu_torch.parallel import collectives as C

    m = MeshSpec(dp=4).build()
    w = torch.ones(4, requires_grad=True)
    xs = torch.from_numpy(x).chunk(4)[ctx.rank]
    ys = torch.from_numpy(y).chunk(4)[ctx.rank]
    (((xs @ w - ys) ** 2).sum() / len(x)).backward()
    return C.all_reduce_raw(w.grad, m.group("dp")).numpy()


def test_grad_allreduce_inserted(job):
    """A replicated parameter's gradient summed over dp equals the
    one-process gradient, on every rank."""
    x = np.random.default_rng(2).standard_normal((64, 4)).astype(np.float32)
    y = np.random.default_rng(3).standard_normal(64).astype(np.float32)
    w = torch.ones(4, requires_grad=True)
    torch.mean((torch.from_numpy(x) @ w - torch.from_numpy(y)) ** 2
               ).backward()
    for got in run(job, _grad_allreduce, x, y):
        np.testing.assert_allclose(got, w.grad.numpy(), rtol=1e-5)


def _ops(ctx, seed, axes):
    """Each autograd op on this rank's block of one global tensor, with
    the gradient of a fixed weighting of its output."""
    import numpy as np
    import torch

    from raydp_tpu_torch.parallel import MeshSpec
    from raydp_tpu_torch.parallel import collectives as C

    m = MeshSpec(**axes).build()
    name = [a for a in axes][-1]
    g, n, me = m.group(name), m.shape[name], m.coords[name]
    rng = np.random.default_rng(seed)
    full = torch.from_numpy(rng.standard_normal((n * 2, 8, 4)))
    w = torch.from_numpy(rng.standard_normal((n * 2, 8, 4)))
    out = {}
    for op in ("copy", "reduce", "gather", "a2a", "shift"):
        x = full.chunk(n)[me].clone().requires_grad_()
        if op == "copy":
            y = C.copy_to_region(x, g)
            wy = w.chunk(n)[me]
        elif op == "reduce":
            y = C.reduce_from_region(x, g)
            wy = w[:2]
        elif op == "gather":
            y = C.all_gather(x, 0, g)
            wy = w
        elif op == "a2a":
            y = C.all_to_all(x, 1, 0, g)       # [2, 8, 4] -> [2n, 8/n, 4]
            wy = w.reshape(n * 2, n, 8 // n, 4)[:, me]
        else:
            y = C.ring_shift(x, g)
            wy = w.chunk(n)[me]
        (y * wy).sum().backward()
        out[op] = (y.detach().numpy(), x.grad.numpy())
    return me, out


def _want(seed, n):
    rng = np.random.default_rng(seed)
    full = torch.from_numpy(rng.standard_normal((n * 2, 8, 4)))
    w = torch.from_numpy(rng.standard_normal((n * 2, 8, 4)))
    blocks, wb = full.chunk(n), w.chunk(n)
    want = {}
    for me in range(n):
        ws = w.reshape(n * 2, n, 8 // n, 4)
        # a2a: rank me receives block me (along dim 1) of every rank's
        # rows; the gradient of its own rows is every rank's weight on it.
        a2a = torch.cat([blocks[j].reshape(2, n, 8 // n, 4)[:, me]
                         for j in range(n)])
        a2a_grad = torch.stack([ws[2 * me:2 * me + 2, j]
                                for j in range(n)], 1).reshape(2, 8, 4)
        want[me] = {
            "copy": (blocks[me], sum(wb)),
            "reduce": (sum(blocks), w[:2].expand(2, 8, 4)),
            "gather": (full, n * wb[me]),
            "a2a": (a2a, a2a_grad),
            "shift": (blocks[(me - 1) % n], wb[(me + 1) % n]),
        }
    return want


@pytest.mark.parametrize("axes", [dict(dp=2, tp=2), dict(sp=4)],
                         ids=["2-ranks", "4-ranks"])
def test_autograd_collectives_match_one_process(job, axes):
    n = list(axes.values())[-1]
    want = _want(7, n)
    for me, got in run(job, _ops, 7, axes):
        for op, (y, gx) in got.items():
            wy, wg = want[me][op]
            np.testing.assert_allclose(y, wy.numpy(), err_msg=op, **EXACT)
            np.testing.assert_allclose(gx, wg.numpy(), err_msg=op + " grad",
                                       **EXACT)


def _refusal(ctx):
    import torch

    from raydp_tpu_torch.parallel import MeshSpec
    from raydp_tpu_torch.parallel import collectives as C

    m = MeshSpec(sp=4).build()
    try:
        C.ring_shift_raw(torch.zeros(2, device="meta"), m.group("sp"))
    except RuntimeError as exc:
        return str(exc)
    return "no error"


def test_collective_on_an_unserved_device_raises(job):
    for msg in run(job, _refusal):
        assert "send_recv" in msg and "gloo" in msg and "meta" in msg
