"""The port's local dataset and loader against the JAX package's.

Blocks come from numpy with a fixed seed; the JAX side gets them as
pyarrow tables, the port as dicts of numpy columns. Shard plans, shard
columns and every batch of every epoch must be equal exactly: the port
copies the shard math and the epoch permutation, and the batches are the
same rows cast to the same dtypes. The locality-preferring plans
(``divide_blocks_local``) and their scores (``locality_fraction``) equal
the JAX functions' over a grid of block sizes, node layouts and world
sizes, and every case of ``tests/test_locality.py`` runs against the
port (``tests/torch_port_cases.py``).
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

from raydp_tpu.data.ml_dataset import MLDataset as JaxMLDataset
from raydp_tpu.utils import sharding as jax_sharding
from raydp_tpu.utils.sharding import divide_blocks as jax_divide_blocks
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.utils import sharding
from raydp_tpu_torch.utils.sharding import divide_blocks
from torch_port_cases import cases, load_port_module, run_case, time_limit

LOCALITY = load_port_module("test_locality.py")
LOCALITY_CASES = cases(
    LOCALITY, [n for n in vars(LOCALITY) if n.startswith("test_")])

FEATURES = ["a", "b", "c"]


def _blocks(sizes, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        cols = {c: rng.standard_normal(n) for c in FEATURES}
        cols["label"] = rng.integers(0, 5, size=n)
        out.append(cols)
    return out


def _plan(plan):
    return {r: [(s.block_index, s.num_samples, s.offset) for s in slices]
            for r, slices in plan.items()}


def _datasets(sizes, num_shards, **kw):
    blocks = _blocks(sizes)
    return (MLDataset(blocks, num_shards, **kw),
            JaxMLDataset([pa.table(b) for b in blocks], num_shards, **kw))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_shard_plans_and_columns_match_jax(num_shards, shuffle):
    ours, theirs = _datasets([7, 3, 11, 5], num_shards, shuffle=shuffle,
                             shuffle_seed=4)
    assert ours.total_rows == theirs.total_rows == 26
    assert ours.rows_per_shard == theirs.rows_per_shard
    assert _plan(ours.shard_plan) == _plan(theirs.shard_plan)
    for rank in range(num_shards):
        got = ours.shard_columns(rank, FEATURES + ["label"])
        want = theirs.shard_columns(rank, FEATURES + ["label"])
        assert len(got["a"]) == ours.rows_per_shard
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("world", [1, 2, 4, 5])
def test_divide_blocks_matches_jax(world):
    sizes = [9, 0, 4, 13, 2]
    for shuffle in (False, True):
        assert _plan(divide_blocks(sizes, world, shuffle, 7)) == \
            _plan(jax_divide_blocks(sizes, world, shuffle, 7))


@pytest.mark.parametrize("coalesce", [None, 1, 3])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_batches_match_jax(shuffle, drop_last, coalesce):
    """Three epochs, every shard: the same batches in the same order."""
    ours, theirs = _datasets([40, 17, 33], 2)
    for rank in range(2):
        kw = dict(feature_columns=FEATURES, label_column="label",
                  batch_size=8, rank=rank, shuffle=shuffle, seed=3,
                  feature_dtype=np.float32, label_dtype=np.int32,
                  prefetch=2, drop_last=drop_last)
        tl = ours.to_torch(device="cpu", transfer_coalesce=coalesce, **kw)
        jl = theirs.to_jax(device=None, **kw)
        assert len(tl) == len(jl)
        for _ in range(3):
            got, want = list(tl), list(jl)
            assert len(got) == len(want) == len(tl)
            for (x, y), (jx, jy) in zip(got, want):
                assert x.dtype == torch.float32 and y.dtype == torch.int32
                np.testing.assert_array_equal(x.numpy(), jx)
                np.testing.assert_array_equal(y.numpy(), jy)


def test_loader_without_labels_yields_features():
    ours, theirs = _datasets([20], 1)
    kw = dict(feature_columns=FEATURES, label_column=None, batch_size=6,
              shuffle=True, seed=1, feature_dtype=np.float64, prefetch=0)
    got = list(ours.to_torch(device="cpu", **kw))
    want = list(theirs.to_jax(device=None, **kw))
    assert len(got) == len(want) == 4
    for x, jx in zip(got, want):
        assert x.dtype == torch.float64
        np.testing.assert_array_equal(x.numpy(), jx)


def test_set_epoch_replays_an_epoch():
    ours, _ = _datasets([30], 1)
    loader = ours.to_torch(FEATURES, "label", batch_size=7, device="cpu")
    first = [x.clone() for x, _ in loader]
    second = [x.clone() for x, _ in loader]
    loader.set_epoch(0)
    again = [x for x, _ in loader]
    assert not all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_abandoned_epoch_stops_its_producer():
    ours, _ = _datasets([200], 1)
    loader = ours.to_torch(FEATURES, "label", batch_size=4, device="cpu",
                           transfer_coalesce=1, prefetch=1)
    it = iter(loader)
    next(it)
    it.close()  # the producer sees the stop flag and exits
    assert len(list(loader)) == 50


def test_blocks_take_pyarrow_tables_and_check_lengths():
    blocks = _blocks([5, 6])
    ds = MLDataset([pa.table(blocks[0]), blocks[1]], 1)
    assert ds.total_rows == 11
    np.testing.assert_array_equal(ds.shard_columns(0, ["a"])["a"][:5],
                                  blocks[0]["a"])
    with pytest.raises(ValueError, match="differ in length"):
        MLDataset([{"a": np.zeros(3), "b": np.zeros(4)}], 1)
    with pytest.raises(ValueError, match="cannot feed"):
        MLDataset(blocks, 3)


def test_loader_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    ours, _ = _datasets([10], 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ours.to_torch(FEATURES, "label")


# -- locality-preferring plans ---------------------------------------------

LOCAL_SIZES = {
    "even": [100, 100, 100, 100],
    "skewed": [300, 300, 100, 100],
    "ragged": [9, 0, 4, 13, 2, 31, 7, 1],
    "one_big": [500, 3, 3, 3, 3, 3],
}
LOCAL_LAYOUTS = {
    "one_node": lambda n: ["node-0"] * n,
    "two_nodes": lambda n: [f"node-{i % 2}" for i in range(n)],
    "halves": lambda n: ["node-0"] * (n // 2) + ["node-1"] * (n - n // 2),
    "three_nodes": lambda n: [f"node-{i % 3}" for i in range(n)],
}


@pytest.mark.parametrize("layout", sorted(LOCAL_LAYOUTS))
@pytest.mark.parametrize("sizes", sorted(LOCAL_SIZES))
@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_divide_blocks_local_matches_jax(world, sizes, layout):
    blocks = LOCAL_SIZES[sizes]
    nodes = LOCAL_LAYOUTS[layout](len(blocks))
    for ranks in ([f"node-{r % 2}" for r in range(world)],
                  [f"node-{r % 3}" for r in range(world)],
                  ["node-9"] * world):
        for shuffle in (False, True):
            got = sharding.divide_blocks_local(blocks, world, nodes, ranks,
                                               shuffle, 7)
            want = jax_sharding.divide_blocks_local(blocks, world, nodes,
                                                    ranks, shuffle, 7)
            assert _plan(got) == _plan(want)
            assert sharding.locality_fraction(got, nodes, ranks) == \
                jax_sharding.locality_fraction(want, nodes, ranks)
            assert sharding.assignment_sample_counts(got) == \
                jax_sharding.assignment_sample_counts(want)


@pytest.mark.parametrize("name,params",
                         [(n, p) for _, n, p in LOCALITY_CASES],
                         ids=[i for i, _, _ in LOCALITY_CASES])
def test_locality_case_on_port(name, params, request):
    with time_limit(120):  # one case starts a session
        run_case(LOCALITY, name, params, request)


def test_locality_cases_cover_the_reference_module():
    assert len(LOCALITY_CASES) == 6


def test_local_plan_from_rank_nodes_matches_jax():
    """A dataset of in-memory blocks carries no nodes: a topology leaves
    the plan as ``divide_blocks``' and ``locality()`` reads the blocks
    as the driver node's, as the JAX dataset does."""
    ours, theirs = _datasets([7, 3, 11, 5], 2)
    ranks = ["node-0", "node-1"]
    ranked = MLDataset(_blocks([7, 3, 11, 5]), 2, rank_nodes=ranks)
    jax_ranked = JaxMLDataset([pa.table(b) for b in _blocks([7, 3, 11, 5])],
                              2, rank_nodes=ranks)
    assert _plan(ranked.shard_plan) == _plan(ours.shard_plan)
    assert _plan(jax_ranked.shard_plan) == _plan(ours.shard_plan)
    assert ranked.block_nodes == jax_ranked.block_nodes == [None] * 4
    assert ranked.locality() == jax_ranked.locality() == 0.5
    assert ours.locality() is None and theirs.locality() is None


def test_each_ref_block_is_read_once():
    """Pending partitions that land as refs: the prefix streamer reads
    each block, and the plan, ``schema``, ``shard_tables`` and
    ``locality`` then use those tables; no block is read twice. The
    refs' nodes become ``block_nodes`` and drive the local plan."""
    from concurrent.futures import Future

    from raydp_tpu_torch.dataframe.scheduler import PendingPartition
    from raydp_tpu_torch.store.object_store import ObjectRef

    sizes, layout = [7, 3, 11, 5], ["node-0", "node-1", "node-1", "node-0"]
    tables = {f"{i:032x}": pa.table(b)
              for i, b in enumerate(_blocks(sizes))}
    reads = []

    class Reader:
        def get_arrow_table(self, ref):
            reads.append(ref.object_id)
            return tables[ref.object_id]

    futures = [Future() for _ in sizes]
    ranks = ["node-0", "node-1"]
    ds = MLDataset([PendingPartition(f, i) for i, f in enumerate(futures)],
                   2, store=Reader(), rank_nodes=ranks)
    for (oid, t), node, f in zip(tables.items(), layout, futures):
        f.set_result(ObjectRef(oid, t.nbytes, "holder", t.num_rows, node))
    streamed = [b for _, b in ds.iter_prefix_tables()]
    assert [t.num_rows for t in streamed] == sizes
    want = sharding.divide_blocks_local(sizes, 2, layout, ranks)
    assert _plan(ds.shard_plan) == _plan(want)
    assert ds.block_nodes == layout
    assert ds.locality() == sharding.locality_fraction(want, layout, ranks)
    assert ds.schema() == streamed[0].schema
    assert sum(t.num_rows for t in ds.shard_tables(1)) == ds.rows_per_shard
    assert sorted(reads) == sorted(tables)
