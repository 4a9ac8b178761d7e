"""The port's local dataset and loader against the JAX package's.

Blocks come from numpy with a fixed seed; the JAX side gets them as
pyarrow tables, the port as dicts of numpy columns. Shard plans, shard
columns and every batch of every epoch must be equal exactly: the port
copies the shard math and the epoch permutation, and the batches are the
same rows cast to the same dtypes.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

from raydp_tpu.data.ml_dataset import MLDataset as JaxMLDataset
from raydp_tpu.utils.sharding import divide_blocks as jax_divide_blocks
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.utils.sharding import divide_blocks

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
