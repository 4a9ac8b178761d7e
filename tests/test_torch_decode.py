"""The port's decode server: slot pool, round loop, and greedy parity.

Scheduler tests mirror tests/test_decode.py on the port's copies
(ToyDecodeEngine: deterministic arithmetic). The model layer checks that
the port's engine, from the JAX engine's converted parameters, produces
token-identical greedy streams to the JAX engine's round loop and to its
own no-cache ``reference_decode`` (which runs the flash path).
"""
import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from raydp_tpu.serve import decode as jd
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.models.transformer import CausalLM, tiny_transformer
from raydp_tpu_torch.ops.flash_attention import flash_attention
from raydp_tpu_torch.serve.decode import (
    DecodeConfig,
    DecodeLoop,
    PagedSlotPool,
    ToyDecodeEngine,
    TransformerDecodeEngine,
    bucket_for,
    build_transformer_engine,
    kv_buckets,
    reference_decode,
)
from raydp_tpu_torch.utils.device import resolve_device
from raydp_tpu_torch.utils.profiling import metrics


@pytest.fixture(autouse=True)
def _fresh_metrics():
    metrics.reset()
    yield
    metrics.reset()


def test_kv_buckets_double_geometrically():
    assert kv_buckets(16, 128) == (16, 32, 64, 128)
    assert kv_buckets(16, 100) == (16, 32, 64, 100)
    assert kv_buckets(8, 8) == (8,)
    assert kv_buckets(16, 512) == (16, 32, 64, 128, 256, 512)


def test_bucket_for_picks_tightest():
    buckets = kv_buckets(16, 128)
    assert bucket_for(buckets, 1) == 16
    assert bucket_for(buckets, 16) == 16
    assert bucket_for(buckets, 17) == 32
    assert bucket_for(buckets, 65) == 128
    assert bucket_for(buckets, 999) == 128


def test_pool_allocate_free_churn():
    pool = PagedSlotPool(num_slots=4, page_tokens=16, max_len=128)
    slots = {i: pool.allocate(f"r{i}", 10 + i * 16) for i in range(4)}
    assert None not in slots.values()
    assert pool.free_slot_count == 0
    assert pool.allocate("r4", 8) is None
    pool.free(slots[2])
    pool.free(slots[1])
    got = pool.allocate("r5", 8)
    assert got == min(slots[1], slots[2])
    assert pool.owner(got) == "r5"
    for s in range(4):
        pool.free(s)
    assert pool.used_pages == 0
    assert pool.free_slot_count == 4
    assert pool.page_fill() == 0.0


def test_pool_grow_and_page_backpressure():
    pool = PagedSlotPool(num_slots=2, page_tokens=16, max_len=64,
                         total_pages=3)
    a = pool.allocate("a", 16)
    b = pool.allocate("b", 17)
    assert a is not None and b is not None
    assert pool.used_pages == 3
    assert not pool.ensure(a, 17)
    pool.free(b)
    assert pool.ensure(a, 17)
    assert pool.used_pages == 2


def test_pool_rejects_oversize_sequence():
    pool = PagedSlotPool(num_slots=2, page_tokens=16, max_len=64)
    with pytest.raises(ValueError):
        pool.allocate("big", 65)


def _toy_loop(num_slots=4, **cfg):
    engine = ToyDecodeEngine(num_slots=num_slots)
    config = DecodeConfig(slots=num_slots, page_tokens=16,
                          round_linger_s=0.0, **cfg)
    return engine, DecodeLoop(engine, config)


def test_batched_matches_unbatched_reference():
    engine, loop = _toy_loop(num_slots=4)
    prompts = [[i + 1, i + 2, i + 3] for i in range(7)]
    for i, p in enumerate(prompts):
        loop.submit(f"r{i}", p, max_new=12)
    loop.run_until_idle()
    for i, p in enumerate(prompts):
        info = loop.sequence_info(f"r{i}")
        assert info is not None and info["reason"] == "length"
        assert info["tokens"] == reference_decode(engine, p, 12)
    assert metrics.snapshot()["counters"]["decode/tokens"] == 7 * 12


def test_eos_and_length_retirement():
    engine, loop = _toy_loop(num_slots=2)
    ref = reference_decode(engine, [5, 9], 40)
    eos = ref[3]
    loop.submit("e", [5, 9], max_new=40, eos=eos)
    loop.submit("l", [5, 9], max_new=6)
    loop.run_until_idle()
    assert loop.sequence_info("e")["reason"] == "eos"
    assert loop.sequence_info("e")["tokens"] == ref[:4]
    assert loop.sequence_info("l")["reason"] == "length"
    assert len(loop.sequence_info("l")["tokens"]) == 6


def test_midstream_admission_joins_next_round():
    engine, loop = _toy_loop(num_slots=4)
    loop.submit("a", [1, 2, 3], max_new=30)
    for _ in range(3):
        loop.run_round()
    assert loop.counts()["live"] == 1
    loop.submit("b", [4, 5, 6], max_new=5)
    loop.run_until_idle()
    info_b = loop.sequence_info("b")
    assert info_b["admit_round"] == 4
    assert info_b["tokens"] == reference_decode(engine, [4, 5, 6], 5)
    assert loop.sequence_info("a")["tokens"] == \
        reference_decode(engine, [1, 2, 3], 30)


def test_eviction_requeues_prefix_and_stream_is_exact():
    engine = ToyDecodeEngine(num_slots=4)
    config = DecodeConfig(slots=4, page_tokens=4, round_linger_s=0.0,
                          total_pages=10)
    streams = {}

    def on_token(rid, index, token):
        assert index == len(streams.setdefault(rid, []))
        streams[rid].append(token)

    loop = DecodeLoop(engine, config, on_token=on_token)
    prompts = [[i + 1, i + 2, i + 3] for i in range(4)]
    for i, p in enumerate(prompts):
        loop.submit(f"r{i}", p, max_new=20)
    loop.run_until_idle()
    assert metrics.snapshot()["counters"].get("decode/evictions", 0) >= 1
    for i, p in enumerate(prompts):
        assert streams[f"r{i}"] == reference_decode(engine, p, 20)


def test_cancel_pending_and_live():
    engine, loop = _toy_loop(num_slots=2)
    loop.submit("live", [1, 2], max_new=30)
    loop.run_round()
    loop.submit("pending", [3, 4], max_new=30)
    loop.cancel("live")
    loop.cancel("pending")
    loop.run_round()
    assert loop.sequence_info("live")["reason"] == "cancel"
    assert loop.sequence_info("pending")["reason"] == "cancel"
    assert loop.counts() == {"live": 0, "pending": 0, "rounds": 2}


def test_deadline_expiry_retires_with_timeout():
    t = [0.0]
    engine = ToyDecodeEngine(num_slots=2)
    loop = DecodeLoop(engine, DecodeConfig(slots=2, round_linger_s=0.0),
                      clock=lambda: t[0])
    loop.submit("d", [1, 2], max_new=1000, deadline_s=5.0)
    loop.run_round()
    assert loop.counts()["live"] == 1
    t[0] = 6.0
    loop.run_round()
    assert loop.sequence_info("d")["reason"] == "timeout"


def test_round_uses_tightest_kv_bucket():
    engine, loop = _toy_loop(num_slots=2)
    loop.submit("s", [1, 2, 3], max_new=200)
    assert loop.run_round()["kv_bucket"] == 16
    for _ in range(20):
        stats = loop.run_round()
    assert stats["kv_bucket"] == 32


def test_submit_validation():
    _, loop = _toy_loop()
    with pytest.raises(ValueError):
        loop.submit("empty", [])
    with pytest.raises(ValueError):
        loop.submit("huge", list(range(200)))


def test_decode_config_env_overrides(monkeypatch):
    monkeypatch.setenv("RAYDP_TPU_DECODE_SLOTS", "3")
    monkeypatch.setenv("RAYDP_TPU_DECODE_PAGES", "12")
    monkeypatch.setenv("RAYDP_TPU_DECODE_ROUND_LINGER_S", "bogus")
    cfg = DecodeConfig.from_env(max_new=5)
    assert (cfg.slots, cfg.total_pages, cfg.max_new) == (3, 12, 5)
    assert cfg.round_linger_s == 0.005


# ---------------------------------------------------------------------
# Transformer engine: greedy parity with the JAX engine and the reference
# ---------------------------------------------------------------------

PROMPTS = [[7, 3, 9], [11, 2], [5, 5, 5, 5, 1], list(range(1, 20))]
MAX_NEW = 8


def _streams(engine, num_slots):
    loop = DecodeLoop(engine, DecodeConfig(slots=num_slots, page_tokens=16,
                                           round_linger_s=0.0))
    for i, p in enumerate(PROMPTS):
        loop.submit(f"t{i}", p, max_new=MAX_NEW)
    loop.run_until_idle()
    return [loop.sequence_info(f"t{i}")["tokens"] for i in range(len(PROMPTS))]


def test_greedy_streams_match_jax_engine_and_reference():
    j_engine = jd.build_transformer_engine(num_slots=4, page_tokens=16)
    want = _streams(j_engine, 4)

    cfg = tiny_transformer(causal=True, dtype=torch.float32, vocab_size=256,
                           max_len=128, attention_impl="flash")
    model = CausalLM(cfg, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, nn.unbox(j_engine.params))
    model.load_state_dict(params_from_flax(tree, cfg))
    engine = TransformerDecodeEngine(model, num_slots=4, page_tokens=16)
    got = _streams(engine, 4)
    assert got == want
    for p, stream in zip(PROMPTS, got):
        assert reference_decode(engine, p, MAX_NEW) == stream
    assert flash_attention.launches == 0  # the CPU path runs no kernel


def test_build_engine_is_seeded():
    a = build_transformer_engine(num_slots=2, seed=3, device="cpu")
    b = build_transformer_engine(num_slots=2, seed=3, device="cpu")
    for (na, ta), (_, tb) in zip(a.model.state_dict().items(),
                                 b.model.state_dict().items()):
        assert torch.equal(ta, tb), na
    assert a.model.cfg.dtype == torch.float32
    assert a.model.cfg.vocab_size == 256 and a.max_len == 128


def test_entry_points_raise_without_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_transformer_engine(num_slots=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
