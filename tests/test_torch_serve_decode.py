"""The port's decode-mode replica group against the JAX package's
decode references.

Mirrors tests/test_decode.py's end-to-end layer on the port: a decode
group of real replica processes on the CPU streams tokens that must
equal the JAX package's ``reference_decode`` token for token: for the
default ``ToyDecodeEngine``, across a replica killed mid-decode (its
in-flight sequences requeue as prefills, zero drops), and for a tiny
causal transformer whose weights are carried across from the JAX
``build_transformer_engine(seed=0)``.
"""
import functools
import time

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from raydp_tpu.serve import decode as jd
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.models.transformer import tiny_transformer
from raydp_tpu_torch.serve import ReplicaGroup
from raydp_tpu_torch.utils.profiling import metrics
from test_torch_serve_models import load_decode_engine

REGISTER_DEADLINE_S = 60.0


@pytest.fixture(autouse=True)
def _fresh_metrics():
    metrics.reset()
    yield
    metrics.reset()


def _decode_group(**kw):
    """A started decode group on the CPU whose replicas have all
    registered (deadline ``REGISTER_DEADLINE_S``)."""
    group = ReplicaGroup(mode="decode", device="cpu",
                         restart_backoff_s=0.1, **kw).start()
    deadline = time.monotonic() + REGISTER_DEADLINE_S
    while group.stats()["replicas_alive"] < group.replicas:
        if time.monotonic() > deadline:
            group.stop()
            pytest.fail("decode replicas did not register")
        time.sleep(0.05)
    return group


def _toy_reference(prompt, max_new):
    return jd.ToyDecodeEngine().reference_decode(prompt, max_new)


def test_decode_group_streams_and_phases():
    with _decode_group(replicas=1, label="t-dec") as group:
        reqs = [
            group.submit_generate([i + 1, i + 2], max_new=6,
                                  timeout_s=30.0)
            for i in range(4)
        ]
        for i, r in enumerate(reqs):
            out = r.wait(timeout=60.0)
            assert out["tokens"] == _toy_reference([i + 1, i + 2], 6)
            assert out["finish_reason"] == "length"
            phases = r.phases
            # prefill + decode is an exact split of execute, and the
            # four primary phases still sum to the wall
            assert phases["prefill"] >= 0
            assert phases["decode"] >= 0
            assert phases["prefill"] + phases["decode"] == \
                pytest.approx(phases["execute"], abs=1e-6)
            assert phases["queue_wait"] + phases["linger"] + \
                phases["execute"] + phases["reply"] == \
                pytest.approx(phases["total"], abs=1e-6)
            assert r.ttft_s() is not None and r.ttft_s() > 0
        stats = group.stats()
        assert stats["mode"] == "decode"
        assert stats["decode"]["tokens"] == 24
        assert stats["decode"]["retired"]["length"] == 4
        assert stats["decode"]["ttft_p50_s"] is not None


def test_decode_replica_kill_requeues_as_prefills(monkeypatch):
    """serve_kill lands at the 5th admission (request index 4), while
    the first wave is already streaming tokens. Every in-flight sequence
    requeues as a prefill of its generated-so-far context; after the
    respawn every stream still equals the reference, with no duplicated
    or skipped token index. The port's toy rounds take well under a
    millisecond, so the group lingers 1 ms (not the default SLO's 50)
    before shipping the trigger, and the first wave decodes 120 tokens,
    enough to still be in flight when the trigger lands."""
    monkeypatch.setenv(
        "RAYDP_TPU_FAULT_PLAN", "serve_kill:replica=0,request=4"
    )
    with _decode_group(replicas=1, label="t-deckill", slo_ms=1,
                       max_restarts=3) as group:
        prompts = [[i + 1, i + 2, i + 3] for i in range(4)]
        reqs = [
            group.submit_generate(p, max_new=120, timeout_s=60.0)
            for p in prompts
        ]
        # wait until the first wave is actually mid-decode
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            if metrics.snapshot()["counters"].get("decode/tokens", 0) >= 4:
                break
            time.sleep(0.005)
        # the 5th admission trips the kill clause on incarnation 0
        trigger = group.submit_generate([9, 9], max_new=4,
                                        timeout_s=60.0)
        for p, r in zip(prompts, reqs):
            assert r.wait(timeout=60.0)["tokens"] == \
                _toy_reference(p, 120), f"stream diverged for {p}"
        assert trigger.wait(timeout=60.0)["tokens"] == \
            _toy_reference([9, 9], 4)
        stats = group.stats()
        assert stats["restarts"] >= 1, stats
        assert stats["decode"]["requeued_prefills"] >= 1, stats
        assert stats["replies"] == 5, stats
        assert stats["errors"] == 0, stats


def test_decode_group_serves_converted_jax_transformer(tmp_path):
    """The JAX engine's weights, converted and saved; a replica's engine
    loads them, and the group's streams equal the JAX engine's
    ``reference_decode``."""
    j_engine = jd.build_transformer_engine(num_slots=4, page_tokens=16,
                                           seed=0)
    spec = dict(causal=True, dtype=torch.float32, vocab_size=256,
                max_len=128)
    tree = jax.tree_util.tree_map(np.asarray, nn.unbox(j_engine.params))
    path = tmp_path / "engine.pt"
    torch.save(params_from_flax(tree, tiny_transformer(**spec)), path)
    prompts = [[7, 3, 9], [11, 2], [5, 5, 5, 5, 1], [1], [200, 17, 4, 4]]
    want = [jd.reference_decode(j_engine, p, 8) for p in prompts]
    # No device bound: the replica gives the factory the group's.
    factory = functools.partial(load_decode_engine, str(path),
                                num_slots=4, page_tokens=16, **spec)
    with _decode_group(replicas=1, label="t-dec-jax",
                       model_fn=factory) as group:
        reqs = [group.submit_generate(p, max_new=8, timeout_s=60.0)
                for p in prompts]
        got = [r.wait(timeout=60.0)["tokens"] for r in reqs]
        stats = group.stats()
    assert got == want
    assert stats["decode"]["tokens"] == sum(len(w) for w in want)
    assert stats["errors"] == 0
