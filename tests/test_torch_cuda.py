"""The port's CUDA paths on a card: the flash forward and backward
kernels against their plain versions over every head dim, ragged
sequence lengths and strided inputs, the tiny models (outputs and
gradients) on the card against the CPU, an estimator fit on the card,
and the CUDA graphs: the scan path's captured train step (against the
stream path, dropout draws, learning-rate guard, launch counts,
checkpoints) and the decode engine's captured prefill and step. Slice 5:
remat inside the captured step against eager steps, the MoE classifier
and DLRM forwards on the card against the CPU, and the GBT histogram and
split search on the card against the CPU. Slice 6: a replica group of
processes on the card serving a bf16 flash classifier, against the
driver's forward, and a ``cuda`` group refusing to start without a card.
Slice 7: ``fit_on_df`` from a 4-partition frame on the card against the
CPU, and the native host library built there, its bucket ids equal to
the numpy twin's. Slice 8: a session's ETL workers import no torch and
see no card, and a scan fit from a frame in the session's object store
counts every kernel launch. Slice 9: a gang of 2 SPMD ranks on the card,
each launching the flash forward once a layer by its own counter. Slice 10:
a two-rank ``fit_spmd`` of a tiny flash classifier whose ranks end with
equal parameters, and the collective backend rule. Slice 11: a 1-rank
``fit_spmd`` killed at a checkpoint step and resumed, equal to a clean
run, and a 2-rank injected preemption whose emergency checkpoint
restores. Slice 12: a stream fit of a bf16 flash classifier under a
telemetry dir writes one ``train/step`` span a step, bills chip-seconds
equal to its epochs' wall time and no more than the fit's on the test's
clock, and reports ``hbm/peak_bytes`` at least
``torch.cuda.max_memory_allocated()``. Slice 13: a 3-step stream fit of a
bf16 flash classifier with the device plane on reports ``mfu`` above 0
and phase fractions summing to 1, and a 0.5 s ``torch.profiler``
capture on one thread records the ``flash_fwd`` kernels another thread
launches. Slice 14: a replica group of one flash replica on the card,
admitted by the arbiter, answers a short open-loop ``GroupTarget``
schedule with zero errors. Slice 15: the pinned loader with 1, 2 and 5
chunk copies in flight gives the CPU's batches, and the torch compat
estimator's fit of a tiny flash classifier on the card against the CPU.

Marked ``cuda``; every test skips without a CUDA device. These import no
JAX, so they run on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import functools
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.models import dlrm, moe
from raydp_tpu_torch.models.transformer import (
    CausalLM,
    SequenceClassifier,
    tiny_transformer,
)
from raydp_tpu_torch.serve.decode import (
    DecodeConfig,
    DecodeLoop,
    build_transformer_engine,
)
from raydp_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_backward_plain,
    flash_attention_forward,
    flash_attention_plain,
    flash_bwd_delta,
    flash_bwd_delta_plain,
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
)
from raydp_tpu_torch.serve import ReplicaGroup
from raydp_tpu_torch.train import Estimator
from raydp_tpu_torch.utils.device import set_exact_float32
from test_torch_serve_models import classify_batch

pytestmark = pytest.mark.cuda

# Kernel vs plain on the card: same f32 arithmetic in another order
# (f32), one bf16 rounding of the output apart (bf16).
TOL = {torch.float32: dict(rtol=2e-4, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
LSE_TOL = dict(rtol=2e-4, atol=2e-5)
# Backward kernels vs plain: the JAX package's own gradient bounds (f32
# 1e-3/1e-4; bf16 6e-2), the slack over the forward's from summation
# order, which can move a bf16 rounding of p or ds by one ulp.
GRAD_TOL = {torch.float32: dict(rtol=1e-3, atol=1e-4),
            torch.bfloat16: dict(rtol=6e-2, atol=6e-2)}
# delta is one f32 row sum in another order.
DELTA_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_exact_float32()
    return torch.device("cuda")


def _qkv(shape, dtype, seed=0):
    b, s, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda")
    return qkv.to(dtype).unbind(dim=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [
    (2, 16, 3, 16), (1, 48, 2, 32), (2, 96, 4, 64), (1, 256, 2, 128),
    (3, 128, 5, 16), (1, 512, 1, 64),
], ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda, shape, causal, dtype):
    q, k, v = _qkv(shape, dtype)
    before = flash_attention.launches
    out, lse = flash_attention_forward(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref_out.float(), **TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, **LSE_TOL)


def test_kernel_reads_contiguous_and_strided_alike(cuda):
    q, k, v = _qkv((2, 64, 4, 32), torch.float32, seed=1)
    a = flash_attention(q, k, v, causal=True)
    b = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 32, 2, 64), torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q, k, v)
    q, k, v = _qkv((1, 32, 2, 48), torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v)
    q, k, v = _qkv((1, 200, 2, 64), torch.float32)
    with pytest.raises(ValueError, match="divisible"):
        flash_attention(q, k, v)


BWD_SHAPES = [
    (2, 16, 3, 16), (1, 48, 2, 32), (2, 96, 4, 64), (1, 256, 2, 128),
    (3, 128, 5, 16), (1, 512, 1, 64), (2, 384, 2, 32),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", BWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_backward_kernels_match_plain(cuda, shape, causal, dtype):
    q, k, v = _qkv(shape, dtype, seed=3)
    out, lse = flash_attention_forward(q, k, v, causal=causal)
    gen = torch.Generator(device="cuda").manual_seed(4)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    counts = (flash_bwd_delta.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    delta = flash_bwd_delta(out, g)
    dq = flash_bwd_dq(q, k, v, g, lse, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, causal)
    assert (flash_bwd_delta.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    want_delta = flash_bwd_delta_plain(out, g)
    want_dq = flash_bwd_dq_plain(q, k, v, g, lse, want_delta, causal)
    want_dk, want_dv = flash_bwd_dkv_plain(q, k, v, g, lse, want_delta,
                                           causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(delta, want_delta, **DELTA_TOL)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == dtype and got.shape == shape
        torch.testing.assert_close(got.float(), want.float(),
                                   **GRAD_TOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [16, 48, 96, 128, 384])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_bf16_wgmma_kernels_match_plain(cuda, d, s, causal):
    """The bf16 forward, dq and dk/dv (the wgmma kernels) at every head
    dim and at S on and off their 64-row tiles: out, lse, dq, dk and dv
    against the plain versions on the same inputs."""
    shape = (2, s, 3, d)
    q, k, v = _qkv(shape, torch.bfloat16, seed=d + s)
    out, lse = flash_attention_forward(q, k, v, causal=causal)
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal)
    gen = torch.Generator(device="cuda").manual_seed(7)
    g = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    delta = flash_bwd_delta(out, g)
    dq = flash_bwd_dq(q, k, v, g, lse, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, causal)
    want_dq = flash_bwd_dq_plain(q, k, v, g, lse, delta, causal)
    want_dk, want_dv = flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref_out.float(),
                               **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, ref_lse, **LSE_TOL)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), want.float(),
                                   **GRAD_TOL[torch.bfloat16])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [16, 48, 96, 128, 384])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_f32_wgmma_kernels_match_plain(cuda, d, s, causal):
    """The f32 forward, dq and dk/dv (the TF32 x3 wgmma kernels) at every
    head dim and at S on and off their tiles (32 kv rows forward; 16 kv
    rows, 32 at D 16, in dq; 32 q rows, 16 at D 128, in dk/dv), S 16 being
    a single kv tile: out, lse, dq, dk and dv against the plain versions
    in exact f32 at the f32 bounds."""
    shape = (2, s, 3, d)
    q, k, v = _qkv(shape, torch.float32, seed=d + s)
    out, lse = flash_attention_forward(q, k, v, causal=causal)
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal)
    gen = torch.Generator(device="cuda").manual_seed(8)
    g = torch.randn(shape, generator=gen, device="cuda")
    delta = flash_bwd_delta(out, g)
    dq = flash_bwd_dq(q, k, v, g, lse, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, causal)
    want_dq = flash_bwd_dq_plain(q, k, v, g, lse, delta, causal)
    want_dk, want_dv = flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref_out, **TOL[torch.float32])
    torch.testing.assert_close(lse, ref_lse, **LSE_TOL)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, **GRAD_TOL[torch.float32])


@pytest.mark.parametrize("kernel, dtype", [
    ("dq", torch.bfloat16), ("dkv", torch.bfloat16), ("dkv", torch.float32),
    ("dq", torch.float32),
], ids=["dq-bf16", "dkv-bf16", "dkv-f32", "dq-f32"])
@pytest.mark.parametrize("d", [64, 128])
def test_bwd_kernels_are_deterministic(cuda, d, kernel, dtype):
    """dq and dk/dv sum without atomics: two runs are bit-identical."""
    shape = (2, 384, 4, d)
    q, k, v = _qkv(shape, dtype, seed=11)
    out, lse = flash_attention_forward(q, k, v, causal=True)
    g = torch.randn(shape, device="cuda").to(dtype)
    delta = flash_bwd_delta(out, g)
    fn = flash_bwd_dq if kernel == "dq" else flash_bwd_dkv
    first = fn(q, k, v, g, lse, delta, True)
    second = fn(q, k, v, g, lse, delta, True)
    if kernel == "dq":
        first, second = (first,), (second,)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _assert_misaligned_views_raise(dtype):
    """16-byte copies need a 16-byte aligned base and (b, s, h) strides
    of 16 bytes' multiples: a tensor without them raises, never falling
    back to another path."""
    n = 2 * 32 * 4 * 64
    flat = torch.randn(n + 8, device="cuda").to(dtype)
    shifted = flat[1:1 + n].view(2, 32, 4, 64)
    wide = torch.randn((2, 32, 4, 66), device="cuda").to(dtype)[..., :64]
    q, k, v = _qkv((2, 32, 4, 64), dtype)
    before = flash_attention.launches
    for bad in (shifted, wide):
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention(bad, k, v)
        out, lse = flash_attention_forward(q, k, v)
        delta = flash_bwd_delta(out, out)
        with pytest.raises(ValueError, match="16-byte"):
            flash_bwd_dq(q, k, v, bad, lse, delta)
        with pytest.raises(ValueError, match="16-byte"):
            flash_bwd_dkv(q, k, v, bad, lse, delta)
    assert flash_attention.launches == before + 2


def test_bf16_kernels_reject_misaligned_views(cuda):
    _assert_misaligned_views_raise(torch.bfloat16)


def test_f32_kernels_reject_misaligned_views(cuda):
    _assert_misaligned_views_raise(torch.float32)


def test_backward_reads_contiguous_and_strided_alike(cuda):
    q, k, v = _qkv((2, 64, 4, 32), torch.bfloat16, seed=5)
    grads = []
    for args in ((q, k, v), tuple(x.contiguous() for x in (q, k, v))):
        leaves = [x.detach().requires_grad_(True) for x in args]
        flash_attention(*leaves, causal=True).float().pow(2).sum().backward()
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_sum_backward_matches_plain(cuda, causal, dtype):
    """``flash_attention(q, k, v).sum().backward()``: autograd's upstream
    gradient is an expanded tensor of ones, which the backward hands the
    kernels as a dense copy; the gradients match the plain backward's
    under the same ones."""
    shape = (2, 96, 4, 64)
    qkv = torch.randn((2, 96, 3, 4, 64), generator=torch.Generator(
        device="cuda").manual_seed(12), device="cuda").to(dtype)
    leaf = qkv.clone().requires_grad_(True)
    q, k, v = leaf.unbind(dim=2)
    counts = (flash_bwd_delta.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    flash_attention(q, k, v, causal=causal).sum().backward()
    assert (flash_bwd_delta.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    q, k, v = qkv.unbind(dim=2)
    out, lse = flash_attention_forward(q, k, v, causal=causal)
    ones = torch.ones(shape, dtype=dtype, device="cuda")
    want = flash_attention_backward_plain(q, k, v, out, lse, ones, causal)
    torch.cuda.synchronize()
    for got, w in zip(leaf.grad.unbind(dim=2), want):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), w.float(), **GRAD_TOL[dtype])


def test_backward_kernels_reject_what_they_do_not_take(cuda):
    q, k, v = _qkv((1, 32, 2, 64), torch.float32)
    out, lse = flash_attention_forward(q, k, v)
    g = torch.randn((1, 32, 64, 2), device="cuda").transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous head dimension"):
        flash_bwd_delta(out, g)
    delta = flash_bwd_delta(out, torch.ones_like(out))
    with pytest.raises(ValueError, match="row statistics"):
        flash_bwd_dq(q, k, v, torch.ones_like(out), lse[..., 0], delta)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_bwd_dkv(q, k, v, torch.ones_like(out).bfloat16(), lse, delta)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tiny_model_gradients_on_card_match_cpu(cuda, dtype):
    """Parameter gradients of one batch through the flash backward
    kernels on the card against the plain backward on the CPU."""
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 1024, (2, 32), generator=gen)
    labels = torch.randint(0, 2, (2,), generator=gen)
    # Relative L2 error per parameter: f32 is the same arithmetic in
    # another order; bf16 rounds at other places in cuBLAS and on the CPU.
    bound = 1e-3 if dtype == torch.float32 else 5e-2
    for causal in (False, True):
        cfg = tiny_transformer(attention_impl="flash", dtype=dtype,
                               causal=causal)
        make = (lambda dev: CausalLM(cfg, device=dev)) if causal else \
            (lambda dev: SequenceClassifier(cfg, device=dev))
        grads = {}
        for dev in ("cuda", "cpu"):
            model = make(dev)
            x = ids.to(dev)
            out = model(x)
            if causal:
                loss = torch.nn.functional.cross_entropy(
                    out[:, :-1].reshape(-1, out.shape[-1]),
                    x[:, 1:].reshape(-1))
            else:
                loss = torch.nn.functional.cross_entropy(out, labels.to(dev))
            loss.backward()
            grads[dev] = {n: p.grad.float().cpu()
                          for n, p in model.named_parameters()
                          if p.grad is not None}
        assert grads["cuda"].keys() == grads["cpu"].keys()
        for name, want in grads["cpu"].items():
            got = grads["cuda"][name]
            err = (got - want).norm() / want.norm().clamp_min(1e-12)
            assert err < bound, (name, causal, float(err))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tiny_models_on_card_match_cpu(cuda, dtype):
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 1024, (2, 32), generator=gen)
    seg = torch.randint(0, 2, (2, 32), generator=gen)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=2e-2)
    cfg = tiny_transformer(attention_impl="flash", dtype=dtype)
    gpu = SequenceClassifier(cfg, device="cuda").eval()
    cpu = SequenceClassifier(cfg, device="cpu").eval()
    lm_cfg = tiny_transformer(attention_impl="flash", dtype=dtype,
                              causal=True)
    lm_gpu = CausalLM(lm_cfg, device="cuda").eval()
    lm_cpu = CausalLM(lm_cfg, device="cpu").eval()
    before = flash_attention.launches
    with torch.inference_mode():
        got = gpu(ids.cuda(), seg.cuda()).cpu()
        want = cpu(ids, seg)
        got_lm = lm_gpu(ids.cuda()).cpu()
        want_lm = lm_cpu(ids)
    assert flash_attention.launches == before + 2 * cfg.n_layers
    torch.testing.assert_close(got, want, **tol)
    torch.testing.assert_close(got_lm, want_lm, **tol)


def _token_cols(n, seq, vocab, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, vocab, size=(n, seq)).astype(np.int32)
    pos = rng.random(n) < 0.5
    ids[pos, rng.integers(0, seq, pos.sum())] = 7
    cols = {f"t{i}": ids[:, i] for i in range(seq)}
    cols["label"] = pos.astype(np.int32)
    return cols


def test_pinned_loader_delivers_the_cpu_batches(cuda):
    ds = MLDataset([_token_cols(70, 16, 64)], 1)
    for coalesce in (1, 3, None):
        kw = dict(feature_columns=[f"t{i}" for i in range(16)],
                  label_column="label", batch_size=8, shuffle=True, seed=2,
                  feature_dtype=np.int32, label_dtype=np.int32, prefetch=2,
                  transfer_coalesce=coalesce)
        on_card, on_cpu = (ds.to_torch(device=d, **kw) for d in ("cuda",
                                                                  "cpu"))
        for _ in range(2):  # two epochs: the pinned ring is reused
            got = [(x.cpu(), y.cpu()) for x, y in on_card]
            want = list(on_cpu)
            assert len(got) == len(want) == 9
            for (x, y), (wx, wy) in zip(got, want):
                assert x.device.type == "cpu"
                torch.testing.assert_close(x, wx, rtol=0, atol=0)
                torch.testing.assert_close(y, wy, rtol=0, atol=0)


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_pinned_loader_infeed_depths_deliver_the_cpu_batches(cuda, depth):
    """Any number of chunk copies in flight ahead of the consumer gives
    the CPU's batches, in order, one copy a chunk."""
    from raydp_tpu_torch.utils.profiling import metrics

    ds = MLDataset([_token_cols(70, 16, 64)], 1)
    kw = dict(feature_columns=[f"t{i}" for i in range(16)],
              label_column="label", batch_size=8, shuffle=True, seed=2,
              feature_dtype=np.int32, label_dtype=np.int32, prefetch=2,
              transfer_coalesce=2)
    on_card = ds.to_torch(device="cuda", infeed_depth=depth, **kw)
    want = list(ds.to_torch(device="cpu", **kw))
    before = metrics.snapshot()["counters"].get("ingest/device_puts", 0)
    got = [(x.cpu(), y.cpu()) for x, y in on_card]
    puts = metrics.snapshot()["counters"]["ingest/device_puts"] - before
    assert len(got) == len(want) == 9 and puts == 5
    for (x, y), (wx, wy) in zip(got, want):
        torch.testing.assert_close(x, wx, rtol=0, atol=0)
        torch.testing.assert_close(y, wy, rtol=0, atol=0)


def test_torch_estimator_on_card_matches_cpu(cuda):
    """The torch compat estimator fits a tiny f32 flash classifier on the
    card (every kernel, 2 launches a step: one a layer) and on the CPU
    from the same seed: per-epoch losses within 1e-3, predictions within
    1e-3, the trained state back on the CPU."""
    from raydp_tpu_torch.train import TorchEstimator

    cols = _token_cols(64, 16, 64, seed=3)
    cfg = tiny_transformer(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                           d_ff=64, max_len=16, attention_impl="flash",
                           dtype=torch.float32, dropout_rate=0.0)

    class Segmented(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.clf = SequenceClassifier(cfg, device="cpu")

        def forward(self, ids):
            return self.clf(ids, torch.zeros_like(ids))

    fits = {}
    for dev in ("cuda", "cpu"):
        est = TorchEstimator(
            model=lambda c: Segmented(),
            optimizer=lambda m, c: torch.optim.AdamW(m.parameters(), lr=1e-3),
            loss=torch.nn.CrossEntropyLoss(),
            feature_columns=[f"t{i}" for i in range(16)],
            feature_types=np.int64, label_column="label",
            label_type=np.int64, batch_size=16, num_epochs=2, device=dev)
        before = _counts()
        hist = est.fit(MLDataset([cols], 1), MLDataset([cols], 1))
        steps = 2 * 4
        want = [cfg.n_layers * (steps + 2)] + [cfg.n_layers * steps] * 3
        got = [a - b for a, b in zip(_counts(), before)]
        assert got == (want if dev == "cuda" else [0] * 4)
        ids = np.stack([cols[f"t{i}"] for i in range(16)], 1)[:8]
        fits[dev] = (hist, est.predict(ids))
        assert all(t.device.type == "cpu"
                   for t in est._trained_state.values())
    for g, c in zip(fits["cuda"][0], fits["cpu"][0]):
        np.testing.assert_allclose(g["train_loss"], c["train_loss"],
                                   rtol=1e-3)
    np.testing.assert_allclose(fits["cuda"][1], fits["cpu"][1], rtol=1e-3,
                               atol=1e-3)


def test_estimator_fit_on_card_matches_cpu(cuda):
    """A tiny flash classifier fitted on the card (kernels forward and
    backward) against the same fit on the CPU (plain versions): per-epoch
    losses within 1e-3 (f32, summation order), and every launch counted."""
    cols = _token_cols(64, 16, 64, seed=1)
    cfg = tiny_transformer(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                           d_ff=64, max_len=16, attention_impl="flash",
                           dtype=torch.float32, dropout_rate=0.0)
    hist = {}
    for dev in ("cuda", "cpu"):
        est = Estimator(
            model=SequenceClassifier(cfg, device=dev), loss="softmax_ce",
            num_epochs=2, batch_size=16,
            feature_columns=[f"t{i}" for i in range(16)],
            label_column="label", feature_dtype=np.int32,
            label_dtype=np.int32, device=dev, epoch_mode="stream",
            optimizer=lambda p: torch.optim.AdamW(p, lr=1e-3))
        before = (flash_attention.launches, flash_bwd_dq.launches,
                  flash_bwd_dkv.launches, flash_bwd_delta.launches)
        hist[dev] = est.fit(MLDataset([cols], 1))
        after = (flash_attention.launches, flash_bwd_dq.launches,
                 flash_bwd_dkv.launches, flash_bwd_delta.launches)
        steps = 2 * 4
        want = cfg.n_layers * steps if dev == "cuda" else 0
        assert [a - b for a, b in zip(after, before)] == [want] * 4
    for g, c in zip(hist["cuda"], hist["cpu"]):
        np.testing.assert_allclose(g["train_loss"], c["train_loss"],
                                   rtol=1e-3)


# ------------------------------------------------------ CUDA graphs

def _counts():
    return [f.launches for f in (flash_attention, flash_bwd_delta,
                                 flash_bwd_dq, flash_bwd_dkv)]


def _graph_estimator(dev="cuda", mode="scan", lr=1e-3, dtype=torch.bfloat16,
                     optimizer=None, **kw):
    """A tiny flash classifier at dropout 0.1, unshuffled: 128 rows in
    batches of 16, 8 steps an epoch; AdamW unless ``optimizer`` is
    given."""
    cfg = tiny_transformer(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                           d_ff=64, max_len=16, attention_impl="flash",
                           dtype=dtype, dropout_rate=0.1)
    return Estimator(
        model=SequenceClassifier(cfg, device=dev,
                                 generator=torch.Generator().manual_seed(3)),
        loss="softmax_ce", num_epochs=2, batch_size=16,
        feature_columns=[f"t{i}" for i in range(16)], label_column="label",
        feature_dtype=np.int32, label_dtype=np.int32, device=dev,
        shuffle=False, epoch_mode=mode, seed=4,
        optimizer=optimizer or (lambda p: torch.optim.AdamW(p, lr=lr)), **kw)


def test_scan_graph_matches_stream_and_counts_every_launch(cuda):
    """bf16, dropout 0.1: the scan fit (3 eager steps, then 13 replays of
    one graph) against the stream fit within the bf16 tolerance (6e-2);
    each kernel counted 2 layers x 16 steps in both; two scan fits from
    one seed bit-identical."""
    cols = _token_cols(128, 16, 64, seed=2)
    losses, counts = {}, {}
    for mode in ("stream", "scan", "scan-again"):
        est = _graph_estimator(mode=mode.split("-")[0])
        before = _counts()
        hist = est.fit(MLDataset([cols], 1))
        counts[mode] = [a - b for a, b in zip(_counts(), before)]
        losses[mode] = [h["train_loss"] for h in hist]
        assert est.effective_epoch_mode == mode.split("-")[0]
        assert [h["samples"] for h in hist] == [128, 128]
    assert counts["stream"] == counts["scan"] == [2 * 16] * 4
    np.testing.assert_allclose(losses["scan"], losses["stream"], rtol=6e-2,
                               atol=6e-2)
    assert losses["scan"] == losses["scan-again"]


def test_replays_draw_fresh_masks_in_the_eager_sequence(cuda):
    """At lr 0 the weights never move, so a step's loss changes only with
    its dropout masks: every replay of one batch gives a new loss, and
    the graphed steps give the eager steps' losses in turn (f32)."""
    cols = _token_cols(16, 16, 64, seed=3)
    x = torch.from_numpy(np.stack([cols[f"t{i}"] for i in range(16)], 1))
    y = torch.from_numpy(cols["label"])
    x, y = x.cuda(), y.cuda()
    runs = {}
    for graphed in (False, True):
        est = _graph_estimator(lr=0.0, dtype=torch.float32)
        est.get_model().train()
        step = est._captured_train_step() if graphed else est._train_step
        runs[graphed] = [float(step(x, y)) for _ in range(7)]
        if graphed:
            assert step.captured
    replays = runs[True][3:]
    assert len(set(replays)) == len(replays)
    np.testing.assert_allclose(runs[True], runs[False], rtol=1e-5)


def test_graphed_sgd_momentum_steps_follow_eager_steps(cuda):
    """SGD has no capturable mode and keeps no host state: it is captured
    as it is, after warm-up steps that create its momentum buffers, so
    the replays apply the momentum update (a capture of the first step
    would reset the buffers on every replay). f32, dropout 0.1: the
    graphed steps give the eager steps' losses and weights."""
    cols = _token_cols(16, 16, 64, seed=7)
    x = torch.from_numpy(np.stack([cols[f"t{i}"] for i in range(16)], 1))
    y = torch.from_numpy(cols["label"])
    x, y = x.cuda(), y.cuda()
    runs, weights = {}, {}
    for graphed in (False, True):
        est = _graph_estimator(dtype=torch.float32, optimizer=lambda p:
                               torch.optim.SGD(p, lr=0.05, momentum=0.9))
        est.get_model().train()
        step = est._captured_train_step() if graphed else est._train_step
        runs[graphed] = [float(step(x, y)) for _ in range(8)]
        weights[graphed] = [p.detach().clone()
                            for p in est.get_model().parameters()]
        if graphed:
            assert step.captured
    assert len(set(runs[True])) == len(runs[True])
    np.testing.assert_allclose(runs[True], runs[False], rtol=1e-5)
    for a, b in zip(weights[True], weights[False]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["SGD", "Adagrad"])
def test_default_epoch_mode_by_optimizer(cuda, name):
    """Under the default ``epoch_mode="auto"`` an SGD fit scans (a CUDA
    graph) and agrees with its stream fit within the bf16 tolerance
    (6e-2); an Adagrad fit, whose step count lies on the host, streams,
    and asked for ``"scan"`` it raises."""
    make = {"SGD": lambda p: torch.optim.SGD(p, lr=1e-2, momentum=0.9),
            "Adagrad": lambda p: torch.optim.Adagrad(p, lr=1e-2)}[name]
    cols = _token_cols(128, 16, 64, seed=8)
    losses, modes = {}, {}
    for mode in ("auto", "stream"):
        est = _graph_estimator(mode=mode, optimizer=make)
        before = _counts()
        hist = est.fit(MLDataset([cols], 1))
        assert [a - b for a, b in zip(_counts(), before)] == [2 * 16] * 4
        losses[mode] = [h["train_loss"] for h in hist]
        modes[mode] = est.effective_epoch_mode
    assert modes["auto"] == ("scan" if name == "SGD" else "stream")
    np.testing.assert_allclose(losses["auto"], losses["stream"], rtol=6e-2,
                               atol=6e-2)
    if name == "Adagrad":
        with pytest.raises(TypeError, match="Adagrad"):
            _graph_estimator(mode="scan", optimizer=make).fit(
                MLDataset([cols], 1))


def test_changed_learning_rate_raises_after_capture(cuda):
    cols = _token_cols(64, 16, 64, seed=4)
    est = _graph_estimator()
    est.fit(MLDataset([cols], 1), num_epochs=1)
    x = torch.zeros((16, 16), dtype=torch.int32, device="cuda")
    y = torch.zeros(16, dtype=torch.int32, device="cuda")
    step = est._captured_train_step()
    for _ in range(4):
        step(x, y)
    assert step.captured
    est.optimizer.param_groups[0]["lr"] = 5e-4
    with pytest.raises(RuntimeError, match="learning rate"):
        step(x, y)


def test_scan_checkpoint_restores_and_resumes_on_stream(cuda, tmp_path):
    """An epoch-end checkpoint of a scan fit holds the dropout
    generator's state after the epoch's replays (the stream fit's after
    the same steps); a fit resumed from it runs the stream path."""
    cols = _token_cols(128, 16, 64, seed=5)
    gens = {}
    for mode in ("scan", "stream"):
        est = _graph_estimator(mode=mode,
                               checkpoint_dir=str(tmp_path / mode))
        est.fit(MLDataset([cols], 1))
        state = torch.load(tmp_path / mode / "step_0.pt", weights_only=True)
        gens[mode] = state["generator"]
        assert state["step"] == 8 and state["data_epoch"] == 1
    assert torch.equal(gens["scan"], gens["stream"])
    resumed = _graph_estimator()
    hist = resumed.fit(MLDataset([cols], 1),
                       resume_from=str(tmp_path / "scan" / "step_0.pt"))
    assert resumed.effective_epoch_mode == "stream"
    assert [h["epoch"] for h in hist] == [1]
    assert np.isfinite(hist[0]["train_loss"])
    # A scan fit after it: the restored AdamW's step counts lie on the
    # CPU and move to the card when the optimizer turns capturable.
    hist = resumed.fit(MLDataset([cols], 1), num_epochs=1)
    assert resumed.effective_epoch_mode == "scan"
    assert np.isfinite(hist[-1]["train_loss"])


def test_decode_graphs_match_eager_steps_and_reference(cuda):
    """A tiny f32 flash CausalLM engine (page 8, max_len 64: kv buckets 8,
    16, 32, 64): the loop's streams equal ``reference_decode``; then each
    captured step and prefill graph, replayed at a cache state, gives the
    tokens of the eager ``decode_step`` or ``prefill`` at that state."""
    engine = build_transformer_engine(
        num_slots=4, page_tokens=8, seed=1, device="cuda", vocab_size=96,
        max_len=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
        attention_impl="flash")
    config = DecodeConfig(slots=4, page_tokens=8, max_new=12,
                          round_linger_s=0.0)
    gen = torch.Generator().manual_seed(0)
    # One prompt at a time, so the short ones run in the small buckets.
    for n in (3, 9, 20, 45):
        prompt = torch.randint(1, 96, (n,), generator=gen).tolist()
        loop = DecodeLoop(engine, config)
        loop.submit("r", prompt)
        loop.run_until_idle()
        assert (loop.sequence_info("r")["tokens"]
                == engine.reference_decode(prompt, 12)), n
    assert sorted(engine.step_graphs) == [8, 16, 32, 64]
    assert sorted(engine.prefill_graphs) == [8, 16, 32, 64]
    model, cache = engine.model, engine._cache
    snapshot = [(k.clone(), v.clone()) for k, v in cache]

    def restore():
        for (k, v), (k0, v0) in zip(cache, snapshot):
            k.copy_(k0)
            v.copy_(v0)

    for kv_len in engine.step_graphs:
        tokens = torch.randint(1, 96, (4,), generator=gen).tolist()
        lens = [kv_len - 1 - j % 3 for j in range(4)]
        got = engine.step(tokens, lens, kv_len)
        restore()
        with torch.inference_mode():
            want = model.decode_step(
                torch.tensor(tokens, device="cuda")[:, None],
                torch.tensor(lens, device="cuda"), kv_len,
                cache).argmax(-1).tolist()
        restore()
        assert got == want, kv_len
    for bucket in engine.prefill_graphs:
        prompt = torch.randint(1, 96, (bucket - 2,), generator=gen).tolist()
        got = engine.prefill(2, prompt)
        restore()
        with torch.inference_mode():
            want = int(model.prefill(
                engine._padded(prompt), torch.tensor([len(prompt)],
                                                     device="cuda"),
                cache, slots=torch.tensor([2], device="cuda")).argmax(-1)[0])
        restore()
        assert got == want, bucket
    assert engine.graph_count == 8


# ------------------------------------------------------------ slice 5

def test_remat_in_captured_step_matches_eager_steps(cuda):
    """f32 flash classifier with remat at dropout 0.1: the scan fit (the
    step, recomputed blocks included, as one CUDA graph) against the
    stream fit's eager steps from the same weights and generator seeds,
    and against the scan fit without remat; each step runs the forward
    twice a layer (once recomputed) and each backward kernel once."""
    cols = _token_cols(128, 16, 64, seed=2)
    losses, counts = {}, {}
    for mode, remat in (("stream", True), ("scan", True), ("scan", False)):
        cfg = tiny_transformer(vocab_size=64, d_model=32, n_heads=2,
                               n_layers=2, d_ff=64, max_len=16,
                               attention_impl="flash", dtype=torch.float32,
                               dropout_rate=0.1, remat=remat)
        est = Estimator(
            model=SequenceClassifier(
                cfg, device="cuda", generator=torch.Generator().manual_seed(3)),
            loss="softmax_ce", num_epochs=2, batch_size=16,
            feature_columns=[f"t{i}" for i in range(16)],
            label_column="label", feature_dtype=np.int32,
            label_dtype=np.int32, device="cuda", shuffle=False,
            epoch_mode=mode, seed=4,
            optimizer=lambda p: torch.optim.AdamW(p, lr=1e-3))
        before = _counts()
        hist = est.fit(MLDataset([cols], 1))
        counts[(mode, remat)] = [a - b for a, b in zip(_counts(), before)]
        losses[(mode, remat)] = [h["train_loss"] for h in hist]
    steps = 2 * 8
    assert counts[("scan", True)] == counts[("stream", True)] == [
        2 * 2 * steps, 2 * steps, 2 * steps, 2 * steps]
    assert counts[("scan", False)] == [2 * steps] * 4
    np.testing.assert_allclose(losses[("scan", True)],
                               losses[("stream", True)], rtol=1e-4)
    np.testing.assert_allclose(losses[("scan", True)],
                               losses[("scan", False)], rtol=1e-4)


@pytest.mark.parametrize("impl", ["take", "onehot"])
def test_dlrm_forward_on_card_matches_cpu(cuda, impl):
    cfg = dlrm.tiny_dlrm(dtype=torch.float32, embedding_impl=impl)
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((32, cfg.dense_features)).astype(np.float32)
    sparse = np.stack([rng.integers(0, v, 32) for v in cfg.vocab_sizes], 1)
    x = torch.from_numpy(np.concatenate([dense, sparse], 1).astype(
        np.float32))
    out = {}
    for dev in ("cuda", "cpu"):
        model = dlrm.PackedDLRM(cfg, device=dev,
                                generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            out[dev] = model(x.to(dev)).cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], **TOL[torch.float32])


def test_moe_classifier_forward_on_card_matches_cpu(cuda):
    cfg = tiny_transformer(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                           d_ff=64, max_len=16, attention_impl="flash",
                           dtype=torch.float32)
    ids = torch.randint(0, 64, (4, 16), generator=torch.Generator()
                        .manual_seed(2))
    out, aux = {}, {}
    for dev in ("cuda", "cpu"):
        model = moe.MoEClassifier(cfg, moe.tiny_moe(capacity_factor=1.0), 2,
                                  device=dev,
                                  generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            out[dev] = model(ids.to(dev)).cpu()
        aux[dev] = moe.moe_aux_loss(model).cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], **TOL[torch.float32])
    torch.testing.assert_close(aux["cuda"], aux["cpu"], **GRAD_TOL[
        torch.float32])


def test_gbt_histogram_on_card_matches_cpu(cuda):
    """One level's histogram (index_add_ with atomics on the card, in row
    order on the CPU) and its split search: sums within float32
    summation-order bounds, and the same splits where the gains are not
    near-ties."""
    from raydp_tpu_torch.train import gbt

    rng = np.random.default_rng(3)
    n, n_feat, n_bins, n_nodes = 200_000, 4, 64, 8
    binned = torch.from_numpy(rng.integers(0, n_bins, (n, n_feat)).astype(
        np.int32))
    node_rel = torch.from_numpy(rng.integers(0, n_nodes, n))
    active = torch.from_numpy(rng.random(n) < 0.9)
    grad = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    hess = torch.ones(n)
    sums, splits = {}, {}
    for dev in ("cuda", "cpu"):
        args = [t.to(dev) for t in (binned, node_rel, active, grad, hess)]
        gsum, hsum = gbt._level_histograms(*args, n_nodes, n_feat, n_bins)
        sums[dev] = (gsum.cpu(), hsum.cpu())
        splits[dev] = [t.cpu() for t in gbt._best_splits(gsum, hsum, 1.0,
                                                         n_nodes)]
    torch.testing.assert_close(sums["cuda"][0], sums["cpu"][0], rtol=1e-5,
                               atol=1e-3)
    torch.testing.assert_close(sums["cuda"][1], sums["cpu"][1], rtol=0,
                               atol=0)  # integer counts: exact either way
    torch.testing.assert_close(splits["cuda"][2], splits["cpu"][2],
                               rtol=1e-4, atol=1e-3)
    assert torch.equal(splits["cuda"][0], splits["cpu"][0])
    assert torch.equal(splits["cuda"][1], splits["cpu"][1])


def test_replica_group_serves_flash_classifier_on_card(cuda):
    """Two replica processes on the card serve a 2-layer bf16 flash
    classifier: every reply equals the driver's forward of the same
    padded ids within the bf16 logit bound, and each replica reports the
    card, memory held on it and flash forward launches. The group's
    device overrules the one the model function binds."""
    model_fn = functools.partial(classify_batch, device="cpu")  # overruled
    rng = np.random.default_rng(0)
    payloads = [rng.integers(1, 512, size=n).tolist()
                for n in rng.integers(8, 65, size=64)]
    group = ReplicaGroup(replicas=2, device="cuda", model_fn=model_fn,
                         buckets=[32, 64], max_batch=8, slo_ms=10,
                         dispatch_timeout_s=120, label="t-card").start()
    try:
        deadline = time.monotonic() + 120.0
        while group.stats()["replicas_alive"] < 2:
            assert time.monotonic() < deadline, group.stats()
            time.sleep(0.05)
        reqs = [group.submit(p, timeout_s=120.0) for p in payloads]
        got = [r.wait(timeout=120.0) for r in reqs]
        pongs = group.ping()
        stats = group.stats()
    finally:
        group.stop()
    assert stats["errors"] == 0 and stats["replies"] == len(payloads)
    for p, logits in zip(payloads, got):
        bucket = 32 if len(p) <= 32 else 64
        want = torch.tensor(classify_batch([p], bucket, device="cuda")[0])
        torch.testing.assert_close(torch.tensor(logits), want, rtol=2e-2,
                                   atol=5e-2)
    for pong in pongs:
        assert pong["device"] == "cuda" and pong["cuda_bytes"] > 0, pong
        assert pong["launches"]["flash_fwd"] > 0, pong


def test_cuda_group_refuses_to_start_without_a_visible_card(cuda):
    """With the card hidden, ``ReplicaGroup(device="cuda").start()``
    raises and starts no replica; it never serves on the CPU."""
    code = (
        "from raydp_tpu_torch.serve import ReplicaGroup\n"
        "from test_torch_serve_models import sum_model\n"
        "g = ReplicaGroup(replicas=1, model_fn=sum_model, device='cuda')\n"
        "try:\n"
        "    g.start()\n"
        "except RuntimeError as e:\n"
        "    print('refused:', e, 'slots:', len(g._slots))\n"
        "else:\n"
        "    g.stop()\n"
        "    raise SystemExit('started without a card')\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=os.pathsep.join(
        os.path.abspath(p) if p else os.getcwd() for p in sys.path))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "refused:" in out.stdout and "no CUDA device" in out.stdout
    assert "slots: 0" in out.stdout


# ------------------------------------------------------------- slice 7

def test_fit_on_df_on_card_matches_cpu(cuda):
    """A tiny flash classifier fitted from a 4-partition DataFrame on the
    card (stream path: the loader gathers chunks natively into pinned
    buffers) and on the CPU: losses within 1e-3, every launch counted,
    and ``predict_on_df`` one prediction per row on both, the two within
    1e-3."""
    import pyarrow as pa

    import raydp_tpu_torch.dataframe as rdf

    cols = _token_cols(64, 16, 64, seed=2)
    df = rdf.from_arrow(pa.table(cols), num_partitions=4)
    cfg = tiny_transformer(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                           d_ff=64, max_len=16, attention_impl="flash",
                           dtype=torch.float32, dropout_rate=0.0)
    hist, preds = {}, {}
    for dev in ("cuda", "cpu"):
        est = Estimator(
            model=SequenceClassifier(
                cfg, device=dev, generator=torch.Generator().manual_seed(3)),
            loss="softmax_ce", num_epochs=2, batch_size=16,
            feature_columns=[f"t{i}" for i in range(16)],
            label_column="label", feature_dtype=np.int32,
            label_dtype=np.int32, device=dev, epoch_mode="stream",
            optimizer=lambda p: torch.optim.AdamW(p, lr=1e-3))
        before = flash_attention.launches
        hist[dev] = est.fit_on_df(df, num_shards=2)
        want = cfg.n_layers * 2 * 4 if dev == "cuda" else 0
        assert flash_attention.launches - before == want
        preds[dev] = est.predict_on_df(df)["prediction"]
        assert len(preds[dev]) == 64
    for g, c in zip(hist["cuda"], hist["cpu"]):
        np.testing.assert_allclose(g["train_loss"], c["train_loss"],
                                   rtol=1e-3)
    np.testing.assert_allclose(np.stack(preds["cuda"]),
                               np.stack(preds["cpu"]), rtol=1e-3, atol=1e-3)


def test_native_hash_bucket_equals_its_twin(cuda):
    """The native library builds and loads on the card's machine, and its
    bucket ids equal the numpy twin's bit for bit."""
    from raydp_tpu_torch.native import lib as native

    assert native.native_available()
    rng = np.random.default_rng(4)
    n = 200_000
    cols = [rng.integers(-2**40, 2**40, n), rng.standard_normal(n),
            (rng.random(n) > 0.1).astype(np.uint8)]
    for n_buckets in (2, 64, 1000):
        np.testing.assert_array_equal(
            native.hash_bucket(cols, n_buckets, native=True),
            native.hash_bucket(cols, n_buckets, native=False))


# ------------------------------------------------------------- slice 8

@pytest.fixture
def port_session(cuda):
    import raydp_tpu_torch

    s = raydp_tpu_torch.init(app_name="cuda-test", num_workers=2,
                             memory_per_worker="256MB")
    yield s
    raydp_tpu_torch.stop()


def test_session_workers_see_no_card(port_session):
    """The ETL workers of a session on a GPU host import no torch
    and see no CUDA device, while this process holds one."""
    def probe(ctx):
        import os
        import sys

        return ("torch" in sys.modules,
                os.environ.get("CUDA_VISIBLE_DEVICES"))

    cluster = port_session.cluster
    seen = [cluster.submit(probe, worker_id=w.worker_id)
            for w in cluster.alive_workers()]
    assert seen == [(False, "")] * 2
    assert torch.cuda.device_count() >= 1


def test_fit_on_cluster_frame_counts_every_launch(port_session):
    """A tiny bf16 flash classifier fitted on the scan path from a frame
    whose partitions live in the session's object store: each kernel
    launched once per layer a step (the scan path's graph replays
    included), as 11c counts at bert_base, with finite losses."""
    import pyarrow as pa

    import raydp_tpu_torch.dataframe as rdf
    from raydp_tpu_torch.dataframe.executor import ClusterExecutor

    cols = _token_cols(128, 16, 64, seed=5)
    df = rdf.from_arrow(pa.table(cols), num_partitions=4)
    assert isinstance(df._executor, ClusterExecutor)
    est = _graph_estimator(mode="scan")
    before = _counts()
    hist = est.fit_on_df(df, num_shards=2)
    counts = [a - b for a, b in zip(_counts(), before)]
    assert est.effective_epoch_mode == "scan"
    assert [h["samples"] for h in hist] == [128, 128]
    assert counts == [2 * 16] * 4
    assert all(np.isfinite(h["train_loss"]) for h in hist)


# ------------------------------------------------------------- slice 9

def _gang_forward(ctx, seed):
    """Rank body: a tiny bf16 flash classifier from ``seed`` on the
    rank's card, one forward; the rank's own flash_fwd launches."""
    import torch

    from raydp_tpu_torch.models.transformer import (
        SequenceClassifier,
        tiny_transformer,
    )
    from raydp_tpu_torch.ops.flash_attention import flash_attention

    device = f"cuda:{ctx.local_rank % torch.cuda.device_count()}"
    cfg = tiny_transformer(attention_impl="flash", dtype=torch.bfloat16)
    model = SequenceClassifier(
        cfg, device=device,
        generator=torch.Generator().manual_seed(seed)).eval()
    ids = torch.randint(0, cfg.vocab_size, (4, 64),
                        generator=torch.Generator().manual_seed(1))
    before = flash_attention.launches
    with torch.inference_mode():
        logits = model(ids.to(device))
    torch.cuda.synchronize()
    return (flash_attention.launches - before, cfg.n_layers,
            logits.float().cpu().numpy())


def test_spmd_gang_on_card_counts_a_launch_a_layer(cuda):
    from raydp_tpu_torch.spmd import create_spmd_job

    with create_spmd_job("cuda-gang", world_size=2, timeout=60) as job:
        out = job.run(_gang_forward, per_rank_args=[(3,), (3,)],
                      timeout=300)
    launches, layers, _ = out[0]
    assert [o[0] for o in out] == [layers] * 2 and layers == 2
    ref = _gang_forward(type("Ctx", (), {"local_rank": 0})(), 3)[2]
    for _, _, logits in out:
        np.testing.assert_allclose(logits, ref, **TOL[torch.bfloat16])


# ------------------------------------------------------------ slice 10

def _spmd_estimator():
    """Rank body's factory: the tiny flash classifier of
    ``_graph_estimator`` on the stream path, over the gang's dp mesh."""
    import torch.distributed as dist

    from raydp_tpu_torch.parallel import MeshSpec

    return _graph_estimator(mode="stream",
                            mesh=MeshSpec(dp=dist.get_world_size()))


def test_fit_spmd_on_card_ranks_hold_equal_parameters(cuda):
    """A two-rank ``fit_spmd`` of a small transformer on the card: the
    ranks' histories and final parameters equal (same digest, the same
    all-reduced gradients through the same AdamW), the backend the rule
    picks for this machine, finite losses."""
    from raydp_tpu_torch.spmd.worker_main import collective_backend
    from raydp_tpu_torch.train import fit_spmd

    ds = MLDataset([_token_cols(64, 16, 64, seed=6),
                    _token_cols(64, 16, 64, seed=7)], 2)
    out = fit_spmd(_spmd_estimator, ds, world_size=2, timeout=300)
    assert out["backend"] == collective_backend(2, "cuda")
    assert len(set(out["per_rank_params_sha256"])) == 1
    first, second = out["per_rank_history"]
    assert [h["train_loss"] for h in first] == [h["train_loss"]
                                                for h in second]
    assert all(np.isfinite(h["train_loss"]) for h in first)
    assert [h["samples"] for h in first] == [64, 64]


def test_collective_backend_rule_on_card(cuda):
    """NCCL only where every rank on a host has a card of its own;
    gloo where ranks share one or run on the CPU."""
    from raydp_tpu_torch.spmd.worker_main import collective_backend

    n = torch.cuda.device_count()
    assert collective_backend(1, "cuda") == "nccl"
    assert collective_backend(n, "cuda") == "nccl"
    assert collective_backend(n + 1, "cuda") == "gloo"
    assert collective_backend(2, "cpu") == "gloo"


# ------------------------------------------------------------ slice 11

def _ft_factory(checkpoint_dir=None, save_every_steps=0):
    """A rank's factory for the fault-tolerance tests: ``_spmd_estimator``
    with checkpoints."""
    def make_estimator():
        import torch.distributed as dist

        from raydp_tpu_torch.parallel import MeshSpec

        return _graph_estimator(mode="stream",
                                mesh=MeshSpec(dp=dist.get_world_size()),
                                checkpoint_dir=checkpoint_dir,
                                save_every_steps=save_every_steps)

    return make_estimator


def _assert_same_params(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v), k


def test_fit_spmd_on_card_killed_and_resumed_equals_clean(cuda, tmp_path):
    """A 1-rank ``fit_spmd`` of the tiny flash classifier (dropout 0.1)
    killed right after ``step_mid_4.pt``: one relaunch resumes there and
    ends with a clean run's parameters bit for bit."""
    from raydp_tpu_torch.train import fit_spmd

    ds = MLDataset([_token_cols(128, 16, 64, seed=6)], 1)
    clean = fit_spmd(_ft_factory(), ds, world_size=1, timeout=300)
    ckpt = str(tmp_path)
    out = fit_spmd(_ft_factory(ckpt, 4), ds, world_size=1, timeout=300,
                   env={"RAYDP_TPU_FAULT_PLAN": "kill:rank=0,step=4"},
                   checkpoint_dir=ckpt, restart_backoff_s=0.1)
    assert clean["restarts"] == 0 and out["restarts"] == 1
    assert os.path.exists(os.path.join(ckpt, "step_mid_4.pt"))
    assert out["history"][-1]["train_loss"] == (
        clean["history"][-1]["train_loss"])
    _assert_same_params(out["params"], clean["params"])


def test_fit_spmd_on_card_preemption_drains_and_restores(cuda, tmp_path):
    """``preempt:step=2,grace=0`` under a 2-rank ``fit_spmd``: both ranks
    drain after step 2 into ``step_emergency_2.pt``, which restores into
    a single-process estimator on the card; the resumed gang ends with a
    clean gang's parameters."""
    from raydp_tpu_torch.train import fit_spmd

    ds = MLDataset([_token_cols(64, 16, 64, seed=6),
                    _token_cols(64, 16, 64, seed=7)], 2)
    clean = fit_spmd(_ft_factory(), ds, world_size=2, timeout=300)
    ckpt = str(tmp_path)
    out = fit_spmd(_ft_factory(ckpt), ds, world_size=2, timeout=300,
                   env={"RAYDP_TPU_FAULT_PLAN": "preempt:step=2,grace=0"},
                   checkpoint_dir=ckpt, restart_backoff_s=0.1)
    (failure,) = out["failures"]
    assert failure["preempted"] and out["restarts"] == 1
    assert failure["error"].count("preempted at step 2 ") == 2
    path = os.path.join(ckpt, "step_emergency_2.pt")
    state = torch.load(path, map_location="cpu", weights_only=True)
    assert (state["step"], state["data_world"]) == (2, 2)
    est = _graph_estimator(mode="stream")
    est.restore_path(path)
    for k, v in est.get_model().state_dict().items():
        assert torch.equal(v.cpu(), state["model"][k]), k
    assert est._resume_position == (0, 2) and est._resume_world == 2
    _assert_same_params(out["params"], clean["params"])


def test_fit_on_card_traces_and_bills_each_step(cuda, tmp_path,
                                                monkeypatch):
    """A stream fit of a bf16 flash classifier under
    ``RAYDP_TPU_TELEMETRY_DIR``: one ``train/step`` span a step in this
    process's shard; chip-seconds equal to the epochs' wall time (each
    epoch bills its own interval) and no more than the fit's on this
    test's clock; the sampled ``hbm/peak_bytes`` at least the
    allocator's peak."""
    import json

    from raydp_tpu_torch.telemetry import accounting as acct
    from raydp_tpu_torch.telemetry import recorder
    from raydp_tpu_torch.utils.profiling import (
        metrics,
        sample_resource_gauges,
    )

    monkeypatch.setenv("RAYDP_TPU_TELEMETRY_DIR", str(tmp_path))
    recorder.clear()
    cfg = tiny_transformer(vocab_size=64, d_model=64, n_heads=2, n_layers=2,
                           d_ff=128, max_len=16, attention_impl="flash",
                           dtype=torch.bfloat16, dropout_rate=0.0)
    ds = MLDataset([_token_cols(256, 16, 64, seed=4)], 1)
    job = acct.mint_job("card-fit")
    before = metrics.snapshot()["counters"].get(
        f"job/{job.job_id}/chip_seconds", 0.0)
    with acct.job_scope(job):
        est = Estimator(
            model=SequenceClassifier(
                cfg, device="cuda",
                generator=torch.Generator().manual_seed(5)),
            loss="softmax_ce", num_epochs=2, batch_size=32,
            feature_columns=[f"t{i}" for i in range(16)],
            label_column="label", feature_dtype=np.int32,
            label_dtype=np.int32, device="cuda", epoch_mode="stream",
            optimizer=lambda p: torch.optim.AdamW(p, lr=1e-3))
        t0 = time.perf_counter()
        hist = est.fit(ds)
        fit_s = time.perf_counter() - t0
    steps = 2 * (256 // 32)
    with open(tmp_path / f"spans-{os.getpid()}.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert sum(r["name"] == "train/step" for r in records) == steps
    billed = metrics.snapshot()["counters"][
        f"job/{job.job_id}/chip_seconds"] - before
    wall = sum(h["time_s"] for h in hist)
    assert billed == wall
    assert 0 < billed <= fit_s
    sample_resource_gauges()
    assert (metrics.gauge_value("hbm/peak_bytes")
            >= torch.cuda.max_memory_allocated())


def test_device_plane_on_card_reports_mfu_and_phases(cuda):
    """Two stream steps of a bf16 flash classifier with the plane on: an
    ``mfu`` above 0 against the card's bf16 peak from the step counted on
    the meta device, both steps in the phases, and the epoch's four
    phase fractions summing to 1."""
    from raydp_tpu_torch.telemetry import device_profiler as dp

    torch.cuda.init()  # the peak table reads the card of a live context
    assert dp.device_peaks()["flops_by_dtype"], dp.device_peaks()
    cfg = tiny_transformer(vocab_size=64, d_model=64, n_heads=2, n_layers=2,
                           d_ff=128, max_len=16, attention_impl="flash",
                           dtype=torch.bfloat16, dropout_rate=0.0)
    est = Estimator(
        model=SequenceClassifier(cfg, device="cuda",
                                 generator=torch.Generator().manual_seed(5)),
        loss="softmax_ce", num_epochs=1, batch_size=32,
        feature_columns=[f"t{i}" for i in range(16)], label_column="label",
        feature_dtype=np.int32, label_dtype=np.int32, device="cuda",
        epoch_mode="stream",
        optimizer=lambda p: torch.optim.AdamW(p, lr=1e-3))
    hist = est.fit(MLDataset([_token_cols(64, 16, 64, seed=4)], 1))
    ph = hist[0]["phases"]
    assert ph["steps"] == 2
    assert hist[0]["mfu"] > 0
    assert dp.get_cost("train_step")["dtype"] == "bfloat16"
    assert sum(ph[k] for k in ("input_wait_frac", "dispatch_frac",
                               "compute_frac", "collective_frac")) == \
        pytest.approx(1.0, abs=1e-3)


def test_capture_records_another_threads_flash_kernels(cuda, tmp_path):
    """A 0.5 s capture on this thread while another thread launches the
    bf16 flash forward: the Chrome trace holds its kernel events (CUPTI
    records the whole process's launches)."""
    import json
    import threading

    from raydp_tpu_torch.telemetry import device_profiler as dp

    q, k, v = _qkv((4, 128, 4, 64), torch.bfloat16)
    flash_attention(q, k, v)  # the kernel library built and loaded
    torch.cuda.synchronize()
    stop = threading.Event()

    def launch():
        while not stop.is_set():
            flash_attention(q, k, v)
            torch.cuda.synchronize()

    worker = threading.Thread(target=launch, daemon=True)
    worker.start()
    try:
        info = dp.capture_local_trace(0.5, str(tmp_path))
    finally:
        stop.set()
        worker.join(timeout=30)
    events = dp._load_torch_chrome_events(info["dir"])
    kernels = [e for e in events if "flash_fwd" in str(e.get("name"))
               and e.get("cat") == "kernel"]
    assert kernels, sorted({str(e.get("cat")) for e in events})



# ------------------------------------------------------------ slice 14

def test_admitted_flash_replica_answers_open_loop_load(cuda):
    """The arbiter admits a one-replica group of the 2-layer bf16 flash
    classifier (``slots = replicas``); a short Poisson schedule through
    the load generator's ``GroupTarget`` gets an ``ok`` for every
    arrival, the replica's flash forward ran, and ``stop()`` returns the
    lease."""
    from raydp_tpu_torch import control
    from raydp_tpu_torch.loadgen import (
        GroupTarget,
        poisson_schedule,
        run_schedule,
    )

    arb = control.configure(2, admit_timeout_s=60.0)
    group = ReplicaGroup(replicas=1, device="cuda", model_fn=classify_batch,
                         buckets=[32, 64, 128], max_batch=16, slo_ms=10,
                         dispatch_timeout_s=120, label="t-card-load")
    try:
        group.start()
        assert arb.report()["in_use"] == 1
        deadline = time.monotonic() + 120.0
        while group.stats()["replicas_alive"] < 1:
            assert time.monotonic() < deadline, group.stats()
            time.sleep(0.05)
        result = run_schedule(GroupTarget(group),
                              poisson_schedule(50.0, 2.0, seed=3),
                              timeout_s=30.0)
        pongs = group.ping()
    finally:
        group.stop()
        in_use = arb.report()["in_use"]
        control.reset_for_tests()
    counts = result.counts()
    assert counts["ok"] == len(result.outcomes) > 50, counts
    assert pongs[0]["launches"]["flash_fwd"] > 0, pongs
    assert in_use == 0
