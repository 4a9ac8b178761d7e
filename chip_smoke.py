#!/usr/bin/env python3
"""Drive the raydp_tpu_torch port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if its check fails:

1. Build every CUDA kernel of the port from ``raydp_tpu_torch/csrc``
   (nvcc, sm_90a), then hold the flash-attention forward kernel against
   its plain PyTorch version on the card: f32 and bf16, causal and not,
   at the main path's shapes; ``out`` and ``lse`` both checked. Times the
   kernel, the plain version and ``scaled_dot_product_attention`` (the
   library yardstick, which the port never calls) at the BERT-GLUE shape.
2. BERT-GLUE forward: ``SequenceClassifier`` at bert_base width, bf16,
   ``attention_impl="flash"``, batch 32 x seq 128; logits held against
   the same weights with dense attention (bf16 and f32).
3. Decode server: a bert_base-width f32 ``CausalLM`` engine behind one
   ``DecodeLoop``, 8 ragged prompts (3 to 200 tokens), 16 new tokens
   each; every stream must equal ``reference_decode``, which runs the
   flash kernel.

Kernel launch counts are set to 0 just before each main-path phase (2
and 3) and read just after. The last lines are a ``kernels`` JSON line,
the card's name and power limit, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): HBM bytes/s, and FLOP/s by input type
# (bf16 on the tensor cores, f32 on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# bf16 logits after 12 layers: two bf16 paths differ by ~1e-2 at logits
# of ~3 (bf16 rounds every layer), so 2e-2 relative plus 5e-2 absolute.
LOGIT_TOL = dict(rtol=2e-2, atol=5e-2)

# (B, S, H, D) of the main path: decode reference prompts (B 1, S 16..256),
# BERT-GLUE (32, 128), and longer sequences.
KERNEL_SHAPES = [(2, 16, 12, 64), (1, 256, 12, 64), (32, 128, 12, 64),
                 (4, 512, 12, 64)]
GLUE_BATCH, GLUE_SEQ = 32, 128
DECODE_PROMPT_LENS = [3, 17, 40, 64, 90, 128, 161, 200]
DECODE_MAX_NEW = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def gpu_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(torch, label, fn, top=5):
    """Trace one call of ``fn`` with torch.profiler: the device's busy and
    idle share between its first and last kernel, and the kernels that
    took the most device time. Tracing slows the host's launches, so the
    idle share is an upper bound on the untraced run's."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
    if not spans:
        log(f"[profile] {label}: the profiler saw no device activity "
            "(not measured)")
        return
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    by_name = {}
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = max(end for _, end, _ in spans) - spans[0][0]
    idle = 1.0 - busy / window if window > 0 else 0.0
    log(f"[profile] {label}: {len(spans)} device events over "
        f"{window / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, idle share "
        f"{idle:.3f}")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[profile]   {t / 1e3:9.3f} ms {t / busy:6.1%}  {name[:80]}")


def fused_qkv(torch, shape, dtype, gen):
    """q, k, v as strided views of one [B, S, 3, H, D] tensor, the layout
    the transformer hands the kernel."""
    b, s, h, d = shape
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda")
    return qkv.to(dtype).unbind(dim=2)


def phase_kernel(torch, P):
    from raydp_tpu_torch.ops import _build
    from raydp_tpu_torch.ops.flash_attention import (
        flash_attention_forward, flash_attention_plain,
    )

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[1] built {libs} in {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for shape in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                q, k, v = fused_qkv(torch, shape, dtype, gen)
                out, lse = flash_attention_forward(q, k, v, causal=causal)
                ref_out, ref_lse = flash_attention_plain(q, k, v, causal)
                torch.cuda.synchronize()
                name = str(dtype).split(".")[-1]
                tol = TOL[name]
                err_o = (out.float() - ref_out.float()).abs().max().item()
                err_l = (lse - ref_lse).abs().max().item()
                ok = (torch.allclose(out.float(), ref_out.float(), **tol)
                      and torch.allclose(lse, ref_lse, **TOL["float32"])
                      and bool(torch.isfinite(out).all()))
                log(f"[1] flash_fwd {shape} {name} causal={causal}: "
                    f"out err {err_o:.3e} lse err {err_l:.3e} "
                    f"(tol out {tol}, lse {TOL['float32']}) "
                    f"{'ok' if ok else 'MISMATCH'}")
                check(ok, f"flash_fwd disagrees with plain at {shape} "
                          f"{name} causal={causal}")
                worst = max(worst, err_o)

    # Timing at the BERT-GLUE shape (bf16, not causal): the classifier's
    # call. The 25 MB of q/k/v/o stay in the 50 MB L2 between calls.
    b, s, h, d = GLUE_BATCH, GLUE_SEQ, 12, 64
    q, k, v = fused_qkv(torch, (b, s, h, d), torch.bfloat16, gen)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernel_ms = time_ms(torch, lambda: flash_attention_forward(q, k, v),
                        iters=50)
    plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v),
                       iters=10)
    library_ms = time_ms(torch, lambda: sdpa(qt, kt, vt), iters=50)
    kernel_ms_2 = time_ms(torch, lambda: flash_attention_forward(q, k, v),
                          iters=50)
    n_bytes = 4 * b * s * h * d * 2 + b * h * s * 4
    flops = 4 * b * h * s * s * d
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    entry = {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "raydp_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "raydp_tpu/ops/flash_attention.py:63",
        "launches": 0,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }
    log(f"[1] flash_fwd at (B {b}, S {s}, H {h}, D {d}) bf16: kernel_ms "
        f"{kernel_ms:.4f} (again {kernel_ms_2:.4f}), plain_ms "
        f"{plain_ms:.4f}, library_ms (sdpa) {library_ms:.4f}, bound_ms "
        f"{entry['bound_ms']:.4f} by {entry['bound_by']} "
        f"({n_bytes} B, {flops} FLOP)")
    return entry


def phase_glue(torch, P):
    flash_attention = P.flash_attention
    gen = torch.Generator().manual_seed(0)
    model = P.SequenceClassifier(
        P.bert_base(attention_impl="flash", dtype=torch.bfloat16),
        device="cuda", generator=gen,
    ).eval()
    dense = P.SequenceClassifier(
        P.bert_base(attention_impl="dense", dtype=torch.bfloat16),
        device="cuda",
    ).eval()
    dense.load_state_dict(model.state_dict())
    dense32 = P.SequenceClassifier(
        P.bert_base(attention_impl="dense", dtype=torch.float32),
        device="cuda",
    ).eval()
    dense32.load_state_dict(model.state_dict())
    ids_gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 30522, (GLUE_BATCH, GLUE_SEQ), generator=ids_gen)
    seg = torch.zeros_like(ids)
    seg[:, GLUE_SEQ // 2:] = 1
    ids, seg = ids.cuda(), seg.cuda()

    with torch.inference_mode():
        model(ids, seg)  # warm-up (cuBLAS handles, kernel library load)
        torch.cuda.synchronize()
        flash_attention.launches = 0
        logits = model(ids, seg)
        torch.cuda.synchronize()
        launches = flash_attention.launches
        want = dense(ids, seg)
        want32 = dense32(ids, seg)
        fwd_ms = time_ms(torch, lambda: model(ids, seg), iters=10)
        dense_ms = time_ms(torch, lambda: dense(ids, seg), iters=10)
    err = (logits - want).abs().max().item()
    err32 = (logits - want32).abs().max().item()
    log(f"[2] bert_base GLUE forward bf16 flash: logits {tuple(logits.shape)}"
        f", flash launches {launches}, max |flash - dense bf16| {err:.3e}, "
        f"max |flash - dense f32| {err32:.3e} (tol {LOGIT_TOL})")
    log(f"[2] forward ms: flash {fwd_ms:.3f}, dense {dense_ms:.3f} "
        f"({GLUE_BATCH / fwd_ms * 1e3:.1f} sequences/s with flash)")
    check(logits.shape == (GLUE_BATCH, 2), "logits shape")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(launches == 12, f"expected 12 flash launches, saw {launches}")
    check(torch.allclose(logits, want, **LOGIT_TOL),
          "flash logits disagree with dense bf16")
    check(torch.allclose(logits, want32, **LOGIT_TOL),
          "flash logits disagree with dense f32")
    with torch.inference_mode():
        device_profile(torch, "bert_base GLUE forward (flash)",
                       lambda: model(ids, seg))
    del model, dense, dense32
    torch.cuda.empty_cache()
    return launches


def _top2_gap(torch, engine, context):
    with torch.inference_mode():
        logits = engine.model(engine._padded(context))[0, len(context) - 1]
    top = torch.topk(logits.float(), 2).values
    return (top[0] - top[1]).item()


def phase_decode(torch, P):
    from raydp_tpu_torch.serve.decode import DecodeConfig, DecodeLoop

    flash_attention = P.flash_attention
    P.set_exact_float32()
    engine = P.build_transformer_engine(
        num_slots=8, page_tokens=16, seed=0, device="cuda",
        causal=True, dtype=torch.float32, attention_impl="flash",
        vocab_size=30522, max_len=512, d_model=768, n_heads=12,
        n_layers=12, d_ff=3072,
    )
    config = DecodeConfig(slots=8, page_tokens=16,
                          max_new=DECODE_MAX_NEW, round_linger_s=0.0)
    # Warm-up on a short request: cuBLAS handles and the first launches.
    warm = DecodeLoop(engine, config)
    warm.submit("warm", [1, 2, 3], max_new=2)
    warm.run_until_idle()
    engine.reference_decode([1, 2, 3], 2)
    torch.cuda.synchronize()

    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, 30522, (n,), generator=gen).tolist()
               for n in DECODE_PROMPT_LENS]
    first_token_s = {}
    t_start = time.perf_counter()

    def on_token(rid, index, token):
        if index == 0:
            first_token_s[rid] = time.perf_counter() - t_start

    flash_attention.launches = 0
    loop = DecodeLoop(engine, config, on_token=on_token)
    for i, p in enumerate(prompts):
        loop.submit(f"r{i}", p, max_new=DECODE_MAX_NEW)
    rounds = loop.run_until_idle()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t_start
    streams = [loop.sequence_info(f"r{i}")["tokens"]
               for i in range(len(prompts))]

    t_ref = time.perf_counter()
    refs = [engine.reference_decode(p, DECODE_MAX_NEW) for p in prompts]
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t_ref
    launches = flash_attention.launches

    n_tokens = sum(len(s) for s in streams)
    ttft = sorted(first_token_s.values())
    log(f"[3] decode server (bert_base width, f32, 8 slots): {n_tokens} "
        f"tokens in {rounds} rounds, {loop_s:.3f} s -> "
        f"{n_tokens / loop_s:.1f} tokens/s; first-token latency mean "
        f"{sum(ttft) / len(ttft) * 1e3:.2f} ms, max {ttft[-1] * 1e3:.2f} ms")
    log(f"[3] reference_decode (full flash forward per token): "
        f"{sum(len(r) for r in refs)} tokens in {ref_s:.3f} s -> "
        f"{sum(len(r) for r in refs) / ref_s:.1f} tokens/s; flash launches "
        f"{launches}")
    mismatches = 0
    for p, got, want in zip(prompts, streams, refs):
        if got == want:
            continue
        mismatches += 1
        i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        gap = _top2_gap(torch, engine, p + want[:i])
        log(f"[3] MISMATCH prompt len {len(p)} at token {i}: loop "
            f"{got[i:i + 3]} reference {want[i:i + 3]}; reference top-2 "
            f"logit gap there {gap:.3e} (a gap above 1e-4 is a bug)")
    check(mismatches == 0, f"{mismatches} decode streams differ from "
                           "reference_decode")
    check(all(len(s) == DECODE_MAX_NEW for s in streams), "stream lengths")
    check(launches > 0, "reference_decode launched no flash kernel")

    def rerun():
        again = DecodeLoop(engine, config)
        for i, p in enumerate(prompts):
            again.submit(f"p{i}", p, max_new=DECODE_MAX_NEW)
        again.run_until_idle()

    device_profile(torch, "decode loop, same 8 requests", rerun)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import raydp_tpu_torch as P
    except ImportError as e:
        print(f"chip_smoke: cannot import raydp_tpu_torch next to this "
              f"script ({e})", file=sys.stderr)
        return 3

    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}; "
        f"{gpu_line()}")

    entry = phase_kernel(torch, P)
    glue_launches = phase_glue(torch, P)
    decode_launches = phase_decode(torch, P)
    entry["launches"] = glue_launches + decode_launches
    log(f"[main path] flash_fwd launches: GLUE forward {glue_launches}, "
        f"decode server and its reference {decode_launches}")
    check(entry["launches"] > 0, "the main path launched no flash kernel")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [entry]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
