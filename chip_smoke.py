#!/usr/bin/env python3
"""Drive the raydp_tpu_torch port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if its check fails:

1. Build every CUDA kernel of the port from ``raydp_tpu_torch/csrc``
   (nvcc, sm_90a, one process per source), report each instance's
   registers, shared memory, resident CTAs per SM and spills (failing on
   a spill in any kernel, by the CUDA runtime's count or ptxas's), then
   hold each kernel against its plain PyTorch version on the card (exact
   f32 matmuls for the plain side):
   f32 and bf16, causal and not, at the main path's shapes, and both
   dtypes also at D 16/32/128 and S 48/96. The forward's ``out`` and
   ``lse``; the backward's delta, dq, dk and dv under a random
   cotangent. Times each kernel at the BERT shape (B 32, S 128) as a CUDA
   graph of calls, warm (inputs in L2) and cold (rotating over input
   sets larger than the 50 MB L2), beside its plain version, the forward
   against ``scaled_dot_product_attention`` and the whole backward
   against SDPA's backward, both as CUDA graphs (the library yardsticks,
   which the port never calls), SDPA's backward also as a torch.profiler
   sum of its kernels; then the f32 kernels the same way (the forward,
   delta, dq and dk/dv), with their bounds on the CUDA cores and in TF32
   x3 on the tensor cores, the f32 forward at the decode oracle's shapes
   and the whole f32 backward against SDPA's f32 backward.
2. BERT-GLUE forward: ``SequenceClassifier`` at bert_base width, bf16,
   ``attention_impl="flash"``, batch 32 x seq 128; logits held against
   the same weights with dense attention (bf16 and f32).
3. Decode server: a bert_base-width f32 ``CausalLM`` engine behind one
   ``DecodeLoop``, 8 ragged prompts (3 to 200 tokens), 16 new tokens
   each, its prefill and step replayed as CUDA graphs (one per prompt
   bucket and kv bucket used, run eagerly at first use and captured at
   the second); every stream must equal ``reference_decode``, which runs
   the flash kernel, reruns must repeat them, and each captured graph,
   replayed at a cache state, must give the eager ``decode_step``'s or
   ``prefill``'s tokens there.
4. BERT-GLUE fine-tune: (a) one batch's parameter gradients with flash
   against dense attention (bf16 and f32); (b) ``Estimator.fit`` of the
   bf16 flash ``SequenceClassifier`` at bert_base width and depth,
   dropout 0.1, AdamW, ``softmax_ce``, batch 32 x seq 128, unshuffled,
   4 epochs of 10 steps on learnable data, once with
   ``epoch_mode="stream"`` (eager steps) and once with ``"scan"`` (the
   step captured as a CUDA graph and replayed), the two held together;
   then ``evaluate`` and ``predict``, and each path's step timed and
   profiled, the flash kernels in the trace of 5 graph replays counted
   against the launch counters; (c) a short self-supervised ``lm_ce``
   fit of a bert_base-width ``CausalLM`` (causal flash backward) on both
   paths.

Kernel launch counts are set to 0 just before each main-path phase (2,
3, 4b and 4c) and read just after. The last lines are a ``kernels`` JSON
line, the card's name and power limit, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): HBM bytes/s, and FLOP/s by input type
# (bf16 and tf32 on the tensor cores, f32 on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}

TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# Backward kernels vs plain: the JAX package's gradient bounds; the slack
# over the forward's comes from summation order, which can move a bf16
# rounding of p or ds by one ulp. delta is one f32 row sum.
GRAD_TOL = {"float32": dict(rtol=1e-3, atol=1e-4),
            "bfloat16": dict(rtol=6e-2, atol=6e-2)}
DELTA_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 logits after 12 layers: two bf16 paths differ by ~1e-2 at logits
# of ~3 (bf16 rounds every layer), so 2e-2 relative plus 5e-2 absolute.
LOGIT_TOL = dict(rtol=2e-2, atol=5e-2)

# (B, S, H, D) of the main path: decode reference prompts (B 1, S 16..256),
# BERT-GLUE (32, 128), and longer sequences.
KERNEL_SHAPES = [(2, 16, 12, 64), (1, 256, 12, 64), (32, 128, 12, 64),
                 (4, 512, 12, 64)]
# Every kernel but the delta pass has a wgmma instance in each dtype (f32:
# TF32 x3); each is also checked at every other head dim and at S that is
# not a multiple of its 64-row tiles.
EXTRA_SHAPES = [(2, 128, 4, 16), (2, 128, 4, 32), (2, 128, 4, 128),
                (2, 48, 12, 64), (2, 96, 12, 64)]
# The decode oracle's forward: B 1, H 12, D 64, causal, S in the prompt
# buckets of the phase-3 engine (page 16, max_len 512, prompts <= 216).
DECODE_ORACLE_SEQS = [16, 32, 64, 128, 256]
# Cold-L2 timing rotates over this many input sets at the BERT shape:
# 25 MB (bf16 forward) to 76 MB (f32 dk/dv) each, so 4 exceed the 50 MB L2.
COLD_SETS = 4
GRAPH_REPS = 10
GLUE_BATCH, GLUE_SEQ = 32, 128
DECODE_PROMPT_LENS = [3, 17, 40, 64, 90, 128, 161, 200]
DECODE_MAX_NEW = 16
# Fine-tune: 10 steps an epoch; the causal LM fit: batch 8 x seq 256, 3
# steps an epoch (scan: epoch 0 the 3 warm-up steps, epoch 1 the capture
# and 2 replays, epoch 2 replays only).
FIT_EPOCHS, FIT_STEPS = 4, 10
LM_BATCH, LM_SEQ, LM_EPOCHS, LM_STEPS = 8, 256, 3, 3
# The symbols of the bf16 kernels in a profiler trace, by counter name.
KERNEL_SYMBOLS = {"flash_fwd": "flash_fwd_bf16_kernel",
                  "flash_bwd_delta": "flash_bwd_delta_kernel",
                  "flash_bwd_dq": "flash_bwd_dq_bf16_kernel",
                  "flash_bwd_dkv": "flash_bwd_dkv_bf16_kernel"}
# Scan against stream fit losses (bf16, dropout 0.1, unshuffled): the
# JAX package's bf16 backward bound. The two paths run the same kernels,
# but the scan path's optimizer runs in its capturable mode.
FIT_TOL = dict(rtol=6e-2, atol=6e-2)
# Per-parameter relative L2 error of flash against dense gradients over
# 12 bf16 layers: the two paths round at different places (bf16 P, the
# kernels' summation order) and the differences grow through depth; a
# wrong kernel output gives errors of order 1.
GRAD_REL_BOUND = 0.1


def flash_module():
    """The module ``raydp_tpu_torch.ops.flash_attention`` (the package
    re-exports a function of the same name)."""
    import importlib

    return importlib.import_module("raydp_tpu_torch.ops.flash_attention")


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


def graph_ms(torch, calls, reps: int = GRAPH_REPS) -> float:
    """Device ms per call with host launch gaps removed: ``calls`` (one
    per input set, run in turn) captured ``reps`` times into one CUDA
    graph and replayed. With one input set the inputs stay in the 50 MB
    L2 between calls (warm); rotating over sets that together exceed it
    reads them from HBM (cold)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            for fn in calls:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (3 * reps * len(calls))
    del graph
    torch.cuda.empty_cache()
    return ms


def warm_cold_ms(torch, make_call, n_sets: int = COLD_SETS):
    """(warm, cold) graph-timed ms of ``make_call(i)``, the call on input
    set i."""
    calls = [make_call(i) for i in range(n_sets)]
    return graph_ms(torch, calls[:1]), graph_ms(torch, calls)


def report_build(torch):
    """Each bf16 and f32 kernel instance's registers, shared memory,
    resident CTAs per SM and spills (from the CUDA runtime), and the ptxas
    report of the wgmma instances (``-Xptxas=-v``): the forward, dq and
    dk/dv in both dtypes. Fails on a spill in any of them, by either
    count. Returns the names (``flash_fwd_f32_kernel<64>``, ...) of the
    wgmma instances that the build compiled."""
    import re

    from raydp_tpu_torch.ops import _build

    fa = flash_module()
    compiled = set()
    for src in _build.SOURCES:
        name = None
        for line in _build.build_log(src).splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"\d(flash_[a-z0-9_]+?kernel)I"
                              r"(13__nv_bfloat16|f)?Li(\d+)E", line)
                wgmma = m and ("_bf16_" in m.group(1)
                               or "_f32_" in m.group(1))
                name = wgmma and f"{m.group(1)}<{m.group(3)}>"
                if name:
                    compiled.add(name)
            elif name and ("Used" in line or "spill" in line):
                log(f"[1] ptxas {name}: {line.strip()}")
                spills = re.findall(r"(\d+) bytes spill", line)
                check(all(n == "0" for n in spills),
                      f"ptxas reports spills in {name}: {line.strip()}")
    for kernel in ("fwd", "dq", "dkv"):
        for dtype in (torch.bfloat16, torch.float32):
            for d in (16, 32, 64, 128):
                res = fa.kernel_resources(kernel, dtype, d)
                log(f"[1] resources {kernel} {str(dtype)[6:]} D {d}: {res}")
                check(res["spill_bytes"] == 0,
                      f"{kernel} {str(dtype)[6:]} D {d} spills: {res}")
    return compiled


def device_profile(torch, label, fn, top=5):
    """Trace one call of ``fn`` with torch.profiler: the device's busy and
    idle share between its first and last kernel, and the kernels that
    took the most device time. Tracing slows the host's launches, so the
    idle share is an upper bound on the untraced run's. Returns the
    number of device events of each name (None where the profiler saw
    no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Device events only; user annotations (``Optimizer.step#...``) span
    # kernels already counted and are left out.
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if str(e.device_type).endswith("CUDA")
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        log(f"[profile] {label}: the profiler saw no device activity "
            "(not measured)")
        return None
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    by_name, seen = {}, {}
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        seen[name] = seen.get(name, 0) + 1
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
    return seen


def kernel_sum_ms(torch, fn, reps: int = 5):
    """Device ms per call of ``fn`` as torch.profiler sees it: the summed
    durations of the device events of ``reps`` calls, over ``reps``; None
    where the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if str(e.device_type).endswith("CUDA")
             and not getattr(e, "is_user_annotation", False)]
    return sum(spans) / 1e3 / reps if spans else None


def fused_qkv(torch, shape, dtype, gen):
    """q, k, v as strided views of one [B, S, 3, H, D] tensor, the layout
    the transformer hands the kernel."""
    b, s, h, d = shape
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda")
    return qkv.to(dtype).unbind(dim=2)


def _kernel_cases(torch):
    """(shape, dtype) of every kernel-vs-plain check of phase 1."""
    return [(shape, dtype) for shape in KERNEL_SHAPES + EXTRA_SHAPES
            for dtype in (torch.float32, torch.bfloat16)]


def phase_kernel(torch, P):
    from raydp_tpu_torch.ops import _build
    from raydp_tpu_torch.ops.flash_attention import (
        flash_attention_forward, flash_attention_plain,
    )

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[1] built {libs} in {time.perf_counter() - t0:.2f} s")

    wgmma = report_build(torch)
    P.set_exact_float32()  # the plain versions' f32 matmuls stay exact

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    cases = _kernel_cases(torch)
    for shape, dtype in cases:
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
    # call. Kernel and SDPA by CUDA graph, warm (the 25 MB of q/k/v/o stay
    # in the 50 MB L2) and cold (rotating over COLD_SETS input sets); the
    # wrapper-paced loop as earlier runs measured it; the plain version.
    b, s, h, d = GLUE_BATCH, GLUE_SEQ, 12, 64
    sets = [fused_qkv(torch, (b, s, h, d), torch.bfloat16, gen)
            for _ in range(COLD_SETS)]
    q, k, v = sets[0]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernel_ms, kernel_cold = warm_cold_ms(
        torch, lambda i: lambda: flash_attention_forward(*sets[i]))
    paced_ms = time_ms(torch, lambda: flash_attention_forward(q, k, v),
                       iters=50)
    plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v),
                       iters=10)
    heads_first = [[x.transpose(1, 2) for x in st] for st in sets]
    library_ms, library_cold = warm_cold_ms(
        torch, lambda i: lambda: sdpa(*heads_first[i]))
    kernel_ms_2 = graph_ms(torch, [lambda: flash_attention_forward(q, k, v)])
    n_bytes = 4 * b * s * h * d * 2 + b * h * s * 4
    flops = 4 * b * h * s * s * d
    bound_ms, bound_by = _bound(n_bytes, flops)
    entry = {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "raydp_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "raydp_tpu/ops/flash_attention.py:63",
        "launches": 0,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "ms_cold": kernel_cold,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }
    log(f"[1] flash_fwd at (B {b}, S {s}, H {h}, D {d}) bf16: kernel_ms "
        f"warm {kernel_ms:.4f} (again {kernel_ms_2:.4f}) cold "
        f"{kernel_cold:.4f}, wrapper-paced {paced_ms:.4f}; plain_ms "
        f"{plain_ms:.4f}; library_ms (sdpa) warm {library_ms:.4f} cold "
        f"{library_cold:.4f}; bound_ms {bound_ms:.4f} by {bound_by} "
        f"({n_bytes} B, {flops} FLOP); cold / bound "
        f"{kernel_cold / bound_ms:.1f}x")
    return entry, wgmma


def _bound(n_bytes, flops, dtype="bfloat16"):
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else \
        "operations"


def backward_set(torch, fa, shape, dtype, gen):
    """(q, k, v, out, lse, dO, delta): fused-qkv inputs, the forward
    kernel's out and lse, a random cotangent and the delta kernel's rows."""
    q, k, v = fused_qkv(torch, shape, dtype, gen)
    out, lse = fa.flash_attention_forward(q, k, v)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return q, k, v, out, lse, g, fa.flash_bwd_delta(out, g)


def whole_backward_vs_sdpa(torch, fa, sets, label):
    """The whole backward (delta + dq + dk/dv) against SDPA's backward,
    both device-only: ours as a CUDA graph of backward calls; SDPA's as a
    CUDA graph of captured forward + torch.autograd.grad less one of the
    forward alone, on [B, H, S, D] leaves. Warm and cold as the kernels;
    the wrapper-paced loops beside them. ``sets`` are backward_set's."""
    b, s, h, d = sets[0][0].shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [[x.transpose(1, 2).detach().requires_grad_(True)
               for x in st[:3]] for st in sets]
    cots = [st[5].transpose(1, 2) for st in sets]

    def sdpa_fwd(i):
        return lambda: sdpa(*leaves[i])

    def sdpa_fwd_bwd(i):
        return lambda: torch.autograd.grad(sdpa(*leaves[i]), leaves[i],
                                           cots[i])

    def ours(i):
        q_, k_, v_, out_, lse_, g_, _ = sets[i]
        return lambda: fa.flash_attention_backward(q_, k_, v_, out_, lse_,
                                                   g_)

    ours_warm, ours_cold = warm_cold_ms(torch, ours)
    fwd_warm, fwd_cold = warm_cold_ms(torch, sdpa_fwd)
    both_warm, both_cold = warm_cold_ms(torch, sdpa_fwd_bwd)
    ours_paced = time_ms(torch, ours(0), iters=50)
    sdpa_paced = (time_ms(torch, sdpa_fwd_bwd(0), iters=50)
                  - time_ms(torch, sdpa_fwd(0), iters=50))
    log(f"[1] whole backward (delta + dq + dkv) at (B {b}, S {s}, H {h}, "
        f"D {d}) {label}: graph warm {ours_warm:.4f} cold {ours_cold:.4f} "
        f"ms, wrapper-paced {ours_paced:.4f}; SDPA backward, graph "
        f"(fwd+bwd {both_warm:.4f} - fwd {fwd_warm:.4f}) warm "
        f"{both_warm - fwd_warm:.4f} cold {both_cold - fwd_cold:.4f} ms, "
        f"paced {sdpa_paced:.4f}; ours / SDPA warm "
        f"{ours_warm / (both_warm - fwd_warm):.2f}x")
    # The yardstick held against a profiler sum of SDPA's backward
    # kernels alone: its forward runs before the profiled window, and
    # every device event in the window belongs to autograd.grad.
    out = sdpa(*leaves[0])
    sdpa_sum = kernel_sum_ms(torch, lambda: torch.autograd.grad(
        out, leaves[0], cots[0], retain_graph=True))
    ours_sum = kernel_sum_ms(torch, ours(0))
    sums = ["not measured" if x is None else f"{x:.4f} ms"
            for x in (sdpa_sum, ours_sum)]
    log(f"[1] backward kernel sums (torch.profiler, 5 calls) {label}: SDPA "
        f"{sums[0]} against its graph yardstick {both_warm - fwd_warm:.4f} "
        f"ms; ours {sums[1]} against its graph {ours_warm:.4f} ms")


def phase_backward_kernels(torch, P):
    """Each backward kernel against its plain version on the same inputs
    (the kernels' own delta feeds both dq versions and both dk/dv
    versions), then times and bounds at the BERT shape."""
    fa = flash_module()

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {"flash_bwd_delta": 0.0, "flash_bwd_dq": 0.0,
             "flash_bwd_dkv": 0.0}
    cases = _kernel_cases(torch)
    for shape, dtype in cases:
        for causal in (False, True):
            name = str(dtype).split(".")[-1]
            q, k, v = fused_qkv(torch, shape, dtype, gen)
            out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            delta = fa.flash_bwd_delta(out, g)
            dq = fa.flash_bwd_dq(q, k, v, g, lse, delta, causal)
            dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal)
            want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, g, lse,
                                                      delta, causal)
            checks = [  # (kernel, output, kernel's, plain's, tolerance)
                ("flash_bwd_delta", "delta", delta,
                 fa.flash_bwd_delta_plain(out, g), DELTA_TOL),
                ("flash_bwd_dq", "dq", dq,
                 fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, causal),
                 GRAD_TOL[name]),
                ("flash_bwd_dkv", "dk", dk, want_dk, GRAD_TOL[name]),
                ("flash_bwd_dkv", "dv", dv, want_dv, GRAD_TOL[name]),
            ]
            torch.cuda.synchronize()
            report = []
            for kname, label, got, want, tol in checks:
                err = (got.float() - want.float()).abs().max().item()
                ok = (torch.allclose(got.float(), want.float(), **tol)
                      and bool(torch.isfinite(got).all()))
                report.append(f"{label} {err:.3e}")
                check(ok, f"{kname} {label} disagrees with plain at "
                          f"{shape} {name} causal={causal} (err "
                          f"{err:.3e}, tol {tol})")
                worst[kname] = max(worst[kname], err)
            log(f"[1] backward {shape} {name} causal={causal}: "
                f"{', '.join(report)} ok")

    # Timing at the BERT shape, bf16: graph-timed warm and cold (as the
    # forward), the wrapper-paced loop, the plain version.
    b, s, h, d = GLUE_BATCH, GLUE_SEQ, 12, 64
    sets = [backward_set(torch, fa, (b, s, h, d), torch.bfloat16, gen)
            for _ in range(COLD_SETS)]
    q, k, v, out, lse, g, delta = sets[0]
    el, row = b * s * h * d * 2, b * h * s * 4  # one bf16 tensor, one row stat
    work = {  # bytes each input read once and output written once; FLOPs
        "flash_bwd_delta": (2 * el + row, 2 * b * s * h * d),
        "flash_bwd_dq": (5 * el + 2 * row, 6 * b * h * s * s * d),
        "flash_bwd_dkv": (6 * el + 2 * row, 8 * b * h * s * s * d),
    }
    def args(i):  # (q, k, v, dO, lse, delta) of input set i
        q_, k_, v_, _, lse_, g_, delta_ = sets[i]
        return q_, k_, v_, g_, lse_, delta_

    calls = {  # kernel on input set i; plain on set 0
        "flash_bwd_delta": (
            lambda i: lambda: fa.flash_bwd_delta(sets[i][3], sets[i][5]),
            lambda: fa.flash_bwd_delta_plain(out, g)),
        "flash_bwd_dq": (
            lambda i: lambda: fa.flash_bwd_dq(*args(i)),
            lambda: fa.flash_bwd_dq_plain(*args(0))),
        "flash_bwd_dkv": (
            lambda i: lambda: fa.flash_bwd_dkv(*args(i)),
            lambda: fa.flash_bwd_dkv_plain(*args(0))),
    }
    entries = []
    for kname, (kernel, plain) in calls.items():
        kernel_ms, kernel_cold = warm_cold_ms(torch, kernel)
        paced_ms = time_ms(torch, kernel(0), iters=50)
        plain_ms = time_ms(torch, plain, iters=10)
        kernel_ms_2 = graph_ms(torch, [kernel(0)])
        n_bytes, flops = work[kname]
        bound_ms, bound_by = _bound(n_bytes, flops)
        entries.append({
            "name": kname,
            "route": "cuda",
            "source": "raydp_tpu_torch/csrc/flash_bwd.cu",
            "replaces": {
                "flash_bwd_delta": "raydp_tpu/ops/flash_attention.py:229",
                "flash_bwd_dq": "raydp_tpu/ops/flash_attention.py:109",
                "flash_bwd_dkv": "raydp_tpu/ops/flash_attention.py:144",
            }[kname],
            "launches": 0,
            "max_abs_err": worst[kname],
            "ms": kernel_ms,
            "ms_cold": kernel_cold,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes it alone
        })
        log(f"[1] {kname} at (B {b}, S {s}, H {h}, D {d}) bf16: kernel_ms "
            f"warm {kernel_ms:.4f} (again {kernel_ms_2:.4f}) cold "
            f"{kernel_cold:.4f}, wrapper-paced {paced_ms:.4f}; plain_ms "
            f"{plain_ms:.4f}; bound_ms {bound_ms:.4f} by {bound_by} "
            f"({n_bytes} B, {flops} FLOP); cold / bound "
            f"{kernel_cold / bound_ms:.1f}x")

    whole_backward_vs_sdpa(torch, fa, sets, "bf16")
    return entries


def time_f32_kernels(torch, wgmma):
    """The f32 kernels at the BERT shape: the forward, dq and dk/dv
    (wgmma, TF32 x3) and the delta pass, graph-timed warm and cold, their
    plain versions, and each bound both ways against the HBM bytes: f32
    FMAs on the CUDA cores (67 TFLOP/s) and TF32 x3 on the tensor cores
    (three products at 495 TFLOP/s; the delta pass runs on the CUDA
    cores, so its bound is the first). Then SDPA's f32 forward, the
    forward at the decode oracle's shapes beside SDPA's, and the whole
    f32 backward against SDPA's f32 backward. A kernel's design in the
    log is wgmma where the build compiled an f32 wgmma instance of it
    (``wgmma``, from ``report_build``). Returns the ``f32`` object of
    each kernel's entry in the kernels line."""
    fa = flash_module()
    gen = torch.Generator(device="cuda").manual_seed(9)
    b, s, h, d = GLUE_BATCH, GLUE_SEQ, 12, 64
    sets = [backward_set(torch, fa, (b, s, h, d), torch.float32, gen)
            for _ in range(COLD_SETS)]

    def args(i):  # (q, k, v, dO, lse, delta) of input set i
        q_, k_, v_, _, lse_, g_, delta_ = sets[i]
        return q_, k_, v_, g_, lse_, delta_

    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads_first = [[x.transpose(1, 2) for x in st[:3]] for st in sets]
    lib_warm, lib_cold = warm_cold_ms(
        torch, lambda i: lambda: sdpa(*heads_first[i]))
    log(f"[1] SDPA forward f32 at (B {b}, S {s}, H {h}, D {d}): graph warm "
        f"{lib_warm:.4f} cold {lib_cold:.4f} ms")
    el, row, sq = b * s * h * d * 4, b * h * s * 4, b * h * s * s * d
    rows = {  # kernel on set i, plain on set 0, bytes, FLOPs
        "flash_fwd": (
            lambda i: lambda: fa.flash_attention_forward(*sets[i][:3]),
            lambda: fa.flash_attention_plain(*sets[0][:3]),
            4 * el + row, 4 * sq),
        "flash_bwd_delta": (
            lambda i: lambda: fa.flash_bwd_delta(sets[i][3], sets[i][5]),
            lambda: fa.flash_bwd_delta_plain(sets[0][3], sets[0][5]),
            2 * el + row, 2 * b * s * h * d),
        "flash_bwd_dq": (
            lambda i: lambda: fa.flash_bwd_dq(*args(i)),
            lambda: fa.flash_bwd_dq_plain(*args(0)), 5 * el + 2 * row,
            6 * sq),
        "flash_bwd_dkv": (
            lambda i: lambda: fa.flash_bwd_dkv(*args(i)),
            lambda: fa.flash_bwd_dkv_plain(*args(0)), 6 * el + 2 * row,
            8 * sq),
    }
    f32 = {}
    for name, (kernel, plain, n_bytes, flops) in rows.items():
        warm, cold = warm_cold_ms(torch, kernel)
        plain_ms = time_ms(torch, plain, iters=10)
        fma_ms, fma_by = _bound(n_bytes, flops, "float32")
        tc_ms, tc_by = _bound(n_bytes, 3 * flops, "tf32")
        design = ("wgmma TF32 x3" if f"{name}_f32_kernel<{d}>" in wgmma
                  else "scalar")
        f32[name] = {"ms": warm, "ms_cold": cold, "plain_ms": plain_ms,
                     "bound_ms": fma_ms if name == "flash_bwd_delta"
                     else tc_ms,
                     "library_ms": lib_warm if name == "flash_fwd" else None}
        log(f"[1] {name} at (B {b}, S {s}, H {h}, D {d}) f32 ({design}): "
            f"kernel_ms warm {warm:.4f} cold {cold:.4f}; plain_ms "
            f"{plain_ms:.4f}; bound_ms TF32 x3 {tc_ms:.4f} by {tc_by} "
            f"(3 x {flops} FLOP at {PEAK_FLOPS['tf32'] / 1e12:.0f} TFLOP/s), "
            f"f32 FMA {fma_ms:.4f} by {fma_by} (at "
            f"{PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s); {n_bytes} B; "
            f"cold / TF32 x3 bound {cold / tc_ms:.1f}x")

    # The decode oracle's launches: B 1, causal, one prompt bucket each;
    # the causal work counts the live half of the scores.
    for s_ in DECODE_ORACLE_SEQS:
        q, k, v = fused_qkv(torch, (1, s_, h, d), torch.float32, gen)
        ms = graph_ms(torch, [lambda: fa.flash_attention_forward(
            q, k, v, causal=True)])
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        lib = graph_ms(torch, [lambda: sdpa(qh, kh, vh, is_causal=True)])
        n_bytes = 4 * s_ * h * d * 4 + h * s_ * 4
        flops = 4 * h * d * s_ * (s_ + 1) // 2
        bound, by = _bound(n_bytes, 3 * flops, "tf32")
        log(f"[1] flash_fwd f32 at the decode oracle's (B 1, S {s_}, H {h}, "
            f"D {d}, causal; {(s_ + 63) // 64 * h} CTAs): graph warm "
            f"{ms:.4f} ms; SDPA f32 causal {lib:.4f} ms; bound_ms TF32 x3 "
            f"{bound:.5f} by {by}")
    whole_backward_vs_sdpa(torch, fa, sets, "f32")
    return f32


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


def check_decode_graphs(torch, engine, gen):
    """Each captured step graph (one per kv bucket) and prefill graph (one
    per prompt bucket), replayed at a cache state, against the eager
    ``decode_step`` or ``prefill`` at the same state: the same tokens.
    The cache is put back after each."""
    model, cache = engine.model, engine._cache
    snapshot = [(k.clone(), v.clone()) for k, v in cache]
    vocab, slots = model.cfg.vocab_size, engine.num_slots

    def restore():
        for (k, v), (k0, v0) in zip(cache, snapshot):
            k.copy_(k0)
            v.copy_(v0)

    for kv_len in sorted(engine.step_graphs):
        tokens = torch.randint(1, vocab, (slots,), generator=gen).tolist()
        lens = [max(0, kv_len - 1 - j % 5) for j in range(slots)]
        got = engine.step(tokens, lens, kv_len)
        restore()
        with torch.inference_mode():
            want = model.decode_step(
                torch.tensor(tokens, device="cuda")[:, None],
                torch.tensor(lens, device="cuda"), kv_len,
                cache).argmax(-1).tolist()
        restore()
        check(got == want, f"step graph for kv bucket {kv_len} gave {got}, "
                           f"eager decode_step {want}")
    for bucket in sorted(engine.prefill_graphs):
        n = max(1, bucket - 3)
        prompt = torch.randint(1, vocab, (n,), generator=gen).tolist()
        got = engine.prefill(1, prompt)
        restore()
        with torch.inference_mode():
            want = int(model.prefill(
                engine._padded(prompt),
                torch.tensor([n], device="cuda"), cache,
                slots=torch.tensor([1], device="cuda")).argmax(-1)[0])
        restore()
        check(got == want, f"prefill graph for bucket {bucket} gave {got}, "
                           f"eager prefill {want}")
    log(f"[3] captured graphs replayed at a cache state match eager: step "
        f"kv buckets {sorted(engine.step_graphs)}, prefill buckets "
        f"{sorted(engine.prefill_graphs)}")


def phase_decode(torch, P):
    from raydp_tpu_torch.serve.decode import (
        DecodeConfig,
        DecodeLoop,
        bucket_for,
    )

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
    # The kv buckets the loop steps in, beside the graphs it captures.
    kv_used = set()
    graphed_step = engine.step

    def step(last, lens, kv_len):
        kv_used.add(kv_len)
        return graphed_step(last, lens, kv_len)

    engine.step = step
    # Warm-up on a short request, twice: cuBLAS handles, the first
    # launches, and the graphs of the smallest buckets (each captured at
    # its second use).
    for _ in range(2):
        warm = DecodeLoop(engine, config)
        warm.submit("warm", [1, 2, 3], max_new=2)
        warm.run_until_idle()
    engine.reference_decode([1, 2, 3], 2)
    torch.cuda.synchronize()

    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, 30522, (n,), generator=gen).tolist()
               for n in DECODE_PROMPT_LENS]

    def run_loop(tag):
        """The 8 requests through one loop: (streams, seconds, rounds,
        first-token latencies in s)."""
        first_token_s = {}
        t_start = time.perf_counter()

        def on_token(rid, index, token):
            if index == 0:
                first_token_s[rid] = time.perf_counter() - t_start

        loop = DecodeLoop(engine, config, on_token=on_token)
        for i, p in enumerate(prompts):
            loop.submit(f"r{i}", p, max_new=DECODE_MAX_NEW)
        rounds = loop.run_until_idle()
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t_start
        streams = [loop.sequence_info(f"r{i}")["tokens"]
                   for i in range(len(prompts))]
        n_tokens = sum(len(s) for s in streams)
        ttft = sorted(first_token_s.values())
        log(f"[3] decode server {tag} (bert_base width, f32, 8 slots, "
            f"CUDA graphs): {n_tokens} tokens in {rounds} rounds, "
            f"{loop_s:.3f} s -> {n_tokens / loop_s:.1f} tokens/s; first-token "
            f"latency mean {sum(ttft) / len(ttft) * 1e3:.2f} ms, max "
            f"{ttft[-1] * 1e3:.2f} ms; graphs captured so far "
            f"{engine.graph_count}")
        return streams

    flash_attention.launches = 0
    streams = run_loop("first run, capturing")
    t_ref = time.perf_counter()
    refs = [engine.reference_decode(p, DECODE_MAX_NEW) for p in prompts]
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t_ref
    launches = flash_attention.launches

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
    # A bucket first used once in the first run is captured in this one.
    second = run_loop("second run, capturing the rest")
    check(second == streams, "the second run's streams differ from the "
                             "first's")
    prefill_used = {bucket_for(engine.prompt_buckets, n)
                    for n in [3] + DECODE_PROMPT_LENS}
    log(f"[3] graphs: {len(engine.step_graphs)} step (kv buckets used "
        f"{sorted(kv_used)}), {len(engine.prefill_graphs)} prefill (prompt "
        f"buckets used {sorted(prefill_used)}), {engine.graph_count} "
        f"captured")
    check(set(engine.step_graphs) == kv_used,
          "not one step graph per kv bucket used")
    check(set(engine.prefill_graphs) == prefill_used,
          "not one prefill graph per prompt bucket used")
    check(engine.graph_count == len(kv_used) + len(prefill_used),
          "a graph used twice is not captured")

    again = run_loop("steady rerun, all graphs captured")
    check(again == streams, "the rerun's streams differ from the first run's")
    device_profile(torch, "decode loop, same 8 requests (CUDA graphs)",
                   lambda: run_loop("profiled rerun"))
    engine.step = graphed_step
    check_decode_graphs(torch, engine, gen)
    return launches


def _counts():
    fa = flash_module()

    return {"flash_fwd": fa.flash_attention.launches,
            "flash_bwd_delta": fa.flash_bwd_delta.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def _reset_counts():
    fa = flash_module()

    for fn in (fa.flash_attention, fa.flash_bwd_delta, fa.flash_bwd_dq,
               fa.flash_bwd_dkv):
        fn.launches = 0


def glue_columns(np, n, seq, vocab, seed):
    """Learnable stand-in for a tokenized GLUE task (as
    examples/bert_glue.py): the label is whether marker token 7 appears."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, vocab, size=(n, seq)).astype(np.int32)
    pos = rng.random(n) < 0.5
    ids[pos, rng.integers(0, seq, pos.sum())] = 7
    cols = {f"t{i}": ids[:, i] for i in range(seq)}
    cols["label"] = pos.astype(np.int32)
    return ids, cols


def phase_grad_check(torch, P):
    """4a: one batch's parameter gradients, flash bf16 against dense bf16
    and dense f32 with the same weights."""
    import torch.nn.functional as F

    grads = {}
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(10, 30522, (GLUE_BATCH, GLUE_SEQ), generator=gen)
    labels = torch.randint(0, 2, (GLUE_BATCH,), generator=gen)
    ids, labels = ids.cuda(), labels.cuda()
    state = None
    for impl, dtype in (("flash", torch.bfloat16), ("dense", torch.bfloat16),
                        ("dense", torch.float32)):
        model = P.SequenceClassifier(
            P.bert_base(attention_impl=impl, dtype=dtype, dropout_rate=0.0),
            device="cuda", generator=torch.Generator().manual_seed(4))
        if state is None:
            state = model.state_dict()
        model.load_state_dict(state)
        F.cross_entropy(model(ids), labels).backward()
        grads[(impl, dtype)] = {n: p.grad.float() for n, p in
                                model.named_parameters() if p.grad is not None}
        del model
    torch.cuda.empty_cache()
    flash = grads[("flash", torch.bfloat16)]
    for ref_key in (("dense", torch.bfloat16), ("dense", torch.float32)):
        ref = grads[ref_key]
        check(flash.keys() == ref.keys(), "gradient sets differ")
        errs = {n: ((flash[n] - ref[n]).norm()
                    / ref[n].norm().clamp_min(1e-30)).item() for n in ref}
        worst = max(errs, key=errs.get)
        finite = all(bool(torch.isfinite(g).all()) for g in flash.values())
        log(f"[4a] flash bf16 vs {ref_key[0]} {str(ref_key[1])[6:]} "
            f"gradients: {len(errs)} parameters, median rel L2 "
            f"{sorted(errs.values())[len(errs) // 2]:.3e}, worst "
            f"{errs[worst]:.3e} ({worst}); bound {GRAD_REL_BOUND}")
        check(finite, "non-finite flash gradients")
        check(errs[worst] < GRAD_REL_BOUND,
              f"flash gradient {worst} off by {errs[worst]:.3e} against "
              f"{ref_key}")


def _fit_modes(torch, P, np, tag, make_estimator, cols, epochs, steps):
    """Fit one estimator per epoch mode, stream then scan, from the same
    weights and seeds, counting launches around each fit. Returns
    ``{mode: (estimator, history, counts)}``."""
    out = {}
    for mode in ("stream", "scan"):
        est = make_estimator(mode)
        torch.cuda.synchronize()
        _reset_counts()
        history = est.fit(P.MLDataset([cols], num_shards=1))
        torch.cuda.synchronize()
        counts = _counts()
        losses = [h["train_loss"] for h in history]
        for h in history:
            log(f"[{tag}] {mode} epoch {h['epoch']}: train_loss "
                f"{h['train_loss']:.4f}, {h['samples']} samples in "
                f"{h['time_s']:.3f} s -> {h['samples_per_sec']:.1f} "
                f"samples/s, {h['time_s'] / steps * 1e3:.2f} ms/step")
        log(f"[{tag}] {mode}: launches over {epochs * steps} steps: {counts}")
        check(est.effective_epoch_mode == mode,
              f"{tag}: asked for {mode}, ran {est.effective_epoch_mode}")
        check(all(np.isfinite(losses)), f"{tag} {mode}: non-finite losses "
                                        f"{losses}")
        check(all(counts[k] == 12 * epochs * steps for k in counts),
              f"{tag} {mode}: expected {12 * epochs * steps} launches of "
              f"each kernel, saw {counts}")
        out[mode] = (est, history, counts)
    stream = [h["train_loss"] for h in out["stream"][1]]
    scan = [h["train_loss"] for h in out["scan"][1]]
    diff = max(abs(a - b) for a, b in zip(scan, stream))
    log(f"[{tag}] scan against stream losses: max |difference| {diff:.3e} "
        f"(tolerance {FIT_TOL}); bit-identical: {scan == stream}")
    check(np.allclose(scan, stream, **FIT_TOL),
          f"{tag}: scan losses {scan} disagree with stream {stream}")
    return out


def phase_finetune(torch, P):
    """4b: Estimator.fit of the bf16 flash classifier at bert_base, on
    the stream path and on the scan path (a CUDA graph of the step)."""
    import numpy as np

    n_rows = GLUE_BATCH * FIT_STEPS
    ids, cols = glue_columns(np, n_rows, GLUE_SEQ, 30522, seed=5)
    _, eval_cols = glue_columns(np, 2 * GLUE_BATCH, GLUE_SEQ, 30522, seed=6)
    cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                      dropout_rate=0.1, max_len=GLUE_SEQ)

    def make_estimator(mode):
        return P.Estimator(
            model=P.SequenceClassifier(
                cfg, device="cuda", generator=torch.Generator().manual_seed(7)),
            optimizer=lambda p: torch.optim.AdamW(p, lr=1e-4,
                                                  weight_decay=1e-2),
            loss="softmax_ce", metrics=["categorical_accuracy"],
            num_epochs=FIT_EPOCHS, batch_size=GLUE_BATCH,
            feature_columns=[f"t{i}" for i in range(GLUE_SEQ)],
            label_column="label", feature_dtype=np.int32,
            label_dtype=np.int32, seed=0, shuffle=False, epoch_mode=mode,
            device="cuda",
        )

    fits = _fit_modes(torch, P, np, "4b", make_estimator, cols, FIT_EPOCHS,
                      FIT_STEPS)
    for mode, (est, history, _) in fits.items():
        losses = [h["train_loss"] for h in history]
        later = history[1:]  # epoch 0 of scan holds warm-up and capture
        ms = sum(h["time_s"] for h in later) / (len(later) * FIT_STEPS) * 1e3
        log(f"[4b] {mode}: epochs 1-{FIT_EPOCHS - 1} {ms:.2f} ms/step, "
            f"{GLUE_BATCH / ms * 1e3:.1f} samples/s (host clock)")
        check(losses[-1] < losses[0], f"{mode}: train loss did not fall: "
                                      f"{losses}")
    est = fits["scan"][0]
    evals = est.evaluate(P.MLDataset([eval_cols], num_shards=1))
    preds = est.predict(ids[:GLUE_BATCH + 5])
    log(f"[4b] evaluate: {evals}; predict {preds.shape}")
    check(np.isfinite(evals["loss"]), "non-finite eval loss")
    check(preds.shape == (GLUE_BATCH + 5, 2) and np.isfinite(preds).all(),
          "predict output")

    x = torch.from_numpy(ids[:GLUE_BATCH]).cuda()
    y = torch.from_numpy(cols["label"][:GLUE_BATCH]).cuda()
    eager = fits["stream"][0]
    eager.get_model().train()
    est.get_model().train()
    graphed = est._captured_train_step()
    while not graphed.captured:
        graphed(x, y)
    step_ms = {"stream": time_ms(torch, lambda: eager._train_step(x, y),
                                 iters=10),
               "scan": time_ms(torch, lambda: graphed(x, y), iters=10)}
    for mode, ms in step_ms.items():
        log(f"[4b] one {mode} train step (CUDA events, 10 steps): {ms:.3f} ms "
            f"-> {GLUE_BATCH / ms * 1e3:.1f} samples/s")
    device_profile(torch, "bert_base fine-tune, one stream train step",
                   lambda: eager._train_step(x, y), top=8)
    _reset_counts()
    seen = device_profile(torch, "bert_base fine-tune, 5 scan steps (graph "
                          "replays)",
                          lambda: [graphed(x, y) for _ in range(5)], top=8)
    counted = _counts()
    # The counters add each replay's launches as recorded at capture;
    # hold them against the kernels the trace saw the replays run.
    traced = {k: sum(n for name, n in (seen or {}).items() if sym in name)
              for k, sym in KERNEL_SYMBOLS.items()}
    log(f"[4b] 5 replays: flash kernels in the trace {traced}, launch "
        f"counters {counted}")
    check(traced == counted == {k: 12 * 5 for k in KERNEL_SYMBOLS},
          f"5 replays: expected {12 * 5} of each kernel, traced {traced}, "
          f"counted {counted}")
    counts = [c for _, _, c in fits.values()]
    del fits, est, eager, graphed
    torch.cuda.empty_cache()
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def phase_causal_lm(torch, P):
    """4c: a short self-supervised lm_ce fit of a bert_base-width
    CausalLM, which runs the causal flash backward, on both paths."""
    import numpy as np

    rng = np.random.default_rng(8)
    ids = rng.integers(0, 30522, size=(LM_BATCH * LM_STEPS, LM_SEQ))
    cols = {f"t{i}": ids[:, i].astype(np.int32) for i in range(LM_SEQ)}
    cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                      causal=True, dropout_rate=0.1, max_len=LM_SEQ)

    def make_estimator(mode):
        return P.Estimator(
            model=P.CausalLM(cfg, device="cuda"),
            optimizer=lambda p: torch.optim.AdamW(p, lr=1e-4),
            loss="lm_ce", num_epochs=LM_EPOCHS, batch_size=LM_BATCH,
            feature_columns=[f"t{i}" for i in range(LM_SEQ)],
            self_supervised=True, feature_dtype=np.int32, shuffle=False,
            epoch_mode=mode, device="cuda")

    fits = _fit_modes(torch, P, np, "4c", make_estimator, cols, LM_EPOCHS,
                      LM_STEPS)
    for mode, (_, history, _) in fits.items():
        # The last epoch is eager steps (stream) or replays only (scan).
        last = history[-1]
        log(f"[4c] CausalLM bert_base width, {mode}, batch {LM_BATCH} x seq "
            f"{LM_SEQ}: losses {[h['train_loss'] for h in history]}, last "
            f"epoch {last['samples_per_sec']:.1f} samples/s, "
            f"{last['time_s'] / LM_STEPS * 1e3:.2f} ms/step")
    counts = [c for _, _, c in fits.values()]
    del fits
    torch.cuda.empty_cache()
    return {k: sum(c[k] for c in counts) for k in counts[0]}


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

    fwd_entry, wgmma = phase_kernel(torch, P)
    entries = [fwd_entry] + phase_backward_kernels(torch, P)
    f32 = time_f32_kernels(torch, wgmma)
    for e in entries:
        if e["name"] in f32:
            e["f32"] = f32[e["name"]]
    glue_launches = phase_glue(torch, P)
    decode_launches = phase_decode(torch, P)
    phase_grad_check(torch, P)
    fit_counts = phase_finetune(torch, P)
    lm_counts = phase_causal_lm(torch, P)
    for e in entries:
        name = e["name"]
        e["launches"] = fit_counts[name] + lm_counts[name]
        if name == "flash_fwd":
            e["launches"] += glue_launches + decode_launches
        check(e["launches"] > 0, f"the main path launched no {name}")
    log(f"[main path] flash_fwd launches: GLUE forward {glue_launches}, "
        f"decode server and its reference {decode_launches} (the f32 "
        f"ones; no f32 backward runs on the main path), fine-tune "
        f"{fit_counts['flash_fwd']}, causal LM fit {lm_counts['flash_fwd']}; "
        f"backward kernels: fine-tune {fit_counts}, causal LM {lm_counts}")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
