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
   paths; (d) the 4b fine-tune with ``remat=True`` on the scan path, its
   blocks recomputed in the backward (24 forward launches a step, 12 of
   each backward kernel, in the counters and in a trace of 5 replays),
   its losses held against 4b's and its peak memory beside 4b's.
5. DLRM: ``PackedDLRM`` at ``criteo_dlrm``'s full width (26 tables of
   100k x 128, bf16 trunk) through ``Estimator``, bce, AdamW, batch
   1024, on both epoch paths from the same weights, over Criteo-shaped
   rows with Pareto-skewed ids; one table by ``onehot`` against ``take``.
6. MoE: ``MoEClassifier`` over bert_base with the flash trunk (8 experts
   of d_ff 3072, top-2), ``aux_losses=True``, on both epoch paths: 12
   launches of each bf16 flash kernel a step, the aux term finite, the
   share of token-slots dropped for capacity.
7. GBT: ``GBTEstimator`` at examples/gbt_nyctaxi.py's settings on
   synthetic taxi rows (squared, then logistic), on the card and on the
   CPU in the same run: histories and predictions within rtol 1e-3; the
   card's histograms sum with atomics, so where that flips a near-tie
   and the trees part, the histories within rtol 1e-3 through the round
   they parted at and the final losses within 1e-2; the split nodes
   that differ counted either way; save, restore and predict the same.
8. Keras: ``TFEstimator`` with examples/tf_nyctaxi.py's tower on the
   taxi rows (``predict`` held against the returned model), and a
   Titanic-shaped classifier with its sigmoid head fused.
9. Serve plane: (a) a ``ReplicaGroup`` of 2 replica processes on the
   card, batch mode (buckets 32/64/128, batch up to 32, SLO 10 ms),
   serving phase 2's bert_base bf16 flash classifier
   (:func:`classify_batch`, shipped by reference); 512 requests of 8-128
   random ids at once, twice (the first pass warms the replicas), every
   reply held against the driver's dense forward (no kernel) of the
   same weights on the same padded ids (the bf16 logit bound, equal
   argmax save ties at that bound), each replica reporting the card,
   the memory it holds there and flash forward launches by ``Ping``;
   phase 1 holds the kernel against its plain version at these
   batches' shapes. Then the
   same traffic under ``serve_kill:replica=0,request=40``: 512 replies,
   0 errors, a restart and both lineages alive again. (b) A decode-mode
   group of 1 replica serving the bert_base-width f32 decode engine of
   phase 3 under ``serve_kill:replica=0,request=4``: four prompts of 48
   new tokens, the trigger ``[9, 9]`` once 4 tokens have streamed; every
   stream equal to the driver's ``reference_decode`` (the f32 flash
   kernel), a restart and requeued prefills.

Each phase of 4-8 reports ms/step (CUDA events over graph replays and
eager steps, and per epoch by the host clock), samples/s, the traced
idle share and the peak device memory of each fit. Kernel launch counts
are set to 0 just before each main-path phase (2, 3, 4b, 4c, 4d, 6 and
9) and read just after; phase 9's replicas are new processes, whose
counts start at 0 and are read by ``Ping``. The last lines are a ``kernels`` JSON
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
# BERT-GLUE (32, 128), the serve plane's classifier batches (B up to 32 at
# S 32, 64, 128: full batches and an odd one), and longer sequences.
KERNEL_SHAPES = [(2, 16, 12, 64), (1, 256, 12, 64), (32, 128, 12, 64),
                 (32, 32, 12, 64), (32, 64, 12, 64), (17, 128, 12, 64),
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
# DLRM (criteo_dlrm, batch 1024) and the MoE classifier (batch 32 x 128):
# epochs of steps on each path.
DLRM_BATCH, DLRM_EPOCHS, DLRM_STEPS = 1024, 3, 8
MOE_EPOCHS, MOE_STEPS = 4, 8
# The taxi rows of the GBT and keras phases, before the filter; GBT trees
# (examples/gbt_nyctaxi.py); keras epochs.
GBT_ROWS, GBT_TREES, TF_EPOCHS = 200_000, 60, 3
# The symbols of the bf16 kernels in a profiler trace, by counter name.
KERNEL_SYMBOLS = {"flash_fwd": "flash_fwd_bf16_kernel",
                  "flash_bwd_delta": "flash_bwd_delta_kernel",
                  "flash_bwd_dq": "flash_bwd_dq_bf16_kernel",
                  "flash_bwd_dkv": "flash_bwd_dkv_bf16_kernel"}
# Scan against stream fit losses (bf16, dropout 0.1, unshuffled): the
# JAX package's bf16 backward bound. The two paths run the same kernels,
# but the scan path's optimizer runs in its capturable mode.
FIT_TOL = dict(rtol=6e-2, atol=6e-2)
# Peak device memory of each fit, (peak, held before it), by (phase, mode).
PEAK_BYTES = {}
# Serve plane (phase 9): the batch group's traffic and knobs, the decode
# group's prompts and new tokens, and how long a replica may take to come
# up (a process reaches the card in ~8 s) or a request to be answered.
SERVE_REPLICAS, SERVE_REQUESTS, SERVE_MAX_BATCH = 2, 512, 32
SERVE_BUCKETS, SERVE_SLO_MS, SERVE_SEED = [32, 64, 128], 10, 0
SERVE_KILL_PLAN = "serve_kill:replica=0,request=40"
SERVE_DECODE_PROMPT_LENS, SERVE_DECODE_MAX_NEW = [5, 17, 40, 90], 48
SERVE_DECODE_KILL_PLAN = "serve_kill:replica=0,request=4"
SERVE_UP_S, SERVE_REQUEST_S = 180.0, 300.0
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


def _fit_modes(torch, P, np, tag, make_estimator, cols, epochs, steps,
               modes=("stream", "scan"), per_step=None):
    """Fit one estimator per epoch mode (stream then scan) from the same
    weights and seeds, counting launches and the peak memory around each
    fit; ``per_step`` is each kernel's expected launches a step (12 of
    each by default). Returns ``{mode: (estimator, history, counts)}``."""
    per_step = per_step or {k: 12 for k in KERNEL_SYMBOLS}
    out = {}
    for mode in modes:
        est = make_estimator(mode)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        history = est.fit(P.MLDataset([cols], num_shards=1))
        torch.cuda.synchronize()
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
        PEAK_BYTES[(tag, mode)] = (peak, held)
        losses = [h["train_loss"] for h in history]
        for h in history:
            log(f"[{tag}] {mode} epoch {h['epoch']}: train_loss "
                f"{h['train_loss']:.4f}, {h['samples']} samples in "
                f"{h['time_s']:.3f} s -> {h['samples_per_sec']:.1f} "
                f"samples/s, {h['time_s'] / steps * 1e3:.2f} ms/step")
        log(f"[{tag}] {mode}: launches over {epochs * steps} steps: {counts}; "
            f"peak memory allocated {peak / 2**30:.3f} GiB, "
            f"{(peak - held) / 2**30:.3f} GiB above the {held / 2**30:.3f} "
            f"GiB held before the fit")
        check(est.effective_epoch_mode == mode,
              f"{tag}: asked for {mode}, ran {est.effective_epoch_mode}")
        check(all(np.isfinite(losses)), f"{tag} {mode}: non-finite losses "
                                        f"{losses}")
        want = {k: n * epochs * steps for k, n in per_step.items()}
        check(counts == want, f"{tag} {mode}: expected launches {want}, saw "
                              f"{counts}")
        out[mode] = (est, history, counts)
    if len(out) == 2:
        stream = [h["train_loss"] for h in out["stream"][1]]
        scan = [h["train_loss"] for h in out["scan"][1]]
        diff = max(abs(a - b) for a, b in zip(scan, stream))
        log(f"[{tag}] scan against stream losses: max |difference| "
            f"{diff:.3e} (tolerance {FIT_TOL}); bit-identical: "
            f"{scan == stream}")
        check(np.allclose(scan, stream, **FIT_TOL),
              f"{tag}: scan losses {scan} disagree with stream {stream}")
    return out


def graph_step_report(torch, tag, est, x, y, per_step):
    """``est``'s train step captured as a CUDA graph: its time by CUDA
    events over 10 replays, then a torch.profiler trace of 5 replays
    (device busy, idle share, top kernels), whose flash kernels must
    equal the launch counters and ``per_step`` of each a step. Returns
    the step's ms."""
    est.get_model().train()
    graphed = est._captured_train_step()
    while not graphed.captured:
        graphed(x, y)
    ms = time_ms(torch, lambda: graphed(x, y), iters=10)
    log(f"[{tag}] one scan train step (graph replay, CUDA events, 10 steps): "
        f"{ms:.3f} ms -> {len(x) / ms * 1e3:.1f} samples/s")
    _reset_counts()
    seen = device_profile(torch, f"{tag}, 5 scan steps (graph replays)",
                          lambda: [graphed(x, y) for _ in range(5)], top=8)
    counted = _counts()
    # The counters add each replay's launches as recorded at capture;
    # hold them against the kernels the trace saw the replays run.
    traced = {k: sum(n for name, n in (seen or {}).items() if sym in name)
              for k, sym in KERNEL_SYMBOLS.items()}
    want = {k: per_step[k] * 5 for k in KERNEL_SYMBOLS}
    log(f"[{tag}] 5 replays: flash kernels in the trace {traced}, launch "
        f"counters {counted}")
    check(traced == counted == want, f"{tag}, 5 replays: expected {want}, "
                                     f"traced {traced}, counted {counted}")
    return ms


def _glue_estimator(torch, P, np, cfg, mode, epochs):
    """The fine-tune estimator of phases 4b and 4d: bert_base-width
    classifier from generator seed 7, AdamW, softmax_ce, batch 32 x seq
    128, unshuffled."""
    return P.Estimator(
        model=P.SequenceClassifier(
            cfg, device="cuda", generator=torch.Generator().manual_seed(7)),
        optimizer=lambda p: torch.optim.AdamW(p, lr=1e-4, weight_decay=1e-2),
        loss="softmax_ce", metrics=["categorical_accuracy"],
        num_epochs=epochs, batch_size=GLUE_BATCH,
        feature_columns=[f"t{i}" for i in range(GLUE_SEQ)],
        label_column="label", feature_dtype=np.int32, label_dtype=np.int32,
        seed=0, shuffle=False, epoch_mode=mode, device="cuda")


def phase_finetune(torch, P):
    """4b: Estimator.fit of the bf16 flash classifier at bert_base, on
    the stream path and on the scan path (a CUDA graph of the step).
    Returns the launch counts and the scan fit's losses."""
    import numpy as np

    n_rows = GLUE_BATCH * FIT_STEPS
    ids, cols = glue_columns(np, n_rows, GLUE_SEQ, 30522, seed=5)
    _, eval_cols = glue_columns(np, 2 * GLUE_BATCH, GLUE_SEQ, 30522, seed=6)
    cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                      dropout_rate=0.1, max_len=GLUE_SEQ)
    fits = _fit_modes(
        torch, P, np, "4b",
        lambda mode: _glue_estimator(torch, P, np, cfg, mode, FIT_EPOCHS),
        cols, FIT_EPOCHS, FIT_STEPS)
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
    stream_ms = time_ms(torch, lambda: eager._train_step(x, y), iters=10)
    log(f"[4b] one stream train step (CUDA events, 10 steps): "
        f"{stream_ms:.3f} ms -> {GLUE_BATCH / stream_ms * 1e3:.1f} samples/s")
    device_profile(torch, "bert_base fine-tune, one stream train step",
                   lambda: eager._train_step(x, y), top=8)
    graph_step_report(torch, "4b", est, x, y,
                      {k: 12 for k in KERNEL_SYMBOLS})
    counts = [c for _, _, c in fits.values()]
    scan_losses = [h["train_loss"] for h in fits["scan"][1]]
    del fits, est, eager
    torch.cuda.empty_cache()
    return {k: sum(c[k] for c in counts) for k in counts[0]}, scan_losses


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


def phase_remat(torch, P, scan_losses):
    """4d: the 4b fine-tune with ``remat=True`` on the scan path, from
    4b's weights and seeds: each step recomputes every block's forward
    in the backward (24 forward launches, 12 of each backward kernel),
    the losses stay within FIT_TOL of 4b's scan losses, and the peak
    memory is held beside 4b's."""
    import numpy as np

    ids, cols = glue_columns(np, GLUE_BATCH * FIT_STEPS, GLUE_SEQ, 30522,
                             seed=5)
    cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                      dropout_rate=0.1, max_len=GLUE_SEQ, remat=True)
    per_step = {k: 12 for k in KERNEL_SYMBOLS}
    per_step["flash_fwd"] = 24
    fits = _fit_modes(
        torch, P, np, "4d",
        lambda mode: _glue_estimator(torch, P, np, cfg, mode, FIT_EPOCHS),
        cols, FIT_EPOCHS, FIT_STEPS, modes=("scan",), per_step=per_step)
    est, history, counts = fits["scan"]
    losses = [h["train_loss"] for h in history]
    diff = max(abs(a - b) for a, b in zip(losses, scan_losses))
    log(f"[4d] remat scan losses {losses} against 4b's scan {scan_losses}: "
        f"max |difference| {diff:.3e} (tolerance {FIT_TOL})")
    check(np.allclose(losses, scan_losses, **FIT_TOL),
          "remat losses disagree with 4b's scan losses")
    later = history[1:]
    ms = sum(h["time_s"] for h in later) / (len(later) * FIT_STEPS) * 1e3
    log(f"[4d] scan epochs 1-{FIT_EPOCHS - 1}: {ms:.2f} ms/step, "
        f"{GLUE_BATCH / ms * 1e3:.1f} samples/s (host clock)")
    x = torch.from_numpy(ids[:GLUE_BATCH]).cuda()
    y = torch.from_numpy(cols["label"][:GLUE_BATCH]).cuda()
    graph_step_report(torch, "4d", est, x, y, per_step)
    (peak, held), (peak_b, held_b) = PEAK_BYTES[("4d", "scan")], \
        PEAK_BYTES[("4b", "scan")]
    log(f"[4d] fit's peak above what it held before: remat "
        f"{(peak - held) / 2**30:.3f} GiB, 4b scan (no remat) "
        f"{(peak_b - held_b) / 2**30:.3f} GiB")
    del fits, est
    torch.cuda.empty_cache()
    return counts


def criteo_columns(np, cfg, n, seed):
    """Criteo-shaped rows, drawn as examples/dlrm_criteo.py draws them:
    gamma dense features; Pareto-skewed ids (heavy heads, long tails)
    folded into each table's vocabulary, as float columns (PackedDLRM's
    form); a label from a logistic of I0, I1 and C0's parity."""
    rng = np.random.default_rng(seed)
    cols = {f"I{i}": rng.gamma(1.5, 2.0, n).astype(np.float32)
            for i in range(cfg.dense_features)}
    for t, vocab in enumerate(cfg.vocab_sizes):
        ids = (rng.pareto(1.2, n) * 17).astype(np.int64) % vocab
        cols[f"C{t}"] = ids.astype(np.float32)
    logit = -1.2 + 0.35 * cols["I0"] - 0.2 * cols["I1"] + 0.3 * (
        cols["C0"] % 2)
    cols["label"] = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(
        np.float32)
    return cols


def embedding_impls(torch, P, ids):
    """One criteo table (100k x 128, bf16 lookups) by ``onehot`` against
    ``take`` on the card: the same rows, and each lookup's time."""
    from raydp_tpu_torch.models.dlrm import ShardedEmbedding

    take = ShardedEmbedding(100_000, 128, impl="take").cuda()
    onehot = ShardedEmbedding(100_000, 128, impl="onehot").cuda()
    onehot.load_state_dict(take.state_dict())
    with torch.no_grad():
        got, want = onehot(ids), take(ids)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        take_ms = time_ms(torch, lambda: take(ids), iters=20)
        onehot_ms = time_ms(torch, lambda: onehot(ids), iters=20)
    log(f"[5] one table (100000 x 128) at batch {len(ids)}: onehot against "
        f"take max |difference| {err:.3e} (tol {TOL['bfloat16']}); forward "
        f"take {take_ms:.4f} ms, onehot {onehot_ms:.4f} ms")
    check(torch.allclose(got.float(), want.float(), **TOL["bfloat16"]),
          "onehot lookup disagrees with take")


def phase_dlrm(torch, P):
    """5: PackedDLRM at criteo_dlrm's full width through Estimator, bce,
    AdamW, batch 1024, on both epoch paths from the same weights."""
    import numpy as np

    cfg = P.criteo_dlrm()
    cols = criteo_columns(np, cfg, DLRM_BATCH * DLRM_STEPS, seed=11)
    names = [f"I{i}" for i in range(cfg.dense_features)] + [
        f"C{t}" for t in range(cfg.n_tables)]

    def make_estimator(mode):
        return P.Estimator(
            model=P.PackedDLRM(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(12)),
            optimizer=lambda p: torch.optim.AdamW(p, lr=1e-3,
                                                  weight_decay=1e-2),
            loss="bce", metrics=["accuracy"], num_epochs=DLRM_EPOCHS,
            batch_size=DLRM_BATCH, feature_columns=names,
            label_column="label", seed=0, shuffle=False, epoch_mode=mode,
            device="cuda")

    no_flash = {k: 0 for k in KERNEL_SYMBOLS}
    fits = _fit_modes(torch, P, np, "5", make_estimator, cols, DLRM_EPOCHS,
                      DLRM_STEPS, per_step=no_flash)
    est = fits["scan"][0]
    n_params = sum(p.numel() for p in est.get_model().parameters())
    log(f"[5] criteo_dlrm: {n_params} parameters, {cfg.n_tables} tables "
        f"of {cfg.vocab_sizes[0]} x {cfg.embed_dim}, lookups "
        f"{cfg.impl_for(cfg.vocab_sizes[0])}")
    for mode, (_, history, _) in fits.items():
        losses = [h["train_loss"] for h in history]
        later = history[1:]
        ms = sum(h["time_s"] for h in later) / (len(later) * DLRM_STEPS) * 1e3
        log(f"[5] {mode}: epochs 1-{DLRM_EPOCHS - 1} {ms:.2f} ms/step, "
            f"{DLRM_BATCH / ms * 1e3:.1f} samples/s (host clock)")
        check(losses[-1] < losses[0], f"5 {mode}: train loss did not fall: "
                                      f"{losses}")
    x = torch.from_numpy(np.stack([cols[c] for c in names], axis=1)[
        :DLRM_BATCH]).cuda()
    y = torch.from_numpy(cols["label"][:DLRM_BATCH]).cuda()
    eager = fits["stream"][0]
    eager.get_model().train()
    stream_ms = time_ms(torch, lambda: eager._train_step(x, y), iters=10)
    log(f"[5] one stream train step (CUDA events, 10 steps): "
        f"{stream_ms:.3f} ms -> {DLRM_BATCH / stream_ms * 1e3:.1f} samples/s")
    device_profile(torch, "criteo_dlrm, one stream train step",
                   lambda: eager._train_step(x, y), top=8)
    graph_step_report(torch, "5", est, x, y, no_flash)
    embedding_impls(torch, P, x[:, cfg.dense_features].long())
    del fits, est, eager
    torch.cuda.empty_cache()


def phase_moe(torch, P):
    """6: MoEClassifier over bert_base with the flash trunk (8 experts of
    d_ff 3072, top-2, capacity factor 1.25), aux_losses=True, AdamW,
    softmax_ce, batch 32 x seq 128, dropout 0.1, on both epoch paths from
    the same weights: 12 launches of each bf16 flash kernel a step."""
    import numpy as np

    from raydp_tpu_torch.models.moe import MoELayer

    ids, cols = glue_columns(np, GLUE_BATCH * MOE_STEPS, GLUE_SEQ, 30522,
                             seed=5)
    cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                      dropout_rate=0.1, max_len=GLUE_SEQ)
    moe = P.MoEConfig()

    def make_estimator(mode):
        return P.Estimator(
            model=P.MoEClassifier(cfg, moe, 2, device="cuda",
                                  generator=torch.Generator().manual_seed(13)),
            optimizer=lambda p: torch.optim.AdamW(p, lr=1e-4,
                                                  weight_decay=1e-2),
            loss="softmax_ce", metrics=["categorical_accuracy"],
            num_epochs=MOE_EPOCHS, batch_size=GLUE_BATCH,
            feature_columns=[f"t{i}" for i in range(GLUE_SEQ)],
            label_column="label", feature_dtype=np.int32,
            label_dtype=np.int32, seed=0, shuffle=False, epoch_mode=mode,
            aux_losses=True, device="cuda")

    fits = _fit_modes(torch, P, np, "6", make_estimator, cols, MOE_EPOCHS,
                      MOE_STEPS)
    tokens = GLUE_BATCH * GLUE_SEQ
    for mode, (est, history, _) in fits.items():
        model = est.get_model()
        layers = [m for m in model.modules() if isinstance(m, MoELayer)]
        aux = float(P.moe_aux_loss(model).detach())
        kept = sum(float(m.kept_slots) for m in layers)
        slots = tokens * moe.top_k * len(layers)
        losses = [h["train_loss"] for h in history]
        later = history[1:]
        ms = sum(h["time_s"] for h in later) / (len(later) * MOE_STEPS) * 1e3
        log(f"[6] {mode}: epochs 1-{MOE_EPOCHS - 1} {ms:.2f} ms/step, "
            f"{GLUE_BATCH / ms * 1e3:.1f} samples/s (host clock); last "
            f"step's aux term {aux:.5f} (weight {moe.aux_loss_weight}); "
            f"token-slots dropped for capacity {1 - kept / slots:.4f} "
            f"({slots - kept:.0f} of {slots}; capacity "
            f"{moe.capacity(tokens)} a expert a layer)")
        check(np.isfinite(aux), f"6 {mode}: non-finite aux loss {aux}")
        check(losses[-1] < losses[0], f"6 {mode}: train loss did not fall: "
                                      f"{losses}")
    est = fits["scan"][0]
    n_params = sum(p.numel() for p in est.get_model().parameters())
    log(f"[6] MoEClassifier: {n_params} parameters")
    x = torch.from_numpy(ids[:GLUE_BATCH]).cuda()
    y = torch.from_numpy(cols["label"][:GLUE_BATCH]).cuda()
    eager = fits["stream"][0]
    eager.get_model().train()
    stream_ms = time_ms(torch, lambda: eager._train_step(x, y), iters=10)
    log(f"[6] one stream train step (CUDA events, 10 steps): "
        f"{stream_ms:.3f} ms -> {GLUE_BATCH / stream_ms * 1e3:.1f} samples/s")
    device_profile(torch, "MoE classifier, one stream train step",
                   lambda: eager._train_step(x, y), top=8)
    graph_step_report(torch, "6", est, x, y, {k: 12 for k in KERNEL_SYMBOLS})
    counts = [c for _, _, c in fits.values()]
    del fits, est, eager
    torch.cuda.empty_cache()
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def taxi_columns(np, n_rows, seed=0):
    """examples/data_process.py's ``synthetic_taxi`` rows (the same draws
    in the same order) through its ``nyc_taxi_preprocess`` (rows with a
    passenger; hour, Spark's day of week, haversine distance), in numpy."""
    rng = np.random.default_rng(seed)
    secs = rng.integers(0, 365 * 24 * 3600, n_rows)  # from 2020-01-01 00:00
    trip_min = rng.gamma(2.0, 7.0, n_rows)
    plon = -73.98 + 0.1 * rng.standard_normal(n_rows)
    plat = 40.75 + 0.1 * rng.standard_normal(n_rows)
    dlon = -73.97 + 0.1 * rng.standard_normal(n_rows)
    dlat = 40.76 + 0.1 * rng.standard_normal(n_rows)
    dist = np.hypot((dlon - plon) * 84.3, (dlat - plat) * 111.1)
    passengers = rng.integers(0, 7, n_rows)
    fare = np.maximum(2.5, 2.5 + 1.6 * dist + 0.3 * trip_min
                      + rng.standard_normal(n_rows))
    rad = np.pi / 180.0
    a = (np.sin((dlat - plat) * rad / 2) ** 2 + np.cos(plat * rad)
         * np.cos(dlat * rad) * np.sin((dlon - plon) * rad / 2) ** 2)
    days = 18262 + secs // 86400  # 2020-01-01 is day 18262 of the epoch
    keep = (fare > 0) & (passengers > 0)
    cols = {"hour": (secs // 3600) % 24,
            "day_of_week": (days + 4) % 7 + 1,  # Sunday 1 .. Saturday 7
            "distance_km": 6371.0 * 2 * np.arcsin(np.sqrt(a)),
            "passenger_count": passengers, "fare_amount": fare}
    return {k: v[keep].astype(np.float32) for k, v in cols.items()}


def _split(np, cols, share=0.9, seed=42):
    """(train, test) row split, the examples' ``random_split([0.9, 0.1])``
    in numpy."""
    train = np.random.default_rng(seed).random(len(cols["fare_amount"])) \
        < share
    return ({k: v[train] for k, v in cols.items()},
            {k: v[~train] for k, v in cols.items()})


def _gbt_fit(torch, P, gbt_mod, device, train_ds, test_ds, label, loss):
    """One GBTEstimator fit at examples/gbt_nyctaxi.py's settings on
    ``device``; on the card each level's histogram and split search are
    timed (synchronised). Returns (estimator, history, seconds,
    histogram seconds)."""
    est = P.GBTEstimator(n_trees=GBT_TREES, max_depth=5, max_bins=64,
                         loss=loss, feature_columns=TAXI_FEATURES,
                         label_column=label, device=device)
    spent = [0.0]
    hist_fn, split_fn = gbt_mod._level_histograms, gbt_mod._best_splits

    def timed(fn):
        def run(*args):
            if device == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            if device == "cuda":
                torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t
            return out
        return run

    gbt_mod._level_histograms = timed(hist_fn)
    gbt_mod._best_splits = timed(split_fn)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        history = est.fit(train_ds, evaluate_ds=test_ds)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        gbt_mod._level_histograms, gbt_mod._best_splits = hist_fn, split_fn
    if device == "cuda":
        log(f"[7] GBT {loss} card fit: peak memory allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return est, history, seconds, spent[0]


def phase_gbt(torch, P, train, test):
    """7: GBTEstimator at examples/gbt_nyctaxi.py's settings (60 trees,
    depth 5, 64 bins) on the taxi rows, squared loss on the fare, then
    logistic on a thresholded fare; each on the card and on the CPU in
    this run, histories and predictions held together, split nodes that
    differ counted; save on the card, restore, predict the same."""
    import importlib

    import numpy as np

    gbt_mod = importlib.import_module("raydp_tpu_torch.train.gbt")
    threshold = float(np.median(train["fare_amount"]))
    x_test = np.stack([test[c] for c in TAXI_FEATURES], axis=1)
    for loss, label in (("squared", "fare_amount"), ("logistic", "high_fare")):
        tr, te = dict(train), dict(test)
        tr["high_fare"] = (tr["fare_amount"] > threshold).astype(np.float32)
        te["high_fare"] = (te["fare_amount"] > threshold).astype(np.float32)
        half = len(tr[label]) // 2
        blocks = [{k: v[:half] for k, v in tr.items()},
                  {k: v[half:] for k, v in tr.items()}]
        fits = {dev: _gbt_fit(torch, P, gbt_mod, dev,
                              P.MLDataset(blocks, num_shards=2),
                              P.MLDataset([te], num_shards=1), label, loss)
                for dev in ("cuda", "cpu")}
        (card, h_card, s_card, hist_card), (cpu, h_cpu, s_cpu, hist_cpu) = \
            fits["cuda"], fits["cpu"]
        parted_nodes = ((card._trees["feature"] != cpu._trees["feature"])
                        | (card._trees["bin"] != cpu._trees["bin"]))
        differ = int(parted_nodes.sum())
        parted = np.flatnonzero(parted_nodes.any(axis=1))
        first = int(parted[0]) if len(parted) else None
        n_split = int((cpu._trees["feature"] >= 0).sum())
        keys = ("train_loss", "eval_loss")

        def rel(a, b):
            return abs(a - b) / max(abs(b), 1e-12)

        worst = [max(rel(h_card[t][k], h_cpu[t][k]) for k in keys)
                 for t in range(len(h_cpu))]
        p_card, p_cpu = card.predict(x_test), cpu.predict(x_test)
        p_err = float(np.max(np.abs(p_card - p_cpu)
                             / np.maximum(np.abs(p_cpu), 1e-12)))
        rounds = len(h_card)
        log(f"[7] GBT {loss} ({len(tr[label])} train rows, {len(te[label])} "
            f"eval rows, {rounds} trees): train_loss "
            f"{h_card[0]['train_loss']:.4f} -> {h_card[-1]['train_loss']:.4f},"
            f" eval_loss {h_card[-1]['eval_loss']:.4f}; "
            f"{card.evaluate(P.MLDataset([te], num_shards=1))}")
        log(f"[7] GBT {loss}: card {s_card / rounds * 1e3:.2f} ms a round "
            f"(histogram and split search {hist_card / rounds * 1e3:.2f} ms, "
            f"the rest {(s_card - hist_card) / rounds * 1e3:.2f} ms: routing, "
            f"leaves, the host's bookkeeping and one sync a level); CPU "
            f"{s_cpu / rounds * 1e3:.2f} ms a round (histogram "
            f"{hist_cpu / rounds * 1e3:.2f})")
        log(f"[7] GBT {loss} card against CPU: {differ} of "
            f"{card._trees['feature'].size} tree nodes differ in split "
            f"({n_split} splits on the CPU), in {len(parted)} trees from "
            f"round {first}; history max relative difference "
            f"{max(worst):.3e}, predictions {p_err:.3e} (rtol 1e-3)")
        check(h_card[-1]["train_loss"] < h_card[0]["train_loss"],
              f"GBT {loss}: train loss did not fall")
        same = max(worst) <= 1e-3 and np.allclose(p_card, p_cpu, rtol=1e-3,
                                                  atol=1e-6)
        if not same:
            # The card's atomic sums can flip a near-tie, and every later
            # tree then grows on other residuals. Hold the fits together up
            # to the round where the trees parted (a near-tie leaves that
            # round's loss alike), then their final quality.
            check(first is not None, f"GBT {loss}: identical trees, yet the "
                                     f"card's fit differs from the CPU's")
            final = worst[-1]
            log(f"[7] GBT {loss}: the trees parted at round {first}; history "
                f"through it within {max(worst[:first + 1]):.3e}, final "
                f"losses within {final:.3e} (bounds 1e-3, 1e-2)")
            check(max(worst[:first + 1]) <= 1e-3,
                  f"GBT {loss}: the card's trees parted from the CPU's at "
                  f"round {first} on no near-tie")
            check(final <= 1e-2, f"GBT {loss}: after the trees parted the "
                                 f"card's final losses differ by {final:.3e}")
        if loss == "squared":
            import tempfile

            with tempfile.TemporaryDirectory() as tmp:
                again = P.GBTEstimator.restore(card.save(tmp), device="cuda")
            check(np.array_equal(again.predict(x_test), p_card),
                  "GBT restored from its save predicts otherwise")
            log("[7] GBT saved on the card, restored: the same predictions")
        # The device's idle share over 5 rounds of the same fit, refitted.
        device_profile(torch, f"GBT {loss}, 5 rounds on the card",
                       lambda: card.fit(P.MLDataset(blocks, num_shards=2),
                                        num_epochs=5))


TAXI_FEATURES = ["hour", "day_of_week", "distance_km", "passenger_count"]


def keras_taxi_model() -> str:
    """examples/tf_nyctaxi.py's ``keras_taxi_model``: the reference
    example's Dense(256..16) + BatchNormalization tower in the keras
    ``to_json()`` wire format."""
    layers = []
    for units in (256, 128, 64, 32, 16):
        layers.append({"class_name": "Dense",
                       "config": {"units": units, "activation": "relu"}})
        layers.append({"class_name": "BatchNormalization", "config": {}})
    layers.append({"class_name": "Dense",
                   "config": {"units": 1, "activation": "linear"}})
    return json.dumps({"class_name": "Sequential",
                       "config": {"name": "taxi_fare", "layers": layers}})


def titanic_columns(np, n, seed=7):
    """Titanic-shaped passengers (examples/jax_titanic.py's draws) after
    its fillna, encoding and scaling, with the class one-hot: 8 features
    and ``Survived``."""
    rng = np.random.default_rng(seed)
    female = rng.choice(["male", "female"], n) == "female"
    pclass = rng.choice([1, 2, 3], n, p=[0.24, 0.21, 0.55])
    age = rng.normal(30, 14, n).clip(0.5, 80)
    age[rng.random(n) < 0.2] = np.nan
    fare = rng.gamma(2.0, 16.0, n)
    logit = (1.2 * female - 0.45 * (pclass - 2)
             - 0.012 * np.nan_to_num(age, nan=30.0) + 0.004 * fare)
    survived = rng.random(n) < 1 / (1 + np.exp(-logit))
    cols = {"class_1": pclass == 1, "class_2": pclass == 2,
            "class_3": pclass == 3, "is_female": female,
            "age_n": np.nan_to_num(age, nan=30.0) / 40.0 - 0.75,
            "SibSp": rng.integers(0, 5, n), "Parch": rng.integers(0, 4, n),
            "fare_n": fare / 50.0 - 0.6, "Survived": survived}
    return {k: v.astype(np.float32) for k, v in cols.items()}


def phase_tf(torch, P, train, test):
    """8: TFEstimator with examples/tf_nyctaxi.py's keras tower,
    optimizer, loss and batch on the taxi rows; then a Titanic-shaped
    binary classifier with its sigmoid head fused into the loss."""
    import numpy as np

    est = P.TFEstimator(
        model=keras_taxi_model(),
        optimizer={"class_name": "Adam", "config": {"learning_rate": 1e-3}},
        loss="mean_squared_error", metrics=["mae"],
        feature_columns=TAXI_FEATURES, label_column="fare_amount",
        batch_size=256, num_epochs=TF_EPOCHS, seed=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    history = est.fit(P.MLDataset([train], num_shards=1),
                      evaluate_ds=P.MLDataset([test], num_shards=1))
    log(f"[8] keras taxi tower fit: peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    impl = est._built()
    steps = -(-len(train["fare_amount"]) // 256)
    for h in history:
        log(f"[8] keras taxi tower ({impl.effective_epoch_mode}) epoch "
            f"{h['epoch']}: train_loss {h['train_loss']:.4f}, eval_mae "
            f"{h['eval_mae']:.4f}, {h['samples_per_sec']:.1f} samples/s, "
            f"{h['time_s'] / steps * 1e3:.3f} ms/step ({steps} steps)")
    check(history[-1]["train_loss"] < history[0]["train_loss"],
          "keras taxi tower: train loss did not fall")
    x = np.stack([test[c] for c in TAXI_FEATURES], axis=1)[:4096]
    preds = est.predict(x)
    module = est.get_model().eval()
    with torch.no_grad():
        want = module(torch.from_numpy(x).cuda()).cpu().numpy()
    check(preds.shape == (len(x), 1) and np.allclose(preds, want, rtol=1e-6,
                                                     atol=1e-6),
          "TFEstimator.predict differs from its model's forward")
    log(f"[8] predict on {len(x)} rows equals the returned model's forward")
    graph_step_report(
        torch, "8", impl,
        torch.from_numpy(np.stack([train[c] for c in TAXI_FEATURES],
                                  axis=1)[:256]).cuda(),
        torch.from_numpy(train["fare_amount"][:256]).cuda(),
        {k: 0 for k in KERNEL_SYMBOLS})

    cols = titanic_columns(np, 50_000)
    features = [c for c in cols if c != "Survived"]
    clf = P.TFEstimator(
        model=[{"class_name": "Dense",
                "config": {"units": 128, "activation": "relu"}},
               {"class_name": "Dense",
                "config": {"units": 64, "activation": "relu"}},
               {"class_name": "Dense",
                "config": {"units": 1, "activation": "sigmoid"}}],
        optimizer="adam", loss="binary_crossentropy", metrics=["accuracy"],
        feature_columns=features, label_column="Survived", batch_size=256,
        num_epochs=TF_EPOCHS, seed=0, device="cuda")
    check(clf.layer_configs[-1]["config"]["activation"] == "linear",
          "the sigmoid head was not fused into the loss")
    hist = clf.fit(P.MLDataset([cols], num_shards=1),
                   evaluate_ds=P.MLDataset([cols], num_shards=1))
    log(f"[8] Titanic-shaped classifier ({len(features)} features): losses "
        f"{[round(h['train_loss'], 4) for h in hist]}, eval accuracy "
        f"{hist[-1]['eval_accuracy']:.4f}, "
        f"{hist[-1]['samples_per_sec']:.1f} samples/s")
    check(hist[-1]["train_loss"] < hist[0]["train_loss"],
          "Titanic-shaped classifier: train loss did not fall")


# ------------------------------------------------------------ phase 9

_SERVE_MODELS = {}


def serve_classifier(seed: int, device="cuda", attention_impl="flash"):
    """Phase 2's classifier (bert_base width and depth, bf16, 2 classes)
    with weights from ``seed``, built once per process and argument
    set; ``attention_impl="dense"`` gives the same weights without the
    kernel."""
    import torch

    import raydp_tpu_torch as P

    key = (seed, str(device), attention_impl)
    if key not in _SERVE_MODELS:
        _SERVE_MODELS[key] = P.SequenceClassifier(
            P.bert_base(attention_impl=attention_impl, dtype=torch.bfloat16),
            device=device, generator=torch.Generator().manual_seed(seed),
        ).eval()
    return _SERVE_MODELS[key]


def padded_ids(torch, payloads, bucket, device):
    """Each request's ids padded with 0 to ``bucket``, as one tensor."""
    return torch.tensor([list(p)[:bucket] + [0] * (bucket - len(p))
                         for p in payloads], device=device)


def classify_batch(payloads, bucket, *, seed, device):
    """A batch replica's model: the requests' ids, padded to ``bucket``,
    through :func:`serve_classifier`; each request's logits as floats.
    Shipped as ``functools.partial(classify_batch, seed=...)``; a replica
    imports this file as the module ``chip_smoke`` and gives ``device``,
    the group's."""
    import torch

    model = serve_classifier(seed, device)
    with torch.inference_mode():
        logits = model(padded_ids(torch, payloads, bucket, device))
    return logits.float().cpu().tolist()


def _wait_up(group, what):
    """Until every replica of ``group`` has registered; fails the run
    after ``SERVE_UP_S``."""
    deadline = time.monotonic() + SERVE_UP_S
    while group.stats()["replicas_alive"] < group.replicas:
        check(time.monotonic() < deadline,
              f"{what}: replicas did not register within {SERVE_UP_S:.0f} "
              f"s: {group.stats()}")
        time.sleep(0.05)


def _wait_respawned(group, what):
    """Until the group has restarted a replica and every lineage is
    alive again."""
    deadline = time.monotonic() + SERVE_UP_S
    while True:
        st = group.stats()
        if st["restarts"] >= 1 and st["replicas_alive"] == group.replicas:
            return st
        check(time.monotonic() < deadline,
              f"{what}: no restart, or a lineage not back, after "
              f"{SERVE_UP_S:.0f} s: {st}")
        time.sleep(0.1)


def phase_serve_batch(torch, P):
    """9a: the bert_base classifier behind a 2-replica batch group."""
    import functools
    import importlib

    import numpy as np

    from raydp_tpu_torch.fault import FAULT_PLAN_ENV
    from raydp_tpu_torch.utils.profiling import metrics

    # By the name the replicas import it under: run as a script, this
    # file is __main__, which a replica cannot resolve.
    smoke = importlib.import_module("chip_smoke")
    model_fn = functools.partial(smoke.classify_batch, seed=SERVE_SEED)
    rng = np.random.default_rng(9)
    payloads = [rng.integers(1, 30522, size=int(n)).tolist()
                for n in rng.integers(8, 129, size=SERVE_REQUESTS)]

    # The driver's forwards of the same weights, each request padded to
    # its bucket, in the batches the queue would form from a full queue:
    # the flash model gives the in-process rate of this traffic, the
    # dense one (no kernel) the reference the replies are held against.
    model = smoke.serve_classifier(SERVE_SEED)
    dense = smoke.serve_classifier(SERVE_SEED, attention_impl="dense")
    by_bucket = {}
    for i, p in enumerate(payloads):
        b = next(b for b in SERVE_BUCKETS if len(p) <= b)
        by_bucket.setdefault(b, []).append(i)
    batches = [(b, idx[j:j + SERVE_MAX_BATCH])
               for b, idx in sorted(by_bucket.items())
               for j in range(0, len(idx), SERVE_MAX_BATCH)]

    def forward(m):
        out = [None] * len(payloads)
        for b, idx in batches:
            logits = m(padded_ids(torch, [payloads[i] for i in idx], b,
                                  "cuda")).float().cpu()
            for i, row in zip(idx, logits):
                out[i] = row
        return torch.stack(out)

    with torch.inference_mode():
        forward(model)  # warm-up
        t0 = time.perf_counter()
        inproc = forward(model)  # one host copy a batch, as a replica's
        inproc_s = time.perf_counter() - t0
        want = forward(dense)
    inproc_rate = SERVE_REQUESTS / inproc_s
    log(f"[9a] traffic: {SERVE_REQUESTS} requests of "
        f"{min(map(len, payloads))}-{max(map(len, payloads))} ids, "
        f"buckets {SERVE_BUCKETS}: "
        + ", ".join(f"{b}: {len(i)}" for b, i in sorted(by_bucket.items()))
        + f"; in-process forward of the same batches ({len(batches)}): "
        f"{inproc_s * 1e3:.2f} ms, {inproc_rate:.1f} sequences/s; max "
        f"|flash - dense| {(inproc - want).abs().max().item():.3e}")

    bound = LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * want.abs()
    # Two logits nearer than their bounds allow are a tie at bf16
    # precision: either argmax is right there.
    tie = (want[:, 0] - want[:, 1]).abs() <= bound.max(dim=1).values * 2

    def check_replies(tag, got):
        got = torch.tensor(got, dtype=torch.float32)
        check(got.shape == want.shape, f"{tag}: replies {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{tag}: non-finite logits")
        outside = int(((got - want).abs() > bound).any(dim=1).sum())
        flips = got.argmax(1) != want.argmax(1)
        log(f"[9a] {tag}: {len(got)} replies, max |replica - dense| "
            f"{(got - want).abs().max().item():.3e} (tol {LOGIT_TOL}), "
            f"{outside} outside; argmax differs on {int(flips.sum())}, "
            f"{int((flips & tie).sum())} of them ties ({int(tie.sum())} "
            f"ties in all); max |replica - driver's flash| "
            f"{(got - inproc).abs().max().item():.3e}")
        check(outside == 0, f"{tag}: {outside} replies outside the bound")
        check(torch.allclose(got, inproc, **LOGIT_TOL),
              f"{tag}: replies differ from the driver's flash forward")
        check(not bool((flips & ~tie).any()),
              f"{tag}: argmax differs beyond a tie")

    def run(tag, plan, passes):
        if plan:
            os.environ[FAULT_PLAN_ENV] = plan
        metrics.reset()
        group = P.ReplicaGroup(
            replicas=SERVE_REPLICAS, device="cuda", mode="batch",
            model_fn=model_fn, buckets=SERVE_BUCKETS,
            max_batch=SERVE_MAX_BATCH, slo_ms=SERVE_SLO_MS,
            max_queue=SERVE_REQUESTS, dispatch_timeout_s=SERVE_REQUEST_S,
            label=f"smoke-{tag}")
        try:
            t0 = time.perf_counter()
            group.start()
            _wait_up(group, tag)
            up_s = time.perf_counter() - t0
            for k in range(passes):
                metrics.reset()
                t1 = time.perf_counter()
                reqs = [group.submit(p, timeout_s=SERVE_REQUEST_S)
                        for p in payloads]
                got = [r.wait(timeout=SERVE_REQUEST_S) for r in reqs]
                wall = time.perf_counter() - t1
                check_replies(f"{tag} pass {k}", got)
            stats = _wait_respawned(group, tag) if plan else group.stats()
            pongs = group.ping()
        finally:
            group.stop()
            os.environ.pop(FAULT_PLAN_ENV, None)
        log(f"[9a] {tag}: replicas up in {up_s:.2f} s; last pass "
            f"{wall * 1e3:.1f} ms -> {SERVE_REQUESTS / wall:.1f} sequences/s "
            f"through the group ({SERVE_REQUESTS / wall / inproc_rate:.3f} "
            f"of in-process); latency p50 {stats['latency_p50_s']} s, p99 "
            f"{stats['latency_p99_s']} s; batch fill {stats['batch_fill']}; "
            f"accepted {stats['accepted']:.0f}, replies "
            f"{stats['replies']:.0f}, errors {stats['errors']:.0f}, requeued "
            f"{stats['requeued']:.0f}, restarts {stats['restarts']:.0f}, "
            f"dup replies {stats['dup_replies']:.0f}; phases (mean s) "
            + ", ".join(f"{k} {v['mean_s']}" for k, v in
                        stats["phases"].items())
            + "; per replica " + json.dumps(stats["per_replica"]))
        log(f"[9a] {tag}: Ping " + "; ".join(
            f"replica {p['replica']} on {p['device']}, {p['cuda_bytes']} "
            f"B on the card, flash_fwd {p['launches']['flash_fwd']}"
            for p in pongs))
        check(stats["replies"] == SERVE_REQUESTS and stats["errors"] == 0,
              f"{tag}: {stats['replies']} replies, {stats['errors']} errors")
        check(stats["dup_replies"] == 0, f"{tag}: duplicate replies")
        check(all(p["device"] == "cuda" for p in pongs),
              f"{tag}: a replica serves on {[p['device'] for p in pongs]}")
        # A replica that ran its model holds it on the card (a respawned
        # one that served nothing has built none).
        check(all(p["cuda_bytes"] > 0 for p in pongs
                  if p["launches"]["flash_fwd"] > 0),
              f"{tag}: a replica launched kernels but holds no card memory")
        return stats, pongs, SERVE_REQUESTS / wall

    stats, pongs, rate = run("batch", None, passes=2)
    check(all(p["launches"]["flash_fwd"] > 0 for p in pongs),
          "a batch replica launched no flash forward")
    kill_stats, kill_pongs, kill_rate = run("batch-kill", SERVE_KILL_PLAN,
                                            passes=1)
    check(kill_stats["restarts"] >= 1 and kill_stats["dead_lineages"] == 0,
          "serve_kill: no restart, or a lineage lost")
    check(kill_stats["requeued"] >= 1, "serve_kill: no batch requeued")
    # By Ping, the replicas alive at each run's end: a killed
    # incarnation's launches are lost with it.
    return {"replica_launches": [
                sum(p["launches"]["flash_fwd"] for p in pongs),
                sum(p["launches"]["flash_fwd"] for p in kill_pongs)],
            "rate": rate, "inproc_rate": inproc_rate, "kill_rate": kill_rate}


def phase_serve_decode(torch, P):
    """9b: the bert_base-width f32 decode engine behind a 1-replica
    decode group, killed mid-stream."""
    import functools

    from raydp_tpu_torch.fault import FAULT_PLAN_ENV
    from raydp_tpu_torch.utils.profiling import metrics

    # No device bound: the replica gives the factory the group's.
    factory = functools.partial(
        P.build_transformer_engine, num_slots=8,
        page_tokens=16, seed=0, causal=True, attention_impl="flash",
        vocab_size=30522, max_len=512, d_model=768, n_heads=12,
        n_layers=12, d_ff=3072)
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, 30522, (n,), generator=gen).tolist()
               for n in SERVE_DECODE_PROMPT_LENS]
    trigger = [9, 9]
    P.set_exact_float32()
    engine = factory(device="cuda")
    want = [P.reference_decode(engine, p, SERVE_DECODE_MAX_NEW)
            for p in prompts]
    want_trigger = P.reference_decode(engine, trigger, 4)
    del engine
    torch.cuda.empty_cache()

    os.environ[FAULT_PLAN_ENV] = SERVE_DECODE_KILL_PLAN
    metrics.reset()
    group = P.ReplicaGroup(
        replicas=1, device="cuda", mode="decode", model_fn=factory,
        slo_ms=SERVE_SLO_MS, dispatch_timeout_s=SERVE_REQUEST_S,
        label="smoke-decode")
    try:
        t0 = time.perf_counter()
        group.start()
        _wait_up(group, "decode")
        # Registered; the engine is ready once Ping reports its graphs.
        deadline = time.monotonic() + SERVE_UP_S
        while "graphs" not in group.ping()[0]:
            check(time.monotonic() < deadline, "decode engine not built")
            time.sleep(0.1)
        up_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        reqs = [group.submit_generate(p, max_new=SERVE_DECODE_MAX_NEW,
                                      timeout_s=SERVE_REQUEST_S)
                for p in prompts]
        deadline = time.monotonic() + SERVE_REQUEST_S
        while metrics.snapshot()["counters"].get("decode/tokens", 0) < 4:
            check(time.monotonic() < deadline, "no token streamed")
            time.sleep(0.005)
        trig = group.submit_generate(trigger, max_new=4,
                                     timeout_s=SERVE_REQUEST_S)
        got = [r.wait(timeout=SERVE_REQUEST_S)["tokens"] for r in reqs]
        got_trigger = trig.wait(timeout=SERVE_REQUEST_S)["tokens"]
        wall = time.perf_counter() - t1
        stats = _wait_respawned(group, "decode")
        pongs = group.ping()
    finally:
        group.stop()
        os.environ.pop(FAULT_PLAN_ENV, None)
    dec = stats["decode"]
    n_tokens = sum(map(len, got)) + len(got_trigger)
    ttfts = [r.ttft_s() for r in reqs + [trig]]
    log(f"[9b] decode group (bert_base width, f32, 1 replica, "
        f"{SERVE_DECODE_KILL_PLAN}): engine up in {up_s:.2f} s; "
        f"{n_tokens} tokens in {wall:.3f} s -> {n_tokens / wall:.1f} "
        f"tokens/s by the host clock, stats tokens/s "
        f"{dec['tokens_per_sec']}; TTFT p50 {dec['ttft_p50_s']} s, p99 "
        f"{dec['ttft_p99_s']} s; by request (prompt lengths "
        f"{SERVE_DECODE_PROMPT_LENS}, then the trigger) "
        + ", ".join(f"{t:.4f}" for t in ttfts)
        + f" s; TPOT p50 {dec['tpot_p50_s']} s; restarts "
        f"{stats['restarts']:.0f}, requeued prefills "
        f"{dec['requeued_prefills']:.0f}, dup tokens {dec['dup_tokens']:.0f}"
        f", replies {stats['replies']:.0f}, errors {stats['errors']:.0f}; "
        f"respawned replica: Ping {pongs[0]}")
    for p, g, w in zip(prompts, got, want):
        if g != w:
            i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                     min(len(g), len(w)))
            log(f"[9b] MISMATCH prompt len {len(p)} at token {i}: group "
                f"{g[i:i + 3]} reference {w[i:i + 3]}")
    check(got == want, "decode group streams differ from reference_decode")
    check(got_trigger == want_trigger, "the trigger's stream differs")
    check(stats["restarts"] >= 1, "decode: no restart")
    check(dec["requeued_prefills"] >= 1, "decode: no prefill requeued")
    check(stats["errors"] == 0 and stats["replies"] == len(prompts) + 1,
          "decode: errors or missing replies")
    check(pongs[0]["device"] == "cuda" and pongs[0]["cuda_bytes"] > 0,
          "decode replica's engine not on the card")
    return pongs[0]["launches"]["flash_fwd"]


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
    fit_counts, scan_losses = phase_finetune(torch, P)
    lm_counts = phase_causal_lm(torch, P)
    remat_counts = phase_remat(torch, P, scan_losses)
    phase_dlrm(torch, P)
    moe_counts = phase_moe(torch, P)
    import numpy as np

    train, test = _split(np, taxi_columns(np, GBT_ROWS))
    phase_gbt(torch, P, train, test)
    phase_tf(torch, P, train, test)
    _reset_counts()
    serve = phase_serve_batch(torch, P)
    serve_bf16_driver = _counts()["flash_fwd"]
    _reset_counts()
    decode_replica_launches = phase_serve_decode(torch, P)
    serve_f32_driver = _counts()["flash_fwd"]
    serve_launches = (sum(serve["replica_launches"]) + serve_bf16_driver
                      + decode_replica_launches + serve_f32_driver)
    fits = {"fine-tune": fit_counts, "causal LM": lm_counts,
            "remat fine-tune": remat_counts, "MoE": moe_counts}
    for e in entries:
        name = e["name"]
        e["launches"] = sum(c[name] for c in fits.values())
        if name == "flash_fwd":
            e["launches"] += glue_launches + decode_launches + serve_launches
        check(e["launches"] > 0, f"the main path launched no {name}")
    log(f"[main path] flash_fwd launches: GLUE forward {glue_launches}, "
        f"decode server and its reference {decode_launches} (the f32 "
        f"ones; no f32 backward runs on the main path); by fit: "
        + "; ".join(f"{tag} {c}" for tag, c in fits.items())
        + f"; serve plane {serve_launches}: batch replicas "
        f"{' + '.join(map(str, serve['replica_launches']))} (by Ping at "
        f"the end of the clean run and of the serve_kill run), the "
        f"driver's bf16 flash forward {serve_bf16_driver} (the in-process "
        f"rate), decode replica {decode_replica_launches}, the driver's "
        f"f32 reference_decode {serve_f32_driver}")
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
