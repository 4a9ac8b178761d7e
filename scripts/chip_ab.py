"""Run one phase of ``chip_smoke.py`` from two checkouts of the repo in
turns, on the card, and print each run's step times side by side.

    python3 scripts/chip_ab.py PARENT_DIR CHANGE_DIR [--phase 13b 4b]
                               [--order pccppc]

``PARENT_DIR`` and ``CHANGE_DIR`` are unpacked checkouts (``git archive``
of two commits). Each run is a fresh interpreter whose working directory
is its checkout: it builds that checkout's kernels, runs the phase
through that checkout's ``chip_smoke.py`` (its holds collected, not
fatal) and prints the phase's log lines. The order alternates the two
sides (``p`` parent, ``c`` change; the default is balanced, 3 runs
each), so a drift of the host or the card over the call falls on both.

Phases:

* ``13b``: ``fit_spmd`` of the bf16 flash bert_base classifier over a
  gang of 2 ranks in a fresh 4-worker session; read: each rank's ms a
  step of the last epoch, by CUDA events in the rank.
* ``4b``: the single-process bert_base fine-tune on the stream and the
  scan path; read: the stream fit's host-clock ms a step (epochs 1 on),
  one eager stream step by CUDA events, and the scan path's graph
  replay.
* ``4bs``: 4b's stream fit alone (its 4 epochs of 10 steps; read: epochs
  1 on a step, the whole fit's wall and epoch 0's) and one eager step,
  ~15 s a run, so more runs fit in a call; ``4bs-off`` the
  same with ``RAYDP_TPU_DEVICE_PLANE=0`` set first (a checkout without
  the device plane ignores it).

Prints one ``AB {json}`` line a run and, last, a summary with each
side's values in run order, the card's name and power limit. Needs a
CUDA card and the CUDA toolkit; imports nothing of JAX.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

RUN_TIMEOUT_S = 900

_PROGRAM = r"""
import sys
sys.path.insert(0, ".")
import chip_smoke as cs

fails = []


def check(cond, msg):
    if not cond:
        fails.append(msg)
        print("CHECK FAILED:", msg, flush=True)


cs.check = check
import torch
import raydp_tpu_torch as P
from raydp_tpu_torch.ops import _build

_build.build_all()
phase = sys.argv[1]
if phase == "13b":
    session = P.init(app_name="chip-ab-13b", num_workers=cs.SESSION_WORKERS)
    try:
        cs.phase_gang_fit(torch, P, session)
    finally:
        P.stop()
elif phase == "4b":
    cs.phase_finetune(torch, P)
elif phase in ("4bs", "4bs-off"):
    import os
    import numpy as np

    if phase == "4bs-off":
        os.environ["RAYDP_TPU_DEVICE_PLANE"] = "0"
    ids, cols = cs.glue_columns(np, cs.GLUE_BATCH * cs.FIT_STEPS,
                                cs.GLUE_SEQ, 30522, seed=5)
    cfg = P.bert_base(attention_impl="flash", dtype=torch.bfloat16,
                      dropout_rate=0.1, max_len=cs.GLUE_SEQ)
    import time

    est = cs._glue_estimator(torch, P, np, cfg, "stream", cs.FIT_EPOCHS)
    t_fit = time.perf_counter()
    history = est.fit(P.MLDataset([cols], num_shards=1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_fit
    later = history[1:]
    ms = sum(h["time_s"] for h in later) / (len(later) * cs.FIT_STEPS) * 1e3
    print(f"[{phase}] stream: epochs 1-{cs.FIT_EPOCHS - 1} {ms:.2f} ms/step")
    print(f"[{phase}] stream: the whole fit {wall:.4f} s, epoch 0 "
          f"{history[0]['time_s']:.4f} s")
    x = torch.from_numpy(ids[:cs.GLUE_BATCH]).cuda()
    y = torch.from_numpy(cols["label"][:cs.GLUE_BATCH]).cuda()
    eager = cs.time_ms(torch, lambda: est._train_step(x, y), iters=10)
    print(f"[{phase}] one stream train step (CUDA events, 10 steps): "
          f"{eager:.3f} ms")
else:
    raise SystemExit(f"unknown phase {phase}")
print("FAILS", len(fails), flush=True)
"""

# What each phase's log lines give, read the same way from both sides.
_READS = {
    "13b": [("rank_step_ms",
             re.compile(r"^\[13b\] rank (\d+): ([\d.]+) ms a step"))],
    "4b": [("stream_fit_ms",
            re.compile(r"^\[4b\] stream: epochs \S+ ([\d.]+) ms/step")),
           ("scan_fit_ms",
            re.compile(r"^\[4b\] scan: epochs \S+ ([\d.]+) ms/step")),
           ("eager_step_ms",
            re.compile(r"^\[4b\] one stream train step \(CUDA events, "
                       r"\d+ steps\): ([\d.]+) ms"))],
}
for _phase in ("4bs", "4bs-off"):
    _READS[_phase] = [
        ("stream_fit_ms",
         re.compile(rf"^\[{_phase}\] stream: epochs \S+ ([\d.]+) ms/step")),
        ("fit_wall_s",
         re.compile(rf"^\[{_phase}\] stream: the whole fit ([\d.]+) s")),
        ("epoch0_s",
         re.compile(rf"^\[{_phase}\] stream: the whole fit \S+ s, epoch 0 "
                    r"([\d.]+) s")),
        ("eager_step_ms",
         re.compile(rf"^\[{_phase}\] one stream train step \(CUDA events, "
                    r"\d+ steps\): ([\d.]+) ms"))]


def run_once(checkout: str, phase: str) -> dict:
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=checkout)
    proc = subprocess.run([sys.executable, "-c", _PROGRAM, phase],
                          cwd=checkout, env=env, capture_output=True,
                          text=True, timeout=RUN_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    out = {"rc": proc.returncode, "seconds": round(seconds, 1)}
    for key, pattern in _READS[phase]:
        values = []
        for line in lines:
            m = pattern.search(line)
            if m:
                values.append(float(m.groups()[-1]))
        out[key] = values
    out["fails"] = [ln for ln in lines if ln.startswith("CHECK FAILED")]
    out["log"] = [ln for ln in lines if ln.startswith(f"[{phase}]")]
    if proc.returncode != 0:
        out["stderr"] = proc.stderr[-3000:]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--phase", nargs="+", default=["13b"],
                    choices=sorted(_READS))
    ap.add_argument("--order", default="pccppc")
    args = ap.parse_args()
    sides = {"p": os.path.abspath(args.parent),
             "c": os.path.abspath(args.change)}
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {gpu.strip()}", flush=True)
    summary = {}
    ok = True
    for phase in args.phase:
        for i, side in enumerate(args.order):
            res = run_once(sides[side], phase)
            ok = ok and res["rc"] == 0 and not res["fails"]
            name = "parent" if side == "p" else "change"
            print("AB " + json.dumps({"phase": phase, "run": i,
                                      "side": name, **res}), flush=True)
            per = summary.setdefault(phase, {}).setdefault(name, {})
            for key, _ in _READS[phase]:
                per.setdefault(key, []).append(res[key])
    print("SUMMARY " + json.dumps({"card": gpu.strip(), "order": args.order,
                                   "phases": summary}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
