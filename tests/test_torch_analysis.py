"""The port's ``raydpcheck`` (``raydp_tpu_torch/analysis``) against
``tests/test_analysis.py``.

* The cases of ``tests/test_analysis.py`` run against the port through
  ``tests/torch_port_cases.py`` (``analysis`` pointed at the port, and
  the tree the whole-repo case checks at ``raydp_tpu_torch/``), all but
  its five R5 cases: the JAX package's R5 checks jitted bodies and
  ``donate_argnums``, which the port has not.
* The port's R5 cases: a sync in a captured step, in a step loop and in
  a decode loop fire; a profiling helper and the one-sync-a-round
  decode shape stay clean.
* The gate: ``python -m raydp_tpu_torch.analysis raydp_tpu_torch/``
  exits 0 with zero findings, no baseline file, in under 30 s, and the
  sites the JAX package's checker found on the port stay clean.
"""
import functools
import os
import subprocess
import sys
import textwrap

import pytest

from raydp_tpu_torch.analysis import baseline as baseline_mod
from raydp_tpu_torch.analysis.core import RULES, run_analysis
from torch_port_cases import case_params, cases, load_port_module, run_case

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO_ROOT, "raydp_tpu_torch")

WHOLE = load_port_module("test_analysis.py")
JAX_ONLY = ("test_r5_host_sync_in_jit", "test_r5_donation_train_only",
            "test_r5_step_loop_host_sync", "test_r5_decode_loop_host_sync",
            "test_r5_decode_loop_good_shapes")
TEST_NAMES = tuple(n for n in vars(WHOLE)
                   if n.startswith("test_") and n not in JAX_ONLY)
REFERENCE_CASES = cases(WHOLE, TEST_NAMES)


@pytest.mark.parametrize("name,params",
                         case_params(WHOLE, REFERENCE_CASES))
def test_reference_case_on_port(name, params, request):
    run_case(WHOLE, name, params, request)


def test_cases_cover_the_reference_module():
    names = [n for n in vars(WHOLE) if n.startswith("test_")]
    assert len(names) == 33 and set(JAX_ONLY) <= set(names)
    assert len(REFERENCE_CASES) == 28


def _run(tmp_path, sources, rules=("R5",)):
    pkg = tmp_path / "fixture_pkg"
    pkg.mkdir(exist_ok=True)
    (pkg / "__init__.py").write_text("")
    for name, src in sources.items():
        (pkg / name).write_text(textwrap.dedent(src))
    docs = tmp_path / "doc"
    docs.mkdir(exist_ok=True)
    return run_analysis([str(pkg)], rules=list(rules), root=str(tmp_path),
                        docs_dir=str(docs))


def _names(result):
    return sorted(f.name for f in result.findings)


# -- R5 device hazards ------------------------------------------------


def test_r5_host_sync_in_captured_step(tmp_path):
    res = _run(tmp_path, {"steps.py": """
        import torch
        from raydp_tpu_torch.utils.graphed import CapturedStep

        def _bad_step(x):
            return x.sum().item()

        def _cast_step(x):
            return float(x.sum())

        def _good_step(x):
            return x * 2

        def build():
            return (CapturedStep(_bad_step), CapturedStep(fn=_cast_step),
                    CapturedStep(_good_step, warmup=1))

        def capture(graph, x):
            with torch.cuda.graph(graph):
                y = x * 2
                torch.cuda.synchronize()
            return y
    """})
    assert _names(res) == ["host-sync-in-jit"] * 3
    scopes = sorted(f.scope.rsplit(".", 1)[-1] for f in res.findings)
    assert scopes == ["_bad_step", "_cast_step", "capture"]
    assert all(f.severity == "error" for f in res.findings)


def test_r5_step_loop_host_sync(tmp_path):
    res = _run(tmp_path, {"loop.py": """
        import torch

        def train_loop(model, opt, batches):
            total = 0.0
            for batch in batches:
                loss = model(batch)
                loss.backward()
                opt.step()
                total = total + loss.item()
            return total

        def fit_epochs(model, batches):
            losses = []
            for batch in batches:
                losses.append(model(batch).detach())
            return torch.stack(losses).cpu()
    """})
    # the per-step .item() warns once; one copy after the loop is clean
    assert _names(res) == ["host-sync-in-step-loop"]
    [f] = res.findings
    assert f.scope.endswith("train_loop") and "`.item()`" in f.message


def test_r5_profiling_helper_is_exempt(tmp_path):
    res = _run(tmp_path, {"loop.py": """
        import torch

        def bench_train_loop(model, batches):
            for batch in batches:
                model(batch)
                torch.cuda.synchronize()

        def measure_fit_step(model, batches):
            return [model(b).item() for b in batches]
    """, "profiling_fit.py": """
        def fit_timed(model, batches):
            for batch in batches:
                model(batch).cpu()
    """})
    assert res.findings == []


def test_r5_decode_loop_per_token_sync(tmp_path):
    res = _run(tmp_path, {"gen.py": """
        import torch

        def decode_tokens(engine, seqs, rounds):
            out = []
            for _ in range(rounds):
                toks = engine.step(seqs)
                for t in toks:
                    out.append(t.item())
            return out

        def generate_stream(engine, prompt, n):
            for _ in range(n):
                tok = engine.step([prompt])
                torch.cuda.synchronize()
                yield tok
    """})
    findings = [f for f in res.findings
                if f.name == "host-sync-in-decode-loop"]
    assert len(findings) == 2
    scopes = sorted(f.scope for f in findings)
    assert scopes[0].endswith("decode_tokens")
    assert scopes[1].endswith("generate_stream")
    assert "per token" in findings[0].message


def test_r5_one_sync_a_round_decode_is_clean(tmp_path):
    res = _run(tmp_path, {"gen.py": """
        def run_round(engine, batch):
            # ONE host copy per round, outside the per-sequence loop
            toks = engine.step(batch).tolist()
            for seq, tok in zip(batch, toks):
                seq.append(tok)
            return toks

        def reference_decode(engine, prompt, n):
            # the unbatched reference path is exempt by name
            out = []
            for _ in range(n):
                out.append(engine.forward(prompt).item())
            return out
    """})
    assert [f for f in res.findings
            if f.name == "host-sync-in-decode-loop"] == []


def test_rule_catalogue_is_the_port_s():
    assert sorted(RULES) == ["R1", "R2", "R3", "R4", "R5", "R6"]
    assert "device hazards" in RULES["R5"] and "jax" not in RULES["R5"]


# -- R4 reads the port's docs ----------------------------------------


@pytest.mark.parametrize("documented_in,fires", [
    ("doc/configuration.md", True),       # the JAX package's docs
    ("README.md:jax", True),              # the README's other sections
    ("README.md:port", False),            # the README's port section
    ("raydp_tpu_torch/doc/configuration.md", False),
])
def test_r4_reads_the_port_docs_only(tmp_path, documented_in, fires):
    """With no ``docs_dir``, R4 reads ``raydp_tpu_torch/doc/`` and the
    README's section on the port: a variable documented only in the
    repo's ``doc/`` (the JAX package's) or in another README section is
    undocumented for the port."""
    pkg = tmp_path / "raydp_tpu_torch"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "knob.py").write_text(
        "import os\n\nKNOB = os.environ.get('RAYDP_TPU_FIXTURE_KNOB')\n")
    readme = ["# repo", "## The JAX package", "", "## PyTorch/CUDA port", "",
              "## Layout", ""]
    line = "| `RAYDP_TPU_FIXTURE_KNOB` | unset | a knob |"
    if documented_in.startswith("README.md"):
        readme.insert(2 if documented_in.endswith("jax") else 4, line)
    else:
        (tmp_path / documented_in).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / documented_in).write_text(line)
    (tmp_path / "README.md").write_text("\n".join(readme))
    res = run_analysis([str(pkg)], rules=["R4"], root=str(tmp_path))
    assert (_names(res) == ["undocumented-env"]) is fires, _names(res)


# -- the gate: the port itself is clean -------------------------------


def test_port_gate_cli_zero_findings():
    """The command the docs give, in a fresh interpreter: exit 0, zero
    findings, no baseline file, under the reference gate's 30 s."""
    assert not os.path.exists(baseline_mod.default_path(REPO_ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "raydp_tpu_torch.analysis",
         "raydp_tpu_torch/"], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("raydpcheck: 0 finding(s), "), last
    files = int(last.split(", ")[1].split()[0])
    seconds = float(last.split(", ")[2].rstrip("s"))
    assert files > 50 and seconds < 30.0


# (rule, finding name, port file, what it named) of each finding the
# JAX package's checker gave on the port before the port had its own.
_FOUND_ON_THE_PORT = (
    ("R1", "lock-held-blocking", "cluster/rpc.py", "_idle.wait"),
    ("R1", "lock-held-blocking", "native/build.py", "subprocess.run"),
    ("R1", "lock-held-blocking", "serve/group.py", "subprocess.Popen"),
    ("R4", "unrouted-metric", "cluster/worker_main.py", "worker/fn_loads"),
    ("R4", "unrouted-metric", "cluster/worker_main.py",
     "telemetry/gauge_errors"),
    ("R4", "unrouted-metric", "spmd/worker_main.py",
     "telemetry/gauge_errors"),
    ("R4", "unrouted-metric", "train/spmd_fit.py",
     "telemetry/gang_report_errors"),
    ("R4", "unrouted-metric", "utils/profiling.py", "cost/uncounted"),
)


@functools.lru_cache(maxsize=None)
def _port_result(rule, path):
    return run_analysis([path], rules=[rule], root=REPO_ROOT)


@pytest.mark.parametrize("rule,name,rel,what", _FOUND_ON_THE_PORT,
                         ids=lambda v: str(v))
def test_sites_found_on_the_port_stay_clean(rule, name, rel, what):
    """Each is repaired, not suppressed: the rpc wait holds the condition
    it waits on, the native build holds no lock while g++ runs and the
    five metric names are in the port's docs. The one exception is the
    replica spawn under ``_spawn_mu``, which is deliberate and carries
    its suppression."""
    path = os.path.join(PORT, rel)
    res = _port_result(rule, PORT if rule == "R4" else path)
    here = [f for f in res.findings if f.path == f"raydp_tpu_torch/{rel}"]
    assert here == [], "\n".join(f.render() for f in here)
    with open(path) as f:
        source = f.read()
    suppressed = f"raydp: ignore[{rule}]" in source
    assert suppressed == (rel == "serve/group.py")
    if rule == "R4":
        with open(os.path.join(PORT, "doc", "telemetry.md")) as f:
            assert f"`{what}`" in f.read()
    else:
        assert what in source
