"""The port's submit CLI (``python -m raydp_tpu_torch.cli.submit``) and the
``init`` handoff it feeds, on the CPU.

* ``tests/test_cli_submit.py``'s four cases mirrored on the port (its
  drivers import JAX; these import only the port): ``--name``,
  ``--num-workers`` and ``--conf`` reach ``init()``'s config, an explicit
  argument beats the environment, the port's taxi example
  (``raydp_tpu_torch/examples/torch_nyctaxi.py``, a 2-rank gang of the
  torch compat estimator) completes under the CLI, and a missing script
  exits 2.
* Handoff parity: the same ``RAYDP_TPU_*`` environment and ``configs=``
  give the same ``ClusterConfig`` (``app_name``, ``num_workers``,
  ``extra``, ``enable_native``) from both packages' ``init``.
"""
import os
import subprocess
import sys

import raydp_tpu
import raydp_tpu_torch
from raydp_tpu_torch.cli.submit import build_parser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_submit(args, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", "raydp_tpu_torch.cli.submit", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
    )


def test_submit_env_handoff_reaches_init(tmp_path):
    """--num-workers/--name/--conf land in the driver's session config."""
    driver = tmp_path / "driver.py"
    driver.write_text(
        "import raydp_tpu_torch\n"
        "s = raydp_tpu_torch.init()\n"
        "print('APP', s.config.app_name)\n"
        "print('WORKERS', s.config.num_workers)\n"
        "print('ALIVE', len(s.cluster.alive_workers()))\n"
        "print('CONF', s.config.extra.get('spark.executor.cores'))\n"
        "raydp_tpu_torch.stop()\n"
        "print('DRIVER-OK')\n"
    )
    proc = _run_submit(["--name", "cli-handoff", "--num-workers", "1",
                        "--conf", "spark.executor.cores=3", str(driver)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "APP cli-handoff" in out
    assert "WORKERS 1" in out
    assert "ALIVE 1" in out
    assert "CONF 3" in out
    assert "DRIVER-OK" in out


def test_submit_explicit_args_beat_env(tmp_path):
    """A driver that hardcodes a value keeps it; env fills only gaps."""
    driver = tmp_path / "driver.py"
    driver.write_text(
        "import raydp_tpu_torch\n"
        "s = raydp_tpu_torch.init(num_workers=2)\n"
        "print('WORKERS', s.config.num_workers)\n"
        "print('APP', s.config.app_name)\n"
        "raydp_tpu_torch.stop()\n"
        "print('DRIVER-OK')\n"
    )
    proc = _run_submit(["--name", "env-name", "--num-workers", "1",
                        str(driver)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "WORKERS 2" in proc.stdout  # explicit beats env
    assert "APP env-name" in proc.stdout  # env fills the gap
    assert "DRIVER-OK" in proc.stdout


def test_submit_runs_nyctaxi_example_smoke():
    """The reference-parity path: submit the port's example driver."""
    proc = _run_submit(["--num-workers", "1",
                        os.path.join(REPO, "raydp_tpu_torch", "examples",
                                     "torch_nyctaxi.py"),
                        "--smoke", "--device", "cpu"])
    assert proc.returncode == 0, (
        f"--- stdout ---\n{proc.stdout[-3000:]}"
        f"\n--- stderr ---\n{proc.stderr[-3000:]}"
    )
    assert "OK" in proc.stdout


def test_submit_rejects_missing_script():
    proc = _run_submit(["/nonexistent/driver.py"], timeout=60)
    assert proc.returncode == 2
    assert "script not found" in proc.stderr


def test_parser_matches_the_reference():
    """The same options as the JAX package's CLI, under the port's name."""
    from raydp_tpu.cli.submit import build_parser as ref_parser

    def options(p):
        return sorted((a.dest, tuple(a.option_strings), a.default,
                       tuple(a.choices or ())) for a in p._actions)

    assert options(build_parser()) == options(ref_parser())
    assert build_parser().prog == "raydp-tpu-torch-submit"


def test_handoff_equals_the_reference(monkeypatch):
    """The same environment and configs= through both packages' init:
    explicit > RAYDP_TPU_* > built-in, RAYDP_TPU_CONF_* merged under
    configs=."""
    monkeypatch.setenv("RAYDP_TPU_APP_NAME", "handoff")
    monkeypatch.setenv("RAYDP_TPU_NUM_WORKERS", "1")
    monkeypatch.setenv("RAYDP_TPU_MEMORY_PER_WORKER", "2GB")
    monkeypatch.setenv("RAYDP_TPU_CONF_a", "env")
    monkeypatch.setenv("RAYDP_TPU_CONF_b", "env")
    configs = {"b": "explicit", "c": 3}
    got = {}
    for pkg in (raydp_tpu, raydp_tpu_torch):
        s = pkg.init(configs=configs, enable_native=False)
        try:
            got[pkg.__name__] = (s.config.app_name, s.config.num_workers,
                                 s.config.memory_per_worker,
                                 s.config.extra, s.config.enable_native,
                                 len(s.cluster.alive_workers()))
        finally:
            pkg.stop()
    assert got["raydp_tpu_torch"] == got["raydp_tpu"]
    assert got["raydp_tpu_torch"] == (
        "handoff", 1, 2 * 1024**3, {"a": "env", "b": "explicit", "c": 3},
        False, 1)
