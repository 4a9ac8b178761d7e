"""The port's health plane (``raydp_tpu_torch/telemetry``: the watchdog,
the flight recorder, the JSONL logs, the debug endpoint) against
``tests/test_health.py``.

* Every case of ``tests/test_health.py`` runs against the port
  (``test_reference_case_on_port``), its ``raydp_tpu.telemetry`` imports
  (those in its subprocess scripts too) pointed at the port; its
  wedged-worker acceptance case runs on a port session.
* The port's own case: a gang rank's SIGTERM drain chains to the flight
  recorder (``raydp_tpu_torch/fault/inject.py``). A process that armed
  the recorder, then the drain, drains on SIGTERM, keeps running until
  it hands the signal on, and then leaves a bundle and dies by the
  signal.
"""
import os
import signal
import subprocess
import sys
import textwrap

import pytest

from raydp_tpu_torch.telemetry import flight_recorder
from torch_port_cases import cases, load_port_module, run_case, time_limit

PORT_REFERENCE = load_port_module("test_health.py")
REFERENCE_NAMES = tuple(n for n in dir(PORT_REFERENCE)
                        if n.startswith("test_"))
LIMIT_S = 150


@pytest.mark.parametrize("name,params",
                         [c[1:] for c in cases(PORT_REFERENCE,
                                               REFERENCE_NAMES)],
                         ids=[c[0] for c in cases(PORT_REFERENCE,
                                                  REFERENCE_NAMES)])
def test_reference_case_on_port(name, params, request):
    with time_limit(LIMIT_S):
        run_case(PORT_REFERENCE, name, params, request)


_DRAIN_SCRIPT = textwrap.dedent("""\
    import time

    from raydp_tpu_torch import fault
    from raydp_tpu_torch.telemetry import flight_recorder as fr

    fr.install(component="spmd-worker")
    fault.install_sigterm_drain()
    print("READY", flush=True)
    while not fault.preemption_requested():
        time.sleep(0.01)
    fr.record("train", "preempt_drain", step=3)
    fault.mark_drained()
    print("DRAINED", flush=True)
    fault.reraise_drained_sigterm()
    time.sleep(30)
    print("SURVIVED", flush=True)
""")


def test_drained_sigterm_leaves_bundle_then_dies_by_signal(tmp_path):
    env = dict(os.environ)
    env[flight_recorder.POSTMORTEM_DIR_ENV] = str(tmp_path)
    env["RAYDP_TPU_PREEMPT_GRACE_S"] = "0"
    proc = subprocess.Popen([sys.executable, "-c", _DRAIN_SCRIPT], env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "READY"
        proc.terminate()
        # The drain ran: the process went on after the signal.
        assert proc.stdout.readline().strip() == "DRAINED"
        rc = proc.wait(timeout=30)
        rest = proc.stdout.read()
    finally:
        proc.kill()
    assert rc == -signal.SIGTERM
    assert "SURVIVED" not in rest
    path = flight_recorder.latest_bundle(str(tmp_path))
    assert path is not None
    bundle = flight_recorder.read_bundle(path)
    assert bundle["reason"] == "SIGTERM"
    assert bundle["component"] == "spmd-worker"
    names = [e["name"] for e in bundle["events"]]
    assert "preempt_drain" in names and "sigterm" in names
    assert names.index("preempt_drain") < names.index("sigterm")
    assert bundle["stacks"]
