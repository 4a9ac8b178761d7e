"""Pluggable process launchers: how worker/agent processes reach their node
(the port's copy of ``raydp_tpu/cluster/launcher.py``).

The reference creates executors on arbitrary cluster nodes through Ray's
actor scheduler (reference: RayExecutorUtils.java:39-61,
RayAppMaster.scala:224-243). Without Ray, launching is a strategy object:

  * ``LocalLauncher`` — subprocess on this host (single host, and the
    multi-host *simulation* used in tests: node identity is carried by
    ``--node-id``, store namespaces keep "hosts" apart).
  * ``CommandLauncher`` — wraps the argv with a user command function (ssh,
    kubectl exec, a cluster scheduler CLI …): the same escape hatch as the
    SPMD runner's ``script_prepare_fn`` (reference:
    python/raydp/mpi/mpi_job.py:239-248 custom mpirun script fn).

A launcher returns a Popen-compatible handle (poll/terminate/kill/wait).
"""
from __future__ import annotations

import os
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class LaunchSpec:
    """One process to run somewhere."""

    argv: List[str]  # interpreter-relative: ["-m", "mod", "--flag", …]
    node_id: str
    log_path: Optional[str] = None
    env: Dict[str, str] = field(default_factory=dict)
    cwd: Optional[str] = None


class WorkerLauncher:
    def launch(self, spec: LaunchSpec) -> subprocess.Popen:
        log = None
        if spec.log_path is not None:
            log = open(spec.log_path, "ab")
        try:
            return subprocess.Popen(
                self._command(spec),
                stdout=log if log is not None else subprocess.DEVNULL,
                stderr=subprocess.STDOUT,
                cwd=self._local_cwd(spec),
                env=self._local_env(spec),
            )
        finally:
            if log is not None:
                log.close()

    def _command(self, spec: LaunchSpec) -> List[str]:
        raise NotImplementedError

    def _local_cwd(self, spec: LaunchSpec) -> Optional[str]:
        return spec.cwd

    def _local_env(self, spec: LaunchSpec) -> Dict[str, str]:
        return {**os.environ, **spec.env}


class LocalLauncher(WorkerLauncher):
    """Spawn on this host with the current interpreter."""

    def _command(self, spec: LaunchSpec) -> List[str]:
        return [sys.executable] + spec.argv


class CommandLauncher(WorkerLauncher):
    """Launch through a user-supplied command function.

    ``build(spec) -> argv`` returns the full command to exec locally that
    lands the process on ``spec.node_id`` (e.g. ``["ssh", host, …]``).
    The function is responsible for carrying ``spec.env`` and ``spec.cwd``
    to the remote side; neither is applied to the local wrapper process.
    """

    def __init__(self, build: Callable[[LaunchSpec], List[str]]):
        self._build = build

    def _command(self, spec: LaunchSpec) -> List[str]:
        return self._build(spec)

    def _local_cwd(self, spec: LaunchSpec) -> Optional[str]:
        return None  # cwd is the REMOTE working dir; the function handles it

    def _local_env(self, spec: LaunchSpec) -> Dict[str, str]:
        return dict(os.environ)


def ssh_launcher(
    hosts: Dict[str, str], python: str = "python3"
) -> CommandLauncher:
    """A CommandLauncher that ssh-es to ``hosts[node_id]`` and runs the
    process there: cd to the spec cwd (so ``-m raydp_tpu_torch...`` resolves
    from a repo checkout) and forward the spec env inline."""
    import shlex

    def build(spec: LaunchSpec) -> List[str]:
        host = hosts[spec.node_id]
        parts = []
        if spec.cwd:
            parts.append(f"cd {shlex.quote(spec.cwd)} &&")
        if spec.env:
            parts.append(
                "env " + " ".join(
                    f"{k}={shlex.quote(v)}" for k, v in spec.env.items()
                )
            )
        parts.append(
            " ".join([python] + [shlex.quote(a) for a in spec.argv])
        )
        return ["ssh", host, " ".join(parts)]

    return CommandLauncher(build)
