"""Multi-process distributed fit: an ``Estimator`` across a supervised
SPMD gang (the port's ``raydp_tpu/train/spmd_fit.py``).

The reference's multi-worker story is Ray Train wiring worker processes
with torch DDP (``torch/estimator.py:276-297``). Here each gang rank
(``raydp_tpu_torch.spmd``) joins ``torch.distributed`` — NCCL where
every rank on a host has a card of its own, gloo where ranks share one
or run on the CPU
(:func:`~raydp_tpu_torch.spmd.worker_main.collective_backend`)
— builds the estimator from the caller's factory, and trains on its own
shard; the estimator's multi-process mode all-reduces the gradients
(``raydp_tpu_torch/train/estimator.py``).

Shards reach the ranks in one of two ways, as in the JAX package:

* **store mode**, when a session holds the dataset's blocks as object
  refs: each rank gets only its ``shard_plan[r]`` and reads its slices
  itself (:func:`~raydp_tpu_torch.data.ml_dataset.resolve_plan_tables`:
  zero-copy for segments on its node, the store agents' chunked fetch
  for the rest); the driver reads no data;
* **in-memory**: the driver slices each rank's tables and ships them.

Supervision (``raydp_tpu/train/spmd_fit.py:158-221, 333-391``): rank
death or a registration timeout tears the gang down and relaunches it
with jittered exponential backoff under a budget of ``max_restarts``
(env ``RAYDP_TPU_MAX_RESTARTS``, default 3), resuming from the newest
complete checkpoint in ``checkpoint_dir``. A preemption notice (an
injected ``preempt`` clause, a SIGTERM, or
:meth:`~raydp_tpu_torch.spmd.job.SPMDJob.request_preemption`) drains
every rank after the same step to a ``step_emergency_<N>.pt``
checkpoint (the estimator's drain), so the relaunch loses nothing. A
failure that names ``PreemptionError`` counts ``preemptions/total`` and
every relaunch ``restarts/total`` in the process's metrics registry
(``utils/profiling.py``). With ``elastic=True`` the gang may run on a
world other than the dataset's shard count, the same blocks re-planned
over it, and a registration shortfall of G of W ranks
(``min_world_size <= G < W``) relaunches on G ranks; the estimator
rescales its resume position to the new world. On a model-parallel mesh
a shrink drops whole dp rows (pp, sp and tp are fixed): the relaunch
runs the largest multiple of ``pp·sp·tp`` ranks that registered, on the
same mesh with a smaller dp, and restores the gathered checkpoint cut
onto it (``raydp_tpu/train/spmd_fit.py:20-22, 141-146, 376-396``, where
the factory builds its mesh from the devices that survive).

Telemetry (``raydp_tpu/train/spmd_fit.py:85-95, 153-221, 296-391``): the
whole supervised fit, every relaunch included, bills to one
``fit-spmd`` job (an ambient job wins), which its gangs and ranks
inherit; relaunches, preemptions and resizes land on the event
timeline (``train/resume``, ``preempt/request``, ``gang/resize``) and in
the flight recorder; a relaunch that resumes behind the steps rank 0
had reported (its shipped ``train/step`` timer) counts the difference
as ``replay/steps``. The result adds the gang's ``metrics`` (its merged
view), ``usage`` (:meth:`~raydp_tpu_torch.spmd.job.SPMDJob.usage_report`)
and the fit's ``job_id``. In a session (an in-process one or a second
driver's), every launch's final rank views also go to the session's
master (``record_gang``), keyed ``<job>/fit-<token>/launch-<n>/rank-<r>``
so that no fit or relaunch overwrites another's, and the session's
``metrics_snapshot``, exposition and ``usage_report`` include the chip-
seconds of every fit and every relaunch.

The control plane (``raydp_tpu/train/spmd_fit.py:232-256, 359``): the
whole supervised fit holds ONE gang lease of the arbiter across
restarts. A preempted gang's drain releases it (``state="drained"``), the
loop's top re-enters admission behind the arrival, an elastic shrink
returns the departed ranks' slots (``Lease.resize``), and every exit
releases it. The arbiter's preemption of the fit is
``SPMDJob.request_preemption`` on the live gang. Inert unless
``RAYDP_TPU_SCHED_CAPACITY`` is above 0.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import random
import re
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from raydp_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

__all__ = ["fit_spmd"]

# "job X: only 2/4 ranks registered within 30s ...": the registration
# shortfall SPMDJob raises when ranks never come up; elastic mode
# shrinks the world to the ranks that did register.
_REGISTERED_RE = re.compile(r"only (\d+)/(\d+) ranks registered")
# The optimizer step in a step-encoded checkpoint's name.
_CKPT_STEP_RE = re.compile(r"^step_(?:mid|emergency)_(\d+)\.pt$")


def _newest_checkpoint(checkpoint_dir: Optional[str]) -> Optional[str]:
    """Newest complete checkpoint file (``step_*.pt`` or ``final.pt``)
    under ``checkpoint_dir``. :meth:`Estimator.save` renames a finished
    file into place, so a rank that died mid-save leaves only a
    ``*.tmp``, which never counts."""
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return None
    best, best_mtime = None, -1.0
    for name in os.listdir(checkpoint_dir):
        if not name.endswith(".pt") or not (
                name.startswith("step_") or name == "final.pt"):
            continue
        path = os.path.join(checkpoint_dir, name)
        mtime = os.path.getmtime(path)
        if mtime > best_mtime:
            best, best_mtime = path, mtime
    return best


def _ckpt_step(path: Optional[str]) -> Optional[int]:
    """The optimizer step a checkpoint's name encodes, or None."""
    if not path:
        return None
    m = _CKPT_STEP_RE.match(os.path.basename(path))
    return int(m.group(1)) if m else None


def _rank0_steps(job) -> int:
    """Optimizer steps rank 0 has reported in its shipped ``train/step``
    timer (a beat of lag: advisory, for replay accounting only)."""
    try:
        workers = job.metrics_snapshot().get("workers", {})
        timer = workers.get("rank-0", {}).get("timer/train/step", {})
        return int(timer.get("count", 0))
    except Exception:
        return 0


def _launch_views(job, since_wall: float) -> Dict[str, dict]:
    """The rank views that one launch of ``job`` shipped: those merged at
    or after ``since_wall``, the launch's start. A relaunch at the same
    world reuses the job, whose view keeps the failed launch's ranks
    until the new ranks beat; a rank's first beat ships every section,
    so a view merged since the launch holds nothing of the last one."""
    workers = job.metrics_snapshot().get("workers", {})
    return {k: v for k, v in workers.items()
            if v.get("updated_wall", 0.0) >= since_wall}


def _report_launch(session, gang: str, views: Dict[str, dict]) -> None:
    """Hand one launch's rank views to the session's master, which bills
    them with its workers'. A failure is logged and counted; the fit's
    result stands."""
    from raydp_tpu_torch.utils.profiling import metrics as _metrics

    try:
        session.cluster.record_gang(gang, views)
    except Exception as exc:
        _metrics.counter_add("telemetry/gang_report_errors")
        logger.warning("fit_spmd: the session did not take %s's rank "
                       "views (%s); its usage_report misses them", gang, exc)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _params_digest(state: Dict[str, Any]) -> str:
    """SHA-256 over a state dict's names, dtypes, shapes and bytes: two
    ranks' digests are equal exactly when their tensors are."""
    import torch

    h = hashlib.sha256()
    for name, t in state.items():
        t = t.detach().cpu().contiguous()
        h.update(f"{name}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _shrink(world: int, got: int, min_world_size: int, mesh=None):
    """``(new world, new mesh, refusal)`` after a registration shortfall
    to ``got`` of ``world`` ranks: the largest multiple of the mesh's
    ``pp·sp·tp`` (1 without a mesh) up to ``got``, on the same mesh
    with a smaller dp. A world of 0 or under ``min_world_size`` is
    refused: the new world is None and ``refusal`` says why."""
    row = mesh.size // mesh.dp if mesh is not None else 1
    fit = got - got % row
    if 0 < fit < world and fit >= min_world_size:
        return fit, (dataclasses.replace(mesh, dp=fit // row)
                     if mesh is not None else None), None
    where = (f" on mesh {mesh.axis_sizes} (whole dp rows of {row} ranks)"
             if mesh is not None else "")
    return None, mesh, (f"elastic shrink refused: {got} of {world} ranks "
                        f"registered{where}, a world of {fit} under "
                        f"min_world_size {min_world_size}"
                        if fit < world else None)


def fit_spmd(
    make_estimator: Callable[[], Any],
    train_ds,
    world_size: int,
    num_procs_per_node: int = 1,
    hosts: Optional[List[str]] = None,
    env: Optional[Dict[str, str]] = None,
    timeout: float = 600.0,
    max_restarts: Optional[int] = None,
    restart_backoff_s: Optional[float] = None,
    checkpoint_dir: Optional[str] = None,
    elastic: bool = False,
    min_world_size: int = 1,
    device: DeviceLike = "cuda",
    mesh=None,
) -> Dict[str, Any]:
    """Train ``make_estimator()`` data-parallel over ``world_size``
    processes. ``train_ds`` (an :class:`MLDataset`) must have
    ``num_shards == world_size`` unless ``elastic``; rank r trains on
    shard r. Returns rank 0's history and its parameters as numpy arrays
    (the ranks hold equal ones).

    The factory runs INSIDE each rank (shipped by the closure carrier,
    ``cluster/closure.py``) after the rank has joined the gang's process
    group and, on a card, made its card the current device; build the
    ``MeshSpec`` there (``MeshSpec(dp=torch.distributed.get_world_size())``).
    ``device`` is the ranks' device: ``"cuda"`` (the default) raises
    here without a card, and a rank that finds none fails the gang;
    ``"cpu"`` trains on the CPU over gloo.

    ``mesh`` (a :class:`~raydp_tpu_torch.parallel.MeshSpec` with pp, sp
    or tp above 1; the factory's estimator takes the same spec) makes
    the gang a mesh, one process per position: ``world_size`` must be
    ``mesh.size`` and ``train_ds`` must have ``mesh.dp`` shards, shard
    ``i`` going to every rank of dp index ``i`` (its sp, tp and pp peers
    read the same rows). ``params`` are then the gathered full
    parameters, and ``per_rank_params_sha256`` digests each rank's
    gathered parameters. A relaunch resumes from the gathered
    checkpoint, which the estimator cuts onto the mesh again.

    Supervision: on rank death or a registration timeout the gang is
    torn down and relaunched (jittered exponential backoff from
    ``restart_backoff_s``, env ``RAYDP_TPU_RESTART_BACKOFF_S``, default
    1 s) under a budget of ``max_restarts`` relaunches, resuming from
    the newest checkpoint in ``checkpoint_dir``. Give the factory's
    estimator the SAME ``checkpoint_dir`` (and ``save_every_steps`` to
    bound the replay). Without ``checkpoint_dir`` a relaunch trains from
    scratch. A preempted gang (a failure naming ``PreemptionError``)
    relaunches the same way, from its emergency checkpoint.

    ``elastic=True``: ``train_ds``'s blocks are re-planned over the
    gang's data world (its world, or the mesh's dp) when its shard count
    differs (store mode re-plans each rank's slices of the same refs;
    ``rank_nodes`` is dropped), and a registration shortfall of G of W
    ranks relaunches the gang on the largest multiple of the mesh's
    ``pp·sp·tp`` (1 without a mesh) that is at most G, when that world
    is above 0 and at least ``min_world_size``; else the launch counts
    against the restart budget as any failure does, and the error says
    why no shrink was made. A shrunk mesh keeps its pp, sp and tp and
    loses dp rows, so the factory must build its ``MeshSpec`` from the
    world it runs in (``dp=torch.distributed.get_world_size() //
    (pp·sp·tp)``); a rank whose estimator's mesh is not the launch's
    fails. The relaunch restores the newest gathered checkpoint cut onto
    the smaller mesh, and the estimator rescales the resume position
    from the checkpoint's data world (its dp) to the new dp.

    The result has the JAX package's keys (``history``, ``params``,
    ``per_rank_history``, ``restarts``, ``world_size``: the world that
    finished) and these of the port's: ``backend`` (the process group's),
    ``start_s`` and ``run_s`` (seconds the last launch's ``start()`` and
    ``run()`` took on the driver's clock: every rank's epochs lie inside
    its ``run()``),
    ``per_rank_params_sha256`` (a digest of each rank's final parameters
    and buffers) and ``failures``: one entry per failed launch, with its
    ``error`` text, the wall-clock time the supervisor saw it (``at``),
    whether it was a ``preempted`` drain, its ``world_size`` and the
    ``backoff_s`` slept before the relaunch."""
    from raydp_tpu_torch.context import current_session
    from raydp_tpu_torch.control import get_arbiter
    from raydp_tpu_torch.data.ml_dataset import MLDataset
    from raydp_tpu_torch.spmd import create_spmd_job
    from raydp_tpu_torch.spmd.job import SPMDJobError
    from raydp_tpu_torch.store.object_store import ObjectRef
    from raydp_tpu_torch.telemetry import accounting as _acct
    from raydp_tpu_torch.telemetry import events as _events
    from raydp_tpu_torch.telemetry import flight_recorder as _flight
    from raydp_tpu_torch.utils.profiling import metrics as _metrics

    if mesh is not None and mesh.data_parallel_only:
        mesh = None
    if mesh is not None:
        if world_size != mesh.size:
            raise ValueError(f"world_size {world_size} != mesh size "
                             f"{mesh.size} ({mesh.axis_sizes})")
        if not elastic and train_ds.num_shards != mesh.dp:
            raise ValueError(
                f"train_ds must have num_shards == mesh.dp "
                f"({train_ds.num_shards} != {mesh.dp})")
    elif not elastic and train_ds.num_shards != world_size:
        raise ValueError(
            f"train_ds must have num_shards == world_size "
            f"({train_ds.num_shards} != {world_size})")
    if min_world_size < 1:
        raise ValueError("min_world_size must be >= 1")
    device = str(resolve_device(device))
    if max_restarts is None:
        max_restarts = int(_env_float("RAYDP_TPU_MAX_RESTARTS", 3))
    if restart_backoff_s is None:
        restart_backoff_s = _env_float("RAYDP_TPU_RESTART_BACKOFF_S", 1.0)

    session = current_session()
    store_mode = session is not None and all(
        isinstance(b, ObjectRef) for b in train_ds.blocks)
    if store_mode:
        cluster = session.cluster
        master = getattr(cluster, "master_address", None) or (
            cluster.master.address)
        namespace = cluster.namespace
        blocks = list(train_ds.blocks)
    else:
        master = namespace = blocks = None

    def _payloads(cur_world: int) -> List[tuple]:
        # The data world: the mesh's dp (shards go to dp indices, every
        # rank of one reads the same), else the gang's world.
        if mesh is not None:
            shards = mesh.dp
            shard_of = [mesh.coords_of(r)["dp"] for r in range(cur_world)]
        else:
            shards, shard_of = cur_world, range(cur_world)
        ds = train_ds
        if ds.num_shards != shards:
            # The same blocks over the new data world (elastic);
            # rank_nodes named the old world's ranks, so it is dropped.
            ds = MLDataset(list(train_ds.blocks), num_shards=shards,
                           shuffle=train_ds.shuffle,
                           shuffle_seed=train_ds.shuffle_seed,
                           store=getattr(train_ds, "_store", None))
        if store_mode:
            return [(ds.shard_plan[i],) for i in shard_of]
        # In-memory blocks: the driver slices each rank's shard tables
        # and ships only those rows.
        return [(ds.shard_tables(i),) for i in shard_of]

    cur_world = world_size
    arbiter = get_arbiter()
    # The accounting root: the whole supervised fit, every relaunch's
    # chip-seconds included, bills to one job (an ambient job wins);
    # the gangs launched below inherit it.
    fit_job = _acct.ensure_job("fit-spmd", world_size=world_size)
    # Names this fit's launches in the session's bill (an ambient job
    # may span several fits).
    fit_key = f"{fit_job.job_id}/fit-{uuid.uuid4().hex[:8]}"
    launches = 0
    with _acct.job_scope(fit_job):
        job = job_world = None

        def _preempt_gang() -> None:
            # The arbiter's victim hook: the live incarnation's ranks
            # drain to an emergency checkpoint (``job`` is read when the
            # arbiter calls, so a relaunch's gang gets the notice).
            if job is not None:
                job.request_preemption()

        # The whole supervised fit holds ONE gang lease across restarts:
        # admission blocks in the arbiter's queue while the pool is full
        # (ClusterBusyError on a shed or an admission timeout; an inert
        # lease while arbitration is off).
        lease = arbiter.acquire(fit_job, slots=world_size, kind="gang",
                                label="fit-spmd", on_preempt=_preempt_gang)
        try:
            restarts = 0
            start_s = 0.0
            prev_obs_steps = 0
            failures: List[Dict[str, Any]] = []
            while True:
                if not lease.active:
                    # Preempted last attempt: the drain released the lease
                    # to the arrival; re-enter admission behind it and
                    # resume from the emergency checkpoint once capacity
                    # returns (the arbiter emits ``sched/resume``).
                    lease = arbiter.acquire(fit_job, slots=cur_world,
                                            kind="gang", label="fit-spmd",
                                            on_preempt=_preempt_gang)
                lease.renew()
                resume = _newest_checkpoint(checkpoint_dir)
                if restarts and resume is not None:
                    # Steps the failed incarnation ran past the checkpoint it
                    # resumes from are run again (heartbeat-lag accuracy).
                    ck = _ckpt_step(resume)
                    if ck is not None and prev_obs_steps > ck:
                        _metrics.counter_add("replay/steps",
                                             prev_obs_steps - ck)
                if job is None or job_world != cur_world:
                    # A new world needs a new gang definition; a relaunch
                    # at the same world reuses the job.
                    job = create_spmd_job(
                        job_name="torch-fit-spmd", world_size=cur_world,
                        num_procs_per_node=num_procs_per_node, hosts=hosts,
                        env=env, timeout=60.0)
                    job_world = cur_world

                def work(ctx, payload, resume_from=resume, _device=device,
                         _store_mode=store_mode, _master=master,
                         _namespace=namespace, _blocks=blocks, _mesh=mesh):
                    import torch

                    from raydp_tpu_torch.data.ml_dataset import (
                        MLDataset,
                        resolve_plan_tables,
                    )
                    from raydp_tpu_torch.train.spmd_fit import _params_digest

                    if _device.startswith("cuda"):
                        torch.cuda.set_device(ctx.device("cuda"))
                    backend = ctx.init_distributed(device=_device)
                    tables = (resolve_plan_tables(_master, _namespace, _blocks,
                                                  payload)
                              if _store_mode else payload)
                    est = make_estimator()
                    if _mesh is not None and est.mesh_spec != _mesh:
                        raise ValueError(
                            f"the factory's estimator runs on mesh "
                            f"{est.mesh_spec.axis_sizes}, this launch on "
                            f"{_mesh.axis_sizes}: build the MeshSpec from "
                            f"torch.distributed.get_world_size()")
                    history = est.fit(MLDataset(list(tables), num_shards=1),
                                      resume_from=resume_from)
                    # Full parameters (collective on a model-parallel mesh).
                    state = est.gathered_state_dict()
                    out = {"rank": ctx.rank, "history": history,
                           "backend": backend, "digest": _params_digest(state)}
                    if ctx.rank == 0:
                        out["params"] = {
                            # raydp: ignore[R5] -- once a launch, after the fit
                            k: (v.detach().float() if v.dtype == torch.bfloat16
                                else v.detach()).cpu().numpy()
                            for k, v in state.items()}
                    return out

                launch_wall = time.time()
                try:
                    if restarts:
                        _flight.record(
                            "supervisor", "relaunch", attempt=restarts,
                            world_size=cur_world,
                            **({"resume": os.path.basename(resume)}
                               if resume else {}))
                        _events.emit(
                            "train/resume", attempt=restarts,
                            world_size=cur_world,
                            resume_step=_ckpt_step(resume),
                            **({"resume": os.path.basename(resume)}
                               if resume else {}))
                        logger.warning(
                            "fit_spmd: relaunching gang (restart %d/%d, world "
                            "%d%s)", restarts, max_restarts, cur_world,
                            f", resume {os.path.basename(resume)}" if resume
                            else ", from scratch")
                    t0 = time.perf_counter()
                    job.start()
                    start_s = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    results = job.run(work, timeout=timeout,
                                      per_rank_args=_payloads(cur_world))
                    run_s = time.perf_counter() - t0
                    break
                except SPMDJobError as exc:
                    err_text = str(exc)
                    failure = {"error": err_text, "at": time.time(),
                               "preempted": "PreemptionError" in err_text,
                               "world_size": cur_world, "backoff_s": 0.0}
                    failures.append(failure)
                    prev_obs_steps = _rank0_steps(job)
                    # Elastic shrink: a registration shortfall means ranks
                    # are gone; continue on those that came up (the job's
                    # count, else the message's), in whole dp rows.
                    m = _REGISTERED_RE.search(err_text)
                    new_world = None
                    if elastic and m:
                        got = (job.last_registered if job.last_registered
                               is not None else int(m.group(1)))
                        new_world, new_mesh, refusal = _shrink(
                            cur_world, got, min_world_size, mesh)
                        if refusal:
                            err_text = failure["error"] = \
                                f"{err_text} ({refusal})"
                    if failure["preempted"]:
                        _metrics.counter_add("preemptions/total")
                        _events.emit("preempt/request", attempt=restarts,
                                     world_size=cur_world)
                        # The drain is durable (the emergency checkpoint
                        # committed before the ranks raised): yield the
                        # slots now; the loop's top re-enters admission.
                        lease.release(state="drained")
                    _flight.record("supervisor", "gang_failed",
                                   attempt=restarts, world_size=cur_world,
                                   preempted=failure["preempted"],
                                   error=err_text[:200])
                    if restarts >= max_restarts:
                        raise SPMDJobError(
                            f"fit_spmd: restart budget exhausted "
                            f"({max_restarts} restarts); last failure: "
                            f"{err_text}") from exc
                    restarts += 1
                    _metrics.counter_add("restarts/total")
                    if new_world is not None:
                        logger.warning("fit_spmd: elastic resize %d -> %d "
                                       "ranks%s", cur_world, new_world,
                                       f", mesh {new_mesh.axis_sizes}"
                                       if new_mesh is not None else "")
                        _events.emit("gang/resize", from_world=cur_world,
                                     to_world=new_world, attempt=restarts)
                        cur_world, mesh = new_world, new_mesh
                        # The departed ranks' slots go back to the queue.
                        lease.resize(cur_world)
                    delay = restart_backoff_s * (2 ** (restarts - 1))
                    delay *= 1.0 + random.uniform(0.0, 0.25)  # decorrelate
                    failure["backoff_s"] = delay
                    logger.warning(
                        "fit_spmd: gang failed (%s); backing off %.1fs before "
                        "restart %d/%d", err_text.splitlines()[0][:160], delay,
                        restarts, max_restarts)
                    time.sleep(delay)
                finally:
                    # Tear down between attempts and after the last one; the
                    # job restarts after stop(). The ranks' final snapshots
                    # arrive during stop().
                    job.stop()
                    if session is not None:
                        _report_launch(session, f"{fit_key}/launch-{launches}",
                                       _launch_views(job, launch_wall))
                    launches += 1
        finally:
            # Capacity never leaks: success, an exhausted budget and any
            # other error return the slots (a drained lease is already
            # released; release is idempotent).
            lease.release()
    rank0 = next(r for r in results if r["rank"] == 0)
    return {
        "history": rank0["history"],
        "params": rank0.get("params"),
        "per_rank_history": [r["history"] for r in results],
        "restarts": restarts,
        "world_size": cur_world,
        "backend": rank0["backend"],
        "start_s": start_s,
        "run_s": run_s,
        "per_rank_params_sha256": [r["digest"] for r in results],
        "failures": failures,
        "metrics": job.metrics_snapshot(),
        "usage": job.usage_report(),
        "job_id": fit_job.job_id,
    }
