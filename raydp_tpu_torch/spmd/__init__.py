"""SPMD host-process job runner (the port's copy of
``raydp_tpu/spmd/__init__.py``).

The reference's MPI-on-Ray capability (reference: python/raydp/mpi/
__init__.py:94 exports create_mpi_job, MPIJobContext, WorkerContext):
gang launch and function shipping over the port's RPC layer, with
``torch.distributed`` as the collective fabric instead of MPI. See
:mod:`raydp_tpu_torch.spmd.job`.
"""
from raydp_tpu_torch.spmd.job import (  # noqa: F401
    DispatchPayloadError,
    SPMDJob,
    SPMDJobContext,
    SPMDJobError,
    create_spmd_job,
)


def __getattr__(name):
    # Lazy: importing worker_main here would shadow `python -m
    # raydp_tpu_torch.spmd.worker_main` in the spawned rank processes
    # (runpy double-import warning).
    if name == "SPMDWorkerContext":
        from raydp_tpu_torch.spmd.worker_main import SPMDWorkerContext

        return SPMDWorkerContext
    raise AttributeError(name)


__all__ = [
    "create_spmd_job",
    "DispatchPayloadError",
    "SPMDJob",
    "SPMDJobContext",
    "SPMDJobError",
    "SPMDWorkerContext",
]
