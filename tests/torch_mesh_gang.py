"""A gang of CPU processes for the port's model-parallel tests.

:func:`gang` starts one ``SPMDJob`` of ``world`` ranks that have joined
a gloo process group on the CPU, for a whole test module (a gang start
costs seconds; each rank imports torch once). Rank functions are shipped
by value (the closure carrier, ``raydp_tpu_torch/cluster/closure.py``):
they import what they use inside, and return numpy arrays or plain
values. :func:`run` runs one on every rank under a time limit.

A case that fails must not cost the module's other cases their time. A
function that raised on every rank leaves the ranks free but their
collectives possibly out of step, so the gang is stopped and the next
case starts a fresh one. A function that ran out of time left ranks
waiting in a collective (one rank raised, its peers wait for it), and
the next case would likely do the same: the gang is stopped and every
later case of the module fails at once with :class:`GangBroken`.
"""
import contextlib

from raydp_tpu_torch.spmd import create_spmd_job
from torch_port_cases import time_limit

LIMIT_S = 150


class GangBroken(RuntimeError):
    """An earlier case of the module hung its gang."""


def _join(ctx):
    ctx.init_distributed(device="cpu")
    import torch

    # Four ranks share the host's cores with the test process.
    torch.set_num_threads(2)
    torch.manual_seed(0)
    return ctx.rank


class Gang:
    """One module's ``SPMDJob``, stopped after a failed case and started
    again (after a raise) or refused (after a hang) for the next."""

    def __init__(self, world: int, name: str):
        self.world = world
        self.name = name
        self.job = None
        self.broken = None

    def start(self) -> None:
        with time_limit(LIMIT_S):
            self.job = create_spmd_job(self.name, world_size=self.world,
                                       timeout=60)
            try:
                self.job.start()
                assert self.job.run(_join) == list(range(self.world))
            except BaseException:
                self.stop()
                raise

    def stop(self) -> None:
        job, self.job = self.job, None
        if job is not None:
            job.stop()

    def run(self, fn, *args, limit: int = LIMIT_S):
        if self.broken is not None:
            raise GangBroken(f"gang {self.name} was stopped: {self.broken}")
        if self.job is None:
            self.start()
        try:
            with time_limit(limit):
                return self.job.run(lambda ctx: fn(ctx, *args), timeout=limit)
        except BaseException as exc:
            # ``SPMDJob.run``'s own deadline says "timed out".
            if isinstance(exc, TimeoutError) or "timed out" in str(exc):
                self.broken = f"a case ran out of its {limit} s: {exc}"
            self.stop()
            raise


@contextlib.contextmanager
def gang(world: int = 4, name: str = "t-mesh"):
    g = Gang(world, name)
    g.start()
    try:
        yield g
    finally:
        g.stop()


def run(gang: Gang, fn, *args, limit: int = LIMIT_S):
    """``fn(ctx, *args)`` on every rank; rank-ordered results."""
    return gang.run(fn, *args, limit=limit)
