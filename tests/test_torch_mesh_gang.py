"""The model-parallel tests' gang (``tests/torch_mesh_gang.py``): a case
that fails costs its module no more than its own time limit. A case that
hangs its ranks in a collective stops the gang, and every later case
fails at once; a case that raised on every rank gets the next case a
fresh gang."""
import time

import pytest

from raydp_tpu_torch.spmd import SPMDJobError
from torch_mesh_gang import GangBroken, gang, run


def _rank(ctx):
    return ctx.rank


def _raise_on_rank0(ctx):
    import torch
    import torch.distributed as dist

    if ctx.rank == 0:
        raise RuntimeError("planted on rank 0")
    dist.all_reduce(torch.ones(1))  # waits for rank 0, which never comes
    return ctx.rank


def _raise_everywhere(ctx):
    raise RuntimeError(f"planted on rank {ctx.rank}")


def test_a_hung_case_fails_the_later_cases_at_once():
    with gang(2, "t-gang-hang") as g:
        with pytest.raises((TimeoutError, SPMDJobError)):
            run(g, _raise_on_rank0, limit=5)
        assert g.job is None
        t0 = time.monotonic()
        for _ in range(3):
            with pytest.raises(GangBroken, match="ran out of its 5 s"):
                run(g, _rank)
        assert time.monotonic() - t0 < 1.0


def test_a_raising_case_gets_the_next_case_a_fresh_gang():
    with gang(2, "t-gang-raise") as g:
        first = g.job
        with pytest.raises(SPMDJobError, match="planted on rank 1"):
            run(g, _raise_everywhere)
        assert g.job is None
        assert run(g, _rank) == [0, 1]
        assert g.job is not None and g.job is not first
