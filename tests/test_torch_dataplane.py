"""The port's zero-copy data plane (``raydp_tpu_torch/cluster``,
``store``, ``data/loader.py``) against ``tests/test_dataplane.py``.

* Its session cases run against the port on one 2-node port session for
  the module, as the reference's module-scoped fixture does: staged
  ``data_args`` keep the RPC envelopes thin, the payload counter reaches
  the exposition, a stage ships one ``RunTaskBatch`` envelope a worker
  (its ``rpc_spy`` fixture gets ``monkeypatch`` through the harness),
  and a remote object streams in chunks.
* Two cases call ``MLDataset.to_jax``; the port names it ``to_torch``.
  They are mirrored by hand below on the CPU, where the loader's chunk is
  a plain host buffer: features and labels of a chunk of
  ``transfer_coalesce`` batches are packed into ONE uint8 buffer
  (on a card, the one buffer that crosses in one copy), unpacked bit for
  bit, and an explicit ``transfer_coalesce`` holds on the host path.
* ``test_spmd_register_hard_timeout_precedence`` runs against the port's
  ``SPMDJob``: ``register_hard_timeout=`` and the
  ``RAYDP_SPMD_REGISTER_TIMEOUT`` / ``RAYDP_SPMD_REGISTER_HARD_TIMEOUT``
  overrides, in the reference's precedence.
"""
import numpy as np
import pyarrow as pa
import pytest

import raydp_tpu_torch
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.data import loader as loader_mod
from torch_port_cases import cases, load_port_module, run_case, time_limit

MIRRORED = ("test_loader_packs_one_device_put_per_chunk",
            "test_host_path_honors_explicit_coalesce")
PORT_REFERENCE = load_port_module("test_dataplane.py")
REFERENCE_CASES = cases(PORT_REFERENCE, [
    n for n in vars(PORT_REFERENCE)
    if n.startswith("test_") and n not in MIRRORED])
LIMIT_S = 120


@pytest.fixture(scope="module")
def port_session():
    s = raydp_tpu_torch.init(app_name="dataplane-test", num_workers=2,
                             num_virtual_nodes=2)
    yield s
    raydp_tpu_torch.stop()


@pytest.mark.parametrize("name,params",
                         [(n, p) for _, n, p in REFERENCE_CASES],
                         ids=[i for i, _, _ in REFERENCE_CASES])
def test_reference_case_on_port(name, params, request, port_session):
    with time_limit(LIMIT_S):
        run_case(PORT_REFERENCE, name, params, request,
                 fixtures={"session": port_session})


def test_cases_cover_the_reference_module():
    assert len(REFERENCE_CASES) + len(MIRRORED) == 7


def _toy_dataset(rows=256):
    rng = np.random.default_rng(7)
    return MLDataset(
        [pa.table({c: rng.normal(size=rows).astype(np.float32)
                   for c in ("a", "b", "c", "y")})],
        num_shards=1)


def test_loader_packs_one_device_put_per_chunk(monkeypatch):
    """Features and labels of a chunk travel in ONE packed uint8 buffer
    and unpack bit for bit against a loader of one batch a chunk."""
    ds = _toy_dataset(rows=256)
    packed = []
    real = loader_mod.ShardLoader._unpack

    def spy(self, buf, rows):
        packed.append(buf.numpy().copy())
        return real(self, buf, rows)

    monkeypatch.setattr(loader_mod.ShardLoader, "_unpack", spy)
    chunked = list(ds.to_torch(["a", "b", "c"], label_column="y",
                               batch_size=32, shuffle=False, device="cpu",
                               transfer_coalesce=4))
    # 256 rows / 32 per batch / 4 batches per chunk = 2 chunks = 2 buffers.
    assert len(packed) == 2
    for buf in packed:
        assert buf.dtype == np.uint8 and buf.ndim == 1
        # 128 rows x (3 features + 1 label) x 4 bytes, packed together.
        assert buf.size == 128 * 4 * 4

    single = list(ds.to_torch(["a", "b", "c"], label_column="y",
                              batch_size=32, shuffle=False, device="cpu",
                              transfer_coalesce=1))
    assert len(chunked) == len(single) == 8
    for (cx, cy), (sx, sy) in zip(chunked, single):
        np.testing.assert_array_equal(cx.numpy(), sx.numpy())
        np.testing.assert_array_equal(cy.numpy(), sy.numpy())


def test_host_path_honors_explicit_coalesce():
    """An explicit ``transfer_coalesce`` holds on the host path, and only
    the automatic size stays at one batch a chunk there; both yield the
    same batches."""
    ds = _toy_dataset(rows=256)
    explicit = ds.to_torch(["a", "b"], label_column="y", batch_size=32,
                           device="cpu", transfer_coalesce=4, shuffle=False)
    assert explicit._coalesce_batches() == 4
    auto = ds.to_torch(["a", "b"], label_column="y", batch_size=32,
                       device="cpu", shuffle=False)
    assert auto._coalesce_batches() == 1
    a = [x.numpy() for x, _ in explicit]
    b = [x.numpy() for x, _ in auto]
    assert len(a) == len(b) == 8
    for ax, bx in zip(a, b):
        np.testing.assert_array_equal(ax, bx)
