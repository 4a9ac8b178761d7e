"""The CPU side of the port's kernel interface: the ctypes signatures
against the C entries in ``raydp_tpu_torch/csrc/*.cu``, the alignment rule
of the wgmma kernels' 16-byte copies (bf16 and f32), and the
once-per-symbol ctypes setup. No card and no nvcc needed: the sources are
parsed, not built.
"""
import ctypes
import importlib
import os
import re

import pytest
import torch

fa = importlib.import_module("raydp_tpu_torch.ops.flash_attention")
from raydp_tpu_torch.ops import _build  # noqa: E402

_ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)\s*\{', re.S)


def _entries():
    """{symbol: (source, [parameter declarations])} of every C entry."""
    found = {}
    for name in sorted(os.listdir(_build.CSRC_DIR)):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            text = f.read()
        for symbol, params in _ENTRY.findall(text):
            found[symbol] = (name, [p.strip() for p in params.split(",")])
    return found


def _kind(param: str) -> str:
    if "*" in param:
        return "pointer"
    if param.startswith("long long"):
        return "stride"
    if param.startswith("float"):
        return "float"
    if param.startswith("int"):
        return "int"
    raise AssertionError(f"unexpected parameter {param!r}")


def test_every_c_entry_has_a_signature():
    assert set(_entries()) == set(fa._SIGNATURES)


@pytest.mark.parametrize("symbol", sorted(fa._SIGNATURES))
def test_signature_matches_the_c_entry(symbol):
    """Pointers, then ints, then the float scale, then (b, s, h) strides,
    then the stream: counted from the source as ctypes will pass them."""
    source, params = _entries()[symbol]
    kinds = [_kind(p) for p in params]
    assert params[-1].replace(" ", "") == "void*stream"
    kinds = kinds[:-1]
    order = ["pointer", "int", "float", "stride"]
    assert kinds == sorted(kinds, key=order.index), kinds
    want = (source, kinds.count("pointer"), kinds.count("int"),
            kinds.count("float") == 1, kinds.count("stride") // 3)
    assert kinds.count("float") <= 1 and kinds.count("stride") % 3 == 0
    assert fa._SIGNATURES[symbol] == want


def _fused_qkv(b, s, h, d, dtype=torch.bfloat16):
    return torch.zeros((b, s, 3, h, d), dtype=dtype).unbind(dim=2)


@pytest.mark.parametrize("shape", [(2, 128, 12, 64), (1, 48, 3, 16),
                                   (3, 96, 5, 32), (2, 16, 2, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_qkv_views_are_aligned(shape):
    for x in _fused_qkv(*shape):
        assert fa.async_copy_aligned(x.data_ptr(), x.shape, x.stride(),
                                     x.element_size())


@pytest.mark.parametrize("address, shape, strides, itemsize, want", [
    (0, (2, 16, 4, 64), (4096, 256, 64, 1), 2, True),
    (8, (2, 16, 4, 64), (4096, 256, 64, 1), 2, False),     # base
    (0, (2, 16, 4, 64), (4096, 260, 64, 1), 2, False),     # s stride
    (0, (2, 16, 4, 64), (4100, 256, 64, 1), 2, False),     # b stride
    (0, (2, 16, 4, 64), (4096, 256, 68, 1), 2, False),     # h stride
    (0, (1, 16, 1, 64), (7, 256, 3, 1), 2, True),          # size-1 dims
    (0, (2, 16, 4, 64), (4096, 256, 4, 1), 4, True),       # 16-byte stride
    (16, (2, 16, 4, 64), (4096, 256, 68, 1), 4, True),
])
def test_async_copy_alignment_rule(address, shape, strides, itemsize, want):
    assert fa.async_copy_aligned(address, shape, strides, itemsize) is want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_misaligned_views_raise_and_fused_ones_pass(dtype):
    """bf16 and f32 inputs are both read with 16-byte copies: a base one
    element off and an h stride of 66 elements raise in either dtype;
    the fused-qkv views pass."""
    flat = torch.zeros(2 * 16 * 4 * 64 + 8, dtype=dtype)
    shifted = flat[1:1 + 2 * 16 * 4 * 64].view(2, 16, 4, 64)
    with pytest.raises(ValueError, match="16-byte"):
        fa._check_kernel_inputs("flash kernel", shifted, shifted, shifted)
    odd = torch.zeros((2, 16, 4, 66), dtype=dtype)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        fa._check_kernel_inputs("flash kernel", odd, odd, odd)
    for d in fa.KERNEL_HEAD_DIMS:
        q, k, v = _fused_qkv(2, 16, 4, d, dtype)
        fa._check_kernel_inputs("flash kernel", q, k, v)  # fused views pass


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_model_and_decode_engine_views_pass_the_kernel_checks(monkeypatch,
                                                              dtype):
    """The q, k and v that the classifier and the decode engine's
    ``reference_decode`` hand the flash wrapper would pass every check
    of the CUDA path, the 16-byte rule included."""
    from raydp_tpu_torch.models import transformer as tt
    from raydp_tpu_torch.serve.decode import build_transformer_engine

    calls = []
    real = tt.flash_attention

    def checked(q, k, v, causal=False):
        fa._check_kernel_inputs("flash kernel", q, k, v)
        calls.append(q.shape)
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(tt, "flash_attention", checked)
    cfg = tt.tiny_transformer(attention_impl="flash", dtype=dtype)
    tt.SequenceClassifier(cfg, device="cpu")(torch.zeros((2, 32),
                                                         dtype=torch.long))
    engine = build_transformer_engine(device="cpu", attention_impl="flash",
                                      dtype=dtype, n_layers=1)
    engine.reference_decode([5, 6, 7], 2)
    assert len(calls) == cfg.n_layers + 2


class _FakeLib:
    """Stands in for a loaded library: a new function object per lookup,
    as ``getattr`` on a ``ctypes.CDLL`` would not guarantee either way."""

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        fn.name = name
        return fn


def test_ctypes_function_is_configured_once_per_symbol(monkeypatch):
    loads = []

    def fake_load(source):
        loads.append(source)
        return _FakeLib()

    monkeypatch.setattr(_build, "load", fake_load)
    monkeypatch.setattr(fa, "_FNS", {})
    for symbol, (source, n_ptrs, n_ints, has_scale, n_strided) in \
            fa._SIGNATURES.items():
        first = fa._kernel_fn(symbol)
        assert fa._kernel_fn(symbol) is first
        assert first.name == symbol and first.restype is ctypes.c_int
        assert len(first.argtypes) == (n_ptrs + n_ints + has_scale
                                       + 3 * n_strided + 1)
    assert sorted(loads) == sorted(s for s, *_ in fa._SIGNATURES.values())


# ------------------------------------------- the autograd backward's dO

SHAPE = (2, 32, 2, 16)
UPSTREAM = ["sum", "misaligned", "strided", "dense"]


def _upstream(kind, dtype):
    """An upstream gradient of SHAPE: expanded (the gradient of
    ``.sum()``), contiguous at a base one element off, with (s, h) strides
    of 18 elements, or dense."""
    if kind == "sum":
        return torch.ones((), dtype=dtype).expand(SHAPE)
    gen = torch.Generator().manual_seed(5)
    n = SHAPE[0] * SHAPE[1] * SHAPE[2] * SHAPE[3]
    if kind == "misaligned":
        flat = torch.randn(n + 1, generator=gen).to(dtype)
        return flat[1:].view(SHAPE)
    if kind == "strided":
        wide = torch.randn(SHAPE[:-1] + (SHAPE[-1] + 2,), generator=gen)
        return wide.to(dtype)[..., :SHAPE[-1]]
    return torch.randn(SHAPE, generator=gen).to(dtype)


def _readable(x):
    return x.stride(-1) == 1 and fa.async_copy_aligned(
        x.data_ptr(), x.shape, x.stride(), x.element_size())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", UPSTREAM)
def test_dense_copies_only_what_the_kernels_cannot_read(kind, dtype):
    g = _upstream(kind, dtype)
    assert _readable(g) == (kind == "dense")
    got = fa._dense(g)
    assert (got is g) == (kind == "dense")
    assert got.is_contiguous() and _readable(got)
    assert torch.equal(got, g)


def _plain_launch(received):
    """Stands in for ``_launch`` on CPU tensors: records the [B, S, H, D]
    tensors each C entry is handed and fills its outputs from the plain
    versions, as the kernel would."""
    def launch(symbol, ptrs, ints, scale, strided, device):
        received.append((symbol, strided))
        causal = bool(ints[-1])
        if symbol == "raydp_flash_fwd":
            q, k, v, out, lse = ptrs
            want_out, want_lse = fa.flash_attention_plain(q, k, v, causal)
            out.copy_(want_out)
            lse.copy_(want_lse)
        elif symbol == "raydp_flash_bwd_delta":
            out, g, delta = ptrs
            delta.copy_(fa.flash_bwd_delta_plain(out, g))
        elif symbol == "raydp_flash_bwd_dq":
            *args, dq = ptrs
            dq.copy_(fa.flash_bwd_dq_plain(*args, causal))
        else:
            *args, dk, dv = ptrs
            want_dk, want_dv = fa.flash_bwd_dkv_plain(*args, causal)
            dk.copy_(want_dk)
            dv.copy_(want_dv)
    return launch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", UPSTREAM)
def test_backward_hands_the_kernels_dense_aligned_grad_out(monkeypatch, kind,
                                                          dtype):
    """With CPU tensors forced onto the kernel route (``_on_cpu`` False,
    ``_launch`` stubbed), ``flash_attention(q, k, v).sum().backward()``
    and ``.backward(g)`` under any layout of ``g`` reach the delta, dq
    and dk/dv entries with a contiguous, 16-byte aligned ``grad_out`` of
    the upstream values, and give the plain route's gradients."""
    gen = torch.Generator().manual_seed(6)
    qkv = torch.randn((SHAPE[0], SHAPE[1], 3) + SHAPE[2:],
                      generator=gen).to(dtype)
    upstream = _upstream(kind, dtype)

    def grads():
        leaf = qkv.clone().requires_grad_(True)
        out = fa.flash_attention(*leaf.unbind(dim=2), causal=True)
        if kind == "sum":
            out.sum().backward()
        else:
            out.backward(upstream)
        return leaf.grad

    want = grads()  # the CPU route, plain versions throughout
    received = []
    monkeypatch.setattr(fa, "_on_cpu", lambda name, x: False)
    monkeypatch.setattr(fa, "_launch", _plain_launch(received))
    got = grads()
    assert [symbol for symbol, _ in received] == [
        "raydp_flash_fwd", "raydp_flash_bwd_delta", "raydp_flash_bwd_dq",
        "raydp_flash_bwd_dkv"]
    for symbol, strided in received[1:]:
        g = strided[1 if symbol == "raydp_flash_bwd_delta" else 3]
        assert g.is_contiguous() and _readable(g), symbol
        assert torch.equal(g, upstream), symbol
    torch.testing.assert_close(got, want, rtol=0, atol=0)
