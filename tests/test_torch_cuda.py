"""The port's CUDA paths on a card: the flash forward kernel against its
plain version over every head dim, ragged sequence lengths and strided
inputs, and the tiny models on the card against the CPU.

Marked ``cuda``; every test skips without a CUDA device. These import no
JAX, so they run on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import pytest
import torch

from raydp_tpu_torch.models.transformer import (
    CausalLM,
    SequenceClassifier,
    tiny_transformer,
)
from raydp_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_forward,
    flash_attention_plain,
)
from raydp_tpu_torch.utils.device import set_exact_float32

pytestmark = pytest.mark.cuda

# Kernel vs plain on the card: same f32 arithmetic in another order
# (f32), one bf16 rounding of the output apart (bf16).
TOL = {torch.float32: dict(rtol=2e-4, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
LSE_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_exact_float32()
    return torch.device("cuda")


def _qkv(shape, dtype, seed=0):
    b, s, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda")
    return qkv.to(dtype).unbind(dim=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [
    (2, 16, 3, 16), (1, 48, 2, 32), (2, 96, 4, 64), (1, 256, 2, 128),
    (3, 128, 5, 16), (1, 512, 1, 64),
], ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda, shape, causal, dtype):
    q, k, v = _qkv(shape, dtype)
    before = flash_attention.launches
    out, lse = flash_attention_forward(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref_out.float(), **TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, **LSE_TOL)


def test_kernel_reads_contiguous_and_strided_alike(cuda):
    q, k, v = _qkv((2, 64, 4, 32), torch.float32, seed=1)
    a = flash_attention(q, k, v, causal=True)
    b = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 32, 2, 64), torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q, k, v)
    q, k, v = _qkv((1, 32, 2, 48), torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v)
    q, k, v = _qkv((1, 200, 2, 64), torch.float32)
    with pytest.raises(ValueError, match="divisible"):
        flash_attention(q, k, v)


def test_kernel_backward_raises(cuda):
    q, k, v = _qkv((1, 32, 2, 64), torch.float32)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, v).sum().backward()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tiny_models_on_card_match_cpu(cuda, dtype):
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 1024, (2, 32), generator=gen)
    seg = torch.randint(0, 2, (2, 32), generator=gen)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=2e-2)
    cfg = tiny_transformer(attention_impl="flash", dtype=dtype)
    gpu = SequenceClassifier(cfg, device="cuda").eval()
    cpu = SequenceClassifier(cfg, device="cpu").eval()
    lm_cfg = tiny_transformer(attention_impl="flash", dtype=dtype,
                              causal=True)
    lm_gpu = CausalLM(lm_cfg, device="cuda").eval()
    lm_cpu = CausalLM(lm_cfg, device="cpu").eval()
    before = flash_attention.launches
    with torch.inference_mode():
        got = gpu(ids.cuda(), seg.cuda()).cpu()
        want = cpu(ids, seg)
        got_lm = lm_gpu(ids.cuda()).cpu()
        want_lm = lm_cpu(ids)
    assert flash_attention.launches == before + 2 * cfg.n_layers
    torch.testing.assert_close(got, want, **tol)
    torch.testing.assert_close(got_lm, want_lm, **tol)
