"""Mixture-of-Experts FFN: top-k routing with a fixed capacity.

The counterpart of ``raydp_tpu/models/moe.py`` on one device, with the
same module names and parameter tree (``params_from_flax`` carries the
flax parameters across). GShard/Switch-style einsum dispatch, no gather
or scatter:

* Router logits and probabilities in float32, whatever the trunk dtype.
* Top-k routing in k rounds with a fixed capacity
  ``C = ceil(T / E · k · capacity_factor)``: a token's slot in its expert
  comes from a cumsum over the tokens, offset by the slots earlier rounds
  used. Tokens past the capacity are dropped: their combine weight is 0
  and the caller's residual carries them.
* Dispatch and combine are ``[T, E, C]`` one-hot tensors, contracted in
  ``cfg.dtype`` with the tokens and with the experts' outputs; the
  experts' weights are stacked ``[E, D, F]``.
* The Switch load-balancing loss, ``weight · E · Σ_e f_e · p_e``, is kept
  on the layer for the step that just ran (``MoELayer.aux_loss``, where
  flax sows it into the ``losses`` collection); :func:`moe_aux_loss` sums
  it over a model's layers. Under a captured step the tensor lives in the
  graph's pool and each replay rewrites it.

Expert parallelism (experts sharded over dp) waits for the multi-GPU
slice: on one card every expert is local.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from raydp_tpu_torch.models.transformer import (
    Dense,
    Embed,
    LayerNorm,
    MultiHeadAttention,
    TransformerConfig,
    init_params,
)
from raydp_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = [
    "MoEConfig",
    "MoELayer",
    "MoEBlock",
    "MoEClassifier",
    "moe_aux_loss",
    "tiny_moe",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 768
    d_ff: int = 3072
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def capacity(self, n_tokens: int) -> int:
        return max(1, math.ceil(
            n_tokens / self.n_experts * self.top_k * self.capacity_factor))


def _stacked_xavier_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``xavier_uniform`` on a stacked ``[E, fan_in, fan_out]``
    kernel: the leading axis counts into both fans."""
    e, fan_in, fan_out = w.shape
    limit = math.sqrt(6.0 / (e * (fan_in + fan_out)))
    nn.init.uniform_(w, -limit, limit, generator=generator)


class MoELayer(nn.Module):
    """Top-k routed expert FFN over the trailing feature axis.

    Input ``[..., D]``, output ``[..., D]`` in the input's dtype; the
    tokens are the flattened leading axes. Dropped tokens give zeros.
    After each forward, ``aux_loss`` holds the weighted Switch loss and
    ``kept_slots`` the number of (token, choice) pairs that found a slot,
    of ``T · top_k``."""

    def __init__(self, cfg: MoEConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        e, d, f, pdt = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.param_dtype
        self.router = nn.Linear(d, e, bias=False, dtype=pdt)
        self.w_up = nn.Parameter(torch.empty(e, d, f, dtype=pdt))
        self.b_up = nn.Parameter(torch.zeros(e, f, dtype=pdt))
        self.w_down = nn.Parameter(torch.empty(e, f, d, dtype=pdt))
        self.b_down = nn.Parameter(torch.zeros(e, d, dtype=pdt))
        self.aux_loss: Optional[torch.Tensor] = None
        self.kept_slots: Optional[torch.Tensor] = None
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            nn.init.xavier_uniform_(self.router.weight, generator=generator)
            _stacked_xavier_(self.w_up, generator)
            _stacked_xavier_(self.w_down, generator)
            self.b_up.zero_()
            self.b_down.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        lead, d = x.shape[:-1], x.shape[-1]
        if d != cfg.d_model:
            raise ValueError(f"feature dim {d} != cfg.d_model {cfg.d_model}")
        tokens = x.reshape(-1, d)
        e, c = cfg.n_experts, cfg.capacity(tokens.shape[0])

        logits = F.linear(tokens.float(), self.router.weight.float())
        probs = torch.softmax(logits, dim=-1)                  # [T, E]

        # k rounds, each masking the experts already chosen. A position
        # past the capacity matches no slot of the comparison, which gives
        # the zero row that jax.nn.one_hot gives out of range.
        slot_ids = torch.arange(c, device=x.device, dtype=torch.float32)
        masked = probs
        dispatch = combine = None
        slots_used = torch.zeros(e, device=x.device)
        for _ in range(cfg.top_k):
            onehot = F.one_hot(torch.argmax(masked, dim=-1), e).float()
            gate = (probs * onehot).sum(-1)                    # [T]
            position = (torch.cumsum(onehot, dim=0) - 1 + slots_used) * onehot
            keep = (position < c).float() * onehot
            pos_oh = (position[..., None] == slot_ids).float() \
                * keep[..., None]                              # [T, E, C]
            dispatch = pos_oh if dispatch is None else dispatch + pos_oh
            term = pos_oh * gate[:, None, None]
            combine = term if combine is None else combine + term
            slots_used = slots_used + keep.sum(dim=0)
            masked = masked * (1.0 - onehot)

        top1 = F.one_hot(torch.argmax(probs, dim=-1), e).float()
        aux = e * torch.sum(top1.mean(dim=0) * probs.mean(dim=0))
        self.aux_loss = cfg.aux_loss_weight * aux
        self.kept_slots = slots_used.sum().detach()

        dt = cfg.dtype
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(dt),
                                 tokens.to(dt))
        h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, self.w_up.to(dt))
                   + self.b_up.to(dt)[:, None, :], approximate="tanh")
        expert_out = (torch.einsum("ecf,efd->ecd", h, self.w_down.to(dt))
                      + self.b_down.to(dt)[:, None, :])
        out = torch.einsum("tec,ecd->td", combine.to(dt), expert_out)
        return out.reshape(*lead, d).to(x.dtype)


class MoEBlock(nn.Module):
    """Pre-LN transformer block whose FFN is a routed MoE: the peer of
    ``TransformerBlock``, with the port's attention (dense or flash)."""

    def __init__(self, cfg: TransformerConfig, moe: MoEConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ln_attn = LayerNorm(cfg.d_model, cfg.dtype, cfg.param_dtype)
        self.attn = MultiHeadAttention(cfg)
        self.ln_moe = LayerNorm(cfg.d_model, cfg.dtype, cfg.param_dtype)
        self.moe = MoELayer(moe, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_attn(x))
        return x + self.moe(self.ln_moe(x))


class MoEClassifier(nn.Module):
    """Sequence classifier whose FFNs are routed MoE layers: token
    embedding plus a learned ``pos`` table (no segment embedding, no
    embedding LayerNorm), MoE blocks, ``ln_f``, first-token pool and a
    float32 head. Fit it with ``Estimator(aux_losses=True)`` so the
    Switch loss joins the objective."""

    def __init__(self, cfg: TransformerConfig, moe: MoEConfig,
                 num_classes: int = 2, *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.moe_cfg = cfg, moe
        pdt = cfg.param_dtype
        gen = generator or torch.Generator().manual_seed(0)
        # flax's Embed without a dtype looks up in the parameter dtype;
        # the sum with ``pos`` is cast to the trunk's dtype afterwards.
        self.tok = Embed(cfg.vocab_size, cfg.d_model, pdt, pdt)
        self.pos = nn.Parameter(torch.empty(cfg.max_len, cfg.d_model,
                                            dtype=pdt))
        self.blocks = nn.ModuleList(
            MoEBlock(cfg, moe, gen) for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype, pdt)
        self.head = Dense(cfg.d_model, num_classes, torch.float32, pdt)
        # The experts drew their weights above; init_params draws the
        # dense layers' (the router's again) and the embeddings'.
        init_params(self, gen)
        with torch.no_grad():
            nn.init.normal_(self.pos, std=0.02, generator=gen)
        self.to(dev)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = (self.tok(ids) + self.pos[None, :ids.shape[1]]).to(self.cfg.dtype)
        for block in self.blocks:
            x = block(x)
        pooled = self.ln_f(x)[:, 0]
        return self.head(pooled.float())


def moe_aux_loss(model: nn.Module) -> torch.Tensor:
    """The sum of the Switch losses of every ``MoELayer`` of ``model``
    from its last forward (float32 zero where none ran)."""
    total = None
    for m in model.modules():
        if isinstance(m, MoELayer) and m.aux_loss is not None:
            total = m.aux_loss if total is None else total + m.aux_loss
    if total is None:
        param = next(model.parameters(), None)
        return torch.zeros((), device=None if param is None else param.device)
    return total


def tiny_moe(**overrides) -> MoEConfig:
    defaults = dict(d_model=32, d_ff=64, n_experts=4, top_k=2,
                    capacity_factor=2.0, dtype=torch.float32)
    defaults.update(overrides)
    return MoEConfig(**defaults)
