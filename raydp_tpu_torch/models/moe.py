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

**On a mesh** (``raydp_tpu/models/moe.py:94-178``; :meth:`MoELayer.bind_mesh`).
The JAX layer sees the dp-sharded global batch under GSPMD, so it routes
over the global tokens. The port's layer does the same over its dp group
of ``n`` ranks, the tokens in rank-major order as the global batch is:
the capacity is ``cfg.capacity(n · T_local)`` (every rank's batch is the
same size), each round's slot positions are offset by the counts of that
round's choices on the lower dp ranks (one ``all_gather`` of the
``[k, E]`` counts a forward: a round's choices depend on this rank's
probabilities only), the slots used carry over from the group's counts,
and the Switch loss takes the group's means of ``top1`` and ``probs``
(the probabilities' sum through
:func:`~raydp_tpu_torch.parallel.collectives.reduce_from_region`, whose
identity backward gives each rank the gradient of its own tokens; the
estimator weights the term by ``n``, ``train/estimator.py``). That holds
with the experts replicated (a data-parallel gang) and cut. With the
``expert`` axis on dp (``logical_axes``; the transformer's
``LOGICAL_RULES``) each rank holds ``E/dp`` experts: its ``[E, C, D]``
dispatch contribution is reduce-scattered over dp by expert, its experts
run with their FFN cut over tp (``w_up`` and ``b_up`` by column, ``w_down``
by row, summed by ``reduce_from_region`` before ``b_down``), and their
``[E/dp, C, D]`` outputs are gathered back over dp for the local combine.
Expert gradients then come whole from every rank's tokens through those
collectives' backwards, and the estimator sums them over no axis (dp
cuts them). The sequence is never cut (sp must be 1). Every rank of the
dp group runs each forward, as every device of a JAX mesh does: a fit's
steps, ``evaluate`` and ``predict`` alike.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from raydp_tpu_torch.parallel import collectives as C
from raydp_tpu_torch.models.transformer import (
    Dense,
    Embed,
    LayerNorm,
    MultiHeadAttention,
    TransformerConfig,
    init_params,
)
from raydp_tpu_torch.utils import startup
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


# The flax parameters' partitioning (raydp_tpu/models/moe.py:94-102,
# 138-162): the stacked experts, and the router's kernel [D, E] seen as
# the Linear's [E, D] weight.
LOGICAL_AXES = {
    "w_up": (("expert", "embed", "mlp"), None),
    "b_up": (("expert", "mlp"), None),
    "w_down": (("expert", "mlp", "embed"), None),
    "b_down": (("expert", "embed"), None),
}
ROUTER_AXES = {"weight": ((None, "embed"), None)}


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
    of ``T · top_k`` (over the dp group's tokens on a mesh: the module
    docstring)."""

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
        self.logical_axes = LOGICAL_AXES
        self.router.logical_axes = ROUTER_AXES
        # The routing group, and the expert and tp groups where the
        # experts are cut (bind_mesh).
        self.dp_group = self.ep_group = self.tp_group = None
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

    def bind_mesh(self, mesh) -> None:
        """Route over ``mesh``'s dp group; where this rank's experts or
        FFN columns are a block, run the expert-parallel path (the module
        docstring)."""
        if mesh.shape["sp"] > 1:
            raise ValueError("the MoE layer routes whole sequences: sp "
                             "must be 1")
        cfg = self.cfg
        self.dp_group = mesh.group("dp")
        self.ep_group = (mesh.group("dp")
                         if self.w_up.shape[0] != cfg.n_experts else None)
        self.tp_group = (mesh.group("tp")
                         if self.w_up.shape[2] != cfg.d_ff else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        lead, d = x.shape[:-1], x.shape[-1]
        if d != cfg.d_model:
            raise ValueError(f"feature dim {d} != cfg.d_model {cfg.d_model}")
        tokens = x.reshape(-1, d)
        n = C.group_size(self.dp_group)
        n_tokens = n * tokens.shape[0]
        e, c = cfg.n_experts, cfg.capacity(n_tokens)

        logits = F.linear(tokens.float(), self.router.weight.float())
        probs = torch.softmax(logits, dim=-1)                  # [T, E]

        # k rounds of choices, each masking the experts already chosen.
        masked, choices = probs, []
        for _ in range(cfg.top_k):
            onehot = F.one_hot(torch.argmax(masked, dim=-1), e).float()
            choices.append(onehot)
            masked = masked * (1.0 - onehot)
        counts = torch.stack([oh.sum(dim=0) for oh in choices])  # [k, E]
        if self.dp_group is None:
            before, total = torch.zeros_like(counts), counts
        else:
            # Every rank's counts: the lower ranks' offset this rank's
            # positions (the global token order is rank-major).
            every = C.all_gather_raw(counts[None], 0, self.dp_group)
            before = every[:C.group_rank(self.dp_group)].sum(dim=0)
            total = every.sum(dim=0)

        # A position past the capacity matches no slot of the comparison,
        # which gives the zero row that jax.nn.one_hot gives out of range.
        slot_ids = torch.arange(c, device=x.device, dtype=torch.float32)
        dispatch = combine = None
        slots_used = torch.zeros(e, device=x.device)
        kept = torch.zeros((), device=x.device)
        for r, onehot in enumerate(choices):
            gate = (probs * onehot).sum(-1)                    # [T]
            position = (torch.cumsum(onehot, dim=0) - 1 + slots_used
                        + before[r]) * onehot
            keep = (position < c).float() * onehot
            pos_oh = (position[..., None] == slot_ids).float() \
                * keep[..., None]                              # [T, E, C]
            dispatch = pos_oh if dispatch is None else dispatch + pos_oh
            term = pos_oh * gate[:, None, None]
            combine = term if combine is None else combine + term
            # The group's slots this round kept: its choices up to the
            # capacity left.
            used = torch.minimum(total[r], (c - slots_used).clamp(min=0))
            slots_used = slots_used + used
            kept = kept + used.sum()

        # Switch loss over the group's tokens: f from the top choices'
        # counts (round 0), p the mean probability.
        p_sum = C.reduce_from_region(probs.sum(dim=0), self.dp_group)
        aux = e * torch.sum((total[0] / n_tokens) * (p_sum / n_tokens))
        self.aux_loss = cfg.aux_loss_weight * aux
        self.kept_slots = kept.detach()

        dt = cfg.dtype
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(dt),
                                 tokens.to(dt))
        # This rank's experts get every rank's tokens for them.
        expert_in = C.reduce_scatter(expert_in, 0, self.ep_group)
        expert_in = C.copy_to_region(expert_in, self.tp_group)
        h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, self.w_up.to(dt))
                   + self.b_up.to(dt)[:, None, :], approximate="tanh")
        expert_out = C.reduce_from_region(
            torch.einsum("ecf,efd->ecd", h, self.w_down.to(dt)),
            self.tp_group) + self.b_down.to(dt)[:, None, :]
        expert_out = C.all_gather(expert_out, 0, self.ep_group)
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

    @startup.timed("model")
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
