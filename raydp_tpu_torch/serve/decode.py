"""Iteration-level autoregressive decode: paged KV slots + round loop.

The counterpart of ``raydp_tpu/serve/decode.py``. Batching is at token
granularity (continuous batching, one greedy stream per request):

* :class:`PagedSlotPool`: pure-Python bookkeeping for a fixed number of
  device cache slots, each backed by fixed-size pages from a shared
  budget. A sequence claims a slot and its prompt's pages at admission,
  grows one page at a time as it decodes, and releases everything at
  EOS/expiry/cancel. When the page budget runs out mid-growth the growing
  sequence is evicted and its generated-so-far prefix re-enters as a
  prefill.
* :class:`DecodeLoop`: the round loop. Each :meth:`DecodeLoop.run_round`
  admits pending prefills into free slots (one prompt pass each, which
  also yields the first token), then runs ONE decode step over every
  live slot, bucketed by cache length, retires finished sequences and
  buffers token/done events.
* Engines: :class:`TransformerDecodeEngine` drives a
  :class:`~raydp_tpu_torch.models.transformer.CausalLM` on its device;
  :class:`ToyDecodeEngine` is a deterministic arithmetic stand-in for
  scheduler tests.

The replica-process serve plane arrives with a later slice; the
in-process :class:`DecodeLoop` is this package's server.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import os
import threading
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import torch

from raydp_tpu_torch.models.transformer import CausalLM, tiny_transformer
from raydp_tpu_torch.utils.device import DeviceLike
from raydp_tpu_torch.utils.env import _env_float, _env_int
from raydp_tpu_torch.utils.profiling import metrics

DECODE_SLOTS_ENV = "RAYDP_TPU_DECODE_SLOTS"
DECODE_PAGE_TOKENS_ENV = "RAYDP_TPU_DECODE_PAGE_TOKENS"
DECODE_MAX_NEW_ENV = "RAYDP_TPU_DECODE_MAX_NEW"
DECODE_ROUND_LINGER_ENV = "RAYDP_TPU_DECODE_ROUND_LINGER_S"
DECODE_PAGES_ENV = "RAYDP_TPU_DECODE_PAGES"

_DEFAULT_SLOTS = 8
_DEFAULT_PAGE_TOKENS = 16
_DEFAULT_MAX_NEW = 64
_DEFAULT_ROUND_LINGER_S = 0.005


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Decode-plane knobs (``RAYDP_TPU_DECODE_*`` env overrides)."""

    slots: int = _DEFAULT_SLOTS
    page_tokens: int = _DEFAULT_PAGE_TOKENS
    max_new: int = _DEFAULT_MAX_NEW
    round_linger_s: float = _DEFAULT_ROUND_LINGER_S
    total_pages: Optional[int] = None  # None → slots × pages(max_len)

    @classmethod
    def from_env(cls, **overrides) -> "DecodeConfig":
        vals = dict(
            slots=_env_int(DECODE_SLOTS_ENV, _DEFAULT_SLOTS),
            page_tokens=_env_int(
                DECODE_PAGE_TOKENS_ENV, _DEFAULT_PAGE_TOKENS
            ),
            max_new=_env_int(DECODE_MAX_NEW_ENV, _DEFAULT_MAX_NEW),
            round_linger_s=_env_float(
                DECODE_ROUND_LINGER_ENV, _DEFAULT_ROUND_LINGER_S
            ),
        )
        raw_pages = os.environ.get(DECODE_PAGES_ENV)
        if raw_pages:
            vals["total_pages"] = _env_int(DECODE_PAGES_ENV, 0) or None
        vals.update(overrides)
        return cls(**vals)


def kv_buckets(page_tokens: int, max_len: int) -> Tuple[int, ...]:
    """Geometric cache-length buckets: page, 2·page, 4·page, …, max_len.

    Each bucket is one attention width of the decode step; doubling
    keeps the count at O(log(max_len/page)) while wasting at most 2x
    attention FLOPs on a young batch."""
    out: List[int] = []
    b = max(1, page_tokens)
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def bucket_for(buckets: Sequence[int], n: int) -> int:
    """Tightest bucket covering ``n`` cache positions."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class PagedSlotPool:
    """Slot + page accounting for the per-request KV cache.

    Pure bookkeeping — the actual device memory lives in the engine's
    cache; the pool just decides which rows are owned, how far each
    row is paged, and when admission must wait. Not thread-safe: the
    round loop is its only caller.
    """

    def __init__(self, num_slots: int, page_tokens: int, max_len: int,
                 total_pages: Optional[int] = None):
        if num_slots < 1 or page_tokens < 1 or max_len < 1:
            raise ValueError("slots, page_tokens, max_len must be >= 1")
        self.num_slots = num_slots
        self.page_tokens = page_tokens
        self.max_len = max_len
        full = math.ceil(max_len / page_tokens)
        self.total_pages = (
            num_slots * full if total_pages is None else int(total_pages)
        )
        self.used_pages = 0
        self._free: List[int] = list(range(num_slots))
        self._pages = [0] * num_slots
        self._owner: List[Optional[str]] = [None] * num_slots

    def _pages_for(self, n_positions: int) -> int:
        return math.ceil(max(1, n_positions) / self.page_tokens)

    def allocate(self, request_id: str, n_positions: int) -> Optional[int]:
        """Claim a slot paged to cover ``n_positions``; ``None`` when no
        slot or not enough pages are free (admission backpressure)."""
        if n_positions > self.max_len:
            raise ValueError(
                f"sequence needs {n_positions} positions > "
                f"max_len {self.max_len}"
            )
        need = self._pages_for(n_positions)
        if not self._free or self.used_pages + need > self.total_pages:
            return None
        slot = min(self._free)
        self._free.remove(slot)
        self._pages[slot] = need
        self._owner[slot] = request_id
        self.used_pages += need
        return slot

    def ensure(self, slot: int, n_positions: int) -> bool:
        """Grow ``slot`` to cover ``n_positions``; False when the page
        budget is exhausted (caller evicts)."""
        need = self._pages_for(n_positions) - self._pages[slot]
        if need <= 0:
            return True
        if self.used_pages + need > self.total_pages:
            return False
        self._pages[slot] += need
        self.used_pages += need
        return True

    def free(self, slot: int) -> None:
        if self._owner[slot] is None:
            return
        self.used_pages -= self._pages[slot]
        self._pages[slot] = 0
        self._owner[slot] = None
        self._free.append(slot)

    def owner(self, slot: int) -> Optional[str]:
        return self._owner[slot]

    @property
    def free_slot_count(self) -> int:
        return len(self._free)

    @property
    def live_slot_count(self) -> int:
        return self.num_slots - len(self._free)

    def page_fill(self) -> float:
        return self.used_pages / max(1, self.total_pages)


# --------------------------------------------------------------- engines

class ToyDecodeEngine:
    """Deterministic arithmetic engine for scheduler tests.

    ``next = (31·sum(context) + 7·len(context)) mod vocab`` — a pure
    function of the visible context, so a sequence requeued as a prefill
    (context = prompt + generated-so-far) continues with exactly the
    tokens its first incarnation would have produced, mirroring greedy
    decode from a real model.
    """

    def __init__(self, num_slots: int = _DEFAULT_SLOTS,
                 max_len: int = 128, vocab: int = 997):
        self.num_slots = num_slots
        self.max_len = max_len
        self.vocab = vocab
        self._ctx: List[List[int]] = [[] for _ in range(num_slots)]

    @staticmethod
    def _next(ctx: List[int], vocab: int) -> int:
        return (31 * sum(ctx) + 7 * len(ctx)) % vocab

    def prefill(self, slot: int, tokens: Sequence[int]) -> int:
        self._ctx[slot] = list(tokens)
        return self._next(self._ctx[slot], self.vocab)

    def step(self, last_tokens: Sequence[int], cache_lens: Sequence[int],
             kv_len: int) -> List[int]:
        out = []
        for slot in range(self.num_slots):
            ctx = self._ctx[slot]
            ctx.append(int(last_tokens[slot]))
            out.append(self._next(ctx, self.vocab))
        return out

    def reference_decode(self, prompt: Sequence[int], max_new: int,
                         eos: Optional[int] = None) -> List[int]:
        ctx = list(prompt)
        out: List[int] = []
        for _ in range(max_new):
            tok = self._next(ctx, self.vocab)
            out.append(tok)
            ctx.append(tok)
            if eos is not None and tok == eos:
                break
            if len(ctx) >= self.max_len:
                break
        return out


class TransformerDecodeEngine:
    """Greedy-decode engine over a :class:`CausalLM` on its device.

    Holds the pooled KV cache (one row per slot, preallocated by
    ``CausalLM.init_cache``). A prefill (batch 1, padded to a prompt
    bucket) writes its rows straight into its slot, and the batched step
    scatters one row per slot, both in place, so a steady-state round
    allocates no cache memory. One host sync per round (the step's token
    fetch), never one per token per sequence.
    """

    def __init__(self, model, num_slots: int = _DEFAULT_SLOTS,
                 page_tokens: int = _DEFAULT_PAGE_TOKENS):
        self.model = model.eval()
        self.device = model.device
        self.num_slots = num_slots
        self.max_len = int(model.cfg.max_len)
        self.prompt_buckets = kv_buckets(page_tokens, self.max_len)
        self._cache = model.init_cache(num_slots)

    def _padded(self, tokens: Sequence[int]) -> torch.Tensor:
        bucket = bucket_for(self.prompt_buckets, len(tokens))
        ids = torch.zeros((1, bucket), dtype=torch.long)
        ids[0, : len(tokens)] = torch.as_tensor(list(tokens))
        return ids.to(self.device)

    @torch.inference_mode()
    def prefill(self, slot: int, tokens: Sequence[int]) -> int:
        logits = self.model.prefill(
            self._padded(tokens),
            torch.tensor([len(tokens)], device=self.device),
            self._cache,
            slots=torch.tensor([slot], device=self.device),
        )
        return int(logits.argmax(dim=-1)[0])

    @torch.inference_mode()
    def step(self, last_tokens: Sequence[int], cache_lens: Sequence[int],
             kv_len: int) -> List[int]:
        tokens = torch.tensor(list(last_tokens), dtype=torch.long,
                              device=self.device)[:, None]
        positions = torch.tensor(list(cache_lens), dtype=torch.long,
                                 device=self.device)
        logits = self.model.decode_step(tokens, positions, int(kv_len),
                                        self._cache)
        return logits.argmax(dim=-1).tolist()

    @torch.inference_mode()
    def reference_decode(self, prompt: Sequence[int], max_new: int,
                         eos: Optional[int] = None) -> List[int]:
        """Unbatched no-cache reference: a full (padded) forward per
        token, the path the round loop must match token for token."""
        seq = list(prompt)
        out: List[int] = []
        for _ in range(max_new):
            logits = self.model(self._padded(seq))
            tok = int(logits[0, len(seq) - 1].argmax())
            out.append(tok)
            seq.append(tok)
            if eos is not None and tok == eos:
                break
            if len(seq) >= self.max_len:
                break
        return out


def build_transformer_engine(
    num_slots: int = _DEFAULT_SLOTS,
    page_tokens: int = _DEFAULT_PAGE_TOKENS,
    seed: int = 0,
    *,
    device: DeviceLike = "cuda",
    **cfg_overrides,
) -> TransformerDecodeEngine:
    """Tiny-CausalLM engine factory; ``cfg_overrides`` widen it (e.g. to
    bert_base widths). Parameters come from a ``torch.Generator`` seeded
    with ``seed``. float32 by default so batched and reference greedy
    argmax agree exactly."""
    defaults = dict(
        causal=True, dtype=torch.float32, vocab_size=256, max_len=128
    )
    defaults.update(cfg_overrides)
    model = CausalLM(
        tiny_transformer(**defaults),
        device=device,
        generator=torch.Generator().manual_seed(seed),
    )
    return TransformerDecodeEngine(
        model, num_slots=num_slots, page_tokens=page_tokens
    )



# ------------------------------------------------------------ round loop

#: Terminal reasons a sequence leaves the loop with.
RETIRE_REASONS = ("eos", "length", "timeout", "cancel", "evict")


@dataclasses.dataclass
class DecodeSequence:
    """One admitted sequence's loop-side state."""

    request_id: str
    prompt: List[int]
    max_new: int
    eos: Optional[int] = None
    start_index: int = 0  # tokens produced by earlier incarnations
    deadline_mono: Optional[float] = None
    slot: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    cache_len: int = 0
    last_token: int = 0
    admit_round: Optional[int] = None

    @property
    def produced(self) -> int:
        return self.start_index + len(self.generated)

    @property
    def context(self) -> List[int]:
        return self.prompt + self.generated


class DecodeLoop:
    """Continuous-batching round loop over one engine's slot pool.

    Thread model: any thread may :meth:`submit`/:meth:`cancel`; exactly
    one thread calls :meth:`run_round`. Token/done events buffer
    internally (drained by :meth:`drain_events` — a replica process
    streams them to its group once per round) and optionally fan out through
    ``on_token(request_id, index, token)`` / ``on_done(request_id,
    reason, n_generated)`` callbacks.

    ``auto_requeue_evicted`` re-admits an evicted sequence locally
    (prefix re-fed as a prefill) — right for in-process use; replica
    mode turns it off and lets the replica group route the eviction through
    the shared queue.
    """

    def __init__(self, engine, config: Optional[DecodeConfig] = None,
                 *,
                 on_token: Optional[Callable[[str, int, int], None]] = None,
                 on_done: Optional[Callable[[str, str, int], None]] = None,
                 auto_requeue_evicted: bool = True,
                 clock: Callable[[], float] = None):
        import time as _time

        self.engine = engine
        self.config = config or DecodeConfig.from_env()
        self.pool = PagedSlotPool(
            engine.num_slots, self.config.page_tokens, engine.max_len,
            total_pages=self.config.total_pages,
        )
        self.kv_bucket_sizes = kv_buckets(
            self.config.page_tokens, engine.max_len
        )
        self.rounds = 0
        self._mu = threading.Lock()
        self._pending: Deque[DecodeSequence] = collections.deque()
        self._cancelled: set = set()
        self._live: Dict[int, DecodeSequence] = {}  # slot → seq
        self._info: Dict[str, Dict[str, Any]] = {}
        self._event_tokens: List[Dict[str, int]] = []
        self._event_done: List[Dict[str, Any]] = []
        self._on_token = on_token
        self._on_done = on_done
        self._auto_requeue = auto_requeue_evicted
        self._now = clock or _time.monotonic

    # -- submission (any thread) ---------------------------------------

    def submit(self, request_id: str, prompt: Sequence[int],
               max_new: Optional[int] = None, eos: Optional[int] = None,
               start_index: int = 0,
               deadline_s: Optional[float] = None) -> None:
        """Queue a sequence for admission at the next round."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("decode prompt must be non-empty")
        if len(prompt) >= self.engine.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} leaves no room to decode "
                f"(max_len {self.engine.max_len})"
            )
        max_new = self.config.max_new if max_new is None else int(max_new)
        seq = DecodeSequence(
            request_id=request_id, prompt=prompt,
            max_new=max(1, max_new), eos=eos,
            start_index=int(start_index),
            deadline_mono=(
                self._now() + deadline_s if deadline_s is not None
                else None
            ),
        )
        with self._mu:
            self._pending.append(seq)

    def cancel(self, request_id: str) -> None:
        with self._mu:
            self._cancelled.add(request_id)

    def free_capacity(self) -> int:
        """Admission hint: slots not yet spoken for by live or pending
        sequences (may go negative under heavy over-submission)."""
        with self._mu:
            pending = len(self._pending)
        return self.engine.num_slots - self.pool.live_slot_count - pending

    def sequence_info(self, request_id: str) -> Optional[Dict[str, Any]]:
        with self._mu:
            info = self._info.get(request_id)
            return dict(info) if info else None

    def counts(self) -> Dict[str, int]:
        with self._mu:
            return {
                "live": self.pool.live_slot_count,
                "pending": len(self._pending),
                "rounds": self.rounds,
            }

    def drain_events(self) -> Dict[str, List[dict]]:
        """Token/done events buffered since the last drain — what the
        replica ships to its group, one RPC per round."""
        with self._mu:
            tokens, self._event_tokens = self._event_tokens, []
            done, self._event_done = self._event_done, []
        return {"tokens": tokens, "done": done}

    # -- the round (loop thread only) ----------------------------------

    def run_round(self) -> Dict[str, Any]:
        """One scheduler iteration: cancels → admissions (prefill) →
        one batched decode step → retirements. Returns round stats."""
        round_no = self.rounds + 1
        with self._mu:
            cancelled, self._cancelled = self._cancelled, set()
            admissions: List[DecodeSequence] = []
            # Peel pending admissions FIFO while capacity lasts; the
            # remainder stays queued for the next round.
            while self._pending:
                admissions.append(self._pending.popleft())

        for rid in cancelled:
            for slot, seq in list(self._live.items()):
                if seq.request_id == rid:
                    self._retire(seq, "cancel", round_no)
        if cancelled:
            still = []
            for seq in admissions:
                if seq.request_id in cancelled:
                    self._retire(seq, "cancel", round_no)
                else:
                    still.append(seq)
            admissions = still

        # Admit prefills into free slots. The prompt pass doubles as
        # the first decode step: its last-position logits are the
        # sequence's first generated token.
        deferred: List[DecodeSequence] = []
        admitted = 0
        now = self._now()
        for seq in admissions:
            if seq.deadline_mono is not None and now > seq.deadline_mono:
                self._retire(seq, "timeout", round_no)
                continue
            slot = self.pool.allocate(
                seq.request_id, len(seq.context) + 1
            )
            if slot is None:
                deferred.append(seq)
                continue
            seq.slot = slot
            seq.admit_round = round_no
            tok = self.engine.prefill(slot, seq.context)
            seq.cache_len = len(seq.context)
            self._live[slot] = seq
            admitted += 1
            metrics.counter_add("decode/prefills")
            self._emit_token(seq, tok)
            self._maybe_retire(seq, round_no, now)
        if deferred:
            with self._mu:
                for seq in reversed(deferred):
                    self._pending.appendleft(seq)

        # One step over the whole slot batch, sized to the
        # tightest cache-length bucket. Slots whose next write has no
        # page left are evicted BEFORE the step (the write at position
        # cache_len must be backed).
        stepped = 0
        kv_len = 0
        if self._live:
            for slot, seq in list(self._live.items()):
                if not self.pool.ensure(slot, seq.cache_len + 1):
                    self._evict(seq, round_no)
            if self._live:
                kv_len = bucket_for(
                    self.kv_bucket_sizes,
                    max(s.cache_len for s in self._live.values()) + 1,
                )
                last = [0] * self.engine.num_slots
                lens = [0] * self.engine.num_slots
                for slot, seq in self._live.items():
                    last[slot] = seq.last_token
                    lens[slot] = seq.cache_len
                next_tokens = self.engine.step(last, lens, kv_len)
                now = self._now()
                for slot, seq in list(self._live.items()):
                    seq.cache_len += 1
                    stepped += 1
                    self._emit_token(seq, int(next_tokens[slot]))
                    self._maybe_retire(seq, round_no, now)

        self.rounds = round_no
        live = self.pool.live_slot_count
        with self._mu:
            pending = len(self._pending)
        metrics.counter_add("decode/rounds")
        metrics.gauge_set(
            "decode/batch_occupancy", live / max(1, self.engine.num_slots)
        )
        metrics.gauge_set("decode/page_fill", self.pool.page_fill())
        metrics.gauge_set("decode/kv_bucket", kv_len)
        metrics.gauge_set("decode/pending", pending)
        return {
            "round": round_no,
            "admitted": admitted,
            "stepped": stepped,
            "live": live,
            "pending": pending,
            "kv_bucket": kv_len,
        }

    def run_until_idle(self, max_rounds: int = 10000) -> int:
        """Drive rounds until no live or pending work remains (in-
        process harness for tests and the bench). Returns rounds run."""
        ran = 0
        while ran < max_rounds:
            stats = self.run_round()
            ran += 1
            if stats["live"] == 0 and stats["pending"] == 0:
                break
        return ran

    # -- internals ------------------------------------------------------

    def _emit_token(self, seq: DecodeSequence, token: int) -> None:
        index = seq.produced  # global index across incarnations
        seq.generated.append(token)
        seq.last_token = token
        metrics.counter_add("decode/tokens")
        metrics.meter("decode/throughput").add(1)
        ev = {"id": seq.request_id, "index": index, "token": token}
        with self._mu:
            self._event_tokens.append(ev)
        if self._on_token is not None:
            self._on_token(seq.request_id, index, token)

    def _maybe_retire(self, seq: DecodeSequence, round_no: int,
                      now: float) -> None:
        if seq.eos is not None and seq.last_token == seq.eos:
            self._retire(seq, "eos", round_no)
        elif seq.produced >= seq.max_new:
            self._retire(seq, "length", round_no)
        elif len(seq.context) >= self.engine.max_len:
            self._retire(seq, "length", round_no)
        elif seq.deadline_mono is not None and now > seq.deadline_mono:
            self._retire(seq, "timeout", round_no)

    def _retire(self, seq: DecodeSequence, reason: str,
                round_no: int) -> None:
        if seq.slot is not None:
            self.pool.free(seq.slot)
            self._live.pop(seq.slot, None)
            seq.slot = None
        metrics.counter_add(f"decode/retired/{reason}")
        self._emit_done(seq, reason, round_no)

    def _evict(self, seq: DecodeSequence, round_no: int) -> None:
        """Recompute-preemption: drop the cache, keep the tokens. The
        prefix (prompt + generated) re-enters as a prefill — locally
        when auto-requeue is on, via the group's shared queue when a
        replica group owns routing."""
        if seq.slot is not None:
            self.pool.free(seq.slot)
            self._live.pop(seq.slot, None)
            seq.slot = None
        metrics.counter_add("decode/evictions")
        if self._auto_requeue:
            requeued = DecodeSequence(
                request_id=seq.request_id,
                prompt=seq.context,
                max_new=seq.max_new,
                eos=seq.eos,
                start_index=seq.produced,
                deadline_mono=seq.deadline_mono,
            )
            with self._mu:
                self._pending.append(requeued)
                self._info[seq.request_id] = {
                    "admit_round": seq.admit_round,
                    "evicted_round": round_no,
                    "produced": seq.produced,
                }
        else:
            self._emit_done(seq, "evict", round_no)

    def _emit_done(self, seq: DecodeSequence, reason: str,
                   round_no: int) -> None:
        ev = {
            "id": seq.request_id,
            "reason": reason,
            "n_generated": len(seq.generated),
            "produced": seq.produced,
            "tokens": list(seq.generated),
        }
        with self._mu:
            self._event_done.append(ev)
            self._info[seq.request_id] = {
                "admit_round": seq.admit_round,
                "retire_round": round_no,
                "reason": reason,
                "produced": seq.produced,
                "tokens": list(seq.generated),
            }
        if self._on_done is not None:
            self._on_done(seq.request_id, reason, len(seq.generated))


def reference_decode(engine, prompt: Sequence[int], max_new: int,
                     eos: Optional[int] = None) -> List[int]:
    """The unbatched one-request-at-a-time path the round loop is
    checked against (and benchmarked 3x+ faster than)."""
    return engine.reference_decode(prompt, max_new, eos)

