"""Request model shared by the scheduler, engine, and simulator (ORCA §III.B)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional


class Phase(enum.Enum):
    WAITING = "waiting"      # queued, not yet prefilled
    INITIATION = "initiation"  # prefill (ORCA's term)
    INCREMENT = "increment"    # autoregressive decode
    PREEMPTED = "preempted"    # pages reclaimed, must re-prefill
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    request_id: int
    arrival_time: float
    prompt: List[int]  # token ids (simulator may leave this empty)
    max_new_tokens: int
    prompt_len: Optional[int] = None  # simulator-only requests set this
    eos_token: Optional[int] = None
    n_samples: int = 1  # deprecated: use SamplingParams.n via the service
    # per-request decoding knobs (serving.api.SamplingParams; duck-typed here
    # to keep this module dependency-free). None = engine defaults (greedy).
    sampling: Optional[Any] = None
    # best-of-n sibling: COW-forked off the parent's prefill by the backend
    parent_id: Optional[int] = None

    phase: Phase = Phase.WAITING
    output: List[int] = dataclasses.field(default_factory=list)
    # tokens generated before a preemption (they re-enter as prompt on
    # recompute but still belong to the client-visible output)
    committed_output: List[int] = dataclasses.field(default_factory=list)
    # per-token log p(sampled token) aligned with ``full_output`` (the
    # engine appends one entry per emitted token; the simulator leaves it
    # empty — its outputs are placeholder ids)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    # chunked-prefill progress: prompt tokens whose KV exists (cached prefix
    # + chunks computed so far). The request decodes only once this reaches
    # ``prompt_len``; preemption resets it (recompute policy).
    prefilled_len: int = 0
    first_token_time: Optional[float] = None
    scheduled_time: Optional[float] = None  # first admission into a plan
    finish_time: Optional[float] = None
    # inter-token-gap tracking (stall observability): backend time of the
    # most recent emitted token, and the worst gap between consecutive
    # tokens — a decode stalled behind a long prefill shows up here
    last_token_time: Optional[float] = None
    max_tbt: float = 0.0
    # one of serving.api.FINISH_REASONS once finished
    finish_reason: Optional[str] = None
    preemptions: int = 0
    # swap-to-host preemptions (KV preserved on host, no recompute) — a
    # separate counter from ``preemptions`` because a swap loses no work and
    # must not eat into the max_preemptions drop budget
    swaps: int = 0
    # scheduler iteration index this request last received work in (decode
    # grant or prefill chunk) — the LRU victim policy's recency key
    last_planned_iter: int = -1
    # sum of log p(sampled token) under the model — best-of-n ranking
    cumulative_logprob: float = 0.0
    # prompt tokens served from the radix prefix cache at the current
    # admission (page-aligned; the engine prefills only the remainder)
    num_cached_tokens: int = 0
    # serving instance this request was placed on (set by RouterBackend;
    # None under a single-backend service)
    instance_id: Optional[int] = None

    def __post_init__(self):
        if self.prompt_len is None:
            self.prompt_len = len(self.prompt)

    @property
    def n_generated(self) -> int:
        return len(self.output)

    @property
    def full_output(self) -> List[int]:
        return self.committed_output + self.output

    @property
    def total_generated(self) -> int:
        return len(self.committed_output) + len(self.output)

    @property
    def context_len(self) -> int:
        return self.prompt_len + self.n_generated

    def record_token_time(self, now: float) -> None:
        """Track the worst inter-token gap (backends call this once per
        emitted token). The first token's gap is TTFT, tracked separately."""
        if self.last_token_time is not None and now > self.last_token_time:
            self.max_tbt = max(self.max_tbt, now - self.last_token_time)
        self.last_token_time = now

    @property
    def stop_token_ids(self):
        return self.sampling.stop_token_ids if self.sampling is not None \
            else ()

    @property
    def finish_reason_if_done(self) -> Optional[str]:
        """Finish reason the request has earned so far, or None while it
        should keep decoding. Stop/eos on the *last sampled token* win over
        the length cap (vLLM semantics)."""
        last = self.output[-1] if self.output else None
        if last is not None:
            if last in self.stop_token_ids:
                return "stop"
            if self.eos_token is not None and last == self.eos_token:
                return "eos"
        if self.n_generated >= self.max_new_tokens:
            return "length"
        return None

    @property
    def done(self) -> bool:
        return self.finish_reason_if_done is not None

    def normalized_latency(self) -> Optional[float]:
        """Paper Fig. 9 metric: end-to-end latency / output length."""
        if self.finish_time is None:
            return None
        return (self.finish_time - self.arrival_time) / max(
            self.total_generated, 1)
