"""Request lifecycle + synthetic open-loop arrival process (the JAX
package's ``serving/request.py``, numpy only, kept as the port's own copy).

A request moves QUEUED -> PREFILL -> DECODE -> DONE (or DROPPED if its
deadline passes while still queued).  Prefill here is *decode-replay*: the
engine feeds prompt tokens through the same slot-decode step the static
server uses, one token per engine iteration, so per-request greedy outputs
are bit-identical between the two paths.

The arrival process is the standard open-loop serving model: exponential
interarrival times at an offered load of ``rate`` requests/second, with
prompt/generation lengths drawn from small discrete mixes — the mixed-length
traffic that makes static batching pay head-of-line blocking.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    DROPPED = "dropped"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (P,) int32 token ids
    max_new_tokens: int
    arrival: float = 0.0                # seconds since stream start
    priority: int = 0                   # lower = more urgent
    deadline: Optional[float] = None    # absolute; queued past it -> DROPPED

    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    # prompt tokens served from shared KV pages (prefix sharing): prefill
    # for these is skipped by binding at an offset, and n_fed counts them
    # as fed so samples_ready stays engine-independent
    shared_tokens: int = 0
    n_fed: int = 0                      # engine steps fed so far (all phases)
    n_streamed: int = 0                 # samples already delivered as deltas
    output: List[int] = dataclasses.field(default_factory=list)
    t_admitted: Optional[float] = None
    # host-visible first token (burst-boundary sync under streaming, the
    # completion pull otherwise) — what TTFT honestly measures
    t_first_token: Optional[float] = None
    # dispatch-time stamp: the burst containing the first sample has been
    # enqueued on the device (the pre-streaming TTFT; kept so the bench can
    # quantify the dispatch-vs-delivery gap)
    t_first_dispatch: Optional[float] = None
    t_done: Optional[float] = None
    # modeled per-step cost at admission time (what the batcher's token
    # budget priced this request against); the tracer pairs it with the
    # observed per-step time in the decode span
    priced_step_s: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_tokens(self) -> int:
        """Full KV footprint the request will ever need (reservation unit)."""
        return self.prompt_len + self.max_new_tokens

    @property
    def samples_ready(self) -> int:
        """Samples present in the slot's output row after ``n_fed`` engine
        steps: the step fed at position p writes sample p - prompt_len + 1
        (valid once the final prompt token has been fed), so ``n_fed`` steps
        leave ``n_fed - prompt_len + 1`` samples, clamped to the request's
        generation length.  Engine-independent: ``n_fed`` counts steps
        across phases, so the formula holds colocated and disaggregated."""
        return min(max(self.n_fed - self.prompt_len + 1, 0),
                   self.max_new_tokens)

    # ---- metrics ---------------------------------------------------------
    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival

    @property
    def ttft_dispatch(self) -> Optional[float]:
        """Dispatch-stamped TTFT (the old metric); <= ttft always."""
        if self.t_first_dispatch is None:
            return None
        return self.t_first_dispatch - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Time per output token after the first (decode-phase latency)."""
        if self.t_done is None or self.t_first_token is None:
            return None
        n = max(len(self.output) - 1, 1)
        return (self.t_done - self.t_first_token) / n


def synthetic_workload(
    n_requests: int,
    *,
    rate: float,
    vocab: int,
    prompt_lens: Sequence[int] = (8, 16),
    gen_lens: Sequence[int] = (4, 8, 16, 48),
    seed: int = 0,
    deadline_s: Optional[float] = None,
) -> List[Request]:
    """Open-loop Poisson arrivals with mixed prompt/generation lengths."""
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs = []
    for rid in range(n_requests):
        t += float(rng.exponential(1.0 / rate)) if rate > 0 else 0.0
        plen = int(rng.choice(prompt_lens))
        glen = int(rng.choice(gen_lens))
        prompt = rng.integers(0, vocab, size=(plen,), dtype=np.int32)
        reqs.append(Request(
            rid=rid, prompt=prompt, max_new_tokens=glen, arrival=t,
            deadline=None if deadline_s is None else t + deadline_s))
    return reqs


def prefix_shared_workload(
    n_requests: int,
    *,
    rate: float,
    vocab: int,
    shared_prefix_len: int,
    shared_frac: float = 0.9,
    suffix_lens: Sequence[int] = (8, 16),
    gen_lens: Sequence[int] = (4, 8, 16),
    seed: int = 0,
    deadline_s: Optional[float] = None,
) -> List[Request]:
    """Open-loop arrivals where ``shared_frac`` of requests front-load one
    common ``shared_prefix_len``-token prompt prefix (the chat/agent
    system-prompt pattern prefix sharing exploits); the rest are fully
    unique.  Every suffix is unique, so sharers still diverge after the
    prefix."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, size=(shared_prefix_len,),
                          dtype=np.int32)
    t = 0.0
    reqs = []
    for rid in range(n_requests):
        t += float(rng.exponential(1.0 / rate)) if rate > 0 else 0.0
        slen = int(rng.choice(suffix_lens))
        glen = int(rng.choice(gen_lens))
        suffix = rng.integers(0, vocab, size=(slen,), dtype=np.int32)
        if rng.random() < shared_frac:
            prompt = np.concatenate([common, suffix])
        else:
            unique = rng.integers(0, vocab, size=(shared_prefix_len,),
                                  dtype=np.int32)
            prompt = np.concatenate([unique, suffix])
        reqs.append(Request(
            rid=rid, prompt=prompt, max_new_tokens=glen, arrival=t,
            deadline=None if deadline_s is None else t + deadline_s))
    return reqs
