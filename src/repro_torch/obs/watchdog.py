"""SLO attainment for ``serve --slo-report`` and the speculative-decoding
acceptance tracker: those parts of the JAX package's ``obs/watchdog.py``.

Requests are bucketed by generation length into short/medium/long terciles,
and each class reports its TTFT/TPOT medians and the share of requests that
met each objective.  :class:`AcceptanceTracker` follows the draft's
measured acceptance rate and vetoes speculation when a re-decision prices
it worse than plain decoding.  The performance watchdog of that module is
not ported yet (ROADMAP §1 item 6).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["AcceptanceTracker", "DEFAULT_ACCEPTANCE_REDECIDE_EVERY",
           "DEFAULT_EWMA_ALPHA", "DEFAULT_WARMUP", "class_boundaries",
           "format_slo_report", "request_class", "slo_attainment"]

# the JAX package's watchdog defaults the tracker uses
DEFAULT_EWMA_ALPHA = 0.4
DEFAULT_WARMUP = 4


# ---------------------------------------------------------------------------
# Speculative-decoding acceptance (online EWMA + re-decision veto)
# ---------------------------------------------------------------------------
DEFAULT_ACCEPTANCE_REDECIDE_EVERY = 8


class AcceptanceTracker:
    """Online EWMA of the draft's per-token acceptance rate.

    The trade-off analyzer prices speculation on a *prior* (or cached)
    acceptance rate; this tracker watches the rate the run actually
    delivers.  Every ``redecide_every`` rounds past ``warmup`` it calls
    ``decide(alpha)`` — a closure over
    :func:`repro_torch.serving.placement.choose_speculation` — and latches
    ``disabled`` the first time the re-decision says speculation now prices
    worse than plain decode.  The veto is one-way: re-enabling mid-run would
    need the draft caches re-synced for every slot, and a wrongly-disabled
    run merely decodes plain.
    """

    def __init__(self, *, ewma_alpha: float = DEFAULT_EWMA_ALPHA,
                 warmup: int = DEFAULT_WARMUP,
                 redecide_every: int = DEFAULT_ACCEPTANCE_REDECIDE_EVERY,
                 decide: Optional[Callable[[float], object]] = None):
        self.ewma_alpha = ewma_alpha
        self.warmup = warmup
        self.redecide_every = max(int(redecide_every), 1)
        self.decide = decide
        self.ewma: Optional[float] = None
        self.n_rounds = 0
        self.n_proposed = 0
        self.n_accepted = 0
        self.disabled = False
        self.decisions: List[dict] = []

    def observe_round(self, proposed: int, accepted: int) -> None:
        """Feed one speculative round's draft-token tallies."""
        if proposed <= 0:
            return
        r = accepted / proposed
        self.n_rounds += 1
        self.n_proposed += int(proposed)
        self.n_accepted += int(accepted)
        a = self.ewma_alpha
        self.ewma = r if self.ewma is None else (1 - a) * self.ewma + a * r
        if (self.decide is not None and not self.disabled
                and self.n_rounds >= self.warmup
                and self.n_rounds % self.redecide_every == 0):
            decision = self.decide(self.acceptance)
            if decision is not None:
                self.decisions.append(
                    {"round": self.n_rounds,
                     "acceptance": self.acceptance,
                     "use": bool(getattr(decision, "use", True))})
                if not getattr(decision, "use", True):
                    self.disabled = True

    @property
    def acceptance(self) -> float:
        """Best current estimate of the per-token acceptance rate."""
        if self.ewma is not None:
            return self.ewma
        if self.n_proposed > 0:
            return self.n_accepted / self.n_proposed
        return 0.0

    def report(self) -> dict:
        return {"acceptance_ewma": self.ewma,
                "acceptance_cum": (self.n_accepted / self.n_proposed
                                   if self.n_proposed else None),
                "n_rounds": self.n_rounds,
                "n_proposed": self.n_proposed,
                "n_accepted": self.n_accepted,
                "disabled": self.disabled,
                "decisions": list(self.decisions)}


# ---------------------------------------------------------------------------
# SLO attainment (serve --slo-report)
# ---------------------------------------------------------------------------


def request_class(req, boundaries: Tuple[int, int]) -> str:
    """Bucket a request by generation length (short/medium/long)."""
    if req.max_new_tokens <= boundaries[0]:
        return "short"
    if req.max_new_tokens <= boundaries[1]:
        return "medium"
    return "long"


def class_boundaries(requests) -> Tuple[int, int]:
    """Tercile boundaries over the workload's generation lengths."""
    lens = sorted(r.max_new_tokens for r in requests)
    if not lens:
        return (0, 0)
    return (lens[len(lens) // 3], lens[(2 * len(lens)) // 3])


def slo_attainment(requests, *, ttft_slo_s: float,
                   tpot_slo_s: float) -> List[dict]:
    """Per-request-class TTFT/TPOT SLO attainment rows (+ an `all` row)."""
    done = [r for r in requests if r.t_done is not None]
    bounds = class_boundaries(done)
    groups: Dict[str, list] = {"short": [], "medium": [], "long": []}
    for r in done:
        groups[request_class(r, bounds)].append(r)
    rows = []
    for name in ("short", "medium", "long", "all"):
        members = done if name == "all" else groups[name]
        ttfts = [r.ttft for r in members if r.ttft is not None]
        tpots = [r.tpot for r in members if r.tpot is not None]
        rows.append({
            "class": name,
            "n": len(members),
            "gen_len_max": max((r.max_new_tokens for r in members),
                               default=None),
            "ttft_p50_s": (sorted(ttfts)[len(ttfts) // 2] if ttfts else None),
            "tpot_p50_s": (sorted(tpots)[len(tpots) // 2] if tpots else None),
            "ttft_attained": (sum(1 for t in ttfts if t <= ttft_slo_s)
                              / len(ttfts) if ttfts else None),
            "tpot_attained": (sum(1 for t in tpots if t <= tpot_slo_s)
                              / len(tpots) if tpots else None),
        })
    return rows


def format_slo_report(rows: List[dict], *, ttft_slo_s: float,
                      tpot_slo_s: float) -> str:
    """Render the attainment rows as the table ``--slo-report`` prints."""
    def pct(v):
        return "    --" if v is None else f"{100.0 * v:5.1f}%"

    def ms(v):
        return "     --" if v is None else f"{1e3 * v:7.1f}"

    lines = [
        f"SLO attainment (TTFT <= {1e3 * ttft_slo_s:.0f} ms, "
        f"TPOT <= {1e3 * tpot_slo_s:.0f} ms)",
        f"{'class':<8}{'n':>4}{'ttft p50 ms':>13}{'ttft ok':>9}"
        f"{'tpot p50 ms':>13}{'tpot ok':>9}",
    ]
    for row in rows:
        lines.append(
            f"{row['class']:<8}{row['n']:>4}{ms(row['ttft_p50_s']):>13}"
            f"{pct(row['ttft_attained']):>9}{ms(row['tpot_p50_s']):>13}"
            f"{pct(row['tpot_attained']):>9}")
    return "\n".join(lines)
