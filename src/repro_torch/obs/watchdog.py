"""SLO attainment for ``serve --slo-report``: the SLO part of the JAX
package's ``obs/watchdog.py``.

Requests are bucketed by generation length into short/medium/long terciles,
and each class reports its TTFT/TPOT medians and the share of requests that
met each objective.  The performance watchdog and the acceptance tracker of
that module are not ported yet (ROADMAP §1 items 5-6).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

__all__ = ["class_boundaries", "format_slo_report", "request_class",
           "slo_attainment"]


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
