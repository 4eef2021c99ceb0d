"""Per-request serving latency accounting: TTFT / TPOT / e2e.

One :class:`RequestTiming` per request records the four timestamps the
standard serving SLOs are built from; :class:`ServeMetrics` aggregates a
run into the headline numbers (p50/p99 TTFT, mean TPOT, tokens/s) that
``launch/serve.py --traffic`` prints.  Pure python; a copy of
``repro.serving.metrics``.
"""
from __future__ import annotations

import dataclasses


def percentile(xs, p: float) -> float:
    """Linear-interpolated percentile (numpy's default method), p ∈ [0, 100]."""
    if not xs:
        raise ValueError("percentile of an empty sequence")
    s = sorted(xs)
    if len(s) == 1:
        return float(s[0])
    rank = (len(s) - 1) * p / 100.0
    lo = int(rank)
    hi = min(lo + 1, len(s) - 1)
    frac = rank - lo
    return float(s[lo] * (1.0 - frac) + s[hi] * frac)


@dataclasses.dataclass
class RequestTiming:
    """Lifecycle timestamps of one request (seconds on the caller's clock)."""
    rid: int
    arrival: float
    admitted: float | None = None        # prefill started
    first_token: float | None = None     # prefill done, token 1 emitted
    finished: float | None = None
    n_tokens: int = 0                    # tokens generated (incl. the first)
    preemptions: int = 0

    @property
    def ttft(self) -> float:
        """Time to first token: arrival → first emitted token (includes
        admission queueing — the p99 of this is the gated SLO)."""
        return self.first_token - self.arrival

    @property
    def tpot(self) -> float:
        """Time per output token over the decode phase."""
        if self.n_tokens <= 1:
            return 0.0
        return (self.finished - self.first_token) / (self.n_tokens - 1)

    @property
    def e2e(self) -> float:
        return self.finished - self.arrival


class ServeMetrics:
    """Aggregate a run's RequestTimings into the headline serving numbers."""

    def __init__(self):
        self.requests: list = []

    def add(self, t: RequestTiming):
        if t.finished is None or t.first_token is None:
            raise ValueError(f"request {t.rid} recorded before finishing")
        self.requests.append(t)

    def summary(self) -> dict:
        rs = self.requests
        if not rs:
            return {"completed": 0}
        t0 = min(r.arrival for r in rs)
        t1 = max(r.finished for r in rs)
        total_tokens = sum(r.n_tokens for r in rs)
        ttfts = [r.ttft for r in rs]
        tpots = [r.tpot for r in rs if r.n_tokens > 1]
        return {
            "completed": len(rs),
            "tokens": total_tokens,
            "makespan_s": t1 - t0,
            "tokens_per_s": total_tokens / max(t1 - t0, 1e-12),
            "ttft_p50_s": percentile(ttfts, 50),
            "ttft_p99_s": percentile(ttfts, 99),
            "ttft_mean_s": sum(ttfts) / len(ttfts),
            "tpot_mean_s": (sum(tpots) / len(tpots)) if tpots else 0.0,
            "e2e_p99_s": percentile([r.e2e for r in rs], 99),
            "preemptions": sum(r.preemptions for r in rs),
        }
