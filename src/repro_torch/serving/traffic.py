"""Open-loop traffic generation: heavy-tail (Pareto) arrivals.

Closed-loop drivers (admit the next request when a slot frees) hide
queueing collapse — an open-loop generator keeps arriving at the offered
rate whether or not the server keeps up, which is what makes TTFT tails
meaningful.  Interarrival gaps are Pareto (the classic heavy-tail model
for request traffic): bursts of near-simultaneous arrivals separated by
long idle gaps, at a configured *mean* rate.

Deterministic: everything derives from ``numpy.random.default_rng(seed)``
so the driver and the tests replay identical traces.  A copy of
``repro.serving.traffic`` (numpy only).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrafficCfg:
    rate: float                  # mean arrivals per second
    n_requests: int
    alpha: float = 2.5           # Pareto shape; smaller → heavier tail
    prompt_lens: tuple = (16, 32, 64, 128)   # sampled uniformly
    gen_lens: tuple = (16, 32, 64)

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"rate must be positive, got {self.rate}")
        if self.alpha <= 1.0:
            raise ValueError(
                f"alpha must exceed 1 (finite mean), got {self.alpha}")


@dataclasses.dataclass(frozen=True)
class Arrival:
    rid: int
    t: float                     # arrival time, seconds from trace start
    prompt_len: int
    gen_len: int


def pareto_interarrivals(rng, rate: float, n: int,
                         alpha: float = 2.5) -> np.ndarray:
    """``n`` Pareto gaps with mean ``1/rate``.

    Pareto(x_m, α) has mean x_m·α/(α−1); solving for the scale gives
    x_m = (α−1)/(α·rate) so the long-run arrival rate is exactly ``rate``
    while individual gaps are bursty/heavy-tailed.
    """
    xm = (alpha - 1.0) / (alpha * rate)
    u = rng.random(n)
    return xm * np.power(1.0 - u, -1.0 / alpha)


def make_trace(cfg: TrafficCfg, seed: int = 0) -> list:
    """Deterministic arrival trace: ``n_requests`` :class:`Arrival`\\ s."""
    rng = np.random.default_rng(seed)
    gaps = pareto_interarrivals(rng, cfg.rate, cfg.n_requests, cfg.alpha)
    times = np.cumsum(gaps)
    prompts = rng.choice(np.asarray(cfg.prompt_lens), cfg.n_requests)
    gens = rng.choice(np.asarray(cfg.gen_lens), cfg.n_requests)
    return [Arrival(rid=i, t=float(times[i]), prompt_len=int(prompts[i]),
                    gen_len=int(gens[i]))
            for i in range(cfg.n_requests)]
