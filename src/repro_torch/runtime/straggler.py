"""Straggler detection: per-step timing, EMA outlier flagging, mitigation;
the port of ``repro/runtime/straggler.py``.

The ATC'22 Whale balances *heterogeneous* GPUs by skewing work; TPU pods are
homogeneous, so the production analogue (DESIGN.md §2, §7) is detecting a
*slow* host (failing HBM, thermal throttle, noisy neighbour on DCN) and
evicting it via elastic re-mesh.  The monitor keeps an EMA + variance of
step times and flags sustained outliers; in a multi-host deployment each
host reports its local step time and the controller aggregates
(single-process here: the aggregation path is exercised with synthetic
per-host timings; the reference's fault injector, ``runtime/faults.py``,
comes with the port's elastic runtime).

Flag semantics are **one-shot**: :meth:`StragglerMonitor.observe` returns
True exactly once, on the step the sustained-outlier flag trips; the
``flagged`` attribute stays latched (queryable) until :meth:`reset`.  The
:class:`HostStragglerAggregator` additionally remembers evicted hosts so a
host that has already been handed to the eviction machinery is never
re-reported — the pre-fix behaviour re-flagged an evicted host on every
``observe`` call, which made the controller loop evict forever.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class StragglerMonitor:
    ema_decay: float = 0.9
    threshold: float = 2.0        # flag when t > mean + threshold·std
    patience: int = 3             # consecutive outliers before flagging
    warmup: int = 5               # ignore the first steps (compile etc.)

    def __post_init__(self):
        self.reset(clear_stats=True)

    def reset(self, *, clear_stats: bool = False) -> None:
        """Re-arm the one-shot flag; ``clear_stats`` also restarts the
        timing statistics (use after a re-plan changes the step time)."""
        self.consecutive = 0
        self.flagged = False
        if clear_stats:
            self.mean = 0.0
            self.var = 0.0
            self._m2 = 0.0        # Welford sum of squared deviations
            self.n = 0

    def observe(self, dt: float) -> bool:
        """Record one step time; True exactly once, when the flag trips.

        After the flag trips the monitor latches (``flagged`` stays True,
        further observations are ignored) until :meth:`reset`.
        """
        self.n += 1
        if self.n <= self.warmup:
            # Welford: seed mean AND variance from the warmup samples so
            # the first post-warmup step is not compared against std == 0
            delta = dt - self.mean
            self.mean += delta / self.n
            self._m2 += delta * (dt - self.mean)
            if self.n >= 2:
                self.var = self._m2 / (self.n - 1)
            return False
        if self.flagged:
            return False          # latched; one-shot already consumed
        std = math.sqrt(max(self.var, 1e-12))
        is_out = dt > self.mean + self.threshold * max(std, 0.05 * self.mean)
        if is_out:
            self.consecutive += 1
        else:
            self.consecutive = 0
        if self.consecutive >= self.patience:
            self.flagged = True
            return True
        # EMA update (outliers excluded so one bad host can't drag the mean)
        if not is_out:
            d = self.ema_decay
            delta = dt - self.mean
            self.mean += (1 - d) * delta
            self.var = d * (self.var + (1 - d) * delta * delta)
        return False


@dataclasses.dataclass
class HostStragglerAggregator:
    """Controller view: one monitor per host; decides eviction.

    ``observe`` returns only *newly* flagged hosts (one-shot, like the
    monitors); hosts handed to :meth:`evict` are dropped entirely and
    silently ignored if their timings keep arriving (a dying host may
    emit a few more heartbeats before the re-mesh lands).
    """
    n_hosts: int
    threshold: float = 2.0
    patience: int = 3
    warmup: int = 5

    def __post_init__(self):
        self.monitors = {h: self._new_monitor() for h in range(self.n_hosts)}
        self.evicted: set = set()

    def _new_monitor(self) -> StragglerMonitor:
        return StragglerMonitor(threshold=self.threshold,
                                patience=self.patience, warmup=self.warmup)

    def observe(self, host_times: dict) -> list:
        """host_id → step time; returns hosts *newly* flagged for eviction."""
        flagged = []
        for h, t in host_times.items():
            mon = self.monitors.get(h)
            if mon is None:                 # evicted / unknown host
                continue
            if mon.observe(t):
                flagged.append(h)
        return flagged

    def evict(self, host: int) -> None:
        """Mark ``host`` as evicted; it is never reported again."""
        self.evicted.add(host)
        self.monitors.pop(host, None)

    def admit(self, host: int) -> None:
        """(Re-)admit ``host``: clear any eviction record and start a
        fresh monitor — a joining host (spot re-admission, scale-up) is
        healthy until its own timings say otherwise.  This is the only
        way an evicted host comes back; :meth:`reset` never resurrects
        one."""
        self.evicted.discard(host)
        self.monitors[host] = self._new_monitor()

    def reset(self, hosts=None) -> None:
        """Fresh monitors after a re-plan (step times change shape).

        ``hosts``: the surviving host ids; default = current non-evicted
        set.  Evicted hosts stay excluded.
        """
        if hosts is None:
            hosts = list(self.monitors)
        self.monitors = {h: self._new_monitor() for h in hosts
                         if h not in self.evicted}
