"""Fault tolerance: auto-resume, signal-triggered checkpoint, bounded retry.

A copy of ``repro/runtime/fault_tolerance.py`` (pure Python) over the
port's :class:`~repro_torch.ckpt.checkpoint.CheckpointManager`.  A failed
CUDA launch surfaces as ``RuntimeError`` (the kernel wrappers raise it),
so it is retried like any transient failure and re-raised once retries
run out — never turned into a run on the plain versions.

The training driver (``launch/train.py``) wraps its step loop in
:class:`FaultTolerantLoop`:

- **auto-resume** — on start, the latest *committed* checkpoint (model +
  optimizer + data-pipeline state) is restored; a preempted/failed job
  relaunched by the cluster scheduler continues where it left off.
- **SIGTERM flush** — preemption notices trigger a final synchronous
  checkpoint before exit (schedulers announce preemption with SIGTERM).
- **bounded retry** — transient step failures (in production: DCN flakes,
  preempted reductions) retry the step up to ``max_retries`` times from the
  last good in-memory state; persistent failure re-raises after a final
  checkpoint so the scheduler can reschedule.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable

from repro_torch.ckpt.checkpoint import CheckpointManager


@dataclasses.dataclass
class FaultTolerantLoop:
    ckpt: CheckpointManager
    save_every: int = 100
    max_retries: int = 3
    async_save: bool = True

    def __post_init__(self):
        self._term_requested = False
        self._stop_requested = False
        self._abort_requested = False
        self._prev_handlers = {}

    # --- signal handling ---
    def _on_term(self, signum, frame):
        self._term_requested = True

    @property
    def preempted(self) -> bool:
        """True once a SIGTERM/SIGINT has been observed."""
        return self._term_requested

    # --- cooperative stop (elastic re-plan) ---
    def request_stop(self) -> None:
        """Ask the loop to exit after the current step with a final
        synchronous checkpoint — the controller's straggler-eviction hook
        (``on_step`` calls this; the loop returns and the caller re-plans
        and calls :meth:`run` again with the new state)."""
        self._stop_requested = True

    def request_abort(self) -> None:
        """Ask the loop to exit after the current step WITHOUT a final
        checkpoint — the deadline-missed membership path (a host died
        mid-segment, so the in-flight state must not be committed; the
        caller restores the last *committed* checkpoint and replays the
        lost steps exactly-once)."""
        self._abort_requested = True

    @property
    def aborted(self) -> bool:
        """True once :meth:`request_abort` ended the last :meth:`run`."""
        return self._abort_requested

    def install_signal_handlers(self) -> None:
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._prev_handlers[sig] = signal.signal(sig, self._on_term)

    def restore_signal_handlers(self) -> None:
        for sig, h in self._prev_handlers.items():
            signal.signal(sig, h)

    # --- the loop ---
    def run(self, *, state: Any, step_fn: Callable, n_steps: int,
            start_step: int = 0, extra_fn: Callable | None = None,
            on_step: Callable | None = None) -> tuple:
        """Run ``state = step_fn(step, state)`` for steps [start, n_steps).

        ``extra_fn(state) -> dict`` supplies non-array state (data pipeline
        position etc.) for each checkpoint; an ``extra_fn(state, step)``
        two-argument form also receives the step being committed — the
        retry-exhausted final save commits at the *failed* step, and a
        data pipeline that already consumed that step's batch must report
        the position of the committed step, not its cursor (exactly-once).
        Returns (final_step, state).
        """
        self.install_signal_handlers()
        self._stop_requested = False
        self._abort_requested = False
        step = start_step
        try:
            while step < n_steps:
                retries = 0
                while True:
                    try:
                        t0 = time.monotonic()
                        state = step_fn(step, state)
                        dt = time.monotonic() - t0
                        break
                    except (RuntimeError, ValueError):
                        retries += 1
                        if retries > self.max_retries:
                            self._final_save(step, state, extra_fn)
                            raise
                if on_step is not None:
                    on_step(step, state, dt)
                step += 1
                if self._abort_requested:
                    break           # untrusted state: commit NOTHING
                if step % self.save_every == 0:
                    self._save(step, state, extra_fn)
                if self._term_requested or self._stop_requested:
                    self._final_save(step, state, extra_fn)
                    break
            else:
                self._final_save(step, state, extra_fn)
        finally:
            self.ckpt.wait()
            self.restore_signal_handlers()
        return step, state

    @staticmethod
    def _extra(step, state, extra_fn) -> dict:
        if extra_fn is None:
            return {}
        import inspect
        try:
            params = inspect.signature(extra_fn).parameters.values()
            # two-arg form = a second REQUIRED positional parameter; a
            # defaulted second parameter (extra_fn=lambda st, verbose=False)
            # keeps the documented one-arg contract and must not have the
            # step misbound into it
            required = [p for p in params
                        if p.kind in (p.POSITIONAL_ONLY,
                                      p.POSITIONAL_OR_KEYWORD)
                        and p.default is p.empty]
            two_arg = len(required) >= 2
        except (TypeError, ValueError):
            two_arg = False
        return extra_fn(state, step) if two_arg else extra_fn(state)

    def _save(self, step, state, extra_fn):
        extra = self._extra(step, state, extra_fn)
        if self.async_save:
            self.ckpt.save_async(step, state, extra=extra)
        else:
            self.ckpt.save(step, state, extra=extra)

    def _final_save(self, step, state, extra_fn):
        self.ckpt.wait()
        self.ckpt.save(step, state, extra=self._extra(step, state, extra_fn))
