"""Lightweight observability: step-rate counters and profiler traces.

The reference's only timing is a wall-clock print in the ANM6Easy demo
(``anm6_easy.py:143-151``); SURVEY §5 calls for step-rate counters plus
``jax.profiler`` traces.  Two tools:

``StepRateCounter``
    A host-side throughput meter for rollout loops.  Records
    (steps, seconds) pairs per program call and reports total / median
    rates.  Median-of-calls damps host-side noise (dispatch jitter, a
    shared CPU) in single-call timings.

``trace``
    Context manager around ``jax.profiler`` that writes a TensorBoard-
    loadable trace directory, for inspecting fusion/HLO-level behavior of
    the compiled step.

Example::

    counter = StepRateCounter()
    for k in keys:
        with counter.measure(batch * n_steps):
            es, (rew, term) = run(es, k)
            jax.block_until_ready(rew)
    print(counter.summary())
"""

from __future__ import annotations

import contextlib
import statistics
import time

import jax

__all__ = ["StepRateCounter", "trace"]


class StepRateCounter:
    """Accumulates (env-steps, wall-seconds) samples; reports rates."""

    def __init__(self):
        self._samples: list[tuple[int, float]] = []

    @contextlib.contextmanager
    def measure(self, n_steps: int):
        """Time a block that executes ``n_steps`` environment steps.

        The caller is responsible for blocking on the result inside the
        block (``jax.block_until_ready``); async dispatch would otherwise
        end the timer before the device finishes.
        """
        t0 = time.perf_counter()
        yield
        self._samples.append((int(n_steps), time.perf_counter() - t0))

    @property
    def n_samples(self) -> int:
        return len(self._samples)

    @property
    def total_steps(self) -> int:
        return sum(n for n, _ in self._samples)

    @property
    def total_seconds(self) -> float:
        return sum(t for _, t in self._samples)

    def rate(self) -> float:
        """Aggregate steps/s over all samples."""
        return self.total_steps / self.total_seconds if self.total_seconds else 0.0

    def median_rate(self) -> float:
        """Median of per-sample rates (robust to queueing outliers)."""
        if not self._samples:
            return 0.0
        return statistics.median(n / t for n, t in self._samples if t > 0)

    def reset(self) -> None:
        self._samples.clear()

    def summary(self) -> dict:
        return {
            "samples": self.n_samples,
            "total_steps": self.total_steps,
            "total_seconds": self.total_seconds,
            "steps_per_s": self.rate(),
            "median_steps_per_s": self.median_rate(),
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``jax.profiler`` trace of the enclosed block.

    View with TensorBoard's profile plugin or Perfetto
    (``tensorboard --logdir <log_dir>``).
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
