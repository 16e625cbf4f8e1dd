"""Profiling & observability (SURVEY.md §5 tracing entry).

The reference's closest analogs are GPU object labels and per-block progress
events; here JAX's profiler does the work:

  - ``trace(logdir)``: context manager around ``jax.profiler`` — dumps a
    TensorBoard/XProf trace of everything dispatched inside.
  - ``annotate(name)``: TraceAnnotation for labeling host-side phases.
  - ``Counters``: cheap throughput accounting (paths/s, rays/s, steps/s)
    shared by bench.py and session metrics.
  - ``timed(fn)``: wall time of a call that ends in ``block_until_ready``
    (JAX dispatch is asynchronous; without the wait it times the enqueue).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace: ``with trace('/tmp/tb'): session.run(64)``."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Label a host-side phase in the trace timeline."""
    import jax

    return jax.profiler.TraceAnnotation(name)


@dataclass
class Counters:
    """Accumulates work counters and reports rates."""

    t0: float = field(default_factory=time.perf_counter)
    work: Dict[str, float] = field(default_factory=dict)

    def add(self, **amounts: float):
        for key, amount in amounts.items():
            self.work[key] = self.work.get(key, 0.0) + amount

    def rates(self, elapsed: Optional[float] = None) -> Dict[str, float]:
        dt = elapsed if elapsed is not None else time.perf_counter() - self.t0
        return {f"{k}_per_s": v / dt for k, v in self.work.items()} | {"seconds": dt}


def timed(fn, *args, **kw):
    """Run ``fn`` and return (result, seconds until the result is ready)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0
