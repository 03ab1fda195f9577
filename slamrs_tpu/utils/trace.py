"""Lightweight tracing: named spans with timing statistics.

Parity surface: the reference wires the ``tracing`` crate with span-close
timing events (baseui/src/main.rs:18-22) and instruments
``GridMapSlam::update`` (slam/src/grid/slam.rs:45); PerfStats windows show
live timings.  Here: a process-global registry of named
:class:`~slamrs_tpu.utils.perf.PerfStats`, a ``span`` context
manager/decorator that logs span-close durations, and optional forwarding
to ``jax.profiler.TraceAnnotation`` so spans show up in device profiles.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import time
from typing import Optional

from slamrs_tpu.utils.perf import PerfStats

logger = logging.getLogger("slamrs_tpu")

_REGISTRY: dict[str, PerfStats] = {}


def stats(name: str) -> PerfStats:
    s = _REGISTRY.get(name)
    if s is None:
        s = _REGISTRY[name] = PerfStats()
    return s


def all_stats() -> dict[str, PerfStats]:
    return dict(_REGISTRY)


def reset() -> None:
    _REGISTRY.clear()


@contextlib.contextmanager
def span(name: str, log_close: bool = True):
    """Timed span; mirrors FmtSpan::CLOSE logging (main.rs:18-22)."""
    try:
        import jax
        annotation = jax.profiler.TraceAnnotation(name)
    except Exception:
        annotation = contextlib.nullcontext()
    t0 = time.perf_counter()
    with annotation:
        yield
    dt = time.perf_counter() - t0
    stats(name).update(dt)
    if log_close:
        logger.debug("span %s closed: %.3f ms", name, dt * 1000.0)


def instrument(name: Optional[str] = None):
    """Decorator form (the reference's #[tracing::instrument])."""

    def wrap(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(label):
                return fn(*args, **kwargs)

        return inner

    return wrap


def report() -> str:
    """Formatted dump of every span's statistics."""
    lines = [f"{name:40s} {st}" for name, st in sorted(_REGISTRY.items())]
    return "\n".join(lines)
