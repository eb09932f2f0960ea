"""Observability: timers, throughput meters, and profiler hooks.

The reference's only runtime metrics are an fps print once per second
(/root/reference/src/main.rs:488-496) and a triangle count at startup
(main.rs:456-459); its profiling workflow was external `perf` (SURVEY.md
§5). Here the equivalents are first-class: a RateMeter for fps/rays-per-
second, wall-clock timers that block on device work, and a context manager
around `jax.profiler.trace` producing xprof/tensorboard traces for
per-kernel analysis on the device.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

import jax

log = logging.getLogger("raytracing_tpu")


@dataclass
class RateMeter:
    """Windowed throughput meter: call tick(units) per frame/batch; emits a
    rate line at most once per `interval` seconds (the reference's once-a-
    second fps print, generalized)."""

    name: str = "fps"
    interval: float = 1.0
    _count: float = 0.0
    _t0: float = field(default_factory=time.perf_counter)
    last_rate: Optional[float] = None

    def tick(self, units: float = 1.0, emit=print) -> Optional[float]:
        self._count += units
        now = time.perf_counter()
        dt = now - self._t0
        if dt >= self.interval:
            self.last_rate = self._count / dt
            if emit:
                emit(f"{self.name}: {self.last_rate:.6g}")
            self._count = 0.0
            self._t0 = now
            return self.last_rate
        return None


@contextlib.contextmanager
def timed(label: str, sync: bool = True) -> Iterator[dict]:
    """Wall-clock timer; `sync` waits for all live device work via a
    throwaway blocking op so async dispatch can't lie."""
    out: dict = {}
    t0 = time.perf_counter()
    yield out
    if sync:
        jax.block_until_ready(jax.device_put(0))
    out["seconds"] = time.perf_counter() - t0
    log.info("%s: %.4fs", label, out["seconds"])


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]) -> Iterator[None]:
    """jax.profiler trace (xprof) when a logdir is given; no-op otherwise."""
    if not logdir:
        yield
        return
    with jax.profiler.trace(logdir):
        yield
    log.info("profiler trace written to %s", logdir)


def device_summary() -> str:
    devs = jax.devices()
    return f"{len(devs)} x {devs[0].device_kind} ({jax.default_backend()})"
