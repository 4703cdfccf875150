"""Profiling / tracing hooks.

Replaces the reference's hand-rolled wall-clock prints
(``energy_calculator.py:42-45, 103-106``; ``monte_carlo.py:195-221``) with:

* ``trace(...)``     — a ``jax.profiler`` trace context writing a TensorBoard
  profile of the device program;
* ``PhaseTimer``     — per-phase step timing with JSONL persistence, the
  structured counterpart of the reference's ``*_times`` lists;
* ``annotate(name)`` — a ``TraceAnnotation`` wrapper so phases show up in
  the profiler timeline.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Dict, Iterator, List

import jax


# The cache's default home: a fixed directory inside the checkout (the path
# is part of the cache key, so it must not move between runs).
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compilation_cache_dir() -> str:
    """Where the persistent compilation cache lives:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache so repeated runs skip
    recompiles.  JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; only
    without it is the directory set here."""
    directory = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(directory, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", directory)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return directory


def gpu_name_and_power() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them (a
    card below its maximum power runs slower under load)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device profile under ``log_dir`` (TensorBoard format)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region visible in the profiler timeline."""
    return jax.profiler.TraceAnnotation(name)


class PhaseTimer:
    """Accumulates wall-clock timings per named phase."""

    def __init__(self, metrics=None):
        self.times: Dict[str, List[float]] = {}
        self.metrics = metrics

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None) -> Iterator[None]:
        """Time a phase; pass a jax array via ``sync_on`` to block on it."""
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            jax.block_until_ready(sync_on)
        dt = time.perf_counter() - t0
        self.times.setdefault(name, []).append(dt)
        if self.metrics is not None:
            self.metrics.log("phase_time", phase=name, seconds=dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            out[name] = {"count": len(ts), "total_s": sum(ts),
                         "mean_s": sum(ts) / len(ts)}
        return out
