"""Tracing, timing, and observability.

The reference has none of this — its only timing artifact feeds a shader
uniform (/root/reference/index.html:502) and the only status output is the
mode-indicator DOM element (SURVEY.md section 5). nbx provides:

  * trace(): jax.profiler trace capture around a code block (view in
    TensorBoard / Perfetto)
  * StepTimer: wall-clock percentile latency tracking (the per-step p50
    metric in BASELINE.json)
  * MetricsLogger: JSONL sink for per-step on-device diagnostics
  * nan_guard(): opt-in NaN/Inf checking for test/debug runs — the
    memory-safety analog in an XLA-managed world (SURVEY.md section 5,
    "race detection / sanitizers")
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field

import jax
import numpy as np


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/nbx-trace"):
    """Capture a jax.profiler device trace for the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@dataclass
class StepTimer:
    """Wall-clock step latency with percentiles.

    Usage:
        timer = StepTimer()
        for _ in range(steps):
            with timer:
                state, ev = sim.step(state, cfg)
                jax.block_until_ready(state.pos)
        print(timer.summary())
    """

    samples_ms: list = field(default_factory=list)
    _t0: float = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples_ms.append((time.perf_counter() - self._t0) * 1e3)
        return False

    def percentile(self, p: float) -> float:
        return float(np.percentile(self.samples_ms, p)) if self.samples_ms else 0.0

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    def summary(self) -> dict:
        return {
            "n": len(self.samples_ms),
            "p50_ms": self.p50,
            "p90_ms": self.percentile(90),
            "p99_ms": self.p99,
            "mean_ms": float(np.mean(self.samples_ms)) if self.samples_ms else 0.0,
        }


class MetricsLogger:
    """Append-only JSONL metrics sink for per-step diagnostics
    (energy, momentum, body count, event counters — SURVEY.md section 5)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def log(self, step: int, **metrics) -> None:
        rec = {"step": step}
        for k, v in metrics.items():
            a = np.asarray(v)
            rec[k] = a.item() if a.ndim == 0 else a.tolist()
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


@contextlib.contextmanager
def nan_guard():
    """Enable jax debug-nans for the enclosed block (test/debug only — it
    forces sync dispatch). Turns silent NaN propagation into an exception at
    the producing op."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def check_finite(pytree, name: str = "state") -> None:
    """Host-side assertion that every leaf is finite (cheap post-step check
    for long unattended runs)."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(pytree):
        a = np.asarray(leaf)
        if np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all():
            key = jax.tree_util.keystr(path)
            raise FloatingPointError(f"non-finite values in {name}{key}")
