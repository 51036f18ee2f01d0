"""Bench harness smoke tests (CPU paths)."""

import numpy as np

from nbx.bench.latency import step_latency_ms
from nbx.bench.throughput import measure_rate
from nbx import scene
import jax.numpy as jnp


def test_throughput_cpu_path():
    sc = scene.uniform_cube(512, seed=0)
    rate, ms, compile_s = measure_rate(
        jnp.asarray(sc["pos"]), jnp.asarray(sc["mass"]), reps=3,
        impl="blocked",
    )
    assert rate > 0 and ms > 0 and compile_s > 0


def test_latency_cpu_path():
    ms = step_latency_ms(512, reps=4, impl="blocked")
    assert ms > 0


def test_drift_run_interpret():
    """The drift gate's scan with the gravity kernel in the interpreter."""
    from nbx.bench.drift import drift_run

    sc = scene.plummer(n=128, total_mass=128.0, scale_radius=5.0, seed=1)
    p, v, e = drift_run(
        jnp.asarray(sc["pos"]), jnp.asarray(sc["vel"]), jnp.asarray(sc["mass"]),
        1.0, 1.0, 1e-3, 200, 100, interpret=True,
    )
    e = np.asarray(e)
    assert np.isfinite(e).all()
    assert np.abs(e - e[0]).max() / abs(e[0]) < 1e-3
