"""Per-step latency of the gravity-only KDK step across N = 1k..1M.

Each measurement compiles a `reps`-step lax.scan ahead of time, warms it
once, and reports the median over 3 timed calls (each ended by
block_until_ready) divided by reps: the steady-state per-step device time.

Usage: python -m nbx.bench.latency [reps]
"""

from __future__ import annotations

import functools
import json
import statistics
import sys
import time

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("reps", "impl"))
def kdk_scan(pos, vel, mass, G, eps, h, reps: int, impl: str = "auto",
             acc0=None):
    """reps KDK steps under one scan with nbx.sim.gravity(impl). Returns
    (pos, vel, acc) so callers stepping frame-by-frame can carry the
    acceleration (leapfrog continuity); acc0 defaults to zeros — the
    reference's fresh-body convention."""
    from nbx.sim import gravity

    def body(c, _):
        p, v, a = c
        v = v + a * (0.5 * h)
        p = p + v * h
        a = gravity(p, mass, G, eps, impl)
        v = v + a * (0.5 * h)
        return (p, v, a), None

    if acc0 is None:
        acc0 = jnp.zeros_like(pos)
    (p, v, a), _ = jax.lax.scan(body, (pos, vel, acc0), None, length=reps)
    return p, v, a


def step_latency_ms(n: int, reps: int = 20, impl: str = "auto") -> float:
    from nbx import scene

    sc = scene.plummer(n=n, total_mass=float(n), scale_radius=10.0, seed=0)
    args = (jnp.asarray(sc["pos"]), jnp.asarray(sc["vel"]),
            jnp.asarray(sc["mass"]), 1.0, 0.1, 1e-4)
    exe = kdk_scan.lower(*args, reps=reps, impl=impl).compile()
    jax.block_until_ready(exe(*args))
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(exe(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) / reps * 1e3


def main(reps: int | None = None):
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit("nbx.bench.latency measures the GPU; none found")
    ns = [1024, 4096, 16384, 65536, 262144, 1048576]
    default_reps = {1024: 400, 4096: 400, 16384: 200, 65536: 50,
                    262144: 10, 1048576: 2}
    out = {}
    for n in ns:
        r = reps or default_reps[n]
        out[n] = step_latency_ms(n, r)
        print(f"N={n}: {out[n]:.3f} ms/step ({r} reps)", file=sys.stderr,
              flush=True)
    print(json.dumps({"metric": "step_latency_ms", "by_n": out,
                      "device": dict(platform=d.platform, kind=d.device_kind,
                                     count=len(jax.devices()))}))
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else None)
