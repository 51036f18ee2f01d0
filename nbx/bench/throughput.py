"""Direct-sum gravity throughput: pair interactions per second.

One force evaluation through nbx.sim.gravity is compiled ahead of time
(compile time reported separately), run once to warm up, then timed `reps`
times, each call ended by block_until_ready; the median is reported.

Usage: python -m nbx.bench.throughput [n] [reps] [impl[,impl...]]

impl is a nbx.sim.gravity dispatcher ("auto", "pallas", "blocked"); a comma
list times each in this one process.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import jax
import jax.numpy as jnp


def measure_rate(pos, mass, G=0.5, eps=0.5, reps: int = 10,
                 impl: str = "auto") -> tuple[float, float, float]:
    """Returns (pairs_per_sec, ms_per_eval, compile_seconds)."""
    from nbx.sim import gravity

    fn = jax.jit(lambda p, m: gravity(p, m, G, eps, impl))
    t0 = time.perf_counter()
    exe = fn.lower(pos, mass).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(exe(pos, mass))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(exe(pos, mass))
        ts.append(time.perf_counter() - t0)
    dt = statistics.median(ts)
    n = pos.shape[0]
    return n * n / dt, dt * 1e3, compile_s


def main(n: int = 262144, reps: int = 10, impls: str = "auto"):
    from nbx import scene

    d = jax.devices()[0]
    device = dict(platform=d.platform, kind=d.device_kind,
                  count=len(jax.devices()))
    sc = scene.cold_collapse_disk(n=n, seed=0)
    pos = jnp.asarray(sc["pos"])
    mass = jnp.asarray(sc["mass"])
    for impl in impls.split(","):
        rate, ms, compile_s = measure_rate(pos, mass, reps=reps, impl=impl)
        print(json.dumps(dict(metric="pairs_per_sec", value=rate, n=n,
                              impl=impl, ms_per_eval=ms,
                              compile_s=compile_s, device=device)))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 262144,
         int(sys.argv[2]) if len(sys.argv) > 2 else 10,
         sys.argv[3] if len(sys.argv) > 3 else "auto")
