"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline: direct-sum gravity, pair interactions per second on one GPU at
N = 262,144 (the cold-collapse disk, seed 0), through nbx.sim.gravity.
Compile time is reported separately from the timed runs; the device is on
the line. There is no fallback: without a GPU the harness fails.

    python bench.py
"""

import json
import sys


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nbx import scene
    from nbx.backend import enable_compile_cache
    from nbx.bench.throughput import measure_rate
    from nbx.sim import gravity

    enable_compile_cache()
    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; found {d.platform}")
    n = 262144
    sc = scene.cold_collapse_disk(n=n, seed=0)
    pos = jnp.asarray(sc["pos"])
    mass = jnp.asarray(sc["mass"])
    rate, ms, compile_s = measure_rate(pos, mass, 0.5, 0.5, reps=10)
    acc = np.asarray(gravity(pos, mass, 0.5, 0.5))
    assert np.isfinite(acc).all(), "non-finite accelerations"
    print(json.dumps({
        "metric": "pairwise_interactions_per_sec",
        "value": rate,
        "unit": "pairs/s",
        "ms_per_eval": ms,
        "compile_s": compile_s,
        "n": n,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
