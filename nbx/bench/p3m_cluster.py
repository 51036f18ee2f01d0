"""P3M clustered-scene benchmark: dense vs two-level residual.

A 1M scene with a 30k dense core overflows the P3M cell binning, and the
exact dense [M, M] residual-residual block grows as M^2.
residual_mode='twolevel' replaces that block with a refined submesh (band
FFT + fine binned PP). This bench measures both on the same scene:
seconds/eval (median of 3 after a warm-up, block_until_ready) + median
relative force error (overall, core, field) against a direct-sum
reference on a body sample (nbx.forces.accelerations_blocked with target
rows).

    python -m nbx.bench.p3m_cluster [n_total] [n_core] [mode ...]
    # defaults: 1000000 30000 dense twolevel
    # mode = dense|twolevel, optionally with a tune suffix
    #   mode@n_cells,K   e.g. dense@12,768
    # The accuracy-resolving tune needs h <= a/1.7 => n_cells <= g/5.1
    # (n_cells=12 at g=64).
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from nbx.ops.p3m import p3m_acceleration

BOX = 100.0
EPS = 0.1


def cluster_scene(n_total: int, n_core: int, sigma: float = 1.5,
                  seed: int = 0):
    """Quasi-uniform field across the full box — the uniform-cell premise
    holds for the bulk (1M over 25^3 cells = 64/cell < K=96) — plus a
    dense sigma=1.5 core at the center that overflows its cells."""
    rng = np.random.default_rng(seed)
    n_field = n_total - n_core
    field = rng.uniform(2.0, 98.0, (n_field, 3))
    core = rng.normal(50.0, sigma, (n_core, 3))
    core = np.clip(core, 2.0, 98.0)
    pos = np.concatenate([field, core]).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n_total).astype(np.float32)
    return jnp.asarray(pos), jnp.asarray(mass), n_field


def sample_errors(pos, mass, acc, n_field, n_sample: int = 4096, seed=1):
    """Median relative error vs direct sum on a half-field/half-core
    sample (sample targets x ALL sources)."""
    from nbx.forces import accelerations_blocked

    rng = np.random.default_rng(seed)
    n = pos.shape[0]
    half = n_sample // 2
    idx = np.concatenate([
        rng.choice(n_field, half, replace=False),
        n_field + rng.choice(n - n_field, half, replace=False),
    ])
    tgt = pos[jnp.asarray(idx)]
    ref = np.asarray(
        accelerations_blocked(pos, mass, 1.0, EPS, 256, target_pos=tgt))
    got = np.asarray(acc)[idx]
    err = np.linalg.norm(got - ref, axis=1) / (
        np.linalg.norm(ref, axis=1) + 1e-9
    )
    return dict(
        median=float(np.median(err)),
        core_median=float(np.median(err[half:])),
        field_median=float(np.median(err[:half])),
    )


def main(argv):
    n_total = int(argv[0]) if argv else 1_000_000
    n_core = int(argv[1]) if len(argv) > 1 else 30_000
    modes = argv[2:] or ["dense", "twolevel"]
    pos, mass, n_field = cluster_scene(n_total, n_core)

    for spec in modes:
        mode, n_cells, k = spec, 25, 96
        if "@" in spec:
            mode, rest = spec.split("@", 1)
            n_cells, k = (int(x) for x in rest.split(",")[:2])
        # Submesh: cost is subcells * 27 * sub_k^2 regardless of occupancy,
        # so size sub_k to the peak submesh-cell density and refine
        # sub_cells; sub_g must resolve a1 (>= 3*sub_cells, enforced).
        kw = dict(
            g=64, n_cells=n_cells, max_per_cell=k, eps=EPS,
            max_residual=32768, residual_mode=mode,
            sub_g=96, sub_cells=24, sub_k=96,
        )
        acc, unc = jax.block_until_ready(
            p3m_acceleration(pos, mass, 1.0, BOX, **kw))  # warm
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            acc, unc = jax.block_until_ready(
                p3m_acceleration(pos, mass, 1.0, BOX, **kw))
            ts.append(time.perf_counter() - t0)
        errs = sample_errors(pos, mass, acc, n_field)
        print(json.dumps(dict(
            n=n_total, n_core=n_core, mode=spec,
            s_per_eval=statistics.median(ts), n_uncorrected=int(unc), **errs,
            device=jax.devices()[0].device_kind,
        )), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
