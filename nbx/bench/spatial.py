"""Spatial halo-exchange step benchmark: protocol overhead against the
single-device step.

Times nbx.parallel.spatial's halo-exchange granular step on all visible
devices against the single-device granular_full_kdk_scan on the SAME scene
and layout, in the SAME process. On one device (D=1) the gap is the
protocol overhead (migration + halo ppermutes + slot churn + PM grid
psum) with no work sharing. Both are 20-step scans, compiled ahead of
time, warmed once, then the median of 3 calls ended by block_until_ready.

    python -m nbx.bench.spatial [N] [g[,B[,Tc,Sc]]] [force]
    # defaults: 131072 32,8,96,104 pm
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import jax
import jax.numpy as jnp

from nbx.bench.granular import BOX, granular_cloud
from nbx.collisions_scaled import granular_full_kdk_scan, make_granular_state
from nbx.config import SimConfig
from nbx.parallel import shard, spatial

STEPS = 20


def _median_ms_per_step(fn, arg) -> float:
    exe = jax.jit(fn).lower(arg).compile()
    out = jax.block_until_ready(exe(arg))
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(exe(arg))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) / STEPS * 1e3, out


def main(argv):
    n = int(argv[0]) if argv else 131072
    parts = (argv[1] if len(argv) > 1 else "32,8,96,104").split(",")
    if len(parts) == 3:
        raise SystemExit(
            f"bad config {argv[1]!r}: caps need BOTH Tc,Sc (g[,B[,Tc,Sc]])"
        )
    g = int(parts[0])
    band = int(parts[1]) if len(parts) > 1 else 8
    caps = (int(parts[2]), int(parts[3])) if len(parts) > 3 else (96, 104)
    force = argv[2] if len(argv) > 2 else "pm"
    pos, vel, mass = granular_cloud(n)
    cfg = SimConfig(G=0.5, dt=0.016, sub_steps=1, merge_time=0.25,
                    fracture_threshold=8.0)
    h = cfg.dt
    d = jax.devices()[0]
    device = dict(platform=d.platform, kind=d.device_kind,
                  count=len(jax.devices()))

    st0 = make_granular_state(pos, vel, mass, key=0)
    ms_ref, (_, tot) = _median_ms_per_step(
        lambda st: granular_full_kdk_scan(
            st, cfg, BOX, n_steps=STEPS, n_cells=g, band_cells=band,
            packed_caps=caps, force_impl=force, pm_grid=128,
        ), st0)
    print(json.dumps(dict(
        path="single_device_scan", n=n, g=g, band=band, caps=caps,
        force=force, ms_per_step=ms_ref, n_bounces=int(tot["n_bounces"]),
        device=device,
    )), flush=True)

    n_dev = len(jax.devices())
    mesh = shard.make_mesh(n_dev)
    step = spatial.make_spatial_granular_step(
        mesh, cfg, BOX, g, band, caps,
        halo_cap=max(256, 2 * n // g), mig_cap=max(256, n // 64),
        force_impl=force, pm_grid=128,
    )
    st = spatial.spatial_state_for(mesh, pos, vel, mass, BOX, g)
    key = jax.random.PRNGKey(0)

    def run_scan(st):
        def body(carry, i):
            s, c = step(carry, h, jax.random.fold_in(key, i))
            return s, c

        return jax.lax.scan(body, st, jnp.arange(STEPS, dtype=jnp.int32))

    ms_sp, (_, counters) = _median_ms_per_step(run_scan, st)
    print(json.dumps(dict(
        path="spatial_halo_step", n=n, d=n_dev, g=g, band=band, caps=caps,
        force=force, ms_per_step=ms_sp, overhead_vs_single=ms_sp / ms_ref,
        n_overflow=int(jnp.max(counters["n_overflow"])),
        n_dropped=int(jnp.sum(counters["n_dropped"])),
        device=device,
    )), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
