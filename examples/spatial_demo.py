"""Spatial halo-exchange demo: the O(N/D)-memory sharded granular path.

    python examples/spatial_demo.py [n_bodies] [n_steps] [out_dir]
    # defaults: 8192 60 /tmp/nbx_spatial

Runs a converging debris cloud under PM gravity with full collision
physics (bounce/timers/merge/fracture) on the spatially-owned sharded
step (nbx.parallel.spatial): bodies live on the chip that owns their
x-slab of the collision grid, migrate via ppermute when they cross, and
see their neighbors through boundary-layer halo exchanges — per-chip
memory O(N/D). On a single device this still exercises the full protocol
(D=1); under `JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_
device_count=8` it runs genuinely sharded. Renders a PNG strip
DEVICE-SIDE from the slab-owned state (per-chip splat + one image psum,
nbx.parallel.spatial.render_spatial): no body gather, one [H, W, 3]
readback per snapshot regardless of N.
"""

import os
import sys

import jax
import numpy as np

from nbx.config import SimConfig
from nbx.parallel import shard, spatial

BOX = 100.0


def main(n: int = 8192, n_steps: int = 60, out_dir: str = "/tmp/nbx_spatial"):
    rng = np.random.default_rng(0)
    pos = rng.uniform(15, 85, (n, 3)).astype(np.float32)
    vel = ((50.0 - pos) * 0.03 + rng.normal(0, 0.4, (n, 3))).astype(
        np.float32
    )
    mass = rng.uniform(0.2, 1.0, n).astype(np.float32)

    cfg = SimConfig(G=0.5, dt=0.016, sub_steps=1, merge_time=0.1,
                    fracture_threshold=6.0)
    import math

    d = len(jax.devices())
    g = 16 * d // math.gcd(16, d)  # lcm(16, d): any device count works
    mesh = shard.make_mesh(d)
    step = spatial.make_spatial_granular_step(
        mesh, cfg, BOX, g, band_cells=4, packed_caps=(96, 256),
        halo_cap=max(256, 4 * n // g), mig_cap=max(128, n // 32),
        force_impl="pm", pm_grid=64,
    )
    st = spatial.spatial_state_for(mesh, pos, vel, mass, BOX, g)
    key = jax.random.PRNGKey(0)

    os.makedirs(out_dir, exist_ok=True)
    from nbx.render.splat import Camera

    cam = Camera.default()
    shots = []
    for i in range(n_steps):
        st, c = step(st, cfg.dt, jax.random.fold_in(key, i))
        if i % max(1, n_steps // 6) == 0 or i == n_steps - 1:
            live = np.asarray(st.mass) > 0
            print(
                f"step {i:4d}: alive={int(live.sum())} "
                f"bounces={int(c['n_bounces'])} merges={int(c['n_merges'])} "
                f"fractures={int(c['n_fractures'])} "
                f"transit={int(c['in_transit'])} "
                f"overflow={int(c['n_overflow'])}",
                flush=True,
            )
            # device-side: per-chip splat of OWNED slots + one image psum
            # (no body gather; one [H, W, 3] readback regardless of N)
            img = spatial.render_spatial(
                mesh, st, cfg, cam, width=480, height=270,
            )
            shots.append(np.asarray(img))
    try:
        import imageio.v2 as iio

        strip = np.concatenate(shots[:6], axis=1)
        path = os.path.join(out_dir, "spatial_strip.png")
        iio.imwrite(path, (np.clip(strip, 0, 1) * 255).astype(np.uint8))
        print("wrote", path)
    except ImportError:
        print("imageio missing — skipped PNG strip")


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]) if a else 8192, int(a[1]) if len(a) > 1 else 60,
         a[2] if len(a) > 2 else "/tmp/nbx_spatial")
