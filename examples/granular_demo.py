"""Granular-dynamics demo at scale: a self-gravitating debris disk with the
FULL collision physics (bounce + friction + heating + contact-timer merges
+ fractures) running through the collision window sweep
(nbx.ops.collide + nbx.collisions_scaled) — the capability the reference
caps at 300 bodies (index.html:57), here at tens of thousands.

    python examples/granular_demo.py [n] [n_frames] [out_dir]

Default N is sized for an interactive run on one GPU; this peaked disk
scene uses the bucketed collision layout.
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from nbx.collisions_scaled import granular_full_kdk_scan, make_granular_state
from nbx.config import SimConfig, body_radius, default_materials
from nbx.render import viewer
from nbx.render.colormap import tonemap
from nbx.render.splat import Camera, splat_bodies_hdr

BOX = 100.0


def debris_disk(n: int, seed: int = 0):
    """Cold annular debris disk around a heavy core body: dense enough to
    keep contacts firing, Keplerian enough to stay bound."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(8.0, 28.0, n)
    th = rng.uniform(0, 2 * np.pi, n)
    pos = np.stack(
        [50 + r * np.cos(th), 50 + rng.normal(0, 0.4, n), 50 + r * np.sin(th)],
        axis=1,
    ).astype(np.float32)
    mass = rng.uniform(0.05, 0.4, n).astype(np.float32)
    m_core = 2000.0
    v = np.sqrt(0.5 * m_core / r)  # circular speed, G = 0.5 (ref default)
    vel = np.stack(
        [-v * np.sin(th), np.zeros(n), v * np.cos(th)], axis=1
    ).astype(np.float32)
    pos = np.concatenate([[[50.0, 50.0, 50.0]], pos]).astype(np.float32)
    vel = np.concatenate([[[0.0, 0.0, 0.0]], vel]).astype(np.float32)
    mass = np.concatenate([[m_core], mass]).astype(np.float32)
    return pos, vel, mass


def main(n: int = 32768, n_frames: int = 60, out_dir: str = "/tmp/nbx_granular",
         steps_per_frame: int = 4):
    os.makedirs(out_dir, exist_ok=True)
    cfg = SimConfig(G=0.5, dt=0.016, sub_steps=1, merge_time=0.25,
                    fracture_threshold=8.0)
    pos, vel, mass = debris_disk(n - 1)
    st = make_granular_state(pos, vel, mass, key=0)
    temp0 = st.temp.at[0].set(1000.0)  # hot core, as the reference galaxy
    st = st._replace(temp=temp0)
    cam = Camera(
        eye=jnp.asarray([50.0, 90.0, 120.0]),
        target=jnp.asarray([50.0, 50.0, 50.0]),
        up=jnp.asarray([0.0, 1.0, 0.0]),
    )
    mats = default_materials()
    totals_sum = dict(n_bounces=0, n_merges=0, n_fractures=0)
    # The disk is a PEAKED scene (a thin annulus: a few per cent of windows
    # hold all bodies), so the bucketed layout is the right tool — uniform
    # packed caps would have to cover the densest window everywhere.
    from nbx.ops.collide import bucketed_layout_for

    buckets = bucketed_layout_for(st.pos, BOX, 28, 6)
    t0 = time.time()
    for f in range(n_frames):
        st, totals = granular_full_kdk_scan(
            st, cfg, BOX, n_steps=steps_per_frame,
            n_cells=28, band_cells=6, buckets=buckets, force_impl="auto",
        )
        for k in ("n_bounces", "n_merges", "n_fractures"):
            totals_sum[k] += int(totals[k])
        alive = st.mass > 0
        radius = body_radius(st.mass, st.mat, mats)
        hdr = splat_bodies_hdr(
            st.pos, radius, st.temp, st.mat, alive,
            mats.color1, mats.color2, cam, width=640, height=360,
        )
        img = np.asarray(tonemap(hdr, exposure=2.5))
        viewer.write_png(os.path.join(out_dir, f"frame_{f:04d}.png"), img)
        if f % 10 == 0:
            print(
                f"frame {f}: alive={int(alive.sum())} "
                f"bounces={totals_sum['n_bounces']} "
                f"merges={totals_sum['n_merges']} "
                f"fractures={totals_sum['n_fractures']}",
                flush=True,
            )
    dt = time.time() - t0
    print(
        f"{n_frames} frames x {steps_per_frame} steps at N={n}: "
        f"{dt / n_frames * 1e3:.0f} ms/frame -> {out_dir} "
        f"(totals: {totals_sum})"
    )
    return totals_sum


if __name__ == "__main__":
    a = sys.argv[1:]
    main(*(int(x) if x.isdigit() else x for x in a))
