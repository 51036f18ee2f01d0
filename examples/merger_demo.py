"""Galaxy-merger demo (BASELINE config 5 scene): two disk galaxies on a
collision course, gravity-only KDK at scale, device-side splat rendering.

On a multi-chip slice the step shards bodies over the mesh
(nbx.parallel.shard); on one device it runs the single-device path.
Default N is sized for an interactive demo on one GPU; pass n=1048576 on
four cards for the full configuration.

    python examples/merger_demo.py [n] [n_frames] [out_dir]
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from nbx import scene
from nbx.bench.latency import kdk_scan
from nbx.parallel import shard
from nbx.render import viewer
from nbx.render.colormap import tonemap
from nbx.render.splat import Camera, splat_bodies_hdr


def main(n: int = 131072, n_frames: int = 120, out_dir: str = "/tmp/nbx_merger",
         steps_per_frame: int = 4):
    os.makedirs(out_dir, exist_ok=True)
    sc = scene.galaxy_merger(n=n, separation=260.0, approach_speed=0.8, seed=0)
    G, eps, h = 0.5, 0.5, 0.02
    n_dev = len(jax.devices())
    cam = Camera(
        eye=jnp.array([0.0, 220.0, 420.0]),
        target=jnp.zeros(3),
        up=jnp.array([0.0, 1.0, 0.0]),
    )
    radius = jnp.full((n,), 0.8)
    temp = jnp.zeros((n,))
    mat = jnp.zeros((n,), jnp.int32)
    alive = jnp.ones((n,), bool)
    from nbx.config import default_materials

    mats = default_materials()

    if n_dev > 1 and n % n_dev == 0:
        mesh = shard.make_mesh(n_dev)
        st = shard.shard_state(mesh, sc["pos"], sc["vel"], sc["mass"])
        step = shard.make_sharded_step(mesh)

        def advance(st):
            for _ in range(steps_per_frame):
                st = step(st, G, eps, h)
            return st

        def render(st):
            return shard.render_sharded(mesh, st, cam, width=640, height=360)
    else:
        pos = jnp.asarray(sc["pos"])
        vel = jnp.asarray(sc["vel"])
        mass = jnp.asarray(sc["mass"])
        st = (pos, vel, jnp.zeros_like(pos))

        def advance(st):
            return kdk_scan(st[0], st[1], mass, G, eps, h, steps_per_frame,
                            acc0=st[2])

        def render(st):
            hdr = splat_bodies_hdr(
                st[0], radius, temp, mat, alive, mats.color1, mats.color2,
                cam, width=640, height=360,
            )
            return tonemap(hdr, 4.0)

    t0 = time.time()
    frames = []
    for k in range(n_frames):
        st = advance(st)
        if k % 2 == 0:
            frames.append(np.asarray(render(st)))
    wall = time.time() - t0
    viewer.write_frames(out_dir, np.stack(frames))
    rate = n * n * steps_per_frame * n_frames / wall
    print(f"{len(frames)} frames -> {out_dir}; {wall:.1f}s "
          f"({rate:.2e} pairs/s sustained incl. render+readback)")


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 131072
    f = int(sys.argv[2]) if len(sys.argv) > 2 else 120
    out = sys.argv[3] if len(sys.argv) > 3 else "/tmp/nbx_merger"
    main(n, f, out)
