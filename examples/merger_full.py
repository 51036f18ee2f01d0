"""BASELINE config 5 as ONE artifact: the 1M-body FULL-physics rendered
galaxy merger — P3M gravity (auto-tuned accurate split) + band-packed
bucketed collisions (bounce/merge/fracture/timers) + thermal decay +
device-side frame rendering (splat + impostors + tiered trails + event
flashes + bloom), one scan dispatch and one render dispatch per frame.

This is the assembly of the separately-tested pieces:
the granular full-physics scan (nbx.collisions_scaled, force_impl="p3m"),
the scene-census P3M tune (nbx.ops.p3m.p3m_tune_for), the occupancy-
bucketed collision layout (nbx.ops.collide.bucketed_layout_for) and the
at-scale frame renderer (nbx.render.pipeline.render_granular).

Scenario semantics: two reference-recipe galaxies on a bound grazing
course (/root/reference/index.html:744-766), scaled 3493x past the
reference's 300-body cap; physics per index.html:247-443.

    python examples/merger_full.py [n] [n_frames] [out_dir] [steps_per_frame]

Without a GPU, pass a small n (e.g. 2048 4): the plain XLA paths run
the same assembly anywhere.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def main(n: int = 1_048_576, n_frames: int = 180,
         out_dir: str = "/tmp/nbx_merger_full", steps_per_frame: int = 2,
         width: int = 640, height: int = 360):
    import jax.numpy as jnp

    from nbx import scene
    from nbx.collisions_scaled import granular_full_kdk_scan, make_granular_state
    from nbx.config import SimConfig, body_radius
    from nbx.ops.collide import bucketed_layout_for
    from nbx.ops.p3m import p3m_tune_for
    from nbx.render import viewer
    from nbx.render.pipeline import (
        FrameState, render_granular, starfield_directions,
    )
    from nbx.render.splat import Camera


    os.makedirs(out_dir, exist_ok=True)
    sc, box = scene.galaxy_merger_3d(n=n, seed=0)

    # ---- gravity: scene-census P3M tune ---------------------------------
    tune = p3m_tune_for(
        sc["pos"], box, residual_budget=131072,
        k_max=1536,
    )
    print(f"[merger_full] p3m tune: {tune}", file=sys.stderr)

    # ---- collisions: cell >= 2 r_max, occupancy-bucketed caps -----------
    cfg = SimConfig(G=0.5, dt=0.35, sub_steps=1, softening=0.5,
                    merge_time=0.5, fracture_threshold=25.0,
                    max_fractures=32)
    r_max = float(np.max(np.asarray(body_radius(
        jnp.asarray(sc["mass"]), jnp.asarray(sc["mat"]), cfg.materials))))
    g_c = min(64, int(box / (2.2 * r_max)))
    g_c = max(8, g_c - g_c % 2)
    # B=8 at 1M: taller bands push the bucketed tail caps past
    # bucketed_layout_for's source-lane bound at this occupancy
    band = 8 if g_c >= 16 else 2
    buckets = bucketed_layout_for(sc["pos"], box, g_c, band)
    print(f"[merger_full] collisions: g={g_c} band={band} buckets={buckets}",
          file=sys.stderr)

    st = make_granular_state(
        sc["pos"], sc["vel"], sc["mass"], mat=sc["mat"], temp=sc["temp"],
        key=0,
    )

    # ---- renderer: tiered trails on the heaviest bodies ------------------
    n_trails = min(512, n)
    trail_idx = jnp.asarray(
        np.argsort(-sc["mass"])[:n_trails].astype(np.int32))
    frame = FrameState.create(capacity=n_trails, trail_length=40)
    stars = starfield_directions()
    cam = Camera(
        eye=jnp.array([0.5 * box, 0.92 * box, 1.55 * box], jnp.float32),
        target=jnp.full((3,), 0.5 * box, jnp.float32),
        up=jnp.array([0.0, 1.0, 0.0], jnp.float32),
    )

    # scene-constant: one smoothed Green's-function rfftn for the whole
    # frame loop instead of one per granular_full_kdk_scan call
    from nbx.ops.pm import isolated_green_hat

    green_hat = isolated_green_hat(
        box, tune["g"], box / tune["n_cells"] / 3.0, smoothed=True)

    def advance(st):
        return granular_full_kdk_scan(
            st, cfg, box, n_steps=steps_per_frame, n_cells=g_c,
            band_cells=band, buckets=buckets, force_impl="p3m",
            pm_grid=tune["g"], p3m_cells=tune["n_cells"],
            p3m_k=tune["max_per_cell"],
            p3m_max_residual=tune["max_residual"],
            log_events=True, green_hat=green_hat,
        )

    def render(frame, st, ev):
        return render_granular(
            frame, st, cfg, ev, cam, trail_idx, width=width, height=height,
            stars=stars, exposure=2.0, n_impostors=64,
        )

    # ---- frame loop: one scan dispatch + one render dispatch per frame ---
    t_total0 = time.time()
    step_ms, render_ms = [], []
    counters = dict(n_bounces=0, n_merges=0, n_fractures=0, n_dropped=0)
    ovf = unc = 0
    frames = []
    for k in range(n_frames):
        t0 = time.time()
        st, totals, ev = advance(st)
        np.asarray(st.pos)  # materialize = the only reliable sync
        t1 = time.time()
        frame, img = render(frame, st, ev)
        frames.append(np.asarray(img))
        t2 = time.time()
        step_ms.append((t1 - t0) * 1e3 / steps_per_frame)
        render_ms.append((t2 - t1) * 1e3)
        for key in counters:
            counters[key] += int(totals[key])
        ovf = max(ovf, int(totals["n_overflow"]))
        unc = max(unc, int(totals["n_uncorrected"]))
        if k % 10 == 0 or k == n_frames - 1:
            print(
                f"[merger_full] frame {k}: step {step_ms[-1]:.0f} ms "
                f"render {render_ms[-1]:.0f} ms  merges={counters['n_merges']}"
                f" fractures={counters['n_fractures']}"
                f" bounces={counters['n_bounces']} ovf={ovf} unc={unc}",
                file=sys.stderr, flush=True,
            )
    wall = time.time() - t_total0

    viewer.write_frames(out_dir, np.stack(frames))
    # warm per-frame numbers: drop the first frame (compile)
    s_ms = np.asarray(step_ms[1:] or step_ms)
    r_ms = np.asarray(render_ms[1:] or render_ms)
    result = dict(
        n=n, n_frames=n_frames, steps_per_frame=steps_per_frame, box=box,
        p3m=dict(g=tune["g"], n_cells=tune["n_cells"],
                 k=tune["max_per_cell"], a_over_h=round(tune["a_over_h"], 3)),
        collisions=dict(g=g_c, band=band),
        ms_per_step_p50=round(float(np.median(s_ms)), 1),
        ms_per_render_p50=round(float(np.median(r_ms)), 1),
        s_per_frame_p50=round(
            float(np.median(s_ms)) * steps_per_frame / 1e3
            + float(np.median(r_ms)) / 1e3, 2),
        wall_s=round(wall, 1),
        n_overflow_max=ovf, n_uncorrected_max=unc, **counters,
    )
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_048_576
    f = int(sys.argv[2]) if len(sys.argv) > 2 else 180
    out = sys.argv[3] if len(sys.argv) > 3 else "/tmp/nbx_merger_full"
    spf = int(sys.argv[4]) if len(sys.argv) > 4 else 2
    main(n, f, out, spf)
