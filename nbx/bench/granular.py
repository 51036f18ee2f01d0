"""Granular full-physics step benchmark: collision layout configs.

Times granular_full_kdk_scan (gravity + window-sweep collisions with
merge/fracture/timers + thermal) per step at scale, for a list of layout
configurations.

    python -m nbx.bench.granular [N[,N...]] [scene] [force] [cfg ...]
    # scene: disk (contact-rich annulus) | cloud (uniform) | cloud@<box>
    #        (explicit box) | cloudcd (box ~ N^(1/3): constant density
    #        vs the 131k scene)
    # force: zero (isolates collisions) | pallas | blocked | pm | ...
    # cfg:   g,B,Tc,Sc   packed layout with caps (Tc target rows, Sc
    #                    source lanes per guarded strip)
    #        g,B,a[q]    packed, caps from packed_caps_for (quantile q)
    #        g,B,u[q][s|g]  bucketed, bucketed_layout_for(split q), with
    #                    the slice or grid strips construction

Timing: one warm-up call of the exact executable, then the median of
`reps` calls of an s_steps-step scan, each ended by block_until_ready;
compile time is reported separately. Prints one JSON line per config with
the device.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import jax
import numpy as np

from nbx.collisions_scaled import granular_full_kdk_scan, make_granular_state
from nbx.config import SimConfig

BOX = 100.0


def debris_disk(n: int, seed: int = 0):
    """Annular debris disk (examples/granular_demo.py) — contact-rich.

    Masses scale as 32768/n beyond the demo's N so the TOTAL body volume
    stays ~the annulus volume: at fixed mass the 131k disk would be ~4x
    over-packed (unphysical) and nearly every body would overflow its cell.
    """
    rng = np.random.default_rng(seed)
    r = rng.uniform(8.0, 28.0, n)
    th = rng.uniform(0, 2 * np.pi, n)
    pos = np.stack(
        [50 + r * np.cos(th), 50 + rng.normal(0, 0.4, n), 50 + r * np.sin(th)],
        axis=1,
    ).astype(np.float32)
    mass = (rng.uniform(0.05, 0.4, n) * min(1.0, 32768 / n)).astype(
        np.float32
    )
    v = np.sqrt(0.5 * 2000.0 / r)
    vel = np.stack(
        [-v * np.sin(th), np.zeros(n), v * np.cos(th)], axis=1
    ).astype(np.float32)
    # The demo's central m=2000 body has radius ~7.8 — larger than any
    # sane cell at this N, so it alone would trip cell_too_small and
    # poison every binned measurement. It only matters for orbital
    # gravity, which a 20-step collision bench doesn't resolve: park the
    # slot dead (mass 0 = exerts nothing, skips collisions).
    pos = np.concatenate([[[50.0, 50.0, 50.0]], pos]).astype(np.float32)
    vel = np.concatenate([[[0.0, 0.0, 0.0]], vel]).astype(np.float32)
    mass = np.concatenate([[0.0], mass]).astype(np.float32)
    return pos, vel, mass


def granular_cloud(n: int, seed: int = 0, box: float = BOX):
    """Uniform cloud in [0.1 box, 0.9 box)^3 with converging velocity
    jitter — near-uniform cell occupancy (exact binning at sane K),
    contacts fire."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.1 * box, 0.9 * box, (n, 3)).astype(np.float32)
    vel = (
        (0.5 * box - pos) * 0.02 + rng.normal(0, 0.3, (n, 3))
    ).astype(np.float32)
    mass = rng.uniform(0.05, 0.4, n).astype(np.float32)
    return pos, vel, mass


def time_config(st0, cfg, g, band, steps=10, reps=5, force_impl="pm",
                pm_grid=128, packed=None, buckets=None, box: float = BOX,
                construction: str = "auto"):
    """(ms per step, compile seconds, totals) of a `steps`-step scan."""
    fn = jax.jit(lambda st: granular_full_kdk_scan(
        st, cfg, box, n_steps=steps, n_cells=g, band_cells=band,
        packed_caps=packed, buckets=buckets, force_impl=force_impl,
        pm_grid=pm_grid, construction=construction,
    ))
    t0 = time.perf_counter()
    exe = fn.lower(st0).compile()
    compile_s = time.perf_counter() - t0
    _, totals = jax.block_until_ready(exe(st0))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(exe(st0))
        ts.append(time.perf_counter() - t0)
    ms = statistics.median(ts) / steps * 1e3
    return ms, compile_s, {k: int(v) for k, v in totals.items()}


def _parse_cfg(a: str):
    parts = a.split(",")
    g, band = int(parts[0]), int(parts[1])
    tok = parts[2] if len(parts) > 2 else "u"
    if tok[0] in "au":
        rest, constr = tok[1:], "auto"
        if rest and rest[-1] in "sg":
            constr = {"s": "slice", "g": "grid"}[rest[-1]]
            rest = rest[:-1]
        q = float(rest) if rest else (0.8 if tok[0] == "u" else 1.0)
        return g, band, ("bucket" if tok[0] == "u" else "auto", q, constr)
    if len(parts) != 4:
        raise SystemExit(f"bad cfg {a!r}: g,B,Tc,Sc | g,B,a[q] | g,B,u[q]")
    return g, band, (int(parts[2]), int(parts[3]))


def main(argv):
    ns = ([int(x) for x in argv[0].split(",")] if argv else [131072])
    scene = argv[1] if len(argv) > 1 else "cloud"
    force = argv[2] if len(argv) > 2 else "pm"
    cfgs = [_parse_cfg(a) for a in argv[3:]] or [_parse_cfg("40,12,u")]
    d = jax.devices()[0]
    device = dict(platform=d.platform, kind=d.device_kind,
                  count=len(jax.devices()))
    for n in ns:
        box = BOX
        sc = scene
        if sc.startswith("cloud@"):
            box, sc = float(sc.split("@", 1)[1]), "cloud"
        elif sc == "cloudcd":
            box, sc = BOX * (n / 131072.0) ** (1.0 / 3.0), "cloud"
        if sc == "cloud":
            pos, vel, mass = granular_cloud(n, box=box)
        else:
            pos, vel, mass = debris_disk(n - 1)
        st0 = make_granular_state(pos, vel, mass, key=0)
        cfg = SimConfig(G=0.5, dt=0.016, sub_steps=1, merge_time=0.25,
                        fracture_threshold=8.0)
        for g, band, lay in cfgs:
            packed, buckets, constr = None, None, "auto"
            if lay[0] == "bucket":
                from nbx.ops.collide import bucketed_layout_for

                buckets = bucketed_layout_for(st0.pos, box, g, band,
                                              split_quantile=lay[1])
                constr = lay[2]
            elif lay[0] == "auto":
                from nbx.ops.collide import packed_caps_for

                packed = packed_caps_for(st0.pos, box, g, band,
                                         quantile=lay[1])
            else:
                packed = lay
            ms, compile_s, totals = time_config(
                st0, cfg, g, band, force_impl=force, packed=packed,
                buckets=buckets, box=box, construction=constr,
            )
            print(json.dumps(dict(
                n=n, scene=sc, force=force, box=box, n_cells=g,
                band_cells=band, packed_caps=packed, buckets=buckets,
                construction=constr, ms_per_step=ms, compile_s=compile_s,
                **totals, device=device,
            )), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
