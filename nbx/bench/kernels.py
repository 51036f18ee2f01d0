"""Each hand-written kernel against its plain XLA version, on the card.

For every mechanism in nbx.backend.GPU_CHOICE the same end-to-end
computation is compiled twice — once with the Pallas-Triton kernel, once
with the plain jax.numpy version — and the two executables are timed in
turns (block_until_ready, median of `reps` runs after a warm-up run each)
and compared for agreement:

  * gravity: nbx.sim.gravity(impl="auto") on the 262,144-body
    cold-collapse disk (seed 0);
  * collide: 10 steps of collisions_scaled.granular_full_kdk_scan at
    131,072 bodies with serve --big's settings (n_cells=40, band_cells=12,
    bucketed_layout_for, PM gravity on a 64^3 mesh).

Prints one JSON line per mechanism with both medians, the compile times and
the device. Needs a GPU: the comparison is meaningless elsewhere.

    python -m nbx.bench.kernels [reps]
"""

from __future__ import annotations

import contextlib
import json
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from nbx import backend


@contextlib.contextmanager
def gpu_choice(mechanism: str, impl: str):
    """Trace with `impl` as the GPU's choice for `mechanism`. Clears JAX's
    trace caches on entry and exit: the choice is read at trace time."""
    old = backend.GPU_CHOICE[mechanism]
    backend.GPU_CHOICE[mechanism] = impl
    jax.clear_caches()
    try:
        yield
    finally:
        backend.GPU_CHOICE[mechanism] = old
        jax.clear_caches()


def compile_both(mechanism: str, fn, *args):
    """{impl: (compiled executable, compile seconds)} for triton and xla."""
    out = {}
    for impl in ("triton", "xla"):
        with gpu_choice(mechanism, impl):
            t0 = time.perf_counter()
            exe = jax.jit(fn).lower(*args).compile()
            out[impl] = (exe, time.perf_counter() - t0)
    return out


def time_in_turns(exes: dict, args, reps: int = 7) -> dict:
    """Median wall seconds per call of each executable, called in turns
    after one warm-up call each; every call ends in block_until_ready."""
    for exe in exes.values():
        jax.block_until_ready(exe(*args))
    times = {k: [] for k in exes}
    for _ in range(reps):
        for k, exe in exes.items():
            t0 = time.perf_counter()
            jax.block_until_ready(exe(*args))
            times[k].append(time.perf_counter() - t0)
    return {k: statistics.median(v) for k, v in times.items()}


def device_info() -> dict:
    d = jax.devices()[0]
    return dict(platform=d.platform, kind=d.device_kind,
                count=len(jax.devices()))


def gravity_case():
    from nbx import scene, sim

    sc = scene.cold_collapse_disk(n=262144, seed=0)
    pos, mass = jnp.asarray(sc["pos"]), jnp.asarray(sc["mass"])

    def fn(p, m):
        return sim.gravity(p, m, 0.5, 0.5, impl="auto")

    return fn, (pos, mass)


def granular_case(n: int = 131072, n_steps: int = 10):
    from nbx.bench.granular import BOX, granular_cloud
    from nbx.collisions_scaled import (granular_full_kdk_scan,
                                       make_granular_state)
    from nbx.config import SimConfig
    from nbx.ops.collide import bucketed_layout_for
    from nbx.ops.pm import isolated_green_hat

    box = BOX * (n / 131072.0) ** (1.0 / 3.0)
    pos, vel, mass = granular_cloud(n, box=box)
    st = make_granular_state(pos, vel, mass, key=0)
    cfg = SimConfig(G=0.5, dt=0.016, sub_steps=1, merge_time=0.25,
                    fracture_threshold=8.0)
    buckets = bucketed_layout_for(st.pos, box, 40, 12)
    green = isolated_green_hat(box, 64)

    def fn(st):
        return granular_full_kdk_scan(
            st, cfg, box, n_steps=n_steps, n_cells=40, band_cells=12,
            buckets=buckets, force_impl="pm", pm_grid=64, green_hat=green,
        )

    return fn, (st,)


def compare(mechanism: str, fn, args, reps: int) -> dict:
    exes = compile_both(mechanism, fn, *args)
    medians = time_in_turns({k: v[0] for k, v in exes.items()}, args, reps)
    outs = {k: v[0](*args) for k, v in exes.items()}
    leaves = {k: jax.tree.leaves(v) for k, v in outs.items()}
    err = max(
        float(np.max(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64))))
        for a, b in zip(leaves["triton"], leaves["xla"])
        if np.asarray(a).dtype.kind == "f"
    )
    counters = {k: {c: int(x) for c, x in v[-1].items()}
                for k, v in outs.items()
                if isinstance(v, tuple) and isinstance(v[-1], dict)}
    return dict(
        mechanism=mechanism, counters=counters,
        triton_ms=medians["triton"] * 1e3, xla_ms=medians["xla"] * 1e3,
        triton_compile_s=exes["triton"][1], xla_compile_s=exes["xla"][1],
        max_abs_diff=err, reps=reps,
        faster="triton" if medians["triton"] < medians["xla"] else "xla",
        device=device_info(),
    )


def main(argv):
    reps = int(argv[0]) if argv else 7
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("nbx.bench.kernels needs a GPU")
    for mech, case in (("gravity", gravity_case), ("collide", granular_case)):
        fn, args = case()
        print(json.dumps(compare(mech, fn, args, reps)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
