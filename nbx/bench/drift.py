"""Energy-drift gate (BASELINE config 3): Plummer sphere N=16k, 10k KDK
steps, relative energy drift must stay < 1e-4.

Everything runs on device: the force evaluation is nbx.sim.gravity (the
direct-sum kernel or the plain blocked sum, as nbx.backend picks), the
time loop is one lax.scan, and energies are sampled on device every
`diag_every` steps with the blocked per-body potential — a 10k-step gate
costs one dispatch and one small readback.

Usage:  python -m nbx.bench.drift [n] [steps] [diag_every] [json_out]
"""

from __future__ import annotations

import functools
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "diag_every", "interpret", "compensated"),
)
def drift_run(
    pos,
    vel,
    mass,
    G,
    eps,
    h,
    n_steps: int,
    diag_every: int = 100,
    interpret: bool = False,
    compensated: bool = True,
):
    """Scan n_steps of KDK with warm-started acceleration; returns
    (final pos, final vel, energies [n_steps / diag_every + 1]).

    interpret=True runs the gravity kernel in the Pallas interpreter
    (tests). compensated=True uses Kahan-compensated position/velocity
    updates: over 10k steps the f32 update roundoff (|dx| ~ 1e-7 |x| per
    step, random-walk accumulation) otherwise becomes a visible
    energy-drift floor.
    """
    from nbx import forces
    from nbx.ops.pairwise import pairwise_acc
    from nbx.sim import gravity

    if interpret:
        force = lambda p: pairwise_acc(p, mass, G, eps, interpret=True)
    else:
        force = lambda p: gravity(p, mass, G, eps)

    def energy(p, v):
        phi = forces.potential_per_body(p, mass, G, eps)
        return 0.5 * jnp.sum(mass * jnp.sum(v * v, -1)) + 0.5 * jnp.sum(mass * phi)

    def kadd(x, c, dx):
        """Kahan: (x, carry) + dx."""
        y = dx - c
        t = x + y
        c = (t - x) - y
        return t, c

    def chunk(carry, _):
        p, v, a, pc, vc = carry

        def substep(s, _):
            p, v, a, pc, vc = s
            if compensated:
                v, vc = kadd(v, vc, a * (0.5 * h))
                p, pc = kadd(p, pc, v * h)
                a = force(p)
                v, vc = kadd(v, vc, a * (0.5 * h))
            else:
                v = v + a * (0.5 * h)
                p = p + v * h
                a = force(p)
                v = v + a * (0.5 * h)
            return (p, v, a, pc, vc), None

        (p, v, a, pc, vc), _ = jax.lax.scan(
            substep, (p, v, a, pc, vc), None, length=diag_every
        )
        return (p, v, a, pc, vc), energy(p, v)

    acc0 = force(pos)
    e0 = energy(pos, vel)
    zero = jnp.zeros_like(pos)
    (pos, vel, _, _, _), energies = jax.lax.scan(
        chunk, (pos, vel, acc0, zero, zero), None, length=n_steps // diag_every
    )
    return pos, vel, jnp.concatenate([e0[None], energies])


def main(
    n: int = 16384,
    n_steps: int = 10000,
    diag_every: int = 100,
    json_out: str | None = None,
    eps_factor: float = 1.0,
    h_div: float = 200.0,
):
    import json

    from nbx import scene

    sc = scene.plummer(n=n, total_mass=float(n), scale_radius=10.0, G=1.0, seed=0)
    pos = jnp.asarray(sc["pos"])
    vel = jnp.asarray(sc["vel"])
    mass = jnp.asarray(sc["mass"])
    # mean inter-particle softening a * N^(-1/3) (standard collisionless choice)
    G, eps = 1.0, eps_factor * 10.0 * n ** (-1 / 3)
    # dynamical time ~ sqrt(R^3 / GM); step well under it
    t_dyn = float(np.sqrt(10.0**3 / (G * n)))
    h = t_dyn / h_div
    d = jax.devices()[0]
    t0 = time.perf_counter()
    exe = drift_run.lower(pos, vel, mass, G, eps, h, n_steps,
                          diag_every).compile()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, e = jax.block_until_ready(exe(pos, vel, mass, G, eps, h))
    wall = time.perf_counter() - t0
    e = np.asarray(e)
    drift = float(np.abs(e - e[0]).max() / abs(e[0]))
    result = {
        "metric": f"relative_energy_drift_{n_steps}_steps",
        "value": drift,
        "gate": 1e-4,
        "pass": bool(drift < 1e-4),
        "n": n,
        "h": h,
        "eps": eps,
        "run_s": wall,
        "compile_s": compile_s,
        "device": dict(platform=d.platform, kind=d.device_kind,
                       count=len(jax.devices())),
    }
    print(json.dumps(result))
    if json_out:
        with open(json_out, "w") as f:
            json.dump(result, f)
    return drift


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]) if a else 16384,
         int(a[1]) if len(a) > 1 else 10000,
         int(a[2]) if len(a) > 2 else 100,
         a[3] if len(a) > 3 else None)
