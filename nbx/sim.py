"""The simulation step: gravity + collisions + thermal under one jit.

Reproduces the reference's per-substep ordering exactly
(/root/reference/index.html:247-262):

    1. half-kick with the PREVIOUS acceleration   (L250-251)
    2. drift                                      (L252)
    3. gravity -> new accelerations               (L255, L264-291)
    4. collision resolution (mutates pos/vel/temp,
       kills, births; newborns have acc = 0)      (L256, L293-390)
    5. half-kick with the NEW acceleration        (L258-259)
    6. thermal decay                              (L260, L227-230)

and the frame loop's `subSteps` substeps of dt / subSteps (L877-879).

The whole frame is one jitted pure function `step(state, cfg) -> (state,
events)`; long rollouts run under `jax.lax.scan` (`run`). Dead slots carry
mass 0 and therefore exert exactly zero force — no extra masking in the
gravity kernels.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from nbx import forces, thermal
from nbx.backend import kernel_impl
from nbx.collisions import Events, empty_events, resolve_collisions
from nbx.config import SimConfig
from nbx.state import SimState

# Dense O(N^2)-memory gravity below this capacity; row-blocked above.
_DENSE_MAX = 2048


def gravity(
    pos: jax.Array,
    mass: jax.Array,
    G,
    softening,
    impl: str = "auto",
) -> jax.Array:
    """Acceleration dispatcher. impl: auto | dense | blocked | pallas.

    "auto" takes the dense form up to _DENSE_MAX bodies and, above it,
    whichever of the Pallas kernel ("pallas") and the plain blocked sum
    ("blocked") nbx.backend picks for this backend."""
    n = pos.shape[0]
    if impl == "auto":
        if n <= _DENSE_MAX:
            impl = "dense"
        elif kernel_impl("gravity") == "triton":
            impl = "pallas"
        else:
            impl = "blocked"
    if impl == "dense":
        return forces.accelerations(pos, mass, G, softening)
    if impl == "blocked":
        return forces.accelerations_blocked(pos, mass, G, softening)
    if impl == "pallas":
        from nbx.ops.pairwise import pairwise_acc

        return pairwise_acc(pos, mass, G, softening)
    raise ValueError(f"unknown force impl {impl!r}")


def substep(
    state: SimState, cfg: SimConfig, h, force_impl: str = "auto",
    collision_impl: str = "jacobi",
) -> tuple[SimState, Events]:
    """One physics substep of size h (reference integrate(), L247-262).

    collision_impl: "jacobi" (default, the parallel sweep) or
    "sequential" — the strict in-sweep-visibility fori_loop path
    (resolve_collisions_sequential), the O(C^2)-sequential tiny-N parity
    mode matching the reference sweep order exactly."""
    half = 0.5 * h
    vel = state.vel + state.acc * half  # half-kick, old acc (L250-251)
    pos = state.pos + vel * h  # drift (L252)
    acc = gravity(pos, state.mass, cfg.G, cfg.softening, force_impl)  # L255
    state = state.replace(pos=pos, vel=vel, acc=acc)

    if cfg.collisions:
        if collision_impl == "sequential":
            from nbx.collisions import resolve_collisions_sequential

            state, events = resolve_collisions_sequential(state, cfg, h)
        else:
            state, events = resolve_collisions(state, cfg, h)  # L256
    else:
        events = empty_events(cfg)

    # Second half-kick (L258-259). Newborns were created with acc = 0
    # (index.html:217) so they are unkicked, exactly like the reference.
    vel = state.vel + state.acc * half
    temp = thermal.decay(state.temp, cfg.heat_decay)  # L260
    return (
        state.replace(vel=vel, temp=temp, step_count=state.step_count + 1),
        events,
    )


def _merge_events(evs: list[Events]) -> Events:
    """Stack the per-substep event logs along a leading substep axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *evs)


@partial(jax.jit, static_argnames=("force_impl", "collision_impl"))
def step(
    state: SimState, cfg: SimConfig, force_impl: str = "auto",
    collision_impl: str = "jacobi",
) -> tuple[SimState, Events]:
    """One frame = cfg.sub_steps substeps of dt / sub_steps (L877-879)."""
    h = cfg.dt / cfg.sub_steps
    evs = []
    for _ in range(cfg.sub_steps):
        state, e = substep(state, cfg, h, force_impl, collision_impl)
        evs.append(e)
    return state, _merge_events(evs)


@partial(jax.jit, static_argnames=("n_steps", "force_impl", "diagnostics",
                                   "collision_impl"))
def run(
    state: SimState,
    cfg: SimConfig,
    n_steps: int,
    force_impl: str = "auto",
    diagnostics: Optional[Callable[[SimState, SimConfig], jax.Array]] = None,
    collision_impl: str = "jacobi",
) -> tuple[SimState, object]:
    """n_steps frames under lax.scan. Returns (final state, stacked aux).

    aux is the per-frame diagnostics output if `diagnostics` is given, else
    the stacked Events log.
    """

    def body(st, _):
        st, ev = step(st, cfg, force_impl, collision_impl)
        out = diagnostics(st, cfg) if diagnostics is not None else ev
        return st, out

    return jax.lax.scan(body, state, None, length=n_steps)
