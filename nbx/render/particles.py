"""Device-side particle pool — explosions and smoke trails.

The reference keeps a 5000-particle CPU pool with per-frame splice/compact
(/root/reference/index.html:461-477, 665-687), fed by fracture explosions
(15 particles each, random directions, speed <= 8u, life 1.0, decay
0.01-0.04, L637-648) and by hot bodies stochastically shedding smoke
(chance min(0.1 + (T-50)*0.002, 1), velocity 0.1*body vel + jitter,
life 0.8-1.2, L555-560, 650-663).

Device version: fixed [P] SoA pool with a free-slot mask — spawning writes into
dead slots by priority (no compaction, no host work), update is one fused
elementwise pass, and rendering reuses the point-splat path. PRNG is a
carried jax.random key (deterministic, checkpointable).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

POOL_SIZE = 5000  # reference cap (index.html:475)
PARTICLE_COLOR = np.array([1.0, 0.666, 0.266], np.float32)  # 0xffaa44 L474
EXPLOSION_COUNT = 15  # L639
SMOKE_BASE_CHANCE = 0.1  # L556
SMOKE_TEMP_SLOPE = 0.002
GLOW_TEMP = 50.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ParticleState:
    pos: jax.Array  # [P, 3]
    vel: jax.Array  # [P, 3]
    life: jax.Array  # [P] — <= 0 means dead
    decay: jax.Array  # [P]
    key: jax.Array

    @staticmethod
    def create(pool: int = POOL_SIZE, key: int | jax.Array = 0) -> "ParticleState":
        if isinstance(key, int):
            key = jax.random.PRNGKey(key)
        return ParticleState(
            pos=jnp.zeros((pool, 3), jnp.float32),
            vel=jnp.zeros((pool, 3), jnp.float32),
            life=jnp.zeros((pool,), jnp.float32),
            decay=jnp.zeros((pool,), jnp.float32),
            key=key,
        )

    @property
    def n_alive(self) -> jax.Array:
        return jnp.sum((self.life > 0).astype(jnp.int32))


@jax.jit
def update(p: ParticleState, dt) -> ParticleState:
    """Life decrement + Euler drift (updateParticles, L665-687). Dead
    particles stay in place with life <= 0 (no compaction needed — the
    splat masks them)."""
    life = jnp.maximum(p.life - p.decay, 0.0)
    return dataclasses.replace(
        p, pos=p.pos + p.vel * dt, life=life
    )


def _spawn(p: ParticleState, new_pos, new_vel, new_life, new_decay, mask):
    """Write spawned particles into dead slots (lowest-life first — the
    pool analog of the reference's splice-and-push)."""
    pool = p.life.shape[0]
    b = min(mask.shape[0], pool)  # spawns beyond the pool size are dropped
    new_pos, new_vel = new_pos[:b], new_vel[:b]
    new_life, new_decay, mask = new_life[:b], new_decay[:b], mask[:b]
    # k dead slots with smallest life (dead slots have life 0)
    neg_life, slots = jax.lax.top_k(-p.life, b)
    ok = mask & (-neg_life <= 0.0)  # only overwrite actually-dead slots
    slots = jnp.where(ok, slots, pool)  # drop
    return dataclasses.replace(
        p,
        pos=p.pos.at[slots].set(new_pos, mode="drop"),
        vel=p.vel.at[slots].set(new_vel, mode="drop"),
        life=p.life.at[slots].set(new_life, mode="drop"),
        decay=p.decay.at[slots].set(new_decay, mode="drop"),
    )


@jax.jit
def spawn_explosions(p: ParticleState, centers, mask) -> ParticleState:
    """spawnExplosion (L637-648): 15 particles per event, random dirs,
    speed <= 8u, life 1.0, decay 0.01-0.04."""
    f = mask.shape[0]
    key, k1, k2, k3 = jax.random.split(p.key, 4)
    n = f * EXPLOSION_COUNT
    dirs = jax.random.normal(k1, (n, 3))
    dirs = dirs / jnp.linalg.norm(dirs, axis=1, keepdims=True)
    speed = jax.random.uniform(k2, (n,)) * 8.0
    decay = 0.01 + jax.random.uniform(k3, (n,)) * 0.03
    pos = jnp.repeat(centers, EXPLOSION_COUNT, axis=0)
    m = jnp.repeat(mask, EXPLOSION_COUNT)
    p = dataclasses.replace(p, key=key)
    return _spawn(p, pos, dirs * speed[:, None], jnp.ones(n), decay, m)


@jax.jit
def spawn_smoke(p: ParticleState, body_pos, body_vel, radius, temp, alive
                ) -> ParticleState:
    """spawnTrail for hot bodies (L555-560, 650-663): chance
    min(0.1 + (T-50)*0.002, 1) per body per frame; one particle at a random
    offset inside the radius; vel = 0.1 * body vel + jitter(+-0.25);
    life 0.8-1.2, decay 0.03."""
    c = alive.shape[0]
    b = min(c, p.life.shape[0])
    key, k1, k2, k3, k4, k5 = jax.random.split(p.key, 6)
    chance = jnp.minimum(SMOKE_BASE_CHANCE + (temp - GLOW_TEMP) * SMOKE_TEMP_SLOPE, 1.0)
    hot = alive & (temp > GLOW_TEMP)
    fire = hot & (jax.random.uniform(k1, (c,)) < chance)
    # extract the first-b FIRING bodies, then draw geometry RNG on [b]
    # rows only: at N >> pool the old full-N draws cost real frame time
    # AND silently restricted smoke to the first `pool` body slots (the
    # _spawn truncation) — extraction is both cheaper and less biased
    from nbx.ops.p3m import take_rows

    idx, valid = take_rows(fire, b)
    offset = jax.random.normal(k2, (b, 3))
    offset = offset / jnp.linalg.norm(offset, axis=1, keepdims=True)
    offset = offset * (radius[idx] * jax.random.uniform(k3, (b,)))[:, None]
    jitter = (jax.random.uniform(k4, (b, 3)) - 0.5) * 0.5
    life = 0.8 + jax.random.uniform(k5, (b,)) * 0.4
    p = dataclasses.replace(p, key=key)
    return _spawn(
        p, body_pos[idx] + offset, body_vel[idx] * 0.1 + jitter, life,
        jnp.full((b,), 0.03), valid,
    )


@partial(jax.jit, static_argnames=("width", "height"))
def splat_particles(
    img_hdr: jax.Array, p: ParticleState, cam, width: int = 640,
    height: int = 360, gain: float = 0.5, depth=None,
) -> jax.Array:
    """Additive-blend point splat of live particles (the reference uses
    AdditiveBlending Points, size 1.2, color 0xffaa44, L470-477). `depth`
    [H, W] hides particles behind opaque impostor surfaces."""
    from nbx.render.splat import project

    px, py, z = project(cam, p.pos, width, height)
    visible = (
        (p.life > 0) & (z > 1e-3)
        & (px >= 0) & (px < width - 1) & (py >= 0) & (py < height - 1)
    )
    if depth is not None:
        xc = jnp.clip(jnp.round(px).astype(jnp.int32), 0, width - 1)
        yc = jnp.clip(jnp.round(py).astype(jnp.int32), 0, height - 1)
        visible = visible & (z <= depth[yc, xc])
    inten = jnp.where(visible, gain * p.life, 0.0)
    rgb = PARTICLE_COLOR[None, :] * inten[:, None]
    x0 = jnp.clip(jnp.round(px).astype(jnp.int32), 0, width - 1)
    y0 = jnp.clip(jnp.round(py).astype(jnp.int32), 0, height - 1)
    return img_hdr.at[y0, x0].add(rgb, mode="drop")
