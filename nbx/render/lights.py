"""Persistent decaying flash lights (reference triggerFlash,
/root/reference/index.html:619-635).

The reference creates a THREE.PointLight(0xffaa00, min(0.2 E, 15), range 60)
per merge/fracture flash, fades it x0.85 per frame in a private rAF loop and
removes it below intensity 0.1 — so one event both FLARES (a visible glow
that persists ~20 frames) and LIGHTS nearby bodies while it lives. Round-2
nbx drew a one-frame additive blob at the event substep only; this module
carries the reference's light LIST as a fixed pool in FrameState:

  * `advance` decays the pool (x0.85, cull < 0.1, L631-632) and inserts the
    frame's new flashes into dead slots (rank-scatter, no sort);
  * `splat_light_glow` draws every live light's additive Gaussian flare;
  * `body_light_gain` returns the per-body illumination each light casts
    (linear-falloff point light over range 60, L621) — the splat/impostor
    passes add it as warm incident light, the splat-level stand-in for the
    PointLight lighting meshes through the scene graph.

Fixed shapes: the pool is a fixed-shape SoA array pair, insertion is a masked
rank-scatter, per-body gain is one [N, L] broadcast — no dynamic lists,
no per-event host work.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

LIGHT_POOL = 16  # concurrent decaying lights (~20-frame life each)
DECAY = 0.85  # per-frame fade (index.html:631)
CULL = 0.1  # removal threshold (index.html:632)
RANGE = 60.0  # PointLight range (index.html:621)
COLOR = (1.0, 0.666, 0.0)  # 0xffaa00 (index.html:621)


class LightState(NamedTuple):
    """Fixed pool of decaying point lights. intensity == 0 marks dead."""

    pos: jax.Array  # [L, 3] f32
    intensity: jax.Array  # [L] f32

    @staticmethod
    def create(pool: int = LIGHT_POOL) -> "LightState":
        return LightState(
            pos=jnp.zeros((pool, 3), jnp.float32),
            intensity=jnp.zeros((pool,), jnp.float32),
        )


def advance(
    lights: LightState,
    flash_pos: jax.Array,  # [F, 3] this frame's event sites
    flash_energy: jax.Array,  # [F]
    flash_mask: jax.Array,  # [F] bool
) -> LightState:
    """Decay the pool one frame, then insert new flashes into dead slots.

    intensity = min(0.2 E, 15) (index.html:625); decay x0.85 and cull < 0.1
    (L631-632). When the pool is full, excess flashes of the frame are
    dropped (the reference never exceeds ~a handful of concurrent lights;
    pool overflow just loses the dimmest-possible newcomers).
    """
    ln = lights.intensity.shape[0]
    inten = lights.intensity * DECAY
    inten = jnp.where(inten < CULL, 0.0, inten)

    new_i = jnp.where(flash_mask, jnp.minimum(0.2 * flash_energy, 15.0), 0.0)
    want = new_i > 0.0
    # rank-scatter newcomers onto dead slots (same pattern as the fragment
    # placement in nbx.collisions_scaled — no sort over the pool)
    dead = inten <= 0.0
    drank = jnp.cumsum(dead.astype(jnp.int32)) - 1
    f = want.shape[0]
    slot_of_rank = jnp.full((f,), ln, jnp.int32).at[
        jnp.where(dead & (drank < f), drank, f)
    ].set(jnp.arange(ln, dtype=jnp.int32), mode="drop")
    wrank = jnp.cumsum(want.astype(jnp.int32)) - 1
    slot = jnp.where(want, slot_of_rank[jnp.clip(wrank, 0, f - 1)], ln)
    slot = jnp.where(slot < ln, slot, ln)
    pos = lights.pos.at[slot].set(flash_pos, mode="drop")
    inten = inten.at[slot].set(new_i, mode="drop")
    return LightState(pos=pos, intensity=inten)


def splat_light_glow(
    img_hdr: jax.Array,  # [H, W, 3]
    lights: LightState,
    cam,
    width: int = 640,
    height: int = 360,
    depth: jax.Array | None = None,  # [H, W] impostor z-buffer
) -> jax.Array:
    """Additive Gaussian flare per live light — the visible after-glow the
    reference gets from the bloomed point light (decays with the pool).
    With `depth`, pixels whose opaque surface is in front of the light are
    masked (a flash behind a planet doesn't glow through the disc; the
    planet it LIGHTS still brightens via body_light_gain)."""
    from nbx.render.splat import project

    px, py, z = project(cam, lights.pos, width, height)
    inten = jnp.where(z > 1e-3, lights.intensity, 0.0)
    ys = jnp.arange(height, dtype=jnp.float32)[:, None]
    xs = jnp.arange(width, dtype=jnp.float32)[None, :]
    sigma = 12.0
    color = jnp.asarray(COLOR, jnp.float32)

    def one(img, args):
        cx, cy, ii, zz = args
        g = ii * jnp.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * sigma**2))
        if depth is not None:
            g = jnp.where(zz <= depth, g, 0.0)
        return img + g[:, :, None] * color, None

    img_hdr, _ = jax.lax.scan(one, img_hdr, (px, py, inten, z))
    return img_hdr


def body_light_gain(lights: LightState, pos: jax.Array) -> jax.Array:
    """Per-body incident flash light, [N] (sum over the pool).

    Linear falloff to the PointLight range (three.js's classic
    distance-bounded falloff for a light with `distance` set, the
    reference's `60`): gain_l = I_l * (1 - d/60)^2, clamped at 0. The
    splat/impostor passes scale this into their shading as warm added
    light; 0.02 matches the visual weight of intensity-15 flashes without
    blowing out the tonemap.
    """
    d = jnp.linalg.norm(pos[:, None, :] - lights.pos[None, :, :], axis=-1)
    fall = jnp.maximum(1.0 - d / RANGE, 0.0)
    return 0.02 * jnp.sum(lights.intensity[None, :] * fall * fall, axis=1)
