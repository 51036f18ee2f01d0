"""Full frame pipeline: bodies + trails + particles + event flashes.

The composition order mirrors the reference frame (additive everything, then
tonemap — the EffectComposer + bloom analog, index.html:724-732, 873-883):

    HDR = splat(bodies) + splat(trails) + splat(particles) + flashes(events)
    frame = tonemap(HDR)

`FrameState` carries the renderer's persistent device state (trail ring
buffer + particle pool). `render_and_advance` consumes one simulation step's
output (state + events) and returns (new FrameState, u8-ready frame) — the
decoupled replacement for the reference's physics->visuals calls.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from nbx.render import lights as lights_mod
from nbx.render import particles as particles_mod
from nbx.render import trails as trails_mod
from nbx.render.bloom import bloom
from nbx.render.colormap import tonemap
from nbx.render.impostor import draw_impostors
from nbx.render.splat import Camera, splat_bodies_hdr


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FrameState:
    trails: trails_mod.TrailState
    particles: particles_mod.ParticleState
    lights: lights_mod.LightState

    @staticmethod
    def create(capacity: int, trail_length: int = 80,
               pool: int = particles_mod.POOL_SIZE, key: int = 0) -> "FrameState":
        return FrameState(
            trails=trails_mod.TrailState.create(capacity, trail_length),
            particles=particles_mod.ParticleState.create(pool, key),
            lights=lights_mod.LightState.create(),
        )


N_STARS = 3000  # reference starfield (index.html:696-705)


def starfield_directions(key: int = 7, n: int = N_STARS) -> jax.Array:
    """Unit directions of the background stars (the reference scatters 3000
    points in a +-750 cube; at infinity only direction matters, so the
    field is camera-rotation-correct and parallax-free)."""
    k = jax.random.PRNGKey(key)
    v = jax.random.normal(k, (n, 3))
    return v / jnp.linalg.norm(v, axis=1, keepdims=True)


@partial(jax.jit, static_argnames=("width", "height"))
def splat_starfield(
    img_hdr: jax.Array, dirs: jax.Array, cam: Camera,
    width: int = 640, height: int = 360, gain: float = 0.22, depth=None,
) -> jax.Array:
    """Additive dim star points at infinity (occluded by planet discs when
    a `depth` buffer is passed — stars are at z ~ 1e6)."""
    from nbx.render.splat import project

    pos = cam.eye[None, :] + dirs * 1e6  # effectively at infinity
    px, py, z = project(cam, pos, width, height)
    vis = (z > 0) & (px >= 0) & (px < width - 1) & (py >= 0) & (py < height - 1)
    x0 = jnp.clip(jnp.round(px).astype(jnp.int32), 0, width - 1)
    y0 = jnp.clip(jnp.round(py).astype(jnp.int32), 0, height - 1)
    if depth is not None:
        vis = vis & (z <= depth[y0, x0])
    inten = jnp.where(vis, gain, 0.0)
    return img_hdr.at[y0, x0].add(
        inten[:, None] * jnp.ones((1, 3)), mode="drop"
    )


@partial(
    jax.jit,
    static_argnames=("width", "height", "use_bloom", "n_impostors"),
)
def render_granular(
    frame: FrameState,
    st,  # GranularState (nbx.collisions_scaled)
    cfg,  # SimConfig
    events,  # ScaledEvents (single substep or stacked [S, ...])
    cam: Camera,
    trail_idx: jax.Array,  # [T] i32 body slots that get ribbon trails
    width: int = 640,
    height: int = 360,
    exposure: float = 1.5,
    use_bloom: bool = True,
    stars: jax.Array | None = None,
    bloom_strength: float = 1.2,
    bloom_threshold: float = 0.3,
    n_impostors: int = 64,
):
    """render_and_advance for the AT-SCALE state (GranularState +
    ScaledEvents): same pass order and look (impostor z-buffer, additive
    splats/trails/particles/flash glows, bloom, tonemap), with the one
    scale adaptation that matters at N ~ 1M — ribbon TRAILS are tiered to
    the `trail_idx` body slots (frame.trails capacity must equal
    trail_idx.shape[0]): an 80-point history for every one of 1M bodies
    is a ~1 GB ring buffer for ribbons thinner than a pixel. Splats,
    impostors (K largest projected discs), smoke, explosion particles and
    flash lights still run over ALL bodies/events, so the tiering only
    affects which bodies leave a ribbon. frame.trails.head drives the
    shader time exactly as in render_and_advance.

    Reference frame semantics: index.html:500-597 (visual update),
    :619-648 (flash/explosion), :724-732 + :873-883 (compose + bloom).
    """
    from nbx.config import body_radius

    radius = body_radius(st.mass, st.mat, cfg.materials)
    alive = st.mass > 0.0
    c1, c2 = cfg.materials.color1, cfg.materials.color2

    trails = trails_mod.update(
        frame.trails, st.pos[trail_idx], alive[trail_idx]
    )
    parts = particles_mod.update(frame.particles, cfg.dt)
    parts = particles_mod.spawn_smoke(
        parts, st.pos, st.vel, radius, st.temp, alive
    )

    stacked = events.merge_pos.ndim == 3

    def flat(x):
        return x.reshape((-1,) + x.shape[2:]) if stacked else x

    parts = particles_mod.spawn_explosions(
        parts, flat(events.spawn_pos), flat(events.spawn_mask)
    )
    flash_pos = jnp.concatenate(
        [flat(events.merge_pos), flat(events.fracture_pos)]
    )
    flash_e = jnp.concatenate(
        [0.5 * flat(events.merge_mass), flat(events.fracture_energy)]
    )
    flash_mask = jnp.concatenate(
        [flat(events.merge_mask), flat(events.fracture_mask)]
    )
    lights = lights_mod.advance(frame.lights, flash_pos, flash_e, flash_mask)
    light_gain = lights_mod.body_light_gain(lights, st.pos)

    depth = None
    imp = None
    if n_impostors > 0:
        imp, depth = draw_impostors(
            jnp.zeros((height, width, 3), jnp.float32),
            st.pos, radius, st.temp, st.mat, alive, c1, c2, cam,
            frame.trails.head.astype(jnp.float32) * cfg.dt,
            width=width, height=height, n_impostors=n_impostors,
            light_gain=light_gain,
        )

    hdr = splat_bodies_hdr(
        st.pos, radius, st.temp, st.mat, alive, c1, c2, cam,
        width=width, height=height, depth=depth, light_gain=light_gain,
    )
    if imp is not None:
        hdr = hdr + imp
    if stars is not None:
        hdr = splat_starfield(hdr, stars, cam, width=width, height=height,
                              depth=depth)
    hdr = trails_mod.splat_trails(
        hdr, trails, radius[trail_idx], st.temp[trail_idx],
        st.mat[trail_idx], c1, c2, cam, width=width, height=height,
        depth=depth,
    )
    hdr = particles_mod.splat_particles(hdr, parts, cam, width=width,
                                        height=height, depth=depth)
    hdr = lights_mod.splat_light_glow(hdr, lights, cam, width=width,
                                      height=height, depth=depth)
    if use_bloom:
        hdr = bloom(hdr, bloom_strength, bloom_threshold)

    return (
        FrameState(trails=trails, particles=parts, lights=lights),
        tonemap(hdr, exposure),
    )


@partial(
    jax.jit,
    static_argnames=("width", "height", "use_bloom", "n_impostors"),
)
def render_and_advance(
    frame: FrameState,
    state,  # SimState
    cfg,  # SimConfig
    events,  # Events (stacked over substeps: leading axis S)
    cam: Camera,
    width: int = 640,
    height: int = 360,
    exposure: float = 1.5,
    use_bloom: bool = True,
    stars: jax.Array | None = None,
    bloom_strength: float = 1.2,
    bloom_threshold: float = 0.3,
    n_impostors: int = 64,
):
    """One rendered frame + advanced renderer state. `events` may be a
    single-substep Events or a substep-stacked one (leaves [S, ...]).
    Pass `stars` (from starfield_directions()) for the background field.
    bloom_strength/bloom_threshold are dynamic jit args — the lil-gui
    Visuals sliders (index.html:862-863) retune them without recompiling.
    n_impostors > 0 shades that many nearest bodies with the per-pixel
    planet-surface pass (nbx.render.impostor); 0 disables it. The pass
    works on fixed-size chunks of K, so its cost grows slowly with K; the
    default 64 covers nearly every visible body at capacity 300."""
    radius = state.radius(cfg)
    c1, c2 = cfg.materials.color1, cfg.materials.color2

    # advance trails + particles
    trails = trails_mod.update(frame.trails, state.pos, state.alive)
    parts = particles_mod.update(frame.particles, cfg.dt)
    parts = particles_mod.spawn_smoke(
        parts, state.pos, state.vel, radius, state.temp, state.alive
    )

    # flatten substep-stacked events (detect stacking from the [.., M, 3]
    # merge_pos leaf: stacked = [S, M, 3], single-substep = [M, 3])
    stacked = events.merge_pos.ndim == 3

    def flat(x):
        return x.reshape((-1,) + x.shape[2:]) if stacked else x

    spawn_pos = flat(events.spawn_pos)
    spawn_mask = flat(events.spawn_mask)
    parts = particles_mod.spawn_explosions(parts, spawn_pos, spawn_mask)

    # advance the persistent flash lights (decay x0.85/frame, cull < 0.1,
    # reference triggerFlash index.html:619-635) and insert this frame's
    # merge/fracture events; the pool both glows and lights the bodies
    flash_pos = jnp.concatenate([flat(events.merge_pos), flat(events.fracture_pos)])
    # merge flash energy = 0.5 * merged mass (L408); fracture = impact E (L358)
    flash_e = jnp.concatenate(
        [0.5 * flat(events.merge_mass), flat(events.fracture_energy)]
    )
    flash_mask = jnp.concatenate([flat(events.merge_mask), flat(events.fracture_mask)])
    lights = lights_mod.advance(frame.lights, flash_pos, flash_e, flash_mask)
    light_gain = lights_mod.body_light_gain(lights, state.pos)

    # Impostors draw FIRST and hand their z-buffer to every additive pass:
    # splats/stars/trails/particles behind an opaque planet disc are hidden,
    # sources in front still glow over it (the raster z-buffer the reference
    # gets for free from WebGL).
    depth = None
    imp = None
    if n_impostors > 0:
        # frame counter x dt = shader time (drives the spin, L549)
        imp, depth = draw_impostors(
            jnp.zeros((height, width, 3), jnp.float32),
            state.pos, radius, state.temp, state.mat, state.alive,
            c1, c2, cam, frame.trails.head.astype(jnp.float32) * cfg.dt,
            width=width, height=height, n_impostors=n_impostors,
            light_gain=light_gain,
        )

    hdr = splat_bodies_hdr(
        state.pos, radius, state.temp, state.mat, state.alive, c1, c2, cam,
        width=width, height=height, depth=depth, light_gain=light_gain,
    )
    if imp is not None:
        hdr = hdr + imp  # imp is zero outside covered pixels
    if stars is not None:
        hdr = splat_starfield(hdr, stars, cam, width=width, height=height,
                              depth=depth)
    hdr = trails_mod.splat_trails(
        hdr, trails, radius, state.temp, state.mat, c1, c2, cam,
        width=width, height=height, depth=depth,
    )
    hdr = particles_mod.splat_particles(hdr, parts, cam, width=width,
                                        height=height, depth=depth)

    # Depth discipline: 5x5 splats test their CENTER pixel (footprint stays
    # within the body's own disc); the 11x11 tier and the flash glows test
    # PER PIXEL, so wide footprints no longer bleed across an occluding
    # planet's disc edge.
    hdr = lights_mod.splat_light_glow(hdr, lights, cam, width=width,
                                      height=height, depth=depth)
    if use_bloom:
        hdr = bloom(hdr, bloom_strength, bloom_threshold)

    return (
        FrameState(trails=trails, particles=parts, lights=lights),
        tonemap(hdr, exposure),
    )
