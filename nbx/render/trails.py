"""Ribbon trails — device-side history buffer + camera-facing tapered quads.

The reference keeps a per-body position history (`history.unshift(pos)`
capped at trailLength, /root/reference/index.html:564-565) and rebuilds a
camera-facing ribbon every frame: per history point the half-width is
width = radius * 0.8 * (1 - i/(len-1)) and the rib direction is
normalize((cam - p) x dir) * width, two vertices per point (L570-593).

Device version: a rolling [C, L, 3] ring buffer updated in one masked
dynamic-update per frame (no host work). Rendering reproduces the ribbon
GEOMETRY — per segment, the camera-facing perpendicular and the tapered
width are computed exactly as the reference vertex pair, and the quad
between consecutive history points is filled by splatting an
(n_along x n_across) lattice of sub-points into the HDR buffer. Thick
near-head ribbons really are wide on screen; the tail tapers to a point.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from nbx.render.colormap import body_color

WIDTH_FACTOR = 0.8  # ribbon half-width = radius * 0.8 * taper (L570-571)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrailState:
    """Ring buffer: pos[C, L, 3], valid[C, L], head [] (next write index)."""

    pos: jax.Array
    valid: jax.Array
    head: jax.Array

    @staticmethod
    def create(capacity: int, length: int = 80) -> "TrailState":
        return TrailState(
            pos=jnp.zeros((capacity, length, 3), jnp.float32),
            valid=jnp.zeros((capacity, length), bool),
            head=jnp.zeros((), jnp.int32),
        )

    @property
    def length(self) -> int:
        return self.pos.shape[1]


@jax.jit
def update(trails: TrailState, body_pos: jax.Array, alive: jax.Array) -> TrailState:
    """Push current positions (history.unshift, L564); dead bodies' trails
    invalidate so a reused slot starts clean (garbageCollect, L599-617)."""
    h = trails.head % trails.length
    pos = trails.pos.at[:, h, :].set(body_pos)
    valid = trails.valid.at[:, h].set(alive)
    valid = valid & alive[:, None]  # clear history of dead slots
    return TrailState(pos=pos, valid=valid, head=trails.head + 1)


@jax.jit
def by_age(trails: TrailState) -> tuple[jax.Array, jax.Array]:
    """History reordered so index 0 is the newest sample (the reference's
    history[0] after unshift): (pos [C, L, 3], valid [C, L])."""
    length = trails.length
    idx = (trails.head - 1 - jnp.arange(length)) % length
    return trails.pos[:, idx, :], trails.valid[:, idx]


@partial(jax.jit, static_argnames=("width", "height", "n_along", "n_across"))
def splat_trails(
    img_hdr: jax.Array,  # [H, W, 3] HDR buffer (pre-tonemap)
    trails: TrailState,
    radius: jax.Array,  # [C]
    temp: jax.Array,  # [C]
    mat: jax.Array,  # [C]
    color1: jax.Array,
    color2: jax.Array,
    cam,
    width: int = 640,
    height: int = 360,
    gain: float = 0.10,
    n_along: int = 2,
    n_across: int = 5,
    depth=None,
) -> jax.Array:
    """Additive tapered ribbon quads (L570-593 geometry, splat-filled).

    Per valid history segment [p_i, p_{i+1}]: rib = normalize((cam - p) x
    (p_{i+1} - p_i)), half-width w_i = radius * 0.8 * (1 - i/(L-1)); the
    quad spanned by p +- rib * w is filled with n_along x n_across
    sub-points whose summed intensity matches one legacy trail point.
    """
    from nbx.render.splat import project

    c, length = trails.valid.shape
    pos_age, valid_age = by_age(trails)
    taper = (1.0 - jnp.arange(length) / max(length - 1, 1)).astype(jnp.float32)

    p0 = pos_age[:, :-1, :]  # [C, L-1, 3] newer end of each segment
    p1 = pos_age[:, 1:, :]
    seg_ok = valid_age[:, :-1] & valid_age[:, 1:]
    seg = p1 - p0
    to_cam = cam.eye[None, None, :] - p0
    rib = jnp.cross(to_cam, seg)  # camera-facing perpendicular (L578-580)
    rib_len = jnp.linalg.norm(rib, axis=-1, keepdims=True)
    rib = rib / jnp.where(rib_len > 1e-6, rib_len, 1.0)
    w0 = (radius[:, None] * WIDTH_FACTOR * taper[None, :-1])[..., None]
    w1 = (radius[:, None] * WIDTH_FACTOR * taper[None, 1:])[..., None]

    t = jnp.linspace(0.0, 1.0, n_along, endpoint=False)  # along the segment
    s = jnp.linspace(-1.0, 1.0, n_across)  # across the ribbon
    # q [C, L-1, A, S, 3] = p0 + seg * t + rib * lerp(w0, w1, t) * s
    q = (
        p0[:, :, None, None, :]
        + seg[:, :, None, None, :] * t[None, None, :, None, None]
        + rib[:, :, None, None, :]
        * (w0[:, :, None, None, :] * (1.0 - t[None, None, :, None, None])
           + w1[:, :, None, None, :] * t[None, None, :, None, None])
        * s[None, None, None, :, None]
    )
    flat = q.reshape(-1, 3)
    px, py, z = project(cam, flat, width, height)
    shape = (c, length - 1, n_along, n_across)
    px = px.reshape(shape)
    py = py.reshape(shape)
    z = z.reshape(shape)

    visible = (
        seg_ok[:, :, None, None]
        & (z > 1e-3)
        & (px >= 0) & (px < width - 1)
        & (py >= 0) & (py < height - 1)
    )
    if depth is not None:  # z-test against opaque impostor surfaces
        xc = jnp.clip(jnp.round(px).astype(jnp.int32), 0, width - 1)
        yc = jnp.clip(jnp.round(py).astype(jnp.int32), 0, height - 1)
        visible = visible & (z <= depth[yc, xc])
    col = body_color(temp, mat, color1, color2)  # [C, 3]
    # one segment's total energy ~ gain * taper * radius (the legacy point),
    # spread across its sub-point lattice
    inten = jnp.where(
        visible,
        (gain / (n_along * n_across))
        * taper[None, :-1, None, None]
        * radius[:, None, None, None],
        0.0,
    )
    rgb = col[:, None, None, None, :] * inten[..., None]

    x0 = jnp.clip(jnp.round(px).astype(jnp.int32), 0, width - 1).reshape(-1)
    y0 = jnp.clip(jnp.round(py).astype(jnp.int32), 0, height - 1).reshape(-1)
    return img_hdr.at[y0, x0].add(rgb.reshape(-1, 3), mode="drop")
