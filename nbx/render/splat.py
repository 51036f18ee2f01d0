"""Device-side point-splat renderer.

Replaces the reference's three.js mesh/shader/bloom pipeline
(reference index.html:446-742) with a data-parallel design: project all
bodies with a pinhole camera, scatter-add 2x2 bilinear splats into an HDR
framebuffer (one XLA scatter, no per-body host work), add event flashes as
additive Gaussian blobs (the point-light flashes of triggerFlash,
index.html:619-635), then tonemap. The whole frame is a single jitted
function over device-resident state; readback ships one [H, W, 3] u8 image.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from nbx.ops.p3m import take_rows
from nbx.render.colormap import body_color, tonemap

_BIG_SPLATS = 512  # 11x11-tier capacity (slot-order, not size-ranked)
_MID_SPLATS = 8192  # 5x5-tier capacity (see the tier comment below)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole look-at camera. Defaults echo the reference: eye (0, 80, 150)
    looking at the origin, 45-degree vertical FOV (index.html:707-708)."""

    eye: jax.Array  # [3]
    target: jax.Array  # [3]
    up: jax.Array  # [3]
    fov_deg: float = 45.0

    @staticmethod
    def default() -> "Camera":
        return Camera(
            eye=jnp.array([0.0, 80.0, 150.0]),
            target=jnp.zeros(3),
            up=jnp.array([0.0, 1.0, 0.0]),
        )

    def pan(self, dx: float = 0.0, dy: float = 0.0) -> "Camera":
        """OrbitControls-style pan (index.html:721: right=pan): translate
        eye AND target along the view plane's right/up axes, scaled by the
        orbit radius so a drag moves the scene a view-proportional amount."""
        rel = self.eye - self.target
        r = jnp.linalg.norm(rel)
        fwd = -rel / r
        right = jnp.cross(fwd, self.up)
        right = right / jnp.linalg.norm(right)
        up = jnp.cross(right, fwd)
        shift = (right * dx + up * dy) * r
        return dataclasses.replace(
            self, eye=self.eye + shift, target=self.target + shift
        )

    def orbit(self, d_yaw: float = 0.0, d_pitch: float = 0.0,
              zoom: float = 1.0) -> "Camera":
        """OrbitControls-style rotate/zoom around the target
        (index.html:716-722: left=rotate, wheel=dolly)."""
        rel = self.eye - self.target
        r = jnp.linalg.norm(rel) * zoom
        yaw = jnp.arctan2(rel[0], rel[2]) + d_yaw
        pitch = jnp.clip(
            jnp.arcsin(rel[1] / jnp.linalg.norm(rel)) + d_pitch, -1.45, 1.45
        )
        eye = self.target + r * jnp.array(
            [jnp.cos(pitch) * jnp.sin(yaw), jnp.sin(pitch),
             jnp.cos(pitch) * jnp.cos(yaw)]
        )
        return dataclasses.replace(self, eye=eye)


def _look_at(cam: Camera):
    fwd = cam.target - cam.eye
    fwd = fwd / jnp.linalg.norm(fwd)
    right = jnp.cross(fwd, cam.up)
    right = right / jnp.linalg.norm(right)
    up = jnp.cross(right, fwd)
    return right, up, fwd


def project(
    cam: Camera, pos: jax.Array, width: int, height: int
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """World [N, 3] -> (px, py, depth). Points behind the camera get
    depth <= 0 (callers mask them)."""
    right, up, fwd = _look_at(cam)
    rel = pos - cam.eye
    x = rel @ right
    y = rel @ up
    z = rel @ fwd  # depth along view axis
    f = (height / 2.0) / jnp.tan(jnp.deg2rad(cam.fov_deg) / 2.0)
    safe_z = jnp.where(z > 1e-6, z, 1.0)
    px = width / 2.0 + f * x / safe_z
    py = height / 2.0 - f * y / safe_z
    return px, py, z


def screen_to_plane(
    cam: Camera, sx, sy, width: int, height: int, plane_y: float = 0.0
):
    """Unproject a screen pixel to the y = plane_y world plane — the
    raycaster the reference uses for drag-to-spawn (index.html:787-790).
    Returns ([3] point, [] hit flag); no hit when the ray is parallel or
    points away from the plane."""
    right, up, fwd = _look_at(cam)
    f = (height / 2.0) / jnp.tan(jnp.deg2rad(cam.fov_deg) / 2.0)
    d = fwd + (sx - width / 2.0) / f * right - (sy - height / 2.0) / f * up
    d = d / jnp.linalg.norm(d)
    denom = d[1]
    t = jnp.where(jnp.abs(denom) > 1e-9, (plane_y - cam.eye[1]) / denom, -1.0)
    hit = t > 0
    return cam.eye + t * d, hit


@partial(jax.jit, static_argnames=("width", "height"))
def splat_bodies_hdr(
    pos, radius, temp, mat, alive, color1, color2, cam,
    width: int = 640, height: int = 360, depth=None, light_gain=None,
) -> jax.Array:
    """Body splats into a fresh HDR buffer (no tonemap) — the composition
    primitive for the full frame pipeline. `depth` [H, W] (from
    draw_impostors) hides splats behind opaque impostor surfaces.
    `light_gain` [N] adds flash-light illumination (nbx.render.lights)."""
    return _splat_bodies(
        pos, radius, temp, mat, alive, color1, color2, cam, width, height,
        depth, light_gain,
    )


@partial(jax.jit, static_argnames=("width", "height"))
def splat_frame(
    pos: jax.Array,  # [N, 3]
    radius: jax.Array,  # [N]
    temp: jax.Array,  # [N]
    mat: jax.Array,  # [N] i32
    alive: jax.Array,  # [N] bool
    color1: jax.Array,  # [M, 3]
    color2: jax.Array,  # [M, 3]
    cam: Camera,
    width: int = 640,
    height: int = 360,
    exposure: float = 1.0,
) -> jax.Array:
    """Render one HDR->tonemapped frame, [H, W, 3] f32 in [0, 1].

    Each body splats its emissive color over a Gaussian footprint with
    intensity ~ apparent area (radius / depth)^2 — the point-splat analog of
    a shaded sphere + bloom.
    """
    img = _splat_bodies(
        pos, radius, temp, mat, alive, color1, color2, cam, width, height
    )
    return tonemap(img, exposure)


SUN_POS = np.array([50.0, 50.0, 50.0], np.float32)  # DirectionalLight site (L737-741)


def _splat_bodies(pos, radius, temp, mat, alive, color1, color2, cam,
                  width, height, depth=None, light_gain=None) -> jax.Array:
    px, py, z = project(cam, pos, width, height)
    visible = (
        alive
        & (z > 1e-3)
        & (px >= 0)
        & (px < width - 1)
        & (py >= 0)
        & (py < height - 1)
    )
    if depth is not None:  # z-test against opaque impostor surfaces
        xc = jnp.clip(jnp.round(px).astype(jnp.int32), 0, width - 1)
        yc = jnp.clip(jnp.round(py).astype(jnp.int32), 0, height - 1)
        visible = visible & (z <= depth[yc, xc])
    col = body_color(temp, mat, color1, color2)  # [N, 3]
    # Sun-phase shading: the lit fraction of a sphere facing the camera is
    # (1 + cos(sun-body-eye angle)) / 2 — the splat-level stand-in for the
    # shader's Lambertian sun term (index.html:174-181) with the reference's
    # 0.05 ambient floor (L197). Hot bodies are emissive and ignore it.
    to_sun = SUN_POS[None, :] - pos
    to_eye = cam.eye[None, :] - pos
    cosang = jnp.sum(to_sun * to_eye, axis=1) * jax.lax.rsqrt(
        jnp.maximum(jnp.sum(to_sun**2, 1) * jnp.sum(to_eye**2, 1), 1e-12)
    )
    lit = 0.05 + 0.95 * 0.5 * (1.0 + cosang)
    emissive = jnp.clip(temp / 50.0, 0.0, 1.0)
    albedo = col
    col = col * jnp.maximum(lit, emissive)[:, None]
    if light_gain is not None:
        # incident flash light (nbx.render.lights): warm reflected add
        from nbx.render.lights import COLOR as _FLASH_COLOR

        col = col + albedo * light_gain[:, None] * jnp.asarray(
            _FLASH_COLOR, jnp.float32
        )
    f = (height / 2.0) / jnp.tan(jnp.deg2rad(cam.fov_deg) / 2.0)
    app = f * radius / jnp.where(z > 1e-3, z, 1.0)  # apparent radius in px

    # THREE footprint tiers (all static shapes). Scatter-adds over the
    # full body array are the cost that grows with N (one per tap: a
    # 25-tap window over every body is 25 full-N scatters), so the full-N
    # tier is the MINIMUM footprint that keeps sub-pixel motion smooth — a 2x2
    # bilinear (4 scatters; weights sum to 1 exactly, and for the
    # sub-pixel majority sigma clips to 0.45 where the old 5x5 window's
    # outer taps carried < 1e-4 of the energy — bloom re-spreads points
    # anyway). Bodies whose footprint genuinely spans pixels
    # (app > 0.75) are EXTRACTED (take_rows = index-order, not a size
    # ranking) into a capped 5x5 Gaussian tier whose scatters run over
    # _MID_SPLATS rows, and app > 2.0 bodies into the 11x11 tier so
    # big/near bodies render as wide soft discs (the n_impostors nearest
    # get exact per-pixel shading on top — nbx.render.impostor). Past a
    # tier's capacity a body falls back to the next-smaller footprint
    # (visible, if clipped) rather than vanish; a true size-ranked
    # selection would need a top_k over N per frame.
    # threshold 2.0 px: in the 5x5 window a sigma above ~1.2 truncates at
    # +-1.7 sigma and reads as a box; the 11x11 tier keeps those round
    big = visible & (app > 2.0)
    idx_b, valid_b = take_rows(big, _BIG_SPLATS)
    in_big = big & (jnp.cumsum(big.astype(jnp.int32)) - 1 < _BIG_SPLATS)
    mid = visible & ~in_big & (app > 0.75)
    m_cap = min(_MID_SPLATS, alive.shape[0])
    idx_m, valid_m = take_rows(mid, m_cap)
    in_mid = mid & (jnp.cumsum(mid.astype(jnp.int32)) - 1 < m_cap)
    small = visible & ~in_big & ~in_mid
    # Energy ~ apparent area, floored so sub-pixel bodies stay visible
    # (the reference never lets a body vanish either — bloom pops them).
    inten_s = jnp.where(small, jnp.clip(app * app, 0.3, 60.0), 0.0)
    rgb_s = col * inten_s[:, None]

    # ---- small tier: 2x2 bilinear over ALL N (4 scatters) -------------
    xf = jnp.clip(px, 0.0, width - 1.001)
    yf = jnp.clip(py, 0.0, height - 1.001)
    x0 = jnp.floor(xf).astype(jnp.int32)
    y0 = jnp.floor(yf).astype(jnp.int32)
    fx = xf - x0
    fy = yf - y0
    img = jnp.zeros((height, width, 3), jnp.float32)
    for dy, dx, w in (
        (0, 0, (1.0 - fx) * (1.0 - fy)),
        (0, 1, fx * (1.0 - fy)),
        (1, 0, (1.0 - fx) * fy),
        (1, 1, fx * fy),
    ):
        img = img.at[y0 + dy, x0 + dx].add(
            rgb_s * w[:, None], mode="drop"
        )

    # ---- mid tier: 5x5 Gaussian over the m_cap gathered rows ----------
    pxm, pym, appm = px[idx_m], py[idx_m], app[idx_m]
    inten_m = jnp.where(valid_m, jnp.clip(appm * appm, 0.3, 60.0), 0.0)
    rgb_m = col[idx_m] * inten_m[:, None]
    sigm = jnp.clip(appm * 0.6, 0.45, 2.2)
    x0m = jnp.clip(jnp.round(pxm).astype(jnp.int32), 2, width - 3)
    y0m = jnp.clip(jnp.round(pym).astype(jnp.int32), 2, height - 3)
    taps = []
    wsum = jnp.zeros_like(pxm)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            d2 = (x0m + dx - pxm) ** 2 + (y0m + dy - pym) ** 2
            w = jnp.exp(-d2 / (2.0 * sigm * sigm))
            taps.append((dy, dx, w))
            wsum = wsum + w
    inv_wsum = 1.0 / jnp.where(wsum > 0, wsum, 1.0)
    for dy, dx, w in taps:
        img = img.at[y0m + dy, x0m + dx].add(
            rgb_m * (w * inv_wsum)[:, None], mode="drop"
        )

    # ---- 11x11 tier: one batched scatter of the gathered big bodies ------
    r_half = 5
    pxb, pyb, appb = px[idx_b], py[idx_b], app[idx_b]
    inten_b = jnp.where(valid_b, jnp.clip(appb * appb, 0.3, 240.0), 0.0)
    rgbb = col[idx_b] * inten_b[:, None]
    sigb = jnp.clip(appb * 0.6, 1.2, 4.8)
    x0b = jnp.clip(jnp.round(pxb).astype(jnp.int32), r_half,
                   width - r_half - 1)
    y0b = jnp.clip(jnp.round(pyb).astype(jnp.int32), r_half,
                   height - r_half - 1)
    dr = jnp.arange(-r_half, r_half + 1)
    dxx = dr[None, None, :]  # [1, 1, 11]
    dyy = dr[None, :, None]  # [1, 11, 1]
    d2b = (
        (x0b[:, None, None] + dxx - pxb[:, None, None]) ** 2
        + (y0b[:, None, None] + dyy - pyb[:, None, None]) ** 2
    )  # [M, 11, 11]
    wb = jnp.exp(-d2b / (2.0 * sigb * sigb)[:, None, None])
    wb = wb / jnp.maximum(jnp.sum(wb, axis=(1, 2), keepdims=True), 1e-9)
    tapshape = (idx_b.shape[0], 2 * r_half + 1, 2 * r_half + 1)
    ys = jnp.broadcast_to(y0b[:, None, None] + dyy, tapshape).reshape(-1)
    xs = jnp.broadcast_to(x0b[:, None, None] + dxx, tapshape).reshape(-1)
    vals = (rgbb[:, None, None, :] * wb[..., None]).reshape(-1, 3)
    if depth is not None:
        # per-TAP z-test: the wide footprint must not bleed across an
        # occluding planet's disc edge (the 5x5 tier keeps the cheaper
        # center-pixel test — its footprint is within the splat's own disc)
        zb = jnp.broadcast_to(z[idx_b][:, None, None], tapshape).reshape(-1)
        vals = jnp.where((zb <= depth[ys, xs])[:, None], vals, 0.0)
    img = img.at[ys, xs].add(vals, mode="drop")
    return img


@partial(jax.jit, static_argnames=("width", "height"))
def add_flashes(
    img_hdr: jax.Array,  # [H, W, 3] HDR (pre-tonemap)
    flash_pos: jax.Array,  # [F, 3] world
    flash_energy: jax.Array,  # [F]
    flash_mask: jax.Array,  # [F] bool
    cam: Camera,
    width: int = 640,
    height: int = 360,
    depth: jax.Array | None = None,  # [H, W] impostor z-buffer
) -> jax.Array:
    """Additive Gaussian flash blobs — the splat analog of triggerFlash's
    transient point light (intensity min(0.2 E, 15), color 0xffaa00,
    index.html:619-626). With `depth`, pixels whose opaque surface is in
    front of the flash are masked, so a flash behind a planet doesn't
    glow through its disc (the persistent LIGHTING of nearby bodies is
    separate — nbx.render.lights)."""
    h, w = img_hdr.shape[:2]
    px, py, z = project(cam, flash_pos, width, height)
    inten = jnp.where(
        flash_mask & (z > 1e-3), jnp.minimum(0.2 * flash_energy, 15.0), 0.0
    )
    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    xs = jnp.arange(w, dtype=jnp.float32)[None, :]
    sigma = 12.0
    color = jnp.array([1.0, 0.666, 0.0], jnp.float32)  # 0xffaa00

    def one(img, args):
        cx, cy, ii, zz = args
        g = ii * jnp.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * sigma**2))
        if depth is not None:
            g = jnp.where(zz <= depth, g, 0.0)
        return img + g[:, :, None] * color, None

    img_hdr, _ = jax.lax.scan(one, img_hdr, (px, py, inten, z))
    return img_hdr


def render_state(state, cfg, cam: Camera | None = None, **kw) -> jax.Array:
    """Render a SimState with its material table."""
    cam = cam or Camera.default()
    return splat_frame(
        state.pos,
        state.radius(cfg),
        state.temp,
        state.mat,
        state.alive,
        cfg.materials.color1,
        cfg.materials.color2,
        cam,
        **kw,
    )
