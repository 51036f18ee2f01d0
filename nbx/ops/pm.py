"""Particle-mesh (PM) gravity solver — the O(N + G^3 log G) scaling path.

The reference (and nbx's Pallas kernel) is direct-sum O(N^2); beyond ~1M
bodies the right collisionless-dynamics tool is PM (Hockney & Eastwood):

    1. deposit mass onto a G^3 grid with cloud-in-cell (CIC) weights
    2. solve the Poisson equation in Fourier space (jnp.fft — XLA hands
       FFTs to cuFFT on the GPU)
    3. spectral gradient -> acceleration grids
    4. CIC-gather accelerations back to the bodies

Everything is one jit; the deposit is a dual scatter-add, the gather a dual
linear interpolation — both XLA-native. Periodic boundaries by construction;
isolated (vacuum) boundaries via the standard 2x zero-padded Hockney trick.

Accuracy: forces are exact for wavelengths >> cell size and softened below
the grid scale — PM's effective softening is ~1 cell. The test suite gates
PM against the direct-sum oracle on smooth mass distributions.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _cic_parts(pos, box_size: float, g: int):
    """CIC base cell + fractional offsets. pos in [0, box)^3."""
    h = box_size / g
    u = pos / h - 0.5  # cell-centered convention
    i0 = jnp.floor(u).astype(jnp.int32)
    f = u - i0
    return i0, f


def _axis_index_weight(i, w, g: int, periodic: bool):
    """Resolve a CIC axis index/weight pair for the boundary mode.

    Periodic wraps the index; isolated (non-periodic) clamps it and zeroes
    the weight of any out-of-range contribution so mass outside [0, box)
    never aliases to the opposite grid face (ADVICE.md round-1 medium)."""
    if periodic:
        return jnp.mod(i, g), w
    valid = (i >= 0) & (i < g)
    return jnp.clip(i, 0, g - 1), jnp.where(valid, w, 0.0)


def cic_deposit(pos, mass, box_size: float, g: int,
                periodic: bool = True) -> jax.Array:
    """Scatter mass to the [g, g, g] density grid (CIC).

    periodic=False drops (rather than wraps) contributions outside the
    grid: a body fully outside [0, box)^3 deposits nothing."""
    i0, f = _cic_parts(pos, box_size, g)
    grid = jnp.zeros((g, g, g), jnp.float32)
    for dx in (0, 1):
        wx = jnp.where(dx == 0, 1.0 - f[:, 0], f[:, 0])
        ix, wx = _axis_index_weight(i0[:, 0] + dx, wx, g, periodic)
        for dy in (0, 1):
            wy = jnp.where(dy == 0, 1.0 - f[:, 1], f[:, 1])
            iy, wy = _axis_index_weight(i0[:, 1] + dy, wy, g, periodic)
            for dz in (0, 1):
                wz = jnp.where(dz == 0, 1.0 - f[:, 2], f[:, 2])
                iz, wz = _axis_index_weight(i0[:, 2] + dz, wz, g, periodic)
                grid = grid.at[ix, iy, iz].add(mass * wx * wy * wz)
    return grid


def cic_gather(field, pos, box_size: float, g: int,
               periodic: bool = True) -> jax.Array:
    """Gather a [g, g, g, C] grid field to the bodies ([N, C]).

    periodic=False zeroes out-of-range weights: a body fully outside
    [0, box)^3 gathers zero field."""
    i0, f = _cic_parts(pos, box_size, g)
    out = 0.0
    for dx in (0, 1):
        wx = jnp.where(dx == 0, 1.0 - f[:, 0], f[:, 0])
        ix, wx = _axis_index_weight(i0[:, 0] + dx, wx, g, periodic)
        for dy in (0, 1):
            wy = jnp.where(dy == 0, 1.0 - f[:, 1], f[:, 1])
            iy, wy = _axis_index_weight(i0[:, 1] + dy, wy, g, periodic)
            for dz in (0, 1):
                wz = jnp.where(dz == 0, 1.0 - f[:, 2], f[:, 2])
                iz, wz = _axis_index_weight(i0[:, 2] + dz, wz, g, periodic)
                out = out + field[ix, iy, iz] * (wx * wy * wz)[:, None]
    return out


def out_of_box_count(pos, box_size: float) -> jax.Array:
    """Number of bodies with any coordinate outside [0, box) — the PM
    domain-contract counter (analog of the P3M overflow counter)."""
    return jnp.sum(jnp.any((pos < 0) | (pos >= box_size), axis=-1))


def _kvec(g: int, box_size: float):
    k1 = 2 * jnp.pi * jnp.fft.fftfreq(g, d=box_size / g)
    kx = k1[:, None, None]
    ky = k1[None, :, None]
    kz = k1[None, None, :]
    k2 = kx**2 + ky**2 + kz**2
    return kx, ky, kz, k2


def _kvec_r(g: int, box_size: float):
    """fftfreq wavevectors for the rfftn half-spectrum (last axis halved)."""
    k1 = 2 * jnp.pi * jnp.fft.fftfreq(g, d=box_size / g)
    kzr = 2 * jnp.pi * jnp.fft.rfftfreq(g, d=box_size / g)
    return k1[:, None, None], k1[None, :, None], kzr[None, None, :]


def _cic_window_r(g: int) -> jax.Array:
    """_cic_window on the rfftn half-spectrum grid."""
    w1 = jnp.sinc(jnp.fft.fftfreq(g))
    wr = jnp.sinc(jnp.fft.rfftfreq(g))
    w = (
        w1[:, None, None] ** 2
        * w1[None, :, None] ** 2
        * wr[None, None, :] ** 2
    )
    return jnp.maximum(w, 0.05)


@functools.partial(jax.jit, static_argnames=("g", "smoothed"))
def isolated_green_hat(
    box_size: float, g: int, smooth_a=0.0, smoothed: bool = False
) -> jax.Array:
    """rfftn of the free-space Green's function on the 2g-padded Hockney
    grid — POSITION-INDEPENDENT, so callers stepping many frames at fixed
    (box, g) precompute it ONCE and pass it to pm_solve_grid /
    p3m_acceleration instead of re-FFT-ing a [2g]^3 volume every force
    evaluation (at g=128 that FFT is ~1/5 of the whole PM solve).

    smoothed=False: -1/r (plain PM; the r=0 cell uses the standard
    -1/(h/2) finite value). smoothed=True: -erf(r / smooth_a) / r, the
    P3M long-range kernel (finite -2/(a sqrt(pi)) at r=0); smooth_a is a
    dynamic arg so retuning a does not recompile."""
    gp = 2 * g
    h = box_size / g
    idx = jnp.arange(gp)
    d1 = jnp.minimum(idx, gp - idx).astype(jnp.float32) * h
    rx = d1[:, None, None]
    ry = d1[None, :, None]
    rz = d1[None, None, :]
    r = jnp.sqrt(rx**2 + ry**2 + rz**2)
    safe_r = jnp.where(r > 0, r, 1.0)
    if smoothed:
        from jax.scipy.special import erf

        a = jnp.asarray(smooth_a, jnp.float32)
        green = jnp.where(
            r > 0, -erf(r / a) / safe_r, -2.0 / (a * jnp.sqrt(jnp.pi))
        )
    else:
        green = jnp.where(r > 0, -1.0 / safe_r, -1.0 / (0.5 * h))
    return jnp.fft.rfftn(green)


def _isolated_solve_r(rho, G, box_size: float, g: int, green_hat,
                      deconvolve: bool = True):
    """[g, g, g, 3] acceleration grid from a [g]^3 density grid: Hockney
    zero-padding + the precomputed green_hat, all transforms REAL-valued
    (rfftn/irfftn — the density and every output are real, so the full
    complex fftn spectrum was 2x redundant work and memory)."""
    gp = 2 * g
    rho_p = jnp.zeros((gp, gp, gp), jnp.float32).at[:g, :g, :g].set(rho)
    phi_hat = jnp.fft.rfftn(rho_p) * green_hat * G
    if deconvolve:
        phi_hat = phi_hat / _cic_window_r(gp) ** 2
    kx, ky, kz = _kvec_r(gp, 2 * box_size)
    s = (gp, gp, gp)
    ax = jnp.fft.irfftn(1j * kx * phi_hat, s=s)
    ay = jnp.fft.irfftn(1j * ky * phi_hat, s=s)
    az = jnp.fft.irfftn(1j * kz * phi_hat, s=s)
    return -jnp.stack([ax, ay, az], axis=-1)[:g, :g, :g]


@functools.partial(jax.jit, static_argnames=("g", "isolated", "deconvolve"))
def pm_acceleration(
    pos: jax.Array,  # [N, 3] — must lie in [0, box)^3 for periodic,
    mass: jax.Array,  # [N]      [0, box/2)^3 recommended for isolated
    G,
    box_size: float,
    g: int = 128,
    isolated: bool = True,
    deconvolve: bool = True,
    green_hat: jax.Array | None = None,
) -> jax.Array:
    """PM gravitational acceleration at each body, [N, 3].

    isolated=True solves vacuum boundaries on a 2x zero-padded grid with the
    free-space Green's function (Hockney); False is fully periodic.
    deconvolve divides out the CIC assignment window twice (deposit+gather),
    sharpening forces near the grid scale. Pass green_hat
    (= isolated_green_hat(box, g)) to skip re-FFT-ing the Green's function
    per evaluation (frame loops at fixed box/g).
    """
    rho = cic_deposit(pos, mass, box_size, g, periodic=not isolated)
    acc_grid = pm_solve_grid(rho, G, box_size, g, isolated, deconvolve,
                             green_hat)
    return cic_gather(acc_grid, pos, box_size, g, periodic=not isolated)


@functools.partial(jax.jit, static_argnames=("g", "isolated", "deconvolve"))
def pm_solve_grid(rho, G, box_size: float, g: int,
                  isolated: bool = True, deconvolve: bool = True,
                  green_hat: jax.Array | None = None):
    """[g, g, g, 3] acceleration grid from a deposited density grid — the
    FFT solve of pm_acceleration factored out so a SHARDED caller can
    psum per-chip cic_deposit grids into the global density and run this
    (replicated, N-independent) solve without ever gathering bodies
    (nbx.parallel.spatial's halo-exchange step). Jitted for standalone
    use.

    The isolated solve runs entirely in rfftn/irfftn (real data — the
    full complex spectrum was 2x redundant); green_hat short-circuits the
    Green's-function transform (see isolated_green_hat)."""
    if isolated:
        if green_hat is None:
            green_hat = isolated_green_hat(box_size, g)
        acc_grid = _isolated_solve_r(rho, G, box_size, g, green_hat,
                                     deconvolve)
    else:
        kx, ky, kz, k2 = _kvec(g, box_size)
        rho_hat = jnp.fft.fftn(rho)
        vol = (box_size / g) ** 3
        safe_k2 = jnp.where(k2 > 0, k2, 1.0)
        phi_hat = jnp.where(k2 > 0, -4 * jnp.pi * G * rho_hat / (safe_k2 * vol), 0.0)
        if deconvolve:
            phi_hat = phi_hat / _cic_window(g) ** 2
        ax = jnp.real(jnp.fft.ifftn(1j * kx * phi_hat))
        ay = jnp.real(jnp.fft.ifftn(1j * ky * phi_hat))
        az = jnp.real(jnp.fft.ifftn(1j * kz * phi_hat))
        acc_grid = -jnp.stack([ax, ay, az], axis=-1)

    return acc_grid


def _cic_window(g: int) -> jax.Array:
    """CIC assignment window W(k) = prod sinc^2(k h / 2) on the FFT grid,
    floored away from zero for stable deconvolution."""
    w1 = jnp.sinc(jnp.fft.fftfreq(g))  # per-axis sinc(k h / 2 / pi)
    w = (
        w1[:, None, None] ** 2
        * w1[None, :, None] ** 2
        * w1[None, None, :] ** 2
    )
    return jnp.maximum(w, 0.05)  # sinc^2 >= 0; floor stabilizes Nyquist


@functools.partial(jax.jit, static_argnames=("g", "n_steps", "isolated"))
def pm_kdk_scan(pos, vel, mass, G, box_size: float, h, n_steps: int,
                g: int = 128, isolated: bool = True):
    """KDK leapfrog under lax.scan with PM forces (the scaling-path
    integrator; same ordering semantics as the direct-sum step). Periodic
    runs (isolated=False) wrap the drift back into [0, box).

    Returns (pos, vel, max_out_of_box): the third output is the maximum
    per-step count of bodies outside [0, box)^3 seen over the scan. For
    isolated runs those bodies silently decouple from the PM field (CIC
    drops them, see cic_deposit) — a nonzero count means the domain
    contract was violated and the box should be enlarged/recentered."""
    force = lambda p: pm_acceleration(p, mass, G, box_size, g, isolated)

    def body(c, _):
        p, v, a = c
        v = v + a * (0.5 * h)
        p = p + v * h
        if not isolated:
            p = jnp.mod(p, box_size)
        a = force(p)
        v = v + a * (0.5 * h)
        return (p, v, a), out_of_box_count(p, box_size)

    (p, v, a), oob = jax.lax.scan(
        body, (pos, vel, force(pos)), None, length=n_steps
    )
    return p, v, jnp.max(oob)
