"""Cell-binned bounce resolution — collisions beyond the O(C^2) envelope.

The masked dense formulation (nbx.collisions) is exact reference semantics
but carries [C, C] pair matrices (interactive up to a capacity of a few
thousand). This module extends the BOUNCE subsystem (impulse + friction +
Baumgarte correction + impact heating, index.html:327-369 and 335-336) to
granular scales (planetary rings, debris disks, 100k+ bodies) with the same
cell-binning machinery as the P3M short-range pass:

  * bodies binned into cells of size >= 2 * max radius (one argsort)
  * each body resolves against its 27-cell neighborhood in [K, K] blocks
  * both ordered copies of every pair are processed (i as target of j and
    vice versa), each accumulating its own side of the impulse — exactly
    the dense Jacobi application, so results match nbx.collisions bit-for-
    fp-reordering on scenes where no merge/fracture fires

Deliberately OUT of scope here (use the dense path): merge/fracture events
and contact timers — their pairwise bookkeeping is what actually needs the
[C, C] state. Granular dynamics is bounce-dominated, which is why this
split pays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from nbx.config import SimConfig
from nbx.ops.p3m import cell_bin

CORRECTION = 0.8  # Baumgarte factor (index.html:350)
HEAT_FRACTION = 0.2  # impact heating fraction (index.html:335)


@functools.partial(
    jax.jit, static_argnames=("n_cells", "max_per_cell", "chunk")
)
def resolve_bounces_binned(
    pos,  # [N, 3] — must lie in [0, box)^3
    vel,  # [N, 3]
    mass,  # [N] (0 = dead/padding)
    radius,  # [N]
    box_size: float,
    n_cells: int,
    restitution=0.2,
    friction=0.5,
    max_per_cell: int = 32,
    chunk: int = 512,
):
    """One bounce sweep. Returns (dpos, dvel, dtemp, n_bounces, n_overflow,
    cell_too_small) — deltas to ADD to the caller's state.

    cell_too_small flags 2 * max(radius) > cell size, i.e. pairs can span
    beyond the 27-neighborhood and some contacts may be missed (surfaced,
    never silent)."""
    n = pos.shape[0]
    g = n_cells
    cell = box_size / g
    table, _, n_overflow = cell_bin(pos, box_size, g, max_per_cell)
    c_total = g * g * g
    pos_p = jnp.concatenate([pos, jnp.full((1, 3), 2.0 * box_size)], 0)
    vel_p = jnp.concatenate([vel, jnp.zeros((1, 3))], 0)
    mass_p = jnp.concatenate([mass, jnp.zeros((1,))], 0)
    rad_p = jnp.concatenate([radius, jnp.zeros((1,))], 0)
    inv_p = jnp.where(mass_p > 0, 1.0 / jnp.where(mass_p > 0, mass_p, 1.0), 0.0)

    cc = jnp.arange(c_total, dtype=jnp.int32)
    ci = cc // (g * g)
    cj = (cc // g) % g
    ck = cc % g
    neigh, dup = [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                ni = jnp.clip(ci + di, 0, g - 1)
                nj = jnp.clip(cj + dj, 0, g - 1)
                nk = jnp.clip(ck + dk, 0, g - 1)
                dup.append((ni == ci + di) & (nj == cj + dj) & (nk == ck + dk))
                neigh.append((ni * g + nj) * g + nk)
    neigh = jnp.stack(neigh, 1)
    dup = jnp.stack(dup, 1)

    k = max_per_cell

    def cell_chunk(c0):
        cs_raw = c0 + jnp.arange(chunk)
        in_range = cs_raw < c_total
        cs = jnp.minimum(cs_raw, c_total - 1)
        tgt_idx = jnp.where(in_range[:, None], table[cs], n)  # [chunk, K]
        tp = pos_p[tgt_idx]
        tv = vel_p[tgt_idx]
        tm = mass_p[tgt_idx]
        tr = rad_p[tgt_idx]
        tinv = inv_p[tgt_idx]
        dvel = jnp.zeros((chunk, k, 3), jnp.float32)
        dpos = jnp.zeros((chunk, k, 3), jnp.float32)
        heat = jnp.zeros((chunk, k), jnp.float32)
        n_b = jnp.zeros((), jnp.int32)
        for o in range(27):
            src_idx = table[neigh[cs, o]]
            src_idx = jnp.where(dup[cs, o][:, None], src_idx, n)
            sp = pos_p[src_idx]
            sv = vel_p[src_idx]
            sm = mass_p[src_idx]
            sr = rad_p[src_idx]
            sinv = inv_p[src_idx]
            d = sp[:, None, :, :] - tp[:, :, None, :]  # [c, K, K, 3] i -> j
            r2 = jnp.sum(d * d, -1)
            min_d = tr[:, :, None] + sr[:, None, :]
            distinct = tgt_idx[:, :, None] != src_idx[:, None, :]
            overlap = (
                distinct
                & (r2 < min_d * min_d)
                & (tm[:, :, None] > 0)
                & (sm[:, None, :] > 0)
            )
            dist = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
            nrm = d / dist[..., None]
            rv = sv[:, None, :, :] - tv[:, :, None, :]  # v_j - v_i
            vn = jnp.sum(rv * nrm, -1)
            act = overlap & (vn < 0)  # approaching gate (index.html:327)
            inv_sum = tinv[:, :, None] + sinv[:, None, :]
            safe_is = jnp.where(inv_sum > 0, inv_sum, 1.0)
            j_imp = jnp.where(act, -(1.0 + restitution) * vn / safe_is, 0.0)
            # tangential friction (index.html:364-369)
            t_raw = rv - vn[..., None] * nrm
            t_len = jnp.sqrt(jnp.sum(t_raw * t_raw, -1))
            t_hat = t_raw / jnp.where(t_len > 0, t_len, 1.0)[..., None]
            jt = jnp.where(act, -t_len * friction / safe_is, 0.0)
            imp = j_imp[..., None] * nrm + jt[..., None] * t_hat
            # this body's (target's) side of the impulse: vel_i -= imp * inv_i
            dvel = dvel - jnp.sum(imp, 2) * tinv[..., None]
            # Baumgarte position correction (index.html:350-352)
            corr = jnp.where(act, (min_d - dist) / safe_is * CORRECTION, 0.0)
            dpos = dpos - jnp.sum(corr[..., None] * nrm, 2) * tinv[..., None]
            # impact heating (index.html:333-336): dT_i = E / m_i * 0.2
            mu = tm[:, :, None] * sm[:, None, :] / jnp.where(
                tm[:, :, None] + sm[:, None, :] > 0,
                tm[:, :, None] + sm[:, None, :], 1.0)
            energy = jnp.where(act, 0.5 * mu * vn * vn, 0.0)
            heat = heat + jnp.sum(energy, 2) * tinv * HEAT_FRACTION
            n_b = n_b + jnp.sum(act.astype(jnp.int32))
        return (dvel, dpos, heat, n_b), tgt_idx

    n_chunks = (c_total + chunk - 1) // chunk
    (dv, dp, ht, nb), idxs = jax.lax.map(
        cell_chunk, jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    )
    flat = idxs.reshape(-1)
    dvel = jnp.zeros((n + 1, 3), jnp.float32).at[flat].add(
        dv.reshape(-1, 3), mode="drop")[:n]
    dpos = jnp.zeros((n + 1, 3), jnp.float32).at[flat].add(
        dp.reshape(-1, 3), mode="drop")[:n]
    dtemp = jnp.zeros((n + 1,), jnp.float32).at[flat].add(
        ht.reshape(-1), mode="drop")[:n]
    # each contact was counted from both sides
    n_bounces = jnp.sum(nb) // 2
    cell_too_small = 2.0 * jnp.max(radius) > cell
    return dpos, dvel, dtemp, n_bounces, n_overflow, cell_too_small


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "n_cells", "max_per_cell", "force_impl"),
)
def granular_kdk_scan(
    pos, vel, mass, radius, G, eps, h, box_size: float, n_steps: int,
    n_cells: int = 32, max_per_cell: int = 32, restitution=0.2, friction=0.5,
    heat_decay=0.998, temp=None, force_impl: str = "auto",
):
    """Granular dynamics loop: KDK gravity + binned bounces + thermal decay,
    reference substep ordering (index.html:247-262) at granular scale.
    Returns (pos, vel, temp, total_bounces, max_overflow, flags) where flags
    is a dict of surfaced contract violations (never silent):

      * cell_too_small — some step had 2*max(radius) > cell size, so pairs
        could span past the 27-neighborhood and contacts may be missed
      * max_out_of_box — max per-step count of bodies outside [0, box)^3.
        The binner clips escapees into boundary face cells, which degrades
        those cells toward dense work and can overflow max_per_cell; the
        loop itself does NOT wrap positions (the box is a binning domain,
        not periodic space). Nonzero means grow box_size or recenter.
    """
    from nbx import thermal
    from nbx.ops.pm import out_of_box_count
    from nbx.sim import gravity

    if temp is None:
        temp = jnp.zeros_like(mass)

    def body(c, _):
        p, v, a, t, nb, ovf, small, oob = c
        v = v + a * (0.5 * h)
        p = p + v * h
        a = gravity(p, mass, G, eps, force_impl)
        dp, dv, dt, n_b, n_o, too_small = resolve_bounces_binned(
            p, v, mass, radius, box_size, n_cells, restitution, friction,
            max_per_cell,
        )
        p, v, t = p + dp, v + dv, t + dt
        v = v + a * (0.5 * h)
        t = thermal.decay(t, heat_decay)
        return (
            p, v, a, t, nb + n_b, jnp.maximum(ovf, n_o),
            small | too_small,
            jnp.maximum(oob, out_of_box_count(p, box_size)),
        ), None

    zero = jnp.zeros_like(pos)
    init = (
        pos, vel, zero, temp, jnp.int32(0), jnp.int32(0),
        jnp.bool_(False), jnp.int32(0),
    )
    (p, v, _, t, nb, ovf, small, oob), _ = jax.lax.scan(
        body, init, None, length=n_steps
    )
    return p, v, t, nb, ovf, {"cell_too_small": small, "max_out_of_box": oob}
