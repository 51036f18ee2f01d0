"""Dense (jnp) softened pairwise gravity — oracle and small-N path.

Physics semantics from the reference's computeGravity (index.html:264-291):
Plummer softening, f = G / (d^2 + eps^2)^(3/2), acc_i += f * m_j * (p_j - p_i).
The i == j term is exactly zero (finite f times zero displacement) as long as
eps > 0; for eps == 0 the diagonal is masked explicitly.

For large N the O(N^2) memory of the fully dense form is avoided by
row-blocked `lax.map` variants (the plain XLA path on every backend); the
GPU's direct-sum kernel is in nbx.ops.pairwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def accelerations(
    pos: jax.Array, mass: jax.Array, G: jax.Array | float, softening: jax.Array | float
) -> jax.Array:
    """Direct-sum softened gravity, O(N^2) memory. pos [N,3], mass [N] -> acc [N,3]."""
    d = pos[None, :, :] - pos[:, None, :]  # d[i, j] = p_j - p_i (index.html:277)
    eps2 = jnp.asarray(softening, pos.dtype) ** 2
    r2 = jnp.sum(d * d, axis=-1) + eps2
    n = pos.shape[0]
    # Guard zero distances for eps == 0: the diagonal, AND coincident pairs
    # (e.g. dead capacity slots all parked at the origin) — 0^-1.5 * 0 = nan.
    zero = (r2 <= 0.0) | jnp.eye(n, dtype=bool)
    safe = jnp.where(zero, 1.0, r2)
    f = G * jax.lax.rsqrt(safe) / safe  # G / r2^(3/2) (index.html:280)
    w = jnp.where(zero, 0.0, f * mass[None, :])
    return jnp.einsum("ij,ijc->ic", w, d)


def _map_target_blocks(fn, targets, block: int):
    """fn over target row blocks under lax.map: O(block * N) memory.

    targets is a tuple of [Nt, ...] arrays; they are padded with zeros to a
    multiple of `block` and the padded rows are cut from the result."""
    nt = targets[0].shape[0]
    block = max(1, min(block, nt))
    nb = -(-nt // block)
    pad = nb * block - nt
    blocks = tuple(
        jnp.pad(t, [(0, pad)] + [(0, 0)] * (t.ndim - 1)).reshape(
            (nb, block) + t.shape[1:]
        )
        for t in targets
    )
    out = jax.lax.map(lambda b: fn(*b), blocks)
    return jax.tree.map(
        lambda o: o.reshape((nb * block,) + o.shape[2:])[:nt], out
    )


def _pair_geometry(pos, pi, eps2):
    """Per-component displacements p_j - p_i [B, N] and r^2 + eps^2."""
    dx = pos[None, :, 0] - pi[:, 0:1]  # index.html:277
    dy = pos[None, :, 1] - pi[:, 1:2]
    dz = pos[None, :, 2] - pi[:, 2:3]
    return dx, dy, dz, dx * dx + dy * dy + dz * dz + eps2


def accelerations_blocked(
    pos: jax.Array,
    mass: jax.Array,
    G: jax.Array | float,
    softening: jax.Array | float,
    block: int = 1024,
    target_pos: jax.Array | None = None,
) -> jax.Array:
    """Same physics, O(N * block) memory via lax.map over target blocks.

    The plain XLA version of the direct sum (the rival of the Pallas kernel
    in nbx.ops.pairwise): each component is a multiply-and-reduce over the
    source axis, which XLA fuses into reductions without materialising a
    [block, N, 3] displacement tensor. target_pos (default: the sources)
    gives the rectangular problem of the sharded path; any Nt works."""
    eps2 = jnp.asarray(softening, pos.dtype) ** 2
    mass = mass.astype(pos.dtype)

    def row_block(pi):
        dx, dy, dz, r2 = _pair_geometry(pos, pi, eps2)
        safe = jnp.where(r2 > 0, r2, 1.0)
        w = jnp.where(r2 > 0, G * jax.lax.rsqrt(safe) / safe * mass[None, :],
                      0.0)
        return jnp.stack(
            [jnp.sum(w * dx, 1), jnp.sum(w * dy, 1), jnp.sum(w * dz, 1)], -1
        )

    tgt = pos if target_pos is None else target_pos.astype(pos.dtype)
    return _map_target_blocks(row_block, (tgt,), block)


def acc_and_jerk(
    pos: jax.Array,
    mass: jax.Array,
    vel: jax.Array,
    G: jax.Array | float,
    softening: jax.Array | float,
) -> tuple[jax.Array, jax.Array]:
    """Softened acceleration AND its time derivative (jerk) — the force
    evaluation the 4th-order Hermite scheme needs (nbx.integrators.hermite):

        acc_i  = G sum_j m_j d_ij / s^3,           s^2 = |d|^2 + eps^2
        jerk_i = G sum_j m_j [ v_ij / s^3 - 3 (d_ij . v_ij) d_ij / s^5 ]

    Same pair masking rules as accelerations(). The reference has no such
    integrator (its loop is the KDK of index.html:247-262); this is a
    beyond-reference capability for high-accuracy few-body work.
    """
    d = pos[None, :, :] - pos[:, None, :]  # d[i, j] = p_j - p_i
    dv = vel[None, :, :] - vel[:, None, :]
    eps2 = jnp.asarray(softening, pos.dtype) ** 2
    r2 = jnp.sum(d * d, axis=-1) + eps2
    n = pos.shape[0]
    zero = (r2 <= 0.0) | jnp.eye(n, dtype=bool)
    safe = jnp.where(zero, 1.0, r2)
    inv = jax.lax.rsqrt(safe)
    inv3 = inv / safe  # s^-3
    w = jnp.where(zero, 0.0, G * mass[None, :] * inv3)
    acc = jnp.einsum("ij,ijc->ic", w, d)
    rv = jnp.sum(d * dv, axis=-1)  # d . v per pair
    jerk = jnp.einsum("ij,ijc->ic", w, dv) - jnp.einsum(
        "ij,ijc->ic", w * 3.0 * rv / safe, d
    )
    return acc, jerk


def potential_energy(
    pos: jax.Array,
    mass: jax.Array,
    G: jax.Array | float,
    softening: jax.Array | float,
    block: int | None = None,
) -> jax.Array:
    """Softened potential energy consistent with the force law:
    U = -G * sum_{i<j} m_i m_j / sqrt(d^2 + eps^2).

    The reference never computes energy; this is the diagnostics quantity the
    drift gates (SURVEY.md section 4.3) are expressed in.
    """
    eps2 = jnp.asarray(softening, pos.dtype) ** 2
    n = pos.shape[0]
    if block is None:
        d = pos[None, :, :] - pos[:, None, :]
        r2 = jnp.sum(d * d, axis=-1) + eps2
        zero = (r2 <= 0.0) | jnp.eye(n, dtype=bool)
        inv_r = jax.lax.rsqrt(jnp.where(zero, 1.0, r2))
        mm = mass[:, None] * mass[None, :]
        mm = jnp.where(zero, 0.0, mm)
        return -0.5 * G * jnp.sum(mm * inv_r)

    assert n % block == 0

    def row_block(i0):
        pi = jax.lax.dynamic_slice_in_dim(pos, i0, block, axis=0)
        mi = jax.lax.dynamic_slice_in_dim(mass, i0, block, axis=0)
        d = pos[None, :, :] - pi[:, None, :]
        r2 = jnp.sum(d * d, axis=-1) + eps2
        row = jax.lax.broadcasted_iota(jnp.int32, (block, n), 0) + i0
        col = jax.lax.broadcasted_iota(jnp.int32, (block, n), 1)
        zero = (row == col) | (r2 <= 0.0)
        r2 = jnp.where(zero, 1.0, r2)
        mm = jnp.where(zero, 0.0, mi[:, None] * mass[None, :])
        return jnp.sum(mm * jax.lax.rsqrt(r2))

    total = jnp.sum(jax.lax.map(row_block, jnp.arange(0, n, block)))
    return -0.5 * G * total


def acc_and_jerk_blocked(
    pos: jax.Array,
    mass: jax.Array,
    vel: jax.Array,
    G: jax.Array | float,
    softening: jax.Array | float,
    block: int = 512,
    target_pos: jax.Array | None = None,
    target_vel: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """acc_and_jerk in O(N * block) memory over target blocks (the at-scale
    force evaluation of the Hermite integrator). Requires softening > 0:
    the self pair is finite through eps^2 and contributes 0."""
    eps2 = jnp.asarray(softening, pos.dtype) ** 2

    def row_block(pi, vi):
        dx, dy, dz, r2 = _pair_geometry(pos, pi, eps2)
        dvx = vel[None, :, 0] - vi[:, 0:1]
        dvy = vel[None, :, 1] - vi[:, 1:2]
        dvz = vel[None, :, 2] - vi[:, 2:3]
        inv = jax.lax.rsqrt(r2)
        inv2 = inv * inv
        w = G * mass[None, :] * inv * inv2  # G m_j / s^3
        c = 3.0 * (dx * dvx + dy * dvy + dz * dvz) * inv2  # 3 (d.dv) / s^2
        acc = [jnp.sum(w * d, 1) for d in (dx, dy, dz)]
        jerk = [jnp.sum(w * (dv - c * d), 1)
                for d, dv in ((dx, dvx), (dy, dvy), (dz, dvz))]
        return jnp.stack(acc, -1), jnp.stack(jerk, -1)

    if target_pos is None:
        target_pos, target_vel = pos, vel
    return _map_target_blocks(row_block, (target_pos, target_vel), block)


def potential_per_body(
    pos: jax.Array,
    mass: jax.Array,
    G: jax.Array | float,
    softening: jax.Array | float,
    target_pos: jax.Array | None = None,
    target_mass: jax.Array | None = None,
    block: int = 1024,
) -> jax.Array:
    """phi_i = -G sum_{j != i} m_j / sqrt(d^2 + eps^2) per target, [Nt].

    Targets default to the sources. When targets are a subset of the
    sources (the sharded path), pass target_pos/target_mass: each target is
    assumed to appear exactly once among the sources, and its self term
    -G m_i / eps is removed. U = 0.5 * sum_i m_i phi_i. Requires eps > 0."""
    eps2 = jnp.asarray(softening, pos.dtype) ** 2

    def row_block(pi):
        _, _, _, r2 = _pair_geometry(pos, pi, eps2)
        return -G * jnp.sum(mass[None, :] * jax.lax.rsqrt(r2), 1)

    if target_pos is None:
        target_pos, target_mass = pos, mass
    phi = _map_target_blocks(row_block, (target_pos,), block)
    return phi + G * target_mass / softening


def kinetic_energy(vel: jax.Array, mass: jax.Array) -> jax.Array:
    return 0.5 * jnp.sum(mass * jnp.sum(vel * vel, axis=-1))
