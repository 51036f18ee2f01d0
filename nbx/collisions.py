"""Collision resolution: contact timers, impulse bounce, merge, fracture.

Re-expresses the reference's sequential in-place pair sweep
(/root/reference/index.html:293-443) as masked data-parallel work over the
fixed-capacity SoA state:

  reference (scalar JS, in-place, pair order (i, j) lexicographic)   nbx (XLA)
  ----------------------------------------------------------------  ---------
  overlap test  d^2 < (rA+rB)^2                 (L311-313)           [C, C] masked matrices
  contact-time Map<pairId, seconds> += dt       (L314-319)           contact[C, C] += h where overlapping, else 0 (prune, L376-380)
  approaching gate relVel . n < 0               (L325-327)           mask
  impulse j = -(1+e)(v.n)/(1/mA+1/mB), e = 0.2  (L328-329)           per-pair matrix
  impact energy E = mu/2 (v.n)^2                (L332-333)           per-pair matrix
  heating dT = (E/m) * 0.2 per body             (L335-336)           Jacobi row-sum over approaching pairs
  merge if contactTime > mergeTime and Q < 2T   (L340-346)           event candidate
  fracture if Q > T and a parent > minFragMass  (L348, 354-359)      event candidate
  position correction 0.8 Baumgarte             (L350-352)           Jacobi accumulation (fracture + bounce branches)
  bounce: normal impulse + 0.5 friction         (L361-369)           Jacobi accumulation
  removedIndices skip (one event per body)      (L302-304)           iterated greedy matching by pair priority

Semantic divergence (documented, gated by parity tests at small N): the
reference applies pair updates *sequentially*, so within one sweep a later
pair sees earlier pairs' impulses and corrections. nbx accumulates all pair
impulses from the pre-sweep state and applies them at once (Jacobi style).
For isolated pairs (<= 1 overlap per body) the two are bit-identical; for
contact clusters they differ by O(h) within one substep. Event *selection*
(which pairs merge/fracture) matches the reference's greedy sweep order
exactly when `match_rounds` iterations suffice to converge the matching —
leftover candidates simply retry next substep (contact timers persist).

RNG: fracture fragment counts/masses/directions use splittable `jax.random`
keys carried in the state, replacing the reference's irreproducible
Math.random (L418-433) with deterministic, checkpointable sampling.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from nbx import thermal
from nbx.config import SimConfig, inverse_mass
from nbx.state import SimState, add_bodies_batch

# Reference values (index.html:328, 365, 350); restitution and friction are
# live-tunable via SimConfig (the constants are just the defaults there).
RESTITUTION = 0.2
FRICTION = 0.5
CORRECTION = 0.8  # Baumgarte position-correction factor


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Events:
    """Per-substep event log — the explicit output replacing the reference's
    physics->renderer calls (triggerFlash L358/L408, spawnExplosion L441).

    Fixed-size masked buffers (shapes static for scan stacking):
      merges:    flash at merged COM with energy 0.5 * merged mass (L408)
      fractures: flash at pair midpoint with the impact energy (L358)
      spawns:    one explosion per fragment at (pos, temp) (L441)
    """

    merge_pos: jax.Array  # [M, 3]
    merge_mass: jax.Array  # [M]
    merge_mask: jax.Array  # [M] bool
    fracture_pos: jax.Array  # [F, 3]
    fracture_energy: jax.Array  # [F]
    fracture_mask: jax.Array  # [F] bool
    spawn_pos: jax.Array  # [F * K, 3] fragment explosion sites
    spawn_temp: jax.Array  # [F * K]
    spawn_mask: jax.Array  # [F * K] bool
    n_merges: jax.Array  # [] i32
    n_fractures: jax.Array  # [] i32
    n_bounces: jax.Array  # [] i32
    n_evicted: jax.Array  # [] i32  FIFO evictions caused by births (L240-242)
    n_dropped: jax.Array  # [] i32  event candidates lost to buffer caps


def empty_events(cfg: SimConfig) -> Events:
    m, f, k = cfg.max_merges, cfg.max_fractures, cfg.max_fragments
    z = jnp.zeros
    return Events(
        merge_pos=z((m, 3), jnp.float32),
        merge_mass=z((m,), jnp.float32),
        merge_mask=z((m,), bool),
        fracture_pos=z((f, 3), jnp.float32),
        fracture_energy=z((f,), jnp.float32),
        fracture_mask=z((f,), bool),
        spawn_pos=z((f * k, 3), jnp.float32),
        spawn_temp=z((f * k,), jnp.float32),
        spawn_mask=z((f * k,), bool),
        n_merges=z((), jnp.int32),
        n_fractures=z((), jnp.int32),
        n_bounces=z((), jnp.int32),
        n_evicted=z((), jnp.int32),
        n_dropped=z((), jnp.int32),
    )


def _greedy_match(cand: jax.Array, rounds: int) -> jax.Array:
    """Greedy maximal matching over candidate pairs by (i, j) lexicographic
    priority — the parallel equivalent of the reference sweep's
    `removedIndices` skipping (index.html:302-304, 342-343, 356-357).

    cand: [C, C] bool, upper-triangular candidate pairs. Returns the matched
    subset. Each round selects every pair that is the minimum-priority
    candidate for *both* of its bodies (this always includes the globally
    minimum pair, so `rounds` iterations select >= `rounds` prefix layers of
    the exact sequential greedy matching).
    """
    c = cand.shape[0]
    row = jax.lax.broadcasted_iota(jnp.int32, (c, c), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (c, c), 1)
    prio = row * c + col  # lexicographic (i, j) sweep order
    big = jnp.int32(c * c)

    def body(_, carry):
        cand, matched = carry
        p = jnp.where(cand, prio, big)
        p_sym = jnp.minimum(p, p.T)  # body b's best candidate priority
        best = jnp.min(p_sym, axis=1)  # [C]
        # pair (i,j) is selected iff it is the best candidate of both i and j
        sel = cand & (p == best[:, None]) & (p == best[None, :])
        matched = matched | sel
        used = jnp.any(sel, axis=1) | jnp.any(sel, axis=0)  # consumed bodies
        cand = cand & ~used[:, None] & ~used[None, :]
        return cand, matched

    _, matched = jax.lax.fori_loop(
        0, rounds, body, (cand, jnp.zeros_like(cand))
    )
    return matched


def _top_pairs(sel: jax.Array, k: int) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Extract up to k selected pairs in sweep order. Returns (i, j, valid).

    `sel` comes from a matching, so each row holds at most one selected
    column: row reductions + a rank scatter suffice — no sort/top_k over
    the C^2 pair space.
    """
    c = sel.shape[0]
    row_has = jnp.any(sel, axis=1)  # [C]
    j_of = jnp.argmax(sel, axis=1).astype(jnp.int32)  # [C]
    rank = jnp.cumsum(row_has.astype(jnp.int32)) - 1  # [C] sweep order
    tgt = jnp.where(row_has & (rank < k), rank, k)  # k = dropped
    ii = jnp.full((k,), c, jnp.int32).at[tgt].set(
        jnp.arange(c, dtype=jnp.int32), mode="drop"
    )
    valid = ii < c
    jj = jnp.where(valid, j_of[jnp.clip(ii, 0, c - 1)], 0)
    return jnp.where(valid, ii, 0), jj, valid


def resolve_collisions(
    state: SimState, cfg: SimConfig, h: jax.Array | float
) -> tuple[SimState, Events]:
    """One collision sweep (reference resolveCollisions, index.html:293-390).

    Runs between the force evaluation and the second half-kick (order matters:
    index.html:255-259). Mutates pos/vel/temp/contact, kills merged/fractured
    bodies, and births merged bodies + fragments (with FIFO eviction).
    """
    c = state.capacity
    pos, vel, mass, temp = state.pos, state.vel, state.mass, state.temp
    alive = state.alive
    inv_m = inverse_mass(mass)
    radius = state.radius(cfg)

    row = jax.lax.broadcasted_iota(jnp.int32, (c, c), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (c, c), 1)
    upper = row < col
    pair_alive = alive[:, None] & alive[None, :] & upper

    d = pos[None, :, :] - pos[:, None, :]  # d[i, j] = p_j - p_i (L309)
    dist2 = jnp.sum(d * d, axis=-1)
    min_dist = radius[:, None] + radius[None, :]
    overlap = pair_alive & (dist2 < min_dist * min_dist)  # L313

    # --- contact-time accumulation + pruning (L314-319, L376-380) ---------
    overlap_sym = overlap | overlap.T
    contact = jnp.where(overlap_sym, state.contact + h, 0.0)

    dist = jnp.sqrt(jnp.where(dist2 > 0, dist2, 1.0))
    normal = d / dist[:, :, None]  # unit, i -> j (L322)
    rel_vel = vel[None, :, :] - vel[:, None, :]  # v_j - v_i (L324)
    vn = jnp.sum(rel_vel * normal, axis=-1)
    approaching = overlap & (vn < 0)  # L327

    inv_sum = inv_m[:, None] + inv_m[None, :]
    safe_inv_sum = jnp.where(inv_sum > 0, inv_sum, 1.0)
    j_imp = -(1.0 + cfg.restitution) * vn / safe_inv_sum  # L329
    m_sum = mass[:, None] + mass[None, :]
    safe_m_sum = jnp.where(m_sum > 0, m_sum, 1.0)
    mu = mass[:, None] * mass[None, :] / safe_m_sum  # L332
    energy = 0.5 * mu * vn * vn  # L333
    q = energy / safe_m_sum  # specific energy (L338)

    # --- heating: every approaching pair heats both bodies (L335-336) -----
    appr_sym = approaching | approaching.T
    e_sym = jnp.where(appr_sym, jnp.maximum(energy, energy.T), 0.0)
    heat = thermal.impact_heating(jnp.sum(e_sym, axis=1), mass)
    temp = temp + heat

    # --- branch classification (L340-370) ---------------------------------
    merge_cand = (
        approaching
        & (contact > cfg.merge_time)
        & (q < cfg.fracture_threshold * 2.0)
    )
    fracture_cand = (
        approaching
        & ~merge_cand
        & (q > cfg.fracture_threshold)
        & (
            (mass[:, None] > cfg.min_fragment_mass)
            | (mass[None, :] > cfg.min_fragment_mass)
        )
    )
    event_cand = merge_cand | fracture_cand
    matched = _greedy_match(event_cand, cfg.match_rounds)
    merge_sel = matched & merge_cand
    fract_sel = matched & fracture_cand
    consumed = jnp.any(matched, axis=1) | jnp.any(matched, axis=0)

    # Bounce pairs: approaching, not an event candidate, neither body consumed
    # (a consumed body skips later pairs in the reference sweep, L302-304).
    bounce = approaching & ~event_cand & ~consumed[:, None] & ~consumed[None, :]

    # --- position correction: fracture + bounce branches (L350-352) -------
    corr_pairs = bounce | fract_sel
    corr_mag = jnp.where(
        corr_pairs, (min_dist - dist) / safe_inv_sum * CORRECTION, 0.0
    )
    corr_vec = corr_mag[:, :, None] * normal  # [C, C, 3]
    dpos = (
        jnp.sum(corr_vec, axis=0) - jnp.sum(corr_vec, axis=1)
    ) * inv_m[:, None]
    pos = pos + dpos

    # --- bounce impulses: normal + friction (L361-369) --------------------
    tangent_raw = rel_vel - vn[:, :, None] * normal
    t_len = jnp.sqrt(jnp.sum(tangent_raw * tangent_raw, axis=-1))
    # THREE.Vector3.normalize maps the zero vector to zero (length || 1).
    tangent = tangent_raw / jnp.where(t_len > 0, t_len, 1.0)[:, :, None]
    jt = -t_len * cfg.friction / safe_inv_sum  # relVel . tangent == |tangent_raw|
    imp = jnp.where(bounce, j_imp, 0.0)[:, :, None] * normal + jnp.where(
        bounce, jt, 0.0
    )[:, :, None] * tangent
    dvel = (jnp.sum(imp, axis=0) - jnp.sum(imp, axis=1)) * inv_m[:, None]
    vel = vel + dvel

    state = state.replace(pos=pos, vel=vel, temp=temp, contact=contact)

    # --- merge events (L392-409) -------------------------------------------
    mi, mj, m_valid = _top_pairs(merge_sel, cfg.max_merges)
    # Note: merge uses UNcorrected positions (correction is skipped by the
    # `continue` at L345) and post-heating temperatures (L335 runs first).
    ma, mb = mass[mi], mass[mj]
    m_tot = ma + mb
    m_safe = jnp.where(m_valid, m_tot, 1.0)
    # Consumed bodies receive neither bounce impulses nor position corrections
    # (matching the `continue` at L345), so vel/pos here equal the pre-sweep
    # values for merge parents.
    merge_vel = (vel[mi] * ma[:, None] + vel[mj] * mb[:, None]) / m_safe[:, None]
    merge_pos = (pos[mi] * ma[:, None] + pos[mj] * mb[:, None]) / m_safe[:, None]
    merge_temp = (temp[mi] * ma + temp[mj] * mb) / m_safe
    merge_mat = jnp.where(ma > mb, state.mat[mi], state.mat[mj])  # L403

    # --- fracture events (L411-443) ----------------------------------------
    fi, fj, f_valid = _top_pairs(fract_sel, cfg.max_fractures)
    fa, fb = mass[fi], mass[fj]
    f_tot = fa + fb
    f_safe = jnp.where(f_valid, f_tot, 1.0)
    # COM/midpoint use post-correction positions (L350-352 precede L355-358).
    com = (pos[fi] * fa[:, None] + pos[fj] * fb[:, None]) / f_safe[:, None]
    base_vel = (vel[fi] * fa[:, None] + vel[fj] * fb[:, None]) / f_safe[:, None]
    f_energy = energy[fi, fj]
    f_temp = jnp.maximum(temp[fi], temp[fj]) + (f_energy / f_safe) * 0.1  # L435
    f_mat = jnp.where(fa > fb, state.mat[fi], state.mat[fj])  # L437
    f_radius_sum = radius[fi] + radius[fj]
    midpoint = 0.5 * (pos[fi] + pos[fj])  # flash site (L358)

    key, sub = jax.random.split(state.key)
    frag = _make_fragments(
        sub, cfg, f_valid, com, base_vel, f_energy, f_tot, f_temp, f_mat,
        f_radius_sum,
    )

    # --- kills --------------------------------------------------------------
    kill = jnp.zeros((c,), bool)
    # .max(): invalid top_k slots carry arbitrary indices that may collide
    # with valid ones — max() never lets a False overwrite a True.
    kill = kill.at[mi].max(m_valid, mode="drop")
    kill = kill.at[mj].max(m_valid, mode="drop")
    kill = kill.at[fi].max(f_valid, mode="drop")
    kill = kill.at[fj].max(f_valid, mode="drop")
    keep = ~kill
    state = state.replace(
        alive=state.alive & keep,
        mass=jnp.where(keep, state.mass, 0.0),
        vel=jnp.where(keep[:, None], state.vel, 0.0),
        acc=jnp.where(keep[:, None], state.acc, 0.0),
        temp=jnp.where(keep, state.temp, 0.0),
        contact=jnp.where(
            keep[:, None] & keep[None, :], state.contact, 0.0
        ),
        key=key,
    )

    # --- births: merged bodies then fragments, FIFO eviction (L387-389) ----
    birth_mass = jnp.concatenate([jnp.where(m_valid, m_tot, 0.0), frag["mass"]])
    birth_pos = jnp.concatenate([merge_pos, frag["pos"]])
    birth_vel = jnp.concatenate([merge_vel, frag["vel"]])
    birth_temp = jnp.concatenate([merge_temp, frag["temp"]])
    birth_mat = jnp.concatenate([merge_mat, frag["mat"]])
    birth_mask = jnp.concatenate([m_valid, frag["mask"]])

    state, n_evicted = add_bodies_batch(
        state, birth_mass, birth_pos, birth_vel, birth_mat, birth_temp,
        birth_mask,
    )

    n_merge_sel = jnp.sum(merge_sel.astype(jnp.int32))
    n_fract_sel = jnp.sum(fract_sel.astype(jnp.int32))
    events = Events(
        merge_pos=merge_pos,
        merge_mass=jnp.where(m_valid, m_tot, 0.0),
        merge_mask=m_valid,
        fracture_pos=midpoint,
        fracture_energy=jnp.where(f_valid, f_energy, 0.0),
        fracture_mask=f_valid,
        spawn_pos=frag["pos"],
        spawn_temp=frag["temp"],
        spawn_mask=frag["mask"],
        n_merges=jnp.sum(m_valid.astype(jnp.int32)),
        n_fractures=jnp.sum(f_valid.astype(jnp.int32)),
        n_bounces=jnp.sum(bounce.astype(jnp.int32)),
        n_evicted=n_evicted,
        n_dropped=(n_merge_sel - jnp.sum(m_valid.astype(jnp.int32)))
        + (n_fract_sel - jnp.sum(f_valid.astype(jnp.int32))),
    )
    return state, events


def resolve_collisions_sequential(
    state: SimState, cfg: SimConfig, h: jax.Array | float
) -> tuple[SimState, Events]:
    """STRICT-SEQUENTIAL collision sweep: the reference's in-place (i, j)
    pair loop (/root/reference/index.html:301-374) reproduced exactly as a
    lax.fori_loop over the flattened pair space, so each pair sees every
    earlier pair's impulses, corrections and heating WITHIN the sweep —
    the in-sweep visibility the Jacobi path (resolve_collisions)
    deliberately approximates (module docstring).

    This is the tiny-N parity oracle mode (SURVEY section 7's planned
    fallback): O(C^2) sequential iterations, no vectorization across
    pairs — use it only in parity tests and small interactive scenes
    (capacity <= ~100). Trajectory-level behavior matches tests/oracle.py
    (the NumPy transliteration) to fp tolerance on contact-cluster scenes
    where the Jacobi path diverges at O(h); fragment RNG still comes from
    jax.random, so fracture OUTCOMES differ from any Math.random stream
    by design.

    Divergences from the reference kept deliberately (both shared with the
    oracle): at-most-one-event-per-body (the reference's single-sided
    removedIndices check can double-merge a body, oracle.py module
    docstring) — and one of its own: births append merges first, then
    fragments (the reference interleaves them in firing order, L387-389),
    observable only through FIFO eviction order at capacity.
    """
    c = state.capacity
    mm, ff = cfg.max_merges, cfg.max_fractures
    i32 = jnp.int32
    f32 = jnp.float32
    radius = state.radius(cfg)  # masses are sweep-constant (births later)
    inv_m = inverse_mass(state.mass)

    def pair_body(p, carry):
        (pos, vel, temp, contact, visited, removed, n_bounces,
         m_bufs, f_bufs) = carry
        i = p // c
        j = p % c
        live = (
            (i < j)
            & state.alive[i] & state.alive[j]
            & ~removed[i] & ~removed[j]
        )
        d = pos[j] - pos[i]
        dist2 = jnp.dot(d, d)
        min_dist = radius[i] + radius[j]
        overlap = live & (dist2 < min_dist * min_dist)  # L313

        # contact-time accumulate on the symmetric pair slot (L314-319)
        c_new = jnp.where(overlap, contact[i, j] + h, contact[i, j])
        contact = contact.at[i, j].set(c_new).at[j, i].set(c_new)
        visited = visited.at[i, j].max(overlap).at[j, i].max(overlap)

        dist = jnp.sqrt(jnp.where(dist2 > 0, dist2, 1.0))
        normal = d / dist
        rel_vel = vel[j] - vel[i]
        vn = jnp.dot(rel_vel, normal)
        act = overlap & (vn < 0)  # L327

        inv_sum = inv_m[i] + inv_m[j]
        safe_inv_sum = jnp.where(inv_sum > 0, inv_sum, 1.0)
        m_sum = state.mass[i] + state.mass[j]
        safe_m_sum = jnp.where(m_sum > 0, m_sum, 1.0)
        mu = state.mass[i] * state.mass[j] / safe_m_sum
        energy = 0.5 * mu * vn * vn  # L333
        q = energy / safe_m_sum

        # heating fires for EVERY approaching pair, before the branch
        # (L335-336) — in-place, so later pairs see it
        heat_i = jnp.where(act, energy * inv_m[i] * 0.2, 0.0)
        heat_j = jnp.where(act, energy * inv_m[j] * 0.2, 0.0)
        temp = temp.at[i].add(heat_i).at[j].add(heat_j)

        merge = act & (c_new > cfg.merge_time) & (
            q < cfg.fracture_threshold * 2.0
        )  # L340
        fract = act & ~merge & (q > cfg.fracture_threshold) & (
            (state.mass[i] > cfg.min_fragment_mass)
            | (state.mass[j] > cfg.min_fragment_mass)
        )  # L348, L354
        bounce = act & ~merge & ~fract

        # ---- merge payload at fire time (pre-correction state, L392-409)
        (m_cnt, m_pos, m_vel, m_mass, m_temp, m_mat, m_drop) = m_bufs
        tot = safe_m_sum
        slot = jnp.minimum(m_cnt, mm - 1)
        rec_m = merge & (m_cnt < mm)
        mpos = (pos[i] * state.mass[i] + pos[j] * state.mass[j]) / tot
        mvel = (vel[i] * state.mass[i] + vel[j] * state.mass[j]) / tot
        mtemp = (temp[i] * state.mass[i] + temp[j] * state.mass[j]) / tot
        mmat = jnp.where(
            state.mass[i] > state.mass[j], state.mat[i], state.mat[j]
        )
        m_pos = m_pos.at[slot].set(jnp.where(rec_m, mpos, m_pos[slot]))
        m_vel = m_vel.at[slot].set(jnp.where(rec_m, mvel, m_vel[slot]))
        m_mass = m_mass.at[slot].set(jnp.where(rec_m, m_sum, m_mass[slot]))
        m_temp = m_temp.at[slot].set(jnp.where(rec_m, mtemp, m_temp[slot]))
        m_mat = m_mat.at[slot].set(jnp.where(rec_m, mmat, m_mat[slot]))
        m_cnt = m_cnt + rec_m.astype(i32)
        m_drop = m_drop + (merge & ~rec_m).astype(i32)

        # ---- position correction: fracture + bounce branches (L350-352)
        corr = act & ~merge
        corr_vec = jnp.where(
            corr, (min_dist - dist) / safe_inv_sum * CORRECTION, 0.0
        ) * normal
        pos = pos.at[i].add(-corr_vec * inv_m[i])
        pos = pos.at[j].add(corr_vec * inv_m[j])

        # ---- fracture payload at fire time (post-correction, L411-443)
        (f_cnt, f_com, f_bvel, f_energy, f_tot, f_temp, f_mat, f_rsum,
         f_mid, f_drop) = f_bufs
        fslot = jnp.minimum(f_cnt, ff - 1)
        rec_f = fract & (f_cnt < ff)
        com = (pos[i] * state.mass[i] + pos[j] * state.mass[j]) / tot
        bvel = (vel[i] * state.mass[i] + vel[j] * state.mass[j]) / tot
        ftmp = jnp.maximum(temp[i], temp[j]) + (energy / tot) * 0.1
        fmat = jnp.where(
            state.mass[i] > state.mass[j], state.mat[i], state.mat[j]
        )
        f_com = f_com.at[fslot].set(jnp.where(rec_f, com, f_com[fslot]))
        f_bvel = f_bvel.at[fslot].set(jnp.where(rec_f, bvel, f_bvel[fslot]))
        f_energy = f_energy.at[fslot].set(
            jnp.where(rec_f, energy, f_energy[fslot]))
        f_tot = f_tot.at[fslot].set(jnp.where(rec_f, m_sum, f_tot[fslot]))
        f_temp = f_temp.at[fslot].set(jnp.where(rec_f, ftmp, f_temp[fslot]))
        f_mat = f_mat.at[fslot].set(jnp.where(rec_f, fmat, f_mat[fslot]))
        f_rsum = f_rsum.at[fslot].set(
            jnp.where(rec_f, min_dist, f_rsum[fslot]))
        f_mid = f_mid.at[fslot].set(
            jnp.where(rec_f, 0.5 * (pos[i] + pos[j]), f_mid[fslot]))
        f_cnt = f_cnt + rec_f.astype(i32)
        f_drop = f_drop + (fract & ~rec_f).astype(i32)

        # ---- event bookkeeping: removed bodies skip later pairs (L302-304);
        # the fired pair's timer is deleted (L344, L357)
        fired = merge | fract
        removed = removed.at[i].max(fired).at[j].max(fired)
        z = jnp.where(fired, 0.0, contact[i, j])
        contact = contact.at[i, j].set(z).at[j, i].set(z)

        # ---- bounce: normal + friction impulses in place (L361-369)
        j_imp = jnp.where(bounce, -(1.0 + cfg.restitution) * vn
                          / safe_inv_sum, 0.0)
        tangent_raw = rel_vel - vn * normal
        t_len = jnp.sqrt(jnp.dot(tangent_raw, tangent_raw))
        tangent = tangent_raw / jnp.where(t_len > 0, t_len, 1.0)
        jt = jnp.where(bounce, -t_len * cfg.friction / safe_inv_sum, 0.0)
        imp = j_imp * normal + jt * tangent
        vel = vel.at[i].add(-imp * inv_m[i])
        vel = vel.at[j].add(imp * inv_m[j])
        n_bounces = n_bounces + bounce.astype(i32)

        return (pos, vel, temp, contact, visited, removed, n_bounces,
                (m_cnt, m_pos, m_vel, m_mass, m_temp, m_mat, m_drop),
                (f_cnt, f_com, f_bvel, f_energy, f_tot, f_temp, f_mat,
                 f_rsum, f_mid, f_drop))

    m_bufs0 = (
        jnp.int32(0), jnp.zeros((mm, 3), f32), jnp.zeros((mm, 3), f32),
        jnp.zeros((mm,), f32), jnp.zeros((mm,), f32),
        jnp.zeros((mm,), jnp.int32), jnp.int32(0),
    )
    f_bufs0 = (
        jnp.int32(0), jnp.zeros((ff, 3), f32), jnp.zeros((ff, 3), f32),
        jnp.zeros((ff,), f32), jnp.zeros((ff,), f32),
        jnp.zeros((ff,), f32), jnp.zeros((ff,), jnp.int32),
        jnp.zeros((ff,), f32), jnp.zeros((ff, 3), f32), jnp.int32(0),
    )
    (pos, vel, temp, contact, visited, removed, n_bounces, m_bufs,
     f_bufs) = jax.lax.fori_loop(
        0, c * c, pair_body,
        (state.pos, state.vel, state.temp, state.contact,
         jnp.zeros((c, c), bool), jnp.zeros((c,), bool), jnp.int32(0),
         m_bufs0, f_bufs0),
    )
    (m_cnt, m_pos, m_vel, m_mass, m_temp, m_mat, m_drop) = m_bufs
    (f_cnt, f_com, f_bvel, f_energy, f_tot, f_temp, f_mat, f_rsum,
     f_mid, f_drop) = f_bufs

    # prune timers of pairs not in contact this frame (L376-380)
    contact = jnp.where(visited, contact, 0.0)

    # kills
    keep = ~removed
    key, sub = jax.random.split(state.key)
    state = state.replace(
        pos=pos, vel=jnp.where(keep[:, None], vel, 0.0),
        temp=jnp.where(keep, temp, 0.0),
        alive=state.alive & keep,
        mass=jnp.where(keep, state.mass, 0.0),
        acc=jnp.where(keep[:, None], state.acc, 0.0),
        contact=jnp.where(keep[:, None] & keep[None, :], contact, 0.0),
        key=key,
    )

    m_valid = jnp.arange(mm, dtype=i32) < m_cnt
    f_valid = jnp.arange(ff, dtype=i32) < f_cnt
    frag = _make_fragments(
        sub, cfg, f_valid, f_com, f_bvel,
        jnp.where(f_valid, f_energy, 0.0), f_tot, f_temp, f_mat, f_rsum,
    )
    birth_mass = jnp.concatenate(
        [jnp.where(m_valid, m_mass, 0.0), frag["mass"]])
    state, n_evicted = add_bodies_batch(
        state, birth_mass,
        jnp.concatenate([m_pos, frag["pos"]]),
        jnp.concatenate([m_vel, frag["vel"]]),
        jnp.concatenate([m_mat, frag["mat"]]),
        jnp.concatenate([m_temp, frag["temp"]]),
        jnp.concatenate([m_valid, frag["mask"]]),
    )
    events = Events(
        merge_pos=m_pos,
        merge_mass=jnp.where(m_valid, m_mass, 0.0),
        merge_mask=m_valid,
        fracture_pos=f_mid,
        fracture_energy=jnp.where(f_valid, f_energy, 0.0),
        fracture_mask=f_valid,
        spawn_pos=frag["pos"],
        spawn_temp=frag["temp"],
        spawn_mask=frag["mask"],
        n_merges=m_cnt,
        n_fractures=f_cnt,
        n_bounces=n_bounces,
        n_evicted=n_evicted,
        n_dropped=m_drop + f_drop,
    )
    return state, events


def _make_fragments(
    key: jax.Array,
    cfg: SimConfig,
    valid: jax.Array,  # [F]
    com: jax.Array,  # [F, 3]
    base_vel: jax.Array,  # [F, 3]
    energy: jax.Array,  # [F]
    total_mass: jax.Array,  # [F]
    temp: jax.Array,  # [F]
    mat: jax.Array,  # [F]
    radius_sum: jax.Array,  # [F]
) -> dict:
    """Stochastic breakup of fractured pairs (index.html:411-442), batched
    over F events x K fragment slots with `jax.random` in place of
    Math.random. The greedy sequential mass split (each fragment takes
    0.3 + 0.4 u of the remainder, last takes all, sub-threshold fragments
    skipped, early break when the remainder is sub-threshold) runs as a
    lax.scan over the K axis carrying (remaining_mass, broke).
    """
    f, k = valid.shape[0], cfg.max_fragments
    safe_m = jnp.where(valid, total_mass, 1.0)
    k_count, k_scan = jax.random.split(key)
    severity = jnp.minimum(energy / cfg.fracture_threshold, 5.0)  # L417
    u0 = jax.random.uniform(k_count, (f,))
    num_frag = jnp.floor(3.0 + u0 * 3.0 * severity).astype(jnp.int32)  # L418
    eject_base = jnp.sqrt(energy / safe_m)  # L433

    def frag_step(carry, ku):
        remaining, broke, idx = carry
        u_mass, u_dir, u_off, u_speed = ku
        broke = broke | (remaining < cfg.min_fragment_mass)  # L422 break
        frag_mass = remaining * (0.3 + 0.4 * u_mass)  # L424
        frag_mass = jnp.where(idx == num_frag - 1, remaining, frag_mass)  # L425
        keep = (
            valid
            & ~broke
            & (idx < num_frag)
            & (frag_mass >= cfg.min_fragment_mass)  # L427 continue
        )
        remaining = jnp.where(keep, remaining - frag_mass, remaining)
        scatter = u_dir - 0.5  # [F, 3] (L430)
        s_len = jnp.sqrt(jnp.sum(scatter * scatter, axis=-1))
        scatter = scatter / jnp.where(s_len > 0, s_len, 1.0)[:, None]
        pos = com + scatter * (radius_sum * 0.5 * u_off)[:, None]  # L431-432
        speed = eject_base * (0.5 + u_speed)  # L433
        vel = base_vel + scatter * speed[:, None]  # L434
        out = dict(
            mass=jnp.where(keep, frag_mass, 0.0),
            pos=pos,
            vel=vel,
            temp=temp,
            mat=mat,
            mask=keep,
        )
        return (remaining, broke, idx + 1), out

    u_mass = jax.random.uniform(jax.random.fold_in(k_scan, 0), (k, f))
    u_dir = jax.random.uniform(jax.random.fold_in(k_scan, 1), (k, f, 3))
    u_off = jax.random.uniform(jax.random.fold_in(k_scan, 2), (k, f))
    u_speed = jax.random.uniform(jax.random.fold_in(k_scan, 3), (k, f))
    init = (jnp.where(valid, total_mass, 0.0), ~valid, jnp.int32(0))
    _, outs = jax.lax.scan(frag_step, init, (u_mass, u_dir, u_off, u_speed))
    # outs leaves are [K, F, ...]; flatten to [F * K] in per-event-major order
    # (event 0's fragments first), matching the reference's push order.
    return jax.tree.map(
        lambda x: jnp.swapaxes(x, 0, 1).reshape((f * k,) + x.shape[2:]), outs
    )
