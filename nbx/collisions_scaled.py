"""Full collision physics at scale: bounce + merge + fracture beyond 100k.

nbx.collisions is exact reference semantics in [C, C] pair matrices
(interactive to capacity ~4k); nbx.collisions_binned scales the BOUNCE
subsystem only. This module runs the COMPLETE event physics of the
reference sweep (/root/reference/index.html:293-443) — contact timers,
merges, fractures, impulses, heating — at granular scale, on top of the
window pair sweep of nbx.ops.collide.

At-scale contact bookkeeping (the piece that actually needed the [C, C]
state) is replaced by a PER-BODY partner record:

  * the kernel reports each body's deepest-overlap partner per substep;
  * a body's contact timer accumulates while its deepest partner is stable
    and resets when it changes (the reference keys a timer per PAIR,
    L314-319 — for isolated contacts the two are identical; in a contact
    pile a body alternating between two equally-deep partners resets where
    the reference would accumulate both. Documented divergence, same spirit
    as the Jacobi impulse note in nbx.collisions);
  * merge/fracture fire only on MUTUAL partners (i's deepest is j and j's
    deepest is i), which also guarantees one event per body per substep —
    the parallel analog of the reference sweep's removedIndices skipping
    (L302-304).

Further documented divergences from the dense path:
  * bounce impulses and Baumgarte corrections are applied to event pairs
    too (the reference `continue`s merges before them, L345). For the
    merging pair itself this is exactly invisible: the pair impulse is
    equal-and-opposite, so the merged body's momentum, and the
    inverse-mass-weighted correction, so the merged COM, are unchanged.
  * a merged body is written in place into the lower slot instead of being
    re-appended at the array tail (no FIFO reordering at scale).
  * fragments go into dead slots; when none remain they are dropped and
    counted (n_dropped) instead of FIFO-evicting live bodies.

RNG: fragment sampling reuses nbx.collisions._make_fragments (jax.random,
deterministic, checkpointable).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from nbx import thermal
from nbx.collisions import _make_fragments
from nbx.config import SimConfig, body_radius
from nbx.ops.collide import binned_collision_pass
from nbx.ops.p3m import take_rows as _take_rows


class GranularState(NamedTuple):
    """Fixed-capacity SoA state for at-scale collisional dynamics.

    Dead slots carry mass 0 (exert zero force, fail all overlap tests).
    partner/contact_t are the at-scale replacement of SimState.contact.
    """

    pos: jax.Array  # [N, 3] f32
    vel: jax.Array  # [N, 3] f32
    mass: jax.Array  # [N] f32 (0 = dead)
    mat: jax.Array  # [N] i32 material id
    temp: jax.Array  # [N] f32
    partner: jax.Array  # [N] i32 deepest-overlap partner (-1 = none)
    contact_t: jax.Array  # [N] f32 accumulated contact seconds with partner
    key: jax.Array  # PRNG key for fracture sampling


def make_granular_state(pos, vel, mass, mat=None, temp=None,
                        key: int | jax.Array = 0,
                        timer_slots: int = 1) -> GranularState:
    """timer_slots=1 (default): the round-3 single-deepest-partner timer
    ([N] partner/contact_t). timer_slots=K>1: a K-slot per-body contact
    table ([N, K]) that keeps timers alive across deepest-partner
    ALTERNATION in contact piles — the reference keys timers per PAIR
    (index.html:314-319), and with one slot a body flip-flopping between
    two equally-deep partners resets both timers forever (module
    docstring divergence). With K slots an unobserved partner survives
    one grace step (sign-encoded in the partner entry), so M <= K
    alternating partners accrue at rate >= h/M: merges fire within
    ~M x merge_time of the reference's merge_time (bounded, tested) where
    the single-slot path never fires."""
    n = pos.shape[0]
    if mat is None:
        mat = jnp.zeros((n,), jnp.int32)
    if temp is None:
        temp = jnp.zeros((n,), jnp.float32)
    if not hasattr(key, "dtype") or key.ndim == 0:
        key = jax.random.PRNGKey(int(key))
    pshape = (n,) if timer_slots == 1 else (n, timer_slots)
    return GranularState(
        pos=jnp.asarray(pos, jnp.float32),
        vel=jnp.asarray(vel, jnp.float32),
        mass=jnp.asarray(mass, jnp.float32),
        mat=jnp.asarray(mat, jnp.int32),
        temp=jnp.asarray(temp, jnp.float32),
        partner=jnp.full(pshape, -1, jnp.int32),
        contact_t=jnp.zeros(pshape, jnp.float32),
        key=key,
    )


class ScaledEvents(NamedTuple):
    """Per-substep event log (fixed shapes; renderer-compatible fields)."""

    merge_pos: jax.Array  # [M, 3] flash sites (merged COM, L408)
    merge_mass: jax.Array  # [M]
    merge_mask: jax.Array  # [M] bool
    fracture_pos: jax.Array  # [F, 3] pair midpoints (L358)
    fracture_energy: jax.Array  # [F]
    fracture_mask: jax.Array  # [F] bool
    spawn_pos: jax.Array  # [F * K, 3] fragment explosion sites (L441)
    spawn_temp: jax.Array  # [F * K]
    spawn_mask: jax.Array  # [F * K] bool
    n_merges: jax.Array  # [] i32 (total fired, not just logged)
    n_fractures: jax.Array  # [] i32
    n_bounces: jax.Array  # [] i32
    n_overflow: jax.Array  # [] i32 bodies dropped from cell binning
    n_dropped: jax.Array  # [] i32 event/fragment candidates lost to caps
    cell_too_small: jax.Array  # [] bool 2*max(r) > cell: contacts may be missed
    touched: jax.Array  # [N] bool slots reborn this substep (merged/killed/
    #   fragment) — NEWBORN bodies carry acc = 0 (index.html:217), so the
    #   integrator must zero their acceleration before the second half-kick


@functools.partial(
    jax.jit,
    static_argnames=("n_cells", "band_cells", "packed_caps", "buckets",
                     "interpret", "construction"),
)
def resolve_collisions_scaled(
    state: GranularState,
    cfg: SimConfig,
    h,
    box_size: float,
    n_cells: int,
    band_cells: int | None = None,
    packed_caps: tuple[int, int] | None = None,
    buckets: tuple[tuple[int, int, int], ...] | None = None,
    interpret: bool = False,
    construction: str = "auto",
) -> tuple[GranularState, ScaledEvents]:
    """One full collision substep at scale (reference resolveCollisions,
    index.html:293-390, with the divergences documented in the module
    docstring). Runs between the force evaluation and the second half-kick.
    Layout arguments as nbx.ops.collide.binned_collision_pass.
    """
    n = state.mass.shape[0]
    i_arange = jnp.arange(n, dtype=jnp.int32)
    radius = body_radius(state.mass, state.mat, cfg.materials)

    dvel, dpos, dtemp, best, n_bounces, n_overflow, too_small = (
        binned_collision_pass(
            state.pos, state.vel, state.mass, radius, box_size, n_cells,
            cfg.restitution, cfg.friction, band_cells=band_cells,
            packed_caps=packed_caps, buckets=buckets, interpret=interpret,
            construction=construction,
        )
    )
    pos = state.pos + dpos
    vel = state.vel + dvel
    temp = state.temp + dtemp  # impact heating (L335-336)

    # ---- per-body contact timer (L314-319 at scale) -----------------------
    has = best["j"] >= 0
    if state.partner.ndim == 1:
        same = best["j"] == state.partner
        contact_t = jnp.where(
            has, jnp.where(same, state.contact_t + h, h), 0.0
        )
        partner = jnp.where(has, best["j"], -1)
        deepest = partner
        t_mine = contact_t
        t_table = contact_t  # [N] — partner's timer read directly
    else:
        # K-SLOT table (make_granular_state docstring): entries are
        # FRESH (p >= 0), MISSED once (-p - 2: sign-encoded grace so an
        # alternating partner's timer survives the steps it is not the
        # deepest), or EMPTY (-1). Per step, with obs = this substep's
        # deepest partner: the matching slot goes fresh and accrues +h;
        # unmatched fresh slots go missed (timer kept); unmatched missed
        # slots are pruned (the reference prunes after ONE non-contact
        # frame, L376-380 — the extra grace step is the documented cost
        # of only observing the deepest partner).
        P, T = state.partner, state.contact_t  # [N, K]
        k_slots = P.shape[1]
        obs = jnp.where(has, best["j"], -2)  # -2 matches nothing
        pdec = jnp.where(P >= 0, P, -P - 2)  # decoded partner (-1 empty)
        entry_live = P != -1
        match = entry_live & (pdec == obs[:, None])  # [N, K]
        matched_any = jnp.any(match, axis=1)
        fresh_unm = (P >= 0) & ~match
        P = jnp.where(match, obs[:, None],
                      jnp.where(fresh_unm, -P - 2, -1))
        T = jnp.where(match, T + h, jnp.where(fresh_unm, T, 0.0))
        # insert an unmatched observation: first empty slot, else the
        # smallest-timer slot (LRU-by-accrual eviction)
        need = has & ~matched_any
        score = jnp.where(P == -1, -1.0, T)  # empties sort first
        slot = jnp.argmin(score, axis=1)  # [N]
        row = i_arange
        P = P.at[row, slot].set(
            jnp.where(need, obs, P[row, slot]))
        T = T.at[row, slot].set(jnp.where(need, h, T[row, slot]))
        partner, contact_t = P, T
        deepest = jnp.where(has, best["j"], -1)
        # my timer for the deepest partner = the matching slot's value
        pdec2 = jnp.where(P >= 0, P, -P - 2)
        sel = (P != -1) & (pdec2 == jnp.where(has, best["j"], -2)[:, None])
        t_mine = jnp.max(jnp.where(sel, T, 0.0), axis=1)  # [N]
        t_table = None  # partner side resolved below (per-pair lookup)

    # ---- event gates on mutual partners (L340-359) ------------------------
    jc = jnp.clip(deepest, 0, n - 1)
    mutual = has & (deepest[jc] == i_arange)
    if state.partner.ndim == 1:
        t_pair = jnp.minimum(t_mine, t_table[jc])
    else:
        # partner's timer FOR ME: look me up in row jc's slot table
        Pj = partner[jc]  # [N, K]
        pdecj = jnp.where(Pj >= 0, Pj, -Pj - 2)
        selj = (Pj != -1) & (pdecj == i_arange[:, None])
        t_theirs = jnp.max(jnp.where(selj, contact_t[jc], 0.0), axis=1)
        t_pair = jnp.minimum(t_mine, t_theirs)
    q = best["q"]
    appr = best["approaching"]
    m_i, m_j = state.mass, state.mass[jc]
    merge_m = (
        mutual & appr
        & (t_pair > cfg.merge_time)
        & (q < cfg.fracture_threshold * 2.0)
    )
    fract_m = (
        mutual & appr & ~merge_m
        & (q > cfg.fracture_threshold)
        & ((m_i > cfg.min_fragment_mass) | (m_j > cfg.min_fragment_mass))
    )
    primary_m = merge_m & (i_arange < jc)
    primary_f = fract_m & (i_arange < jc)

    # ---- merges, applied in place into the lower slot (L392-409) ----------
    tot = m_i + m_j
    safe_tot = jnp.where(tot > 0, tot, 1.0)
    mpos = (pos * m_i[:, None] + pos[jc] * m_j[:, None]) / safe_tot[:, None]
    mvel = (vel * m_i[:, None] + vel[jc] * m_j[:, None]) / safe_tot[:, None]
    mtemp = (temp * m_i + temp[jc] * m_j) / safe_tot
    mmat = jnp.where(m_i > m_j, state.mat, state.mat[jc])  # heavier (L403)

    # the merge gates are bitwise-SYMMETRIC between mutual partners (vn/q/E
    # commute exactly; t_pair is a min — the invariant the spatial halo
    # protocol relies on), so the secondary side is pure arithmetic: no
    # N-length scatter (the sharded paths use the same form)
    killed = merge_m & (i_arange > jc)
    pm2 = primary_m[:, None]
    pos = jnp.where(pm2, mpos, pos)
    vel = jnp.where(pm2, mvel, jnp.where(killed[:, None], 0.0, vel))
    temp = jnp.where(primary_m, mtemp, jnp.where(killed, 0.0, temp))
    mat = jnp.where(primary_m, mmat, state.mat)
    mass = jnp.where(primary_m, tot, jnp.where(killed, 0.0, m_i))

    # ---- fractures: extract up to F events, sample fragments (L411-443) ---
    f_cap = cfg.max_fractures
    fi, f_valid = _take_rows(primary_f, f_cap)
    fj = jc[fi]
    fa, fb = mass[fi], mass[fj]  # == pre-merge masses (events exclusive)
    f_tot = fa + fb
    f_safe = jnp.where(f_valid, f_tot, 1.0)
    com = (pos[fi] * fa[:, None] + pos[fj] * fb[:, None]) / f_safe[:, None]
    base_vel = (vel[fi] * fa[:, None] + vel[fj] * fb[:, None]) / f_safe[:, None]
    f_energy = jnp.where(f_valid, best["energy"][fi], 0.0)
    f_temp = jnp.maximum(temp[fi], temp[fj]) + (f_energy / f_safe) * 0.1
    f_mat = jnp.where(fa > fb, mat[fi], mat[fj])  # heavier parent (L437)
    f_radius_sum = radius[fi] + radius[fj]
    midpoint = 0.5 * (pos[fi] + pos[fj])  # flash site (L358)

    key, sub = jax.random.split(state.key)
    frag = _make_fragments(
        sub, cfg, f_valid, com, base_vel, f_energy, f_tot, f_temp, f_mat,
        f_radius_sum,
    )

    # kill fracture parents
    fkill = jnp.zeros((n,), bool)
    fkill = fkill.at[jnp.where(f_valid, fi, n)].set(True, mode="drop")
    fkill = fkill.at[jnp.where(f_valid, fj, n)].set(True, mode="drop")
    mass = jnp.where(fkill, 0.0, mass)
    vel = jnp.where(fkill[:, None], 0.0, vel)
    temp = jnp.where(fkill, 0.0, temp)

    # ---- place fragments into dead slots -----------------------------------
    fk = frag["mask"].shape[0]  # F * K
    dead = mass <= 0.0
    # first-fk dead slots via take_rows (searchsorted over the cumsum, no
    # N-length rank scatter)
    slot_of_rank, sv = _take_rows(dead, fk)
    slot_of_rank = jnp.where(sv, slot_of_rank, n)
    frank = jnp.cumsum(frag["mask"].astype(jnp.int32)) - 1
    slot = jnp.where(
        frag["mask"], slot_of_rank[jnp.clip(frank, 0, fk - 1)], n
    )
    placed = frag["mask"] & (slot < n)
    slot = jnp.where(placed, slot, n)
    mass = mass.at[slot].set(frag["mass"], mode="drop")
    pos = pos.at[slot].set(frag["pos"], mode="drop")
    vel = vel.at[slot].set(frag["vel"], mode="drop")
    temp = temp.at[slot].set(frag["temp"], mode="drop")
    mat = mat.at[slot].set(frag["mat"], mode="drop")

    # ---- reset contact bookkeeping on every touched slot -------------------
    touched = primary_m | killed | fkill
    touched = touched.at[slot].set(True, mode="drop")
    t_b = touched if partner.ndim == 1 else touched[:, None]
    partner = jnp.where(t_b, -1, partner)
    contact_t = jnp.where(t_b, 0.0, contact_t)

    # ---- event log ----------------------------------------------------------
    mi_idx, m_valid = _take_rows(primary_m, cfg.max_merges)
    n_merges = jnp.sum(primary_m.astype(jnp.int32))
    n_fracts = jnp.sum(primary_f.astype(jnp.int32))
    n_dropped = (
        (n_fracts - jnp.sum(f_valid.astype(jnp.int32)))
        + (n_merges - jnp.sum(m_valid.astype(jnp.int32)))
        + (jnp.sum(frag["mask"].astype(jnp.int32))
           - jnp.sum(placed.astype(jnp.int32)))
    )
    events = ScaledEvents(
        merge_pos=pos[mi_idx],
        merge_mass=jnp.where(m_valid, mass[mi_idx], 0.0),
        merge_mask=m_valid,
        fracture_pos=midpoint,
        fracture_energy=f_energy,
        fracture_mask=f_valid,
        spawn_pos=frag["pos"],
        spawn_temp=frag["temp"],
        spawn_mask=placed,
        n_merges=n_merges,
        n_fractures=n_fracts,
        n_bounces=n_bounces,
        n_overflow=n_overflow,
        n_dropped=n_dropped,
        cell_too_small=too_small,
        touched=touched,
    )
    new_state = GranularState(
        pos=pos, vel=vel, mass=mass, mat=mat, temp=temp,
        partner=partner, contact_t=contact_t, key=key,
    )
    return new_state, events


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_steps", "n_cells", "band_cells", "packed_caps", "buckets",
        "force_impl", "pm_grid", "interpret", "p3m_cells", "p3m_k",
        "p3m_max_residual", "log_events", "construction",
    ),
)
def granular_full_kdk_scan(
    state: GranularState,
    cfg: SimConfig,
    box_size: float,
    n_steps: int,
    n_cells: int = 32,
    band_cells: int | None = None,
    packed_caps: tuple[int, int] | None = None,
    buckets: tuple[tuple[int, int, int], ...] | None = None,
    force_impl: str = "auto",
    pm_grid: int = 128,
    interpret: bool = False,
    p3m_cells: int = 16,
    p3m_k: int = 32,
    p3m_max_residual: int = 8192,
    log_events: bool = False,
    green_hat: jax.Array | None = None,
    construction: str = "auto",
):
    """Full-physics granular loop at scale: KDK gravity + fused-kernel
    collisions (bounce/merge/fracture/timers) + thermal decay, reference
    substep ordering (index.html:247-262). Returns (state, totals) where
    totals aggregates the per-step counters (max for overflow/flags).
    With log_events=True returns (state, totals, events) where events is
    the per-step ScaledEvents stack (leaves [n_steps, ...]) — the
    renderer's flash/explosion feed (nbx.render.pipeline.render_granular).

    force_impl: the nbx.sim.gravity dispatchers (auto|dense|blocked|pallas)
    plus "pm" — the particle-mesh solver on a pm_grid^3 isolated mesh over
    the same [0, box)^3 domain as the collision binning — "p3m" — the
    accurate particle-particle/particle-mesh split (nbx.ops.p3m: PM part on
    the pm_grid^3 mesh, exact erfc pairs within p3m_cells-grid
    neighborhoods at p3m_k bodies/cell, adaptive residual for overflowing
    cells; nbx.ops.p3m.p3m_tune_for sizes it) — and "zero" (no gravity:
    pure contact dynamics, also the collision-cost isolation mode for
    benchmarks). PM makes the gravity half of a 1M-body collisional step
    O(N + G^3 log G) instead of O(N^2), the right trade for
    collisionless-scale gravity + collisional contact dynamics (planetary
    rings, debris disks); P3M restores small-scale force accuracy on
    clustered scenes (merging galaxy cores).

    Layout arguments as nbx.ops.collide.binned_collision_pass."""
    from nbx.sim import gravity

    if force_impl == "pm":
        from nbx.ops.pm import isolated_green_hat, pm_acceleration

        # loop-invariant: one [2g]^3 rfftn saved per STEP — before this
        # the pm path re-built and re-transformed the Green's function
        # inside every force eval. Frame loops calling with n_steps=1
        # should precompute green_hat = isolated_green_hat(box, pm_grid)
        # once per scene and pass it in (nbx.serve.BigLiveSim does).
        if green_hat is None:
            green_hat = isolated_green_hat(box_size, pm_grid)
    elif force_impl == "p3m":
        from nbx.ops.p3m import p3m_acceleration
        from nbx.ops.pm import isolated_green_hat

        # loop-invariant: the smoothed Green's-function transform depends
        # only on (box, pm_grid, a) — computed once per scan call, not per
        # force evaluation (a [2g]^3 rfftn saved per step); pass the
        # smoothed green_hat in to skip even the per-call build
        if green_hat is None:
            green_hat = isolated_green_hat(
                box_size, pm_grid, box_size / p3m_cells / 3.0, smoothed=True
            )
    else:
        green_hat = None

    h = cfg.dt / cfg.sub_steps
    z = jnp.int32(0)

    def _force(pos, mass):
        """-> (acc, n_uncorrected); n_uncorrected is p3m's dropped-
        correction count (0 for every other impl — no silent caps)."""
        if force_impl == "zero":
            return jnp.zeros_like(pos), z
        if force_impl == "pm":
            return pm_acceleration(
                pos, mass, cfg.G, box_size, g=pm_grid, isolated=True,
                green_hat=green_hat,
            ), z
        if force_impl == "p3m":
            return p3m_acceleration(
                pos, mass, cfg.G, box_size, g=pm_grid, n_cells=p3m_cells,
                max_per_cell=p3m_k, eps=cfg.softening,
                max_residual=p3m_max_residual, green_hat=green_hat,
            )
        return gravity(pos, mass, cfg.G, cfg.softening, force_impl), z

    def body(carry, _):
        st, acc, nb, nm, nf, ovf, drop, small, unc = carry
        vel = st.vel + acc * (0.5 * h)
        pos = st.pos + vel * h
        acc2, n_unc = _force(pos, st.mass)
        st = st._replace(pos=pos, vel=vel)
        st, ev = resolve_collisions_scaled(
            st, cfg, h, box_size, n_cells, band_cells, packed_caps, buckets,
            interpret, construction,
        )
        # slots reborn by merge/fracture are NEWBORN: acc = 0
        # (index.html:217) — their pre-event acc includes dead partners'
        # pulls and would inject net momentum through the half-kick
        acc2 = jnp.where(ev.touched[:, None], 0.0, acc2)
        st = st._replace(
            vel=st.vel + acc2 * (0.5 * h),
            temp=thermal.decay(st.temp, cfg.heat_decay),
        )
        return (
            st, acc2,
            nb + ev.n_bounces, nm + ev.n_merges, nf + ev.n_fractures,
            jnp.maximum(ovf, ev.n_overflow),
            drop + ev.n_dropped,
            small | ev.cell_too_small,
            jnp.maximum(unc, n_unc),
        ), (ev._replace(touched=jnp.zeros((0,), bool)) if log_events
            else None)

    acc0, unc0 = _force(state.pos, state.mass)
    init = (state, acc0, z, z, z, z, z, jnp.bool_(False), unc0)
    (st, _, nb, nm, nf, ovf, drop, small, unc), ev_stack = jax.lax.scan(
        body, init, None, length=n_steps
    )
    totals = dict(
        n_bounces=nb, n_merges=nm, n_fractures=nf,
        n_overflow=ovf, n_dropped=drop, cell_too_small=small,
        n_uncorrected=unc,
    )
    if log_events:
        return st, totals, ev_stack
    return st, totals
