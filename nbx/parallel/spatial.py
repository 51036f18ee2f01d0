"""Spatially-owned sharded granular physics: halo exchange, O(N/D) memory.

make_sharded_granular_step (nbx.parallel.shard) scales the full-physics
collisional step's PAIR WORK to O(N S / D) per chip, but it still
all-gathers the body state: per-chip MEMORY is O(N), which caps the
multi-chip path at the single-chip capacity ceiling (~16M bodies of HBM)
no matter how many chips join the mesh. This module removes that ceiling —
the distributed-memory design ROADMAP 4c names as the remaining step:

  * OWNERSHIP IS SPATIAL: the collision grid's g x-cell layers split into
    D contiguous slabs of W = g/D layers; chip d owns the bodies inside
    slab d, in a fixed-capacity [nl] slot array (dead slots mass 0). A
    persistent per-body `uid` carries identity across chips — contact
    timers key on partner uid, not slot index (slot indices change on
    every migration). A TWO-axis mesh ("bx", "by") splits x AND y layers
    into a (d_x, d_y) grid of slabs — the decomposition for meshes wider
    than g x-layers; every protocol phase then runs per axis, x first,
    with corner traffic riding two hops (see make_spatial_granular_step).
  * MIGRATION, not all-gather: after the drift, bodies that left the slab
    ship to the +-1 x-neighbor chip through fixed-cap ppermute buffers
    (mig_cap rows/side) and land in dead slots. Bodies headed further than
    one slab hop one slab per step (counted as in_transit; they skip
    collisions while between slabs — at sane dt a body crosses a CELL in
    many steps, so transit is a pathology counter, not a running mode).
    Bodies past mig_cap simply WAIT a step (counted, never lost); bodies
    that find no dead slot on arrival are dropped and counted (size nl
    with headroom — the no-silent-caps rule).
  * HALO EXCHANGE, not replication: collisions reach +-1 cell, so each
    chip sends only its boundary x-cell LAYER (halo_cap rows/side) to each
    x-neighbor. The packed collision kernel then runs on a LOCAL
    [W + 2, g, g] slab grid (nbx.ops.collide.packed_collision_blocks_local)
    over [nl + 2 halo] rows: owned columns are targets, halo columns are
    source-only. Comm per step is O(halo) + O(pm_grid^3), independent of N.
  * EVENT MACHINERY cross-chip by symmetry: the pair quantities the gates
    need (vn, q, E) are bitwise-symmetric between the two owners, so each
    owner evaluates the same gates locally. Three small aligned exchanges
    complete the protocol: (1) halo body features before the kernel;
    (2) the halo bodies' post-kernel partner uid / contact timer /
    post-delta state (mutual-partner check + merge/fracture payload);
    (3) fracture-accept kill flags back to the secondary parent's owner
    (the primary's f_cap extraction decides acceptance, and the secondary
    must not kill its parent for a dropped event).
  * Merge keeps the LOWER-UID slot (the at-scale analog of the
    reference's lower-index in-place merge, index.html:392-409, same
    divergence class as nbx.collisions_scaled's in-place merge note);
    fractures sample fragments with a per-chip folded key and place them
    in the primary owner's dead slots.
  * Gravity: "pm" deposits local bodies on the pm_grid^3 CIC grid, psums
    the DENSITY grid over the mesh (N-independent comm), and every chip
    runs the replicated FFT solve (nbx.ops.pm.pm_solve_grid) and gathers
    its own rows; "p3m" adds the ACCURATE short-range term with the split
    scale tied to the collision grid (a = cell/3): the erfc pair sum is
    FUSED into the collision kernel's existing pair blocks
    (the short_gravity option of nbx.ops.collide) and therefore reaches
    exactly the +-1-cell neighborhood the existing halo already ships —
    accurate P3M gravity at zero extra communication (the long range uses
    the erf-smoothed Green's function on the same psummed grid; requires
    pm_grid >= 3 n_cells); "zero" isolates contact dynamics. Direct-sum
    gravity wants the all-gather design — use make_sharded_granular_step
    there (it pays O(N) memory anyway).

Divergences from the single-chip collisions_scaled path (all counted or
tested): fragment RNG streams are per-chip (fold_in(key, chip)) and the
fracture cap is per chip, not global; partner tie-breaks on bitwise-equal
depths use local slot ids, so a cross-boundary tie can fail the mutual
gate (bounce-only) where a single-chip run fires an event; under
target-cap window overflow the dropped SET at a slab boundary is decided
by each chip's local sort order. Zero-overflow caps (packed_caps_for) and
tie-free scenes give step-for-step parity with granular_full_kdk_scan —
gated by tests/test_spatial.py on the virtual 8-device mesh.

Physics semantics: reference resolveCollisions / mergeBodies /
fractureBody (/root/reference/index.html:293-443), as implemented at
scale by nbx.collisions_scaled.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nbx import thermal
from nbx.collisions import _make_fragments
from nbx.config import SimConfig, body_radius
from nbx.ops.collide import (
    bucketed_collision_blocks_local,
    epilogue_rows,
    packed_collision_blocks_local,
)
from nbx.ops.p3m import take_rows


class SpatialState(NamedTuple):
    """Slot arrays [D * nl], body axis sharded P("b"); chip d's rows hold
    ONLY bodies inside x-slab d (or dead slots / in-transit migrants).
    uid_next is a replicated scalar: the next fresh uid for fragments."""

    pos: jax.Array  # [N, 3] f32
    vel: jax.Array  # [N, 3] f32
    acc: jax.Array  # [N, 3] f32 (carried KDK acceleration)
    mass: jax.Array  # [N] f32 (0 = dead slot)
    mat: jax.Array  # [N] i32
    temp: jax.Array  # [N] f32
    uid: jax.Array  # [N] i32 persistent identity (-1 = dead slot)
    partner_uid: jax.Array  # [N] i32 deepest-partner uid (-1 = none)
    contact_t: jax.Array  # [N] f32
    uid_next: jax.Array  # [] i32 (replicated)


def _mesh_split(mesh: Mesh, n_cells: int):
    """(two_d, ax_x, ax_y, d_x, d_y, w_x, w_y) for a 1-axis or 2-axis mesh.

    A 1-axis mesh splits the grid's g x-layers into d_x slabs (w_y = g).
    A 2-axis mesh ("bx", "by") splits x AND y layers — the decomposition
    for meshes wider than g x-layers (ROADMAP 4d)."""
    axes = mesh.axis_names
    g = n_cells
    if len(axes) == 1:
        d = mesh.devices.size
        if g % d:
            raise ValueError(f"n_cells={g} must divide over {d} devices")
        return False, axes[0], None, d, 1, g // d, g
    if len(axes) != 2:
        raise ValueError(f"spatial step wants a 1- or 2-axis mesh: {axes}")
    d_x, d_y = mesh.devices.shape
    if g % d_x or g % d_y:
        raise ValueError(
            f"n_cells={g} must divide over the ({d_x}, {d_y}) mesh"
        )
    return True, axes[0], axes[1], d_x, d_y, g // d_x, g // d_y


def spatial_state_for(
    mesh: Mesh,
    pos,
    vel,
    mass,
    box_size: float,
    n_cells: int,
    mat=None,
    temp=None,
    nl: int | None = None,
    slack: float = 1.5,
) -> SpatialState:
    """Distribute a global scene into slab-owned slot arrays (host-side).

    nl (slots per chip) defaults to the most-loaded slab's count times
    `slack`, rounded up to 8 — the headroom is what absorbs migration and
    fragment births before drops start being counted. Dead input rows
    (mass <= 0) are dropped: a uid names a body that EXISTS, and dead
    slots are this layout's own free-list, not payload."""
    import numpy as np

    d = mesh.devices.size
    g = n_cells
    two_d, _, _, d_x, d_y, w_x, w_y = _mesh_split(mesh, g)
    pos = np.asarray(pos, np.float32)
    vel = np.asarray(vel, np.float32)
    mass = np.asarray(mass, np.float32)
    n = pos.shape[0]
    mat = np.zeros(n, np.int32) if mat is None else np.asarray(mat, np.int32)
    temp = (np.zeros(n, np.float32) if temp is None
            else np.asarray(temp, np.float32))
    keep = mass > 0.0
    uid0 = np.nonzero(keep)[0].astype(np.int32)
    pos, vel, mass = pos[keep], vel[keep], mass[keep]
    mat, temp = mat[keep], temp[keep]
    cell = box_size / g
    cx = np.clip((pos[:, 0] / cell).astype(np.int64), 0, g - 1)
    dest = np.clip(cx // w_x, 0, d_x - 1) * d_y
    if two_d:
        cy = np.clip((pos[:, 1] / cell).astype(np.int64), 0, g - 1)
        dest = dest + np.clip(cy // w_y, 0, d_y - 1)
    counts = np.bincount(dest, minlength=d)
    if nl is None:
        nl = max(8, int(np.ceil(counts.max() * slack / 8)) * 8)
    if counts.max() > nl:
        raise ValueError(
            f"slab {counts.argmax()} holds {counts.max()} bodies > nl={nl}"
        )

    def alloc(shape, fill, dtype):
        return np.full((d * nl, *shape), fill, dtype)

    P3 = alloc((3,), 0.0, np.float32)
    V3 = alloc((3,), 0.0, np.float32)
    M = alloc((), 0.0, np.float32)
    MT = alloc((), 0, np.int32)
    T = alloc((), 0.0, np.float32)
    U = alloc((), -1, np.int32)
    for c in range(d):
        rows = np.nonzero(dest == c)[0]
        sl = slice(c * nl, c * nl + rows.size)
        P3[sl] = pos[rows]
        V3[sl] = vel[rows]
        M[sl] = mass[rows]
        MT[sl] = mat[rows]
        T[sl] = temp[rows]
        U[sl] = uid0[rows]
    row = mesh.axis_names if two_d else mesh.axis_names[0]
    s3 = NamedSharding(mesh, P(row, None))
    s1 = NamedSharding(mesh, P(row))
    sr = NamedSharding(mesh, P())
    put = jax.device_put
    return SpatialState(
        pos=put(jnp.asarray(P3), s3),
        vel=put(jnp.asarray(V3), s3),
        acc=put(jnp.zeros((d * nl, 3), jnp.float32), s3),
        mass=put(jnp.asarray(M), s1),
        mat=put(jnp.asarray(MT), s1),
        temp=put(jnp.asarray(T), s1),
        uid=put(jnp.asarray(U), s1),
        partner_uid=put(jnp.full((d * nl,), -1, jnp.int32), s1),
        contact_t=put(jnp.zeros((d * nl,), jnp.float32), s1),
        uid_next=put(jnp.asarray(n, jnp.int32), sr),
    )


def spatial_buckets_for(
    mesh: Mesh,
    pos,
    box_size: float,
    n_cells: int,
    band_cells: int,
    split_quantile: float = 0.8,
    slack: float = 1.25,
    block_slack: float = 1.3,
) -> tuple[tuple[int, int, int], ...]:
    """PER-CHIP bucket sizing for make_spatial_granular_step(buckets=...).

    Caps come from bucketed_layout_for on the global frame; block budgets
    are set to the WORST chip's occupied-window count in each bucket
    (x block_slack, multiples of 8). Every chip launches its own budget
    of kernel blocks, so whole-grid budgets would cost ~D x the needed
    block work, while global/D budgets under-serve imbalanced ownership
    (an empty boundary slab next to a dense middle slab). One window
    census is shared across caps, assignment (bucket_flags_host — the
    single source of the assignment rule) and budgets. HOST-side:
    returns python ints — call per scene or when n_overflow goes
    nonzero."""
    import numpy as np

    from nbx.ops.collide import (
        _window_counts,
        _window_max_strip_runs,
        bucket_flags_host,
        bucketed_layout_for,
    )

    g = n_cells
    two_d, _, _, d_x, d_y, w_x, w_y = _mesh_split(mesh, g)
    cnt, cnt_s = _window_counts(pos, box_size, g, band_cells)
    mrun = _window_max_strip_runs(pos, box_size, g, band_cells,
                                  cnt_s=cnt_s)
    caps = bucketed_layout_for(
        pos, box_size, g, band_cells, split_quantile=split_quantile,
        slack=slack, block_slack=block_slack, _stats=(cnt, mrun),
    )
    cols = np.arange(g * g)
    ci, cj = cols // g, cols % g
    chip = (ci // w_x) * d_y
    if two_d:
        chip = chip + np.clip(cj // w_y, 0, d_y - 1)
    chip = np.broadcast_to(chip[:, None], cnt.shape)
    out = []
    for (t, sc, _), fl in zip(caps, bucket_flags_host(cnt, mrun, caps)):
        m = 0
        if fl.any():
            m = int(np.bincount(chip[fl], minlength=d_x * d_y).max())
        m = max(8, -(-int(np.ceil(m * block_slack)) // 8) * 8)
        out.append((t, sc, m))
    return tuple(out)


def render_spatial(
    mesh: Mesh,
    state: SpatialState,
    cfg: SimConfig,
    cam,
    width: int = 640,
    height: int = 360,
    exposure: float = 4.0,
):
    """Device-side rendering FROM SPATIAL OWNERSHIP: every chip splats its
    own slab's live slots (full material colors + temperature glow) into
    an HDR framebuffer; ONE psum over the mesh composites the additive
    image; tonemap replicates. The render never gathers bodies — readback
    ships one [H, W, 3] frame regardless of N, the same psum-composition
    as nbx.parallel.shard.render_sharded but fed by slab-owned state.
    Additive splats commute, so the composite equals the gathered-state
    single-device splat to fp addition-order tolerance (gated in
    tests/test_spatial.py). Works on 1D and 2D spatial meshes.
    Render fidelity semantics: /root/reference/index.html:446-688."""
    from nbx.render.colormap import tonemap
    from nbx.render.splat import splat_bodies_hdr

    mats = cfg.materials
    axes = tuple(mesh.axis_names)
    row = axes if len(axes) == 2 else axes[0]

    @jax.jit
    def run(pos, mass, mat, temp):
        def local(pos, mass, mat, temp):
            radius = body_radius(mass, mat, mats)
            hdr = splat_bodies_hdr(
                pos, radius, temp, mat, mass > 0.0, mats.color1,
                mats.color2, cam, width=width, height=height,
            )
            return tonemap(jax.lax.psum(hdr, axes), exposure)

        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(row, None), P(row), P(row), P(row)),
            out_specs=P(),
        )(pos, mass, mat, temp)

    return run(state.pos, state.mass, state.mat, state.temp)


def make_spatial_granular_step(
    mesh: Mesh,
    cfg: SimConfig,
    box_size: float,
    n_cells: int,
    band_cells: int,
    packed_caps: tuple[int, int],
    halo_cap: int,
    mig_cap: int,
    force_impl: str = "pm",
    pm_grid: int = 128,
    interpret: bool = False,
    buckets: tuple[tuple[int, int, int], ...] | None = None,
):
    """Build the halo-exchange sharded granular step (module docstring).

    With buckets=((t1, s1, m1), (t2, s2, m2), ...) the local kernel uses
    the occupancy-BUCKETED layout instead of uniform packed_caps (which
    are then ignored): each chip's owned windows run at the first
    covering bucket's caps — the cap-tax fix carried into the O(N/D)
    path. Size with spatial_buckets_for (PER-CHIP block budgets: every
    chip launches grid=(m_k,) blocks per bucket, so whole-grid budgets
    from bucketed_layout_for would cost ~D x the needed block work).

    The mesh may have ONE axis (x-slab ownership, the round-3 design) or
    TWO axes ("bx", "by": 2D (x, y)-slab ownership — the decomposition
    for meshes wider than the grid's g x-layers, ROADMAP 4d). In 2D the
    protocol runs its 1D phases per axis, x first:

      * migration hops x then y WITHIN one step, so a diagonal mover
        lands in one step (via the x-neighbor's slot array);
      * the halo exchange forwards corner bodies: phase y selects its
        boundary-y rows from own slots AND the just-received x-halo, so
        a diagonal neighbor's corner cell arrives in two hops;
      * the decision exchange reuses the same selections (the x-halo's
        decision rows arrive before phase y sends them onward);
      * fracture-accept kill flags retrace the route: y-returns that land
        on a forwarded x-halo row are OR-ed into the x-return.

    Returns jitted (state: SpatialState, h, key) -> (state, counters);
    counters = the collisions_scaled scalar set (n_bounces/n_merges/
    n_fractures/n_overflow/n_dropped/cell_too_small) plus the spatial
    protocol's own: n_mig_wait (movers past mig_cap, delayed one step),
    n_halo_over (boundary bodies past halo_cap — potentially missed
    cross-boundary contacts), in_transit (bodies between slabs this
    step). key must be fresh per step (fold_in) and identical across
    chips; fragment streams fold the linear chip index on top.
    """
    g = n_cells
    two_d, ax_x, ax_y, d_x, d_y, w_x, w_y = _mesh_split(mesh, g)
    n_dev = mesh.devices.size
    if force_impl not in ("pm", "p3m", "zero"):
        raise ValueError(
            "spatial step supports force_impl 'pm' | 'p3m' | 'zero' "
            "(direct-sum gravity needs the all-gather design: "
            "make_sharded_granular_step)"
        )
    if force_impl in ("pm", "p3m"):
        from nbx.ops.pm import cic_deposit, cic_gather, pm_solve_grid
    green_hat = None
    if force_impl == "p3m":
        # P3M with the split scale TIED TO THE COLLISION GRID (a = cell/3):
        # the erfc short-range pass then reaches exactly +-1 collision
        # cell, so it rides the EXISTING halo exchange and is fused into
        # the collision kernel's pair blocks (zero extra comm, zero extra
        # memory traffic — the short_gravity option of nbx.ops.collide);
        # the erf-smoothed long range runs on the psummed pm_grid mesh.
        # Mesh-resolution rule (nbx.ops.p3m): h_pm <= a/1.7 wants
        # pm_grid >= 5.1 g; we require the minimum pm_grid >= 3 g and
        # leave accuracy/cost to the caller's pm_grid choice. Bodies
        # dropped by window caps lose their short-range term (counted in
        # n_overflow); in-transit bodies get PM-only gravity for the hop
        # step (counted in in_transit).
        if pm_grid < 3 * g:
            raise ValueError(
                f"p3m needs pm_grid >= 3 * n_cells (= {3 * g}) so the "
                f"mesh resolves the split scale a = cell/3; got {pm_grid}"
            )
        from nbx.ops.pm import _isolated_solve_r, isolated_green_hat

        green_hat = isolated_green_hat(
            box_size, pm_grid, box_size / g / 3.0, smoothed=True
        )

    mats = cfg.materials
    f_cap = cfg.max_fractures
    cell = box_size / g
    i32 = jnp.int32
    H = halo_cap
    M = mig_cap
    AXES = tuple(mesh.axis_names)
    row = AXES if two_d else ax_x
    perm_xr = [(i, (i + 1) % d_x) for i in range(d_x)]
    perm_xl = [(i, (i - 1) % d_x) for i in range(d_x)]
    perm_yr = [(i, (i + 1) % d_y) for i in range(d_y)]
    perm_yl = [(i, (i - 1) % d_y) for i in range(d_y)]
    n_halo = 4 * H if two_d else 2 * H  # kernel halo rows

    def _send(rows_f, rows_i, idx, valid, perm, ax):
        """Gather payload rows at idx (invalid -> zeros/-1) and ppermute."""
        pf = jnp.where(valid[:, None], rows_f[idx], 0.0)
        pi = jnp.where(valid[:, None], rows_i[idx], -1)
        return (
            jax.lax.ppermute(pf, ax, perm),
            jax.lax.ppermute(pi, ax, perm),
        )

    # green_hat is threaded as a jit ARGUMENT (replicated shard_map
    # operand), never a closure: closing over the committed complex64
    # device array would bake it into the program as a constant.
    @jax.jit
    def _step(state: SpatialState, h, key, gh):
        def local(pos, vel, acc, mass, mat, temp, uid, p_uid, ct, uid_next,
                  gh):
            nl = pos.shape[0]
            me_x = jax.lax.axis_index(ax_x).astype(i32)
            me_y = (jax.lax.axis_index(ax_y).astype(i32) if two_d
                    else jnp.int32(0))
            me_lin = me_x * d_y + me_y

            # ---- KDK first half ------------------------------------------
            vel = vel + acc * (0.5 * h)
            pos = pos + vel * h

            # ---- migration (one +-1 hop per AXIS per step; x then y) -----
            def migrate(pos, vel, mass, mat, temp, uid, p_uid, ct,
                        coord, me, w, d_ax, perm_r, perm_l, ax):
                alive = mass > 0.0
                c = jnp.clip((pos[:, coord] / cell).astype(i32), 0, g - 1)
                dest = jnp.clip(c // w, 0, d_ax - 1)
                go_r = alive & (dest > me)
                go_l = alive & (dest < me)
                idx_r, v_r = take_rows(go_r, M)
                idx_l, v_l = take_rows(go_l, M)
                wait = (
                    jnp.sum(go_r.astype(i32)) - jnp.sum(v_r.astype(i32))
                    + jnp.sum(go_l.astype(i32)) - jnp.sum(v_l.astype(i32))
                )
                mig_f = jnp.concatenate(
                    [pos, vel, mass[:, None], temp[:, None], ct[:, None]],
                    axis=1,
                )  # [nl, 9]
                mig_i = jnp.stack([mat, uid, p_uid], axis=1)  # [nl, 3]
                rf_l, ri_l = _send(mig_f, mig_i, idx_r, v_r, perm_r, ax)
                rf_r, ri_r = _send(mig_f, mig_i, idx_l, v_l, perm_l, ax)
                # kill the sent rows
                sent = jnp.zeros((nl,), bool)
                sent = sent.at[jnp.where(v_r, idx_r, nl)].set(
                    True, mode="drop")
                sent = sent.at[jnp.where(v_l, idx_l, nl)].set(
                    True, mode="drop")
                mass = jnp.where(sent, 0.0, mass)
                uid = jnp.where(sent, -1, uid)
                # place arrivals into dead slots (rank-scatter)
                arr_f = jnp.concatenate([rf_l, rf_r], axis=0)  # [2M, 9]
                arr_i = jnp.concatenate([ri_l, ri_r], axis=0)  # [2M, 3]
                ok = (arr_i[:, 1] >= 0) & (arr_f[:, 6] > 0.0)
                dead = mass <= 0.0
                # first-2M dead slots via take_rows, not the nl-length
                # rank-scatter
                slot_of, sv = take_rows(dead, 2 * M)
                slot_of = jnp.where(sv, slot_of, nl)
                rrank = jnp.cumsum(ok.astype(i32)) - 1
                slot = jnp.where(
                    ok, slot_of[jnp.clip(rrank, 0, 2 * M - 1)], nl)
                placed = ok & (slot < nl)
                slot = jnp.where(placed, slot, nl)
                drop = jnp.sum(ok.astype(i32)) - jnp.sum(placed.astype(i32))
                pos = pos.at[slot].set(arr_f[:, 0:3], mode="drop")
                vel = vel.at[slot].set(arr_f[:, 3:6], mode="drop")
                mass = mass.at[slot].set(arr_f[:, 6], mode="drop")
                temp = temp.at[slot].set(arr_f[:, 7], mode="drop")
                ct = ct.at[slot].set(arr_f[:, 8], mode="drop")
                mat = mat.at[slot].set(arr_i[:, 0], mode="drop")
                uid = uid.at[slot].set(arr_i[:, 1], mode="drop")
                p_uid = p_uid.at[slot].set(arr_i[:, 2], mode="drop")
                return (pos, vel, mass, mat, temp, uid, p_uid, ct,
                        wait, drop)

            (pos, vel, mass, mat, temp, uid, p_uid, ct, wait_t, drop_t) = (
                migrate(pos, vel, mass, mat, temp, uid, p_uid, ct,
                        0, me_x, w_x, d_x, perm_xr, perm_xl, ax_x)
            )
            if two_d:
                (pos, vel, mass, mat, temp, uid, p_uid, ct, w2, dr2) = (
                    migrate(pos, vel, mass, mat, temp, uid, p_uid, ct,
                            1, me_y, w_y, d_y, perm_yr, perm_yl, ax_y)
                )
                wait_t = wait_t + w2
                drop_t = drop_t + dr2
            n_mig_wait = jax.lax.psum(wait_t, AXES)
            n_mig_drop = jax.lax.psum(drop_t, AXES)

            # ---- halo exchange 1: boundary cell layers -------------------
            alive = mass > 0.0
            cx = jnp.clip((pos[:, 0] / cell).astype(i32), 0, g - 1)
            transit = jnp.clip(cx // w_x, 0, d_x - 1) != me_x
            if two_d:
                cy = jnp.clip((pos[:, 1] / cell).astype(i32), 0, g - 1)
                transit = transit | (
                    jnp.clip(cy // w_y, 0, d_y - 1) != me_y
                )
            in_transit = alive & transit
            n_transit = jax.lax.psum(jnp.sum(in_transit.astype(i32)), AXES)
            settled = alive & ~in_transit
            # a size-1 axis has NO neighbor: the cyclic ppermute would
            # self-deliver boundary bodies as in-slab CLONES (same uid,
            # same cell — they hijack the deepest-partner record and
            # suppress events). Halo selection is statically empty there;
            # sends of boundary chips to WRAPPED neighbors (d > 1) are
            # harmless: the non-periodic positions park outside the
            # receiver's local grid.
            if d_x > 1:
                lay_l = settled & (cx == me_x * w_x)
                lay_r = settled & (cx == (me_x + 1) * w_x - 1)
            else:
                lay_l = lay_r = jnp.zeros((nl,), bool)
            idxh_l, vh_l = take_rows(lay_l, H)
            idxh_r, vh_r = take_rows(lay_r, H)
            halo_over = (
                jnp.sum(lay_l.astype(i32)) - jnp.sum(vh_l.astype(i32))
                + jnp.sum(lay_r.astype(i32)) - jnp.sum(vh_r.astype(i32))
            )
            hal_f = jnp.concatenate(
                [pos, vel, mass[:, None]], axis=1
            )  # [nl, 7]
            hal_i = jnp.stack([mat, uid], axis=1)  # [nl, 2]
            # my RIGHT layer -> right neighbor = its LEFT halo; and so on
            hf_L, hi_L = _send(hal_f, hal_i, idxh_r, vh_r, perm_xr, ax_x)
            hf_R, hi_R = _send(hal_f, hal_i, idxh_l, vh_l, perm_xl, ax_x)
            pos_h = jnp.concatenate([hf_L[:, 0:3], hf_R[:, 0:3]], axis=0)
            vel_h = jnp.concatenate([hf_L[:, 3:6], hf_R[:, 3:6]], axis=0)
            mass_h = jnp.concatenate([hf_L[:, 6], hf_R[:, 6]], axis=0)
            mat_h = jnp.concatenate([hi_L[:, 0], hi_R[:, 0]], axis=0)
            uid_h = jnp.concatenate([hi_L[:, 1], hi_R[:, 1]], axis=0)

            # ---- halo phase y (2D): own + forwarded x-halo corners ------
            if two_d:
                pos_cc = jnp.concatenate([pos, pos_h], axis=0)
                vel_cc = jnp.concatenate([vel, vel_h], axis=0)
                mass_cc = jnp.concatenate([mass, mass_h], axis=0)
                mat_cc = jnp.concatenate([mat, mat_h], axis=0)
                uid_cc = jnp.concatenate([uid, uid_h], axis=0)
                cyc = jnp.clip((pos_cc[:, 1] / cell).astype(i32), 0, g - 1)
                # x-halo rows qualify only if their x-cell actually lies in
                # my local grid: an x-BOUNDARY chip also receives the
                # cyclic ppermute's WRAP traffic (the far slab's layer,
                # non-periodic box) — forwarding it would burn the phase-y
                # H-cap ahead of genuine corner rows and inflate
                # n_halo_over (the junk itself parks outside every grid)
                cx_h = jnp.clip(
                    (pos_h[:, 0] / cell).astype(i32), 0, g - 1
                ) - (me_x * w_x - 1)
                halo_ok = (mass_h > 0.0) & (cx_h >= 0) & (cx_h < w_x + 2)
                cand = jnp.concatenate([settled, halo_ok])
                if d_y > 1:  # size-1 y axis: same no-self-clone rule
                    lay_d = cand & (cyc == me_y * w_y)
                    lay_u = cand & (cyc == (me_y + 1) * w_y - 1)
                else:
                    lay_d = lay_u = jnp.zeros_like(cand)
                idxy_d, vy_d = take_rows(lay_d, H)
                idxy_u, vy_u = take_rows(lay_u, H)
                halo_over = halo_over + (
                    jnp.sum(lay_d.astype(i32)) - jnp.sum(vy_d.astype(i32))
                    + jnp.sum(lay_u.astype(i32)) - jnp.sum(vy_u.astype(i32))
                )
                hal_fc = jnp.concatenate(
                    [pos_cc, vel_cc, mass_cc[:, None]], axis=1
                )
                hal_ic = jnp.stack([mat_cc, uid_cc], axis=1)
                yf_D, yi_D = _send(hal_fc, hal_ic, idxy_u, vy_u,
                                   perm_yr, ax_y)
                yf_U, yi_U = _send(hal_fc, hal_ic, idxy_d, vy_d,
                                   perm_yl, ax_y)
                pos_h = jnp.concatenate(
                    [pos_h, yf_D[:, 0:3], yf_U[:, 0:3]], axis=0)
                vel_h = jnp.concatenate(
                    [vel_h, yf_D[:, 3:6], yf_U[:, 3:6]], axis=0)
                mass_h = jnp.concatenate([mass_h, yf_D[:, 6], yf_U[:, 6]])
                mat_h = jnp.concatenate([mat_h, yi_D[:, 0], yi_U[:, 0]])
                uid_h = jnp.concatenate([uid_h, yi_D[:, 1], yi_U[:, 1]])
            n_halo_over = jax.lax.psum(halo_over, AXES)

            # ---- gravity on the post-migration shard ---------------------
            if force_impl == "zero":
                acc_new = jnp.zeros_like(pos)
            elif force_impl == "p3m":
                rho = jax.lax.psum(
                    cic_deposit(pos, mass, box_size, pm_grid,
                                periodic=False),
                    AXES,
                )
                acc_grid = _isolated_solve_r(
                    rho, cfg.G, box_size, pm_grid, gh
                )
                acc_new = cic_gather(acc_grid, pos, box_size, pm_grid,
                                     periodic=False)
                # the short-range erfc term joins from the fused collision
                # kernel below
            else:
                rho = jax.lax.psum(
                    cic_deposit(pos, mass, box_size, pm_grid,
                                periodic=False),
                    AXES,
                )
                acc_grid = pm_solve_grid(rho, cfg.G, box_size, pm_grid,
                                         isolated=True)
                acc_new = cic_gather(acc_grid, pos, box_size, pm_grid,
                                     periodic=False)

            # ---- packed collision kernel on the local slab grid ----------
            pos_a = jnp.concatenate([pos, pos_h], axis=0)
            vel_a = jnp.concatenate([vel, vel_h], axis=0)
            mass_a = jnp.concatenate([mass, mass_h], axis=0)
            mat_a = jnp.concatenate([mat, mat_h], axis=0)
            uid_a = jnp.concatenate([uid, uid_h], axis=0)
            rad_a = body_radius(mass_a, mat_a, mats)
            n_all = nl + n_halo
            sg = (
                (cfg.G, box_size / g / 3.0, cfg.softening)
                if force_impl == "p3m" else None
            )
            if buckets is not None:
                outs = bucketed_collision_blocks_local(
                    pos_a, vel_a, mass_a, rad_a, box_size, g, band_cells,
                    buckets, cfg.restitution, cfg.friction,
                    me_x * w_x - 1, w_x, interpret,
                    me_y * w_y - 1 if two_d else 0,
                    w_y if two_d else None,
                    short_gravity=sg,
                )
                if sg is not None:
                    out_d, out_e, out_g, novf = outs
                    acc_new = acc_new + out_g[:nl, 0:3]
                else:
                    out_d, out_e, novf = outs
            else:
                outs = packed_collision_blocks_local(
                    pos_a, vel_a, mass_a, rad_a, box_size, g, band_cells,
                    packed_caps, cfg.restitution, cfg.friction,
                    me_x * w_x - 1, w_x, interpret,
                    me_y * w_y - 1 if two_d else 0,
                    w_y if two_d else None,
                    short_gravity=sg,
                )
                if sg is not None:
                    delta, evt, grav, body_slot, novf = outs
                    m_rows = grav.shape[0]
                    grav_p = jnp.concatenate(
                        [grav, jnp.zeros((1, grav.shape[1]), jnp.float32)],
                        axis=0,
                    )
                    acc_new = acc_new + grav_p[
                        jnp.clip(body_slot[:nl], 0, m_rows)
                    ][:, 0:3]
                else:
                    delta, evt, body_slot, novf = outs
                out_d, out_e = epilogue_rows(delta, evt, body_slot)
            n_overflow = jax.lax.psum(novf, AXES)
            n_bounces = (
                jax.lax.psum(jnp.sum(out_d[:nl, 7]), AXES) / 2.0
            ).astype(i32)
            too_small = (
                2.0 * jax.lax.pmax(jnp.max(rad_a), AXES) > cell
            )
            od, oe = out_d[:nl], out_e[:nl]

            # winner's pair quantities from the PRE-delta local state
            # (same formulas as _collide_epilogue; j is a LOCAL row)
            has = oe[:, 0] > 0.0
            j_loc = jnp.where(has, oe[:, 1].astype(i32), n_all - 1)
            jcl = jnp.clip(j_loc, 0, n_all - 1)
            dd = pos_a[jcl] - pos
            r2b = jnp.sum(dd * dd, axis=-1)
            invb = jax.lax.rsqrt(jnp.where(r2b > 0.0, r2b, 1.0))
            vnb = jnp.sum((vel_a[jcl] - vel) * dd, axis=-1) * invb
            m_j = mass_a[jcl]
            m_sum = mass + m_j
            r_msb = 1.0 / jnp.where(m_sum > 0.0, m_sum, 1.0)
            e_b = 0.5 * (mass * m_j * r_msb) * vnb * vnb
            q_l = jnp.where(has, e_b * r_msb, 0.0)
            appr_l = has & (vnb < 0.0)

            # apply the sweep's Jacobi deltas to the OWNED rows
            pos = pos + od[:, 3:6]
            vel = vel + od[:, 0:3]
            temp = temp + od[:, 6]

            # ---- contact timers on partner UID (L314-319) ----------------
            pu_new = jnp.where(has, uid_a[jcl], -1)
            same = has & (pu_new == p_uid) & (pu_new >= 0)
            ct = jnp.where(has, jnp.where(same, ct + h, h), 0.0)

            # ---- exchange 2: halo decision fields + post-delta state -----
            dec_f = jnp.concatenate(
                [pos, vel, temp[:, None], ct[:, None]], axis=1
            )  # [nl, 8] (post-delta)
            dec_i = pu_new[:, None]  # [nl, 1]
            df_L, di_L = _send(dec_f, dec_i, idxh_r, vh_r, perm_xr, ax_x)
            df_R, di_R = _send(dec_f, dec_i, idxh_l, vh_l, perm_xl, ax_x)
            pos2_h = jnp.concatenate([df_L[:, 0:3], df_R[:, 0:3]], axis=0)
            vel2_h = jnp.concatenate([df_L[:, 3:6], df_R[:, 3:6]], axis=0)
            temp2_h = jnp.concatenate([df_L[:, 6], df_R[:, 6]], axis=0)
            ct_h = jnp.concatenate([df_L[:, 7], df_R[:, 7]], axis=0)
            pu_h = jnp.concatenate([di_L[:, 0], di_R[:, 0]], axis=0)
            if two_d:
                # phase y forwards the SAME selection as halo phase y: rows
                # of [own; x-halo] — own rows from this chip's decision
                # state, x-halo rows from the phase-x receive above
                dec_fc = jnp.concatenate([dec_f, jnp.concatenate(
                    [df_L, df_R], axis=0)], axis=0)  # [nl + 2H, 8]
                dec_ic = jnp.concatenate([dec_i, jnp.concatenate(
                    [di_L, di_R], axis=0)], axis=0)
                dfy_D, diy_D = _send(dec_fc, dec_ic, idxy_u, vy_u,
                                     perm_yr, ax_y)
                dfy_U, diy_U = _send(dec_fc, dec_ic, idxy_d, vy_d,
                                     perm_yl, ax_y)
                pos2_h = jnp.concatenate(
                    [pos2_h, dfy_D[:, 0:3], dfy_U[:, 0:3]], axis=0)
                vel2_h = jnp.concatenate(
                    [vel2_h, dfy_D[:, 3:6], dfy_U[:, 3:6]], axis=0)
                temp2_h = jnp.concatenate(
                    [temp2_h, dfy_D[:, 6], dfy_U[:, 6]])
                ct_h = jnp.concatenate([ct_h, dfy_D[:, 7], dfy_U[:, 7]])
                pu_h = jnp.concatenate([pu_h, diy_D[:, 0], diy_U[:, 0]])
            pos2_a = jnp.concatenate([pos, pos2_h], axis=0)
            vel2_a = jnp.concatenate([vel, vel2_h], axis=0)
            temp2_a = jnp.concatenate([temp, temp2_h], axis=0)
            ct_a = jnp.concatenate([ct, ct_h], axis=0)
            pu_a = jnp.concatenate([pu_new, pu_h], axis=0)

            # ---- event gates on mutual partners (L340-359) ---------------
            mutual = has & (uid >= 0) & (pu_a[jcl] == uid)
            t_pair = jnp.minimum(ct, ct_a[jcl])
            merge_m = (
                mutual & appr_l
                & (t_pair > cfg.merge_time)
                & (q_l < cfg.fracture_threshold * 2.0)
            )
            fract_m = (
                mutual & appr_l & ~merge_m
                & (q_l > cfg.fracture_threshold)
                & ((mass > cfg.min_fragment_mass)
                   | (m_j > cfg.min_fragment_mass))
            )
            lower = uid < pu_new
            prim_m = merge_m & lower
            kill_m = merge_m & ~lower
            prim_f = fract_m & lower

            # ---- merges in place into the lower-UID slot (L392-409) ------
            tot = mass + m_j
            safe_tot = jnp.where(tot > 0, tot, 1.0)
            mpos = (pos * mass[:, None] + pos2_a[jcl] * m_j[:, None]) \
                / safe_tot[:, None]
            mvel = (vel * mass[:, None] + vel2_a[jcl] * m_j[:, None]) \
                / safe_tot[:, None]
            mtemp = (temp * mass + temp2_a[jcl] * m_j) / safe_tot
            mmat = jnp.where(mass > m_j, mat, mat_a[jcl])  # heavier (L403)

            # fracture payload BEFORE the merge/kill writes
            f_safe = jnp.where(fract_m, tot, 1.0)
            f_com = (pos * mass[:, None] + pos2_a[jcl] * m_j[:, None]) \
                / f_safe[:, None]
            f_bvel = (vel * mass[:, None] + vel2_a[jcl] * m_j[:, None]) \
                / f_safe[:, None]
            e_best = jnp.where(fract_m, e_b, 0.0)
            f_temp = jnp.maximum(temp, temp2_a[jcl]) + (e_best / f_safe) * 0.1
            f_mat = jnp.where(mass > m_j, mat, mat_a[jcl])
            f_rsum = rad_a[:nl] + rad_a[jcl]

            pm2 = prim_m[:, None]
            pos = jnp.where(pm2, mpos, pos)
            vel = jnp.where(pm2, mvel, jnp.where(kill_m[:, None], 0.0, vel))
            temp = jnp.where(prim_m, mtemp, jnp.where(kill_m, 0.0, temp))
            mat = jnp.where(prim_m, mmat, mat)
            mass = jnp.where(prim_m, tot, jnp.where(kill_m, 0.0, mass))
            uid = jnp.where(kill_m, -1, uid)

            # ---- fractures: per-chip extraction + fragment sampling ------
            fi, f_valid = take_rows(prim_f, f_cap)
            frag = _make_fragments(
                jax.random.fold_in(key, me_lin), cfg, f_valid,
                f_com[fi], f_bvel[fi],
                jnp.where(f_valid, e_best[fi], 0.0),
                tot[fi], f_temp[fi], f_mat[fi], f_rsum[fi],
            )
            # kill accepted parents: my fi rows, plus partners — local
            # directly, remote via kill-flag exchanges retracing the halo
            fkill = jnp.zeros((nl,), bool)
            fkill = fkill.at[jnp.where(f_valid, fi, nl)].set(
                True, mode="drop"
            )
            fj = jnp.where(f_valid, jcl[fi], n_all)
            fkill = fkill.at[jnp.where(fj < nl, fj, nl)].set(
                True, mode="drop"
            )
            flag_h = jnp.zeros((n_halo,), bool).at[
                jnp.where(fj >= nl, fj - nl, n_halo)
            ].set(True, mode="drop")
            flag_x = flag_h[:2 * H]
            if two_d:
                # y-returns first: flags for my y-halo rows go back to the
                # y-sender, aligned with ITS phase-y selection over
                # [own; x-halo]; own rows kill directly, x-halo rows are
                # OR-ed into the x-return (the corner's second hop)
                flag_y = flag_h[2 * H:]
                back_dn = jax.lax.ppermute(flag_y[:H], ax_y, perm_yl)
                back_up = jax.lax.ppermute(flag_y[H:], ax_y, perm_yr)
                # back_dn aligns with MY idxy_u rows; back_up with idxy_d
                yk_u = jnp.where(vy_u & back_dn, idxy_u, nl + 2 * H)
                yk_d = jnp.where(vy_d & back_up, idxy_d, nl + 2 * H)
                fkill = fkill.at[jnp.where(yk_u < nl, yk_u, nl)].set(
                    True, mode="drop")
                fkill = fkill.at[jnp.where(yk_d < nl, yk_d, nl)].set(
                    True, mode="drop")
                xfwd = jnp.zeros((2 * H,), bool)
                xfwd = xfwd.at[jnp.where(
                    (yk_u >= nl) & (yk_u < nl + 2 * H), yk_u - nl, 2 * H
                )].set(True, mode="drop")
                xfwd = xfwd.at[jnp.where(
                    (yk_d >= nl) & (yk_d < nl + 2 * H), yk_d - nl, 2 * H
                )].set(True, mode="drop")
                flag_x = flag_x | xfwd
            back_l = jax.lax.ppermute(flag_x[:H], ax_x, perm_xl)
            back_r = jax.lax.ppermute(flag_x[H:], ax_x, perm_xr)
            # back_l arrives aligned with MY idxh_r rows; back_r with idxh_l
            fkill = fkill.at[
                jnp.where(vh_r & back_l, idxh_r, nl)
            ].set(True, mode="drop")
            fkill = fkill.at[
                jnp.where(vh_l & back_r, idxh_l, nl)
            ].set(True, mode="drop")
            mass = jnp.where(fkill, 0.0, mass)
            vel = jnp.where(fkill[:, None], 0.0, vel)
            temp = jnp.where(fkill, 0.0, temp)
            uid = jnp.where(fkill, -1, uid)

            # ---- fragment placement into dead slots ----------------------
            n_fk = frag["mask"].shape[0]  # F * K
            dead = mass <= 0.0
            # first-n_fk dead slots via take_rows, not the nl-length
            # rank-scatter
            slot_of2, sv2 = take_rows(dead, n_fk)
            slot_of2 = jnp.where(sv2, slot_of2, nl)
            frank = jnp.cumsum(frag["mask"].astype(i32)) - 1
            fslot = jnp.where(
                frag["mask"], slot_of2[jnp.clip(frank, 0, n_fk - 1)], nl
            )
            fplaced = frag["mask"] & (fslot < nl)
            fslot = jnp.where(fplaced, fslot, nl)
            mass = mass.at[fslot].set(frag["mass"], mode="drop")
            pos = pos.at[fslot].set(frag["pos"], mode="drop")
            vel = vel.at[fslot].set(frag["vel"], mode="drop")
            temp = temp.at[fslot].set(frag["temp"], mode="drop")
            mat = mat.at[fslot].set(frag["mat"], mode="drop")
            new_uid = uid_next + me_lin * n_fk + jnp.arange(n_fk, dtype=i32)
            uid = uid.at[fslot].set(new_uid, mode="drop")
            uid_next2 = uid_next + i32(n_dev * n_fk)

            # ---- reset contact bookkeeping on touched slots --------------
            touched = prim_m | kill_m | fkill
            touched = touched.at[fslot].set(True, mode="drop")
            pu_new = jnp.where(touched, -1, pu_new)
            ct = jnp.where(touched, 0.0, ct)
            # reborn slots are NEWBORN: acc = 0 (index.html:217)
            acc_new = jnp.where(touched[:, None], 0.0, acc_new)

            # ---- second half-kick + thermal decay ------------------------
            vel = vel + acc_new * (0.5 * h)
            temp = thermal.decay(temp, cfg.heat_decay)

            # ---- counters ------------------------------------------------
            n_merges = jax.lax.psum(jnp.sum(prim_m.astype(i32)), AXES)
            n_fracts = jax.lax.psum(jnp.sum(prim_f.astype(i32)), AXES)
            n_dropped = jax.lax.psum(
                jnp.sum(prim_f.astype(i32)) - jnp.sum(f_valid.astype(i32))
                + jnp.sum(frag["mask"].astype(i32))
                - jnp.sum(fplaced.astype(i32)),
                AXES,
            ) + n_mig_drop
            return (pos, vel, acc_new, mass, mat, temp, uid, pu_new, ct,
                    uid_next2, n_merges, n_fracts, n_bounces, n_overflow,
                    n_dropped, too_small, n_mig_wait, n_halo_over, n_transit)

        out = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                P(row, None), P(row, None), P(row, None), P(row), P(row),
                P(row), P(row), P(row), P(row), P(), P(),
            ),
            out_specs=(
                P(row, None), P(row, None), P(row, None), P(row), P(row),
                P(row), P(row), P(row), P(row), P(),
                P(), P(), P(), P(), P(), P(), P(), P(), P(),
            ),
            # pallas_call's out_shape carries no vma annotation (see
            # make_sharded_binned_collision_pass)
            check_vma=False,
        )(state.pos, state.vel, state.acc, state.mass, state.mat,
          state.temp, state.uid, state.partner_uid, state.contact_t,
          state.uid_next, gh)
        new_state = SpatialState(*out[:10])
        return new_state, {
            "n_merges": out[10], "n_fractures": out[11],
            "n_bounces": out[12], "n_overflow": out[13],
            "n_dropped": out[14], "cell_too_small": out[15],
            "n_mig_wait": out[16], "n_halo_over": out[17],
            "in_transit": out[18],
        }

    gh_arg = (green_hat if green_hat is not None
              else jnp.zeros((), jnp.complex64))

    def step(state: SpatialState, h, key):
        return _step(state, h, key, gh_arg)

    return step
