"""Multi-device scaling: bodies sharded over a device mesh.

The reference is a single browser tab with zero parallelism (SURVEY.md
section 2b); this module is the multi-card scaling story (BASELINE config
5: the N = 1M galaxy merger).

Design (the all-gather strategy from the scaling playbook):

  * 1D mesh axis "b": each device owns N/D bodies (pos, vel, mass shards).
  * Per KDK substep, every device `lax.all_gather`s the drifted positions
    and masses (tiled), then computes the force of ALL bodies on its LOCAL
    shard with the rectangular gravity kernel (or the plain blocked sum,
    as nbx.backend picks) — O(N^2/D) flops/device, O(N) comm/device.
  * Optional 2D mesh ("b", "j"): the source axis is also sharded, each
    device computes a partial force over its source slice and a `psum`
    over "j" completes the reduction — halves the gather volume per device
    when the per-device N shard no longer amortizes the all-gather.
  * Diagnostics (energy/momentum) are psum-reduced on device.

Everything is `shard_map` over a `jax.sharding.Mesh`, so the same code runs
on several GPUs or on N virtual CPU devices
(--xla_force_host_platform_device_count) in the test suite.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nbx import forces
from nbx.backend import kernel_impl


def make_mesh(n_devices: int | None = None, axes=("b",)) -> Mesh:
    """1D (or factored 2D) device mesh. n_devices defaults to all."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    if len(axes) == 1:
        return jax.make_mesh((n,), axes, devices=devs)
    assert len(axes) == 2
    # Factor n into a near-square 2D mesh
    a = int(n**0.5)
    while n % a:
        a -= 1
    return jax.make_mesh((a, n // a), axes, devices=devs)


class ShardedState(NamedTuple):
    """Gravity-only phase state, body axis sharded over the mesh."""

    pos: jax.Array  # [N, 3]
    vel: jax.Array  # [N, 3]
    acc: jax.Array  # [N, 3]
    mass: jax.Array  # [N]


def shard_state(mesh: Mesh, pos, vel, mass) -> ShardedState:
    """Place arrays on the mesh, body axis sharded. N must divide evenly
    (pad with mass-0 bodies otherwise — they exert zero force)."""
    n = pos.shape[0]
    d = mesh.devices.size
    if n % d:
        raise ValueError(f"N={n} not divisible by mesh size {d}; pad with mass-0")
    s3 = NamedSharding(mesh, P("b", None))
    s1 = NamedSharding(mesh, P("b"))
    pos = jax.device_put(jnp.asarray(pos, jnp.float32), s3)
    vel = jax.device_put(jnp.asarray(vel, jnp.float32), s3)
    mass = jax.device_put(jnp.asarray(mass, jnp.float32), s1)
    acc = jnp.zeros_like(pos)  # reference newborn acc=0 (index.html:217)
    return ShardedState(pos, vel, acc, mass)


def shard_state2d(mesh: Mesh, pos, vel, mass) -> ShardedState:
    """2D-mesh placement: body axis sharded over both mesh axes ("b" major,
    "j" minor) — the layout make_sharded_step_2d expects."""
    n = pos.shape[0]
    d = mesh.devices.size
    if n % d:
        raise ValueError(f"N={n} not divisible by mesh size {d}; pad with mass-0")
    s3 = NamedSharding(mesh, P(("b", "j"), None))
    s1 = NamedSharding(mesh, P(("b", "j")))
    pos = jax.device_put(jnp.asarray(pos, jnp.float32), s3)
    vel = jax.device_put(jnp.asarray(vel, jnp.float32), s3)
    mass = jax.device_put(jnp.asarray(mass, jnp.float32), s1)
    return ShardedState(pos, vel, jnp.zeros_like(pos), mass)


def _local_acc(pos_all, mass_all, pos_local, G, eps, impl: str):
    """Force of all bodies on the local shard (rectangular problem): the
    gravity kernel ("pallas") or the plain blocked sum ("jnp"), both in
    O(N_local * block) memory."""
    if impl == "pallas":
        from nbx.ops.pairwise import pairwise_acc

        return pairwise_acc(pos_all, mass_all, G, eps, target_pos=pos_local)
    return forces.accelerations_blocked(pos_all, mass_all, G, eps,
                                        target_pos=pos_local)


def make_sharded_step(mesh: Mesh, impl: str = "auto"):
    """Build the sharded KDK substep: (state, G, eps, h) -> state.

    Same integration semantics as the single-chip gravity path
    (nbx.integrators.kdk_step, reference index.html:247-262, collisions off).
    """
    impl = _resolve_impl(impl)

    @jax.jit
    def step(state: ShardedState, G, eps, h) -> ShardedState:
        def local(pos, vel, acc, mass):
            vel = vel + acc * (0.5 * h)
            pos = pos + vel * h
            pos_all = jax.lax.all_gather(pos, "b", axis=0, tiled=True)
            mass_all = jax.lax.all_gather(mass, "b", axis=0, tiled=True)
            acc = _local_acc(pos_all, mass_all, pos, G, eps, impl)
            vel = vel + acc * (0.5 * h)
            return pos, vel, acc

        pos, vel, acc = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P("b", None), P("b", None), P("b", None), P("b")),
            out_specs=(P("b", None), P("b", None), P("b", None)),
            check_vma=False,  # pallas_call outputs carry no vma type
        )(state.pos, state.vel, state.acc, state.mass)
        return ShardedState(pos, vel, acc, state.mass)

    return step


def make_sharded_step_2d(mesh: Mesh, impl: str = "auto"):
    """2D-mesh variant: bodies sharded over "b", sources over "j".

    Each chip gathers positions only over its "b" row (1/|j| of the full
    gather volume), computes the partial force of its source slice on its
    body shard, and a psum over "j" completes the Newton sum — the
    tensor-parallel analog for the force reduction.
    """
    impl = _resolve_impl(impl)

    @jax.jit
    def step(state: ShardedState, G, eps, h) -> ShardedState:
        def local(pos, vel, acc, mass):
            # pos/vel/acc: [N/(b*j), 3] — body axis sharded over BOTH mesh
            # axes so that drift/kick work and memory are fully distributed.
            vel = vel + acc * (0.5 * h)
            pos = pos + vel * h
            # Re-assemble the "b"-row body shard: gather over "j".
            pos_b = jax.lax.all_gather(pos, "j", axis=0, tiled=True)
            # Source slice for this chip's "j" column: gather over "b"
            # (a strided 1/|j| subset of all bodies; the j columns partition
            # the sources, and the force sum is order-invariant).
            src_pos = jax.lax.all_gather(pos, "b", axis=0, tiled=True)
            src_mass = jax.lax.all_gather(mass, "b", axis=0, tiled=True)
            partial = _local_acc(src_pos, src_mass, pos_b, G, eps, impl)
            # Complete the source reduction and scatter back to the local
            # body sub-shard in one collective: chunk j of the "b"-row is
            # exactly this device's sub-shard under P(("b", "j")) layout.
            acc_full = jax.lax.psum_scatter(
                partial, "j", scatter_dimension=0, tiled=True
            )
            vel = vel + acc_full * (0.5 * h)
            return pos, vel, acc_full

        pos, vel, acc = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(("b", "j"), None),) * 3 + (P(("b", "j")),),
            out_specs=(P(("b", "j"), None),) * 3,
            check_vma=False,  # pallas_call outputs carry no vma type
        )(state.pos, state.vel, state.acc, state.mass)
        return ShardedState(pos, vel, acc, state.mass)

    return step


def make_sharded_step_ring(mesh: Mesh, impl: str = "auto"):
    """Ring-systolic variant of the sharded KDK substep.

    Instead of one all-gather of every position (peak comm buffer = N), the
    source chunk rotates around the ring with `lax.ppermute`: D-1 hops of
    N/D positions+masses each, with the local force partial computed between
    hops — XLA can overlap the async permute with the force computation
    (the systolic N-body pattern; same total bytes as the all-gather but
    O(N/D) peak buffer and compute/comm overlap instead of a serial
    gather-then-compute).

    Bit-matches the physics of make_sharded_step up to f32 summation order
    (chunk-major instead of source-major accumulation).
    """
    impl = _resolve_impl(impl)

    @jax.jit
    def step(state: ShardedState, G, eps, h) -> ShardedState:
        def local(pos, vel, acc, mass):
            d = jax.lax.axis_size("b")
            vel = vel + acc * (0.5 * h)
            pos = pos + vel * h

            perm = [(i, (i + 1) % d) for i in range(d)]

            def hop(k, carry):
                acc_sum, src_pos, src_mass = carry
                acc_sum = acc_sum + _local_acc(
                    src_pos, src_mass, pos, G, eps, impl
                )
                # rotate sources to the next chip (a no-op result on the
                # final iteration is avoided by bounding the loop at d - 1
                # hops and adding the last chunk's force outside)
                src_pos = jax.lax.ppermute(src_pos, "b", perm)
                src_mass = jax.lax.ppermute(src_mass, "b", perm)
                return acc_sum, src_pos, src_mass

            acc0 = jnp.zeros_like(pos)
            acc_sum, src_pos, src_mass = jax.lax.fori_loop(
                0, d - 1, hop, (acc0, pos, mass)
            )
            acc = acc_sum + _local_acc(src_pos, src_mass, pos, G, eps, impl)
            vel = vel + acc * (0.5 * h)
            return pos, vel, acc

        pos, vel, acc = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P("b", None), P("b", None), P("b", None), P("b")),
            out_specs=(P("b", None), P("b", None), P("b", None)),
            check_vma=False,  # pallas_call outputs carry no vma type
        )(state.pos, state.vel, state.acc, state.mass)
        return ShardedState(pos, vel, acc, state.mass)

    return step


class ShardedBodyState(NamedTuple):
    """Full-physics sharded state: gravity + collision fields, body axis
    sharded over the mesh. partner/contact_t are the per-body contact
    records of the at-scale collision semantics (nbx.collisions_scaled)."""

    pos: jax.Array  # [N, 3]
    vel: jax.Array  # [N, 3]
    acc: jax.Array  # [N, 3]
    mass: jax.Array  # [N] (0 = dead)
    mat: jax.Array  # [N] i32
    temp: jax.Array  # [N]
    partner: jax.Array  # [N] i32 GLOBAL index of deepest partner (-1 none)
    contact_t: jax.Array  # [N]


def shard_body_state(mesh: Mesh, pos, vel, mass, mat=None,
                     temp=None) -> ShardedBodyState:
    n = pos.shape[0]
    d = mesh.devices.size
    if n % d:
        raise ValueError(f"N={n} not divisible by mesh size {d}; pad with mass-0")
    s3 = NamedSharding(mesh, P("b", None))
    s1 = NamedSharding(mesh, P("b"))
    put3 = lambda x: jax.device_put(jnp.asarray(x, jnp.float32), s3)
    put1 = lambda x, dt=jnp.float32: jax.device_put(jnp.asarray(x, dt), s1)
    return ShardedBodyState(
        pos=put3(pos),
        vel=put3(vel),
        acc=put3(jnp.zeros((n, 3))),
        mass=put1(mass),
        mat=put1(mat if mat is not None else jnp.zeros(n), jnp.int32),
        temp=put1(temp if temp is not None else jnp.zeros(n)),
        partner=put1(jnp.full((n,), -1), jnp.int32),
        contact_t=put1(jnp.zeros(n)),
    )


def make_sharded_physics_step(mesh: Mesh, cfg, impl: str = "auto"):
    """Sharded FULL-physics KDK substep: gravity + bounce + contact timers
    + merges + FRACTURES across chips. (state, h, key) -> (state, counters).

    Design (docs/DESIGN.md "sharded collisions"): each chip resolves its
    LOCAL body shard against the all-gathered global state — O(N^2/D) pair
    work per chip, the same scaling as the force path. Event decisions are
    made from REPLICATED data: pair quantities (vn, Q, depth) are computed
    identically on both owners (elementwise f32 on identical gathered
    inputs), and the mutual deepest-partner gate (nbx.collisions_scaled
    semantics) needs only one extra all-gather of the per-body partner /
    timer / flags — so the two owners of a merging pair reach the SAME
    decision with no extra round trips. The lower-index slot hosts the
    merged body (it stays on its owning chip; slot ownership is static),
    the higher-index copy dies in place.

    Fractures (reference index.html:411-443) extend the same replication
    principle to slot ALLOCATION: every chip gathers the fracture-event
    payload, extracts the same globally-ranked event list, samples the SAME
    fragments from the shared `key` (jax.random is deterministic), and runs
    the same rank-scatter of fragments onto the global dead-slot census —
    then each chip writes only the fragments whose assigned slot falls in
    its own shard. Pure replicated arithmetic; no negotiation, no extra
    round trips beyond the payload gather.

    Pair math is dense [N/D, N] jnp (the correctness/semantics reference;
    interactive scale). The production-scale path is
    make_sharded_granular_step, which runs the binned window sweep
    (nbx.ops.collide) per chip.

    PRNG contract: `key` is consumed as-is — the caller MUST pass a fresh
    key per step (jax.random.fold_in(base, step) or split), or every
    fracture event replays identical fragment counts/velocities.
    """
    from nbx.collisions import _make_fragments
    from nbx.config import body_radius, inverse_mass
    from nbx.ops.p3m import take_rows

    impl = _resolve_impl(impl)
    mats = cfg.materials
    f_cap = cfg.max_fractures

    @jax.jit
    def step(state: ShardedBodyState, h, key):
        def local(pos, vel, acc, mass, mat, temp, partner, t_prev):
            nl = pos.shape[0]
            me = jax.lax.axis_index("b")
            gidx = me * nl + jnp.arange(nl, dtype=jnp.int32)  # global ids

            # ---- KDK first half + gravity (as make_sharded_step) --------
            vel = vel + acc * (0.5 * h)
            pos = pos + vel * h
            gather = lambda x: jax.lax.all_gather(x, "b", axis=0, tiled=True)
            pos_g = gather(pos)
            mass_g = gather(mass)
            acc_new = _local_acc(pos_g, mass_g, pos, cfg.G, cfg.softening, impl)

            # ---- collisions: local rows vs global columns ----------------
            radius = body_radius(mass, mat, mats)
            radius_g = gather(radius)
            vel_g = gather(vel)
            n = pos_g.shape[0]
            col = jnp.arange(n, dtype=jnp.int32)

            d = pos_g[None, :, :] - pos[:, None, :]  # [nl, N] i -> j
            r2 = jnp.sum(d * d, axis=-1)
            min_d = radius[:, None] + radius_g[None, :]
            alive2 = (mass[:, None] > 0) & (mass_g[None, :] > 0)
            distinct = gidx[:, None] != col[None, :]
            overlap = alive2 & distinct & (r2 < min_d * min_d)
            dist = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
            nrm = d / dist[:, :, None]
            rv = vel_g[None, :, :] - vel[:, None, :]
            vn = jnp.sum(rv * nrm, axis=-1)
            appr = overlap & (vn < 0)

            inv_l = inverse_mass(mass)
            inv_g = inverse_mass(mass_g)
            inv_sum = inv_l[:, None] + inv_g[None, :]
            safe_is = jnp.where(inv_sum > 0, inv_sum, 1.0)
            j_imp = jnp.where(appr, -(1 + cfg.restitution) * vn / safe_is, 0.0)
            t_raw = rv - vn[:, :, None] * nrm
            t_len = jnp.sqrt(jnp.sum(t_raw * t_raw, axis=-1))
            t_hat = t_raw / jnp.where(t_len > 0, t_len, 1.0)[:, :, None]
            jt = jnp.where(appr, -t_len * cfg.friction / safe_is, 0.0)
            imp = j_imp[:, :, None] * nrm + jt[:, :, None] * t_hat
            vel = vel - jnp.sum(imp, axis=1) * inv_l[:, None]
            corr = jnp.where(appr, (min_d - dist) / safe_is * 0.8, 0.0)
            pos = pos - jnp.sum(corr[:, :, None] * nrm, axis=1) * inv_l[:, None]
            m_sum = mass[:, None] + mass_g[None, :]
            safe_ms = jnp.where(m_sum > 0, m_sum, 1.0)
            e_full = 0.5 * (mass[:, None] * mass_g[None, :] / safe_ms) * vn * vn
            temp = temp + jnp.sum(jnp.where(appr, e_full, 0.0), 1) * inv_l * 0.2
            n_bounce = jnp.sum(appr.astype(jnp.int32))

            # ---- deepest-overlap partner + timers (collisions_scaled) ----
            depth = jnp.where(overlap, min_d - dist, -jnp.inf)
            best_j = jnp.argmax(depth, axis=1).astype(jnp.int32)
            has = jnp.take_along_axis(depth, best_j[:, None], 1)[:, 0] > 0
            atj = lambda m: jnp.take_along_axis(m, best_j[:, None], 1)[:, 0]
            q_l = jnp.where(has, atj(e_full / safe_ms), 0.0)
            appr_l = has & (atj(vn) < 0)
            same = (best_j == partner) & has
            t_new = jnp.where(has, jnp.where(same, t_prev + h, h), 0.0)
            partner_new = jnp.where(has, best_j, -1)

            # ---- merge gate from replicated decision data -----------------
            pos2_g = gather(pos)  # post-correction values for merge math
            vel2_g = gather(vel)
            temp2_g = gather(temp)
            mat_g = gather(mat)
            partner_g = gather(partner_new)
            t_g = gather(t_new)
            appr_g = gather(appr_l)
            q_g = gather(q_l)

            jc = jnp.clip(partner_new, 0, n - 1)
            mutual = has & (partner_g[jc] == gidx)
            t_pair = jnp.minimum(t_new, t_g[jc])
            mergeable = (
                mutual & appr_l & appr_g[jc]
                & (t_pair > cfg.merge_time)
                & (q_l < cfg.fracture_threshold * 2.0)
            )
            primary = mergeable & (gidx < jc)  # merged body lives here
            killed = mergeable & (gidx > jc)  # our copy dies

            mj = mass_g[jc]
            tot = mass + mj
            safe_tot = jnp.where(tot > 0, tot, 1.0)
            mpos = (pos * mass[:, None] + pos2_g[jc] * mj[:, None]) / safe_tot[:, None]
            mvel = (vel * mass[:, None] + vel2_g[jc] * mj[:, None]) / safe_tot[:, None]
            mtemp = (temp * mass + temp2_g[jc] * mj) / safe_tot
            mmat = jnp.where(mass > mj, mat, mat_g[jc])  # heavier (L403)

            # ---- fracture gate, exclusive with merges (L348, 354-359) ------
            fract = (
                mutual & appr_l & appr_g[jc] & ~mergeable
                & (q_l > cfg.fracture_threshold)
                & ((mass > cfg.min_fragment_mass)
                   | (mj > cfg.min_fragment_mass))
            )
            primary_f = fract & (gidx < jc)
            # event payload from PRE-KILL values (fracture parents are
            # untouched by the merge writes below — gates are exclusive)
            e_best = jnp.where(fract, atj(e_full), 0.0)
            f_tot = jnp.where(fract, mass + mj, 1.0)
            f_com = (pos * mass[:, None] + pos2_g[jc] * mj[:, None]) / f_tot[:, None]
            f_bvel = (vel * mass[:, None] + vel2_g[jc] * mj[:, None]) / f_tot[:, None]
            f_temp = jnp.maximum(temp, temp2_g[jc]) + (e_best / f_tot) * 0.1
            f_mat = jnp.where(mass > mj, mat, mat_g[jc])
            f_rsum = radius + radius_g[jc]

            pm = primary[:, None]
            pos = jnp.where(pm, mpos, pos)
            vel = jnp.where(pm, mvel, jnp.where(killed[:, None], 0.0, vel))
            temp = jnp.where(primary, mtemp, jnp.where(killed, 0.0, temp))
            mat = jnp.where(primary, mmat, mat)
            mass = jnp.where(primary, tot, jnp.where(killed, 0.0, mass))

            # ---- fractures: kill parents, replicate event extraction ------
            mass = jnp.where(fract, 0.0, mass)
            vel = jnp.where(fract[:, None], 0.0, vel)
            temp = jnp.where(fract, 0.0, temp)

            pf_g = gather(primary_f)
            fi_g, f_valid = take_rows(pf_g, f_cap)  # replicated event ranks
            frag = _make_fragments(
                key, cfg, f_valid,
                gather(f_com)[fi_g], gather(f_bvel)[fi_g],
                jnp.where(f_valid, gather(e_best)[fi_g], 0.0),
                gather(f_tot)[fi_g], gather(f_temp)[fi_g],
                gather(f_mat)[fi_g], gather(f_rsum)[fi_g],
            )  # identical on every chip: same key, same replicated inputs

            # global dead-slot census -> rank-scatter slot assignment,
            # identical on every chip (nbx.collisions_scaled pattern)
            mass_g2 = gather(mass)
            fk = frag["mask"].shape[0]  # F * K
            dead_g = mass_g2 <= 0.0
            drank = jnp.cumsum(dead_g.astype(jnp.int32)) - 1
            slot_of_rank = jnp.full((fk,), n, jnp.int32).at[
                jnp.where(dead_g & (drank < fk), drank, fk)
            ].set(col, mode="drop")
            frank = jnp.cumsum(frag["mask"].astype(jnp.int32)) - 1
            slot = jnp.where(
                frag["mask"], slot_of_rank[jnp.clip(frank, 0, fk - 1)], n
            )
            placed = frag["mask"] & (slot < n)
            # each chip writes only the fragments landing in ITS shard
            lslot = jnp.where(
                placed & (slot >= me * nl) & (slot < (me + 1) * nl),
                slot - me * nl, nl,
            )
            mass = mass.at[lslot].set(frag["mass"], mode="drop")
            pos = pos.at[lslot].set(frag["pos"], mode="drop")
            vel = vel.at[lslot].set(frag["vel"], mode="drop")
            temp = temp.at[lslot].set(frag["temp"], mode="drop")
            mat = mat.at[lslot].set(frag["mat"], mode="drop")

            touched = primary | killed | fract
            touched = touched.at[lslot].set(True, mode="drop")
            partner_new = jnp.where(touched, -1, partner_new)
            t_new = jnp.where(touched, 0.0, t_new)
            # merged/newborn bodies carry acc = 0 (index.html:217), so the
            # second half-kick skips them — the pre-merge acc includes the
            # dead partner's pull and would inject net momentum
            acc_new = jnp.where(touched[:, None], 0.0, acc_new)

            # ---- second half-kick + thermal decay -------------------------
            vel = vel + acc_new * (0.5 * h)
            temp = jnp.where(mass > 0, temp * cfg.heat_decay, 0.0)
            temp = jnp.where(temp < 0.1, 0.0, temp)  # snap (L227-230)
            n_merges = jax.lax.psum(
                jnp.sum(primary.astype(jnp.int32)), "b"
            )
            n_bounce = jax.lax.psum(n_bounce, "b") // 2
            # the fracture counters are replicated by construction (pure
            # arithmetic on gathered data), but shard_map can't statically
            # infer that — psum over the per-chip value / axis size proves it
            n_fract = jax.lax.psum(
                jnp.sum(primary_f.astype(jnp.int32)), "b"
            )
            n_dropped = (
                (jnp.sum(pf_g.astype(jnp.int32))
                 - jnp.sum(f_valid.astype(jnp.int32)))
                + (jnp.sum(frag["mask"].astype(jnp.int32))
                   - jnp.sum(placed.astype(jnp.int32)))
            )
            n_dropped = jax.lax.psum(n_dropped, "b") // jax.lax.axis_size("b")
            return (pos, vel, acc_new, mass, mat, temp, partner_new, t_new,
                    n_merges, n_bounce, n_fract, n_dropped)

        out = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                P("b", None), P("b", None), P("b", None), P("b"), P("b"),
                P("b"), P("b"), P("b"),
            ),
            out_specs=(
                P("b", None), P("b", None), P("b", None), P("b"), P("b"),
                P("b"), P("b"), P("b"), P(), P(), P(), P(),
            ),
        )(state.pos, state.vel, state.acc, state.mass, state.mat,
          state.temp, state.partner, state.contact_t)
        new_state = ShardedBodyState(*out[:8])
        return new_state, {"n_merges": out[8], "n_bounces": out[9],
                           "n_fractures": out[10], "n_dropped": out[11]}

    return step


def run_sharded(
    state: ShardedState,
    step_fn,
    G,
    eps,
    h,
    n_steps: int,
    diag_every: int = 0,
    mesh: Mesh | None = None,
):
    """Scan n_steps of the sharded substep in one dispatch.

    Returns (state, energies): `energies` is a [n_steps // diag_every, 2]
    array of psum-reduced (KE, PE) samples when diag_every > 0 (requires
    `mesh`), else None.
    """
    def body(st, _):
        return step_fn(st, G, eps, h), None

    if diag_every > 0:
        if mesh is None:
            raise ValueError("diag_every > 0 requires the mesh for psum diagnostics")
        chunks = n_steps // diag_every

        def chunk(st, _):
            # inner scan keeps the traced program size independent of
            # diag_every (a python loop would inline diag_every step copies)
            st, _ = jax.lax.scan(body, st, None, length=diag_every)
            ke, pe = sharded_energy(mesh, st, G, eps)
            return st, jnp.stack([ke, pe])

        state, energies = jax.lax.scan(chunk, state, None, length=chunks)
        remainder = n_steps - chunks * diag_every
        if remainder:
            state, _ = jax.lax.scan(body, state, None, length=remainder)
        return state, energies

    state, _ = jax.lax.scan(body, state, None, length=n_steps)
    return state, None


def _resolve_impl(impl: str) -> str:
    """"auto" -> the gravity kernel where nbx.backend picks it, else the
    plain blocked sum."""
    if impl != "auto":
        return impl
    return "pallas" if kernel_impl("gravity") == "triton" else "jnp"


@functools.partial(jax.jit, static_argnames=("mesh", "width", "height"))
def render_sharded(
    mesh: Mesh,
    state: ShardedState,
    cam,
    radius_scale: float = 0.8,
    width: int = 640,
    height: int = 360,
    exposure: float = 4.0,
):
    """Device-side rendering of a sharded state: every chip splats its LOCAL
    body shard into an HDR framebuffer, one psum over the mesh composites the
    additive image, tonemap replicates — the interactive-render story for the
    N=1M multi-chip configuration (BASELINE config 5). Readback ships one
    [H, W, 3] image regardless of N."""
    from nbx.config import default_materials
    from nbx.render.colormap import tonemap
    from nbx.render.splat import splat_bodies_hdr

    mats = default_materials()

    def local(pos, mass):
        n_loc = pos.shape[0]
        radius = jnp.cbrt(mass) * radius_scale
        hdr = splat_bodies_hdr(
            pos,
            radius,
            jnp.zeros((n_loc,)),
            jnp.zeros((n_loc,), jnp.int32),
            jnp.ones((n_loc,), bool),
            mats.color1,
            mats.color2,
            cam,
            width=width,
            height=height,
        )
        return tonemap(jax.lax.psum(hdr, "b"), exposure)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("b", None), P("b")),
        out_specs=P(),
    )(state.pos, state.mass)


@functools.partial(jax.jit, static_argnames=("mesh",))
def sharded_energy(mesh: Mesh, state: ShardedState, G, eps):
    """Total (KE, PE) computed on device with psum reduction (blocked
    per-body potential, O(N_local * block) memory)."""
    def local(pos, vel, mass):
        ke = 0.5 * jnp.sum(mass * jnp.sum(vel * vel, axis=-1))
        pos_all = jax.lax.all_gather(pos, "b", axis=0, tiled=True)
        mass_all = jax.lax.all_gather(mass, "b", axis=0, tiled=True)
        phi = forces.potential_per_body(
            pos_all, mass_all, G, eps, target_pos=pos, target_mass=mass
        )
        pe = 0.5 * jnp.sum(mass * phi)
        # psum makes the scalars identical on every device -> replicated out
        return jax.lax.psum(ke, "b"), jax.lax.psum(pe, "b")

    ke, pe = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("b", None), P("b", None), P("b")),
        out_specs=(P(), P()),
    )(state.pos, state.vel, state.mass)
    return ke, pe  # noqa: E501


def make_sharded_binned_collision_pass(
    mesh: Mesh,
    box_size: float,
    n_cells: int,
    band_cells: int,
    packed_caps: tuple[int, int],
    restitution: float = 0.2,
    friction: float = 0.5,
    interpret: bool = False,
):
    """Column-slab sharded band-packed collision sweep — the multi-chip
    form of nbx.ops.collide.binned_collision_pass (packed layout).

    Decomposition: the packed layout's work is indexed by (i, j) cell
    COLUMN, so chip d takes the contiguous column slab
    [d n_cols/D, (d+1) n_cols/D) — it all-gathers the body shards
    (replicating state, the same comm pattern as the sharded gravity
    step), builds ONLY its slab's blocks + the superset source strips it
    needs (packed_collision_blocks with a traced col_lo), and runs the
    kernel on 1/D of the grid. Per-body output rows are zero-masked
    outside the slab and psum-ed: each body has a slot on exactly one
    chip, so the reduction reconstructs the whole-grid rows exactly
    (bit-identical block content — only the psum's f32 addition order is
    new, and every term but one is 0.0). Layout construction (sort,
    tables, target gathers) is replicated O(N) work per chip; the O(N S)
    kernel and the strip/fusion gathers scale 1/D.

    Returns a jitted (pos, vel, mass, radius) -> same tuple as
    binned_collision_pass, with per-body outputs SHARDED P("b") like the
    inputs and scalar counters replicated.
    """
    from nbx.ops.collide import epilogue_rows, packed_collision_blocks_slab

    n_dev = mesh.devices.size
    g = n_cells
    n_cols = g * g
    if n_cols % n_dev:
        raise ValueError(
            f"n_cells^2 = {n_cols} columns must divide over {n_dev} devices"
        )
    n_slab = n_cols // n_dev

    @jax.jit
    def collision_pass(pos, vel, mass, radius):
        n = pos.shape[0]
        nb_sh = n // n_dev

        def local(pos_l, vel_l, mass_l, rad_l):
            i32 = jnp.int32
            pos_g = jax.lax.all_gather(pos_l, "b", axis=0, tiled=True)
            vel_g = jax.lax.all_gather(vel_l, "b", axis=0, tiled=True)
            mass_g = jax.lax.all_gather(mass_l, "b", axis=0, tiled=True)
            rad_g = jax.lax.all_gather(rad_l, "b", axis=0, tiled=True)
            d = jax.lax.axis_index("b").astype(i32)
            delta, evt, body_slot, novf = packed_collision_blocks_slab(
                pos_g, vel_g, mass_g, rad_g, box_size, g, band_cells,
                packed_caps, restitution, friction, d * n_slab, n_slab,
                interpret,
            )
            out_d, out_e = epilogue_rows(delta, evt, body_slot)
            in_slab = (body_slot < delta.shape[0])[:, None]
            out_d = jax.lax.psum(jnp.where(in_slab, out_d, 0.0), "b")
            out_e = jax.lax.psum(jnp.where(in_slab, out_e, 0.0), "b")
            novf = jax.lax.psum(novf, "b")
            n_bounces = (jnp.sum(out_d[:, 7]) / 2.0).astype(i32)
            too_small = (
                2.0 * jax.lax.pmax(jnp.max(rad_l), "b") > box_size / g
            )

            # finish on this chip's BODY shard (row slice of the psum)
            sl = lambda x: jax.lax.dynamic_slice_in_dim(
                x, d * nb_sh, nb_sh, 0
            )
            od, oe = sl(out_d), sl(out_e)
            dvel, dpos, dtemp = od[:, 0:3], od[:, 3:6], od[:, 6]
            # recompute the winner's pair quantities from the gathered
            # state (j is a GLOBAL index; same formulas as the
            # single-chip epilogue)
            has = oe[:, 0] > 0.0
            j_idx = jnp.where(has, oe[:, 1].astype(i32), -1)
            jcl = jnp.clip(j_idx, 0, n - 1)
            dd = pos_g[jcl] - pos_l
            r2b = jnp.sum(dd * dd, axis=-1)
            invb = jax.lax.rsqrt(jnp.where(r2b > 0.0, r2b, 1.0))
            vnb = jnp.sum((vel_g[jcl] - vel_l) * dd, axis=-1) * invb
            m_j = mass_g[jcl]
            m_sum = mass_l + m_j
            r_msb = 1.0 / jnp.where(m_sum > 0.0, m_sum, 1.0)
            e_b = 0.5 * (mass_l * m_j * r_msb) * vnb * vnb
            best = dict(
                j=j_idx,
                vn=jnp.where(has, vnb, 0.0),
                q=jnp.where(has, e_b * r_msb, 0.0),
                energy=jnp.where(has, e_b, 0.0),
                m_j=jnp.where(has, m_j, 0.0),
                approaching=has & (vnb < 0.0),
            )
            return dvel, dpos, dtemp, best, n_bounces, novf, too_small

        best_spec = dict(
            j=P("b"), vn=P("b"), q=P("b"), energy=P("b"), m_j=P("b"),
            approaching=P("b"),
        )
        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P("b", None), P("b", None), P("b"), P("b")),
            out_specs=(P("b", None), P("b", None), P("b"), best_spec,
                       P(), P(), P()),
            # pallas_call's out_shape carries no vma annotation; the
            # reduction structure here is explicit (masked psum), so the
            # varying-across-mesh check adds nothing
            check_vma=False,
        )(pos, vel, mass, radius)

    return collision_pass


def make_sharded_granular_step(
    mesh: Mesh,
    cfg,
    box_size: float,
    n_cells: int,
    band_cells: int,
    packed_caps: tuple[int, int],
    force_impl: str = "auto",
    pm_grid: int = 128,
    interpret: bool = False,
):
    """Sharded FULL-physics granular step AT SCALE: KDK gravity + the
    band-packed collision window sweep + the complete event machinery of
    nbx.collisions_scaled (contact timers, merges, fractures, heating,
    thermal decay), body axis sharded over the mesh.

    This replaces make_sharded_physics_step's dense [N/D, N] pair matrices
    (which cap the multi-chip full-physics path at interactive N) with the
    column-slab decomposition of the packed collision kernel
    (packed_collision_blocks_slab): each chip runs the kernel on 1/D of the
    (column, band) grid, a masked psum reconstructs the whole-grid per-body
    rows bit-exactly (each body has a slot on exactly one chip), and the
    collisions_scaled semantics (mutual deepest-partner gates, reference
    index.html:293-443) run on the chip's own shard against gathered
    decision fields.

    Comm is all-gather: O(N) per-device replication, the same
    pattern (and largely the same buffers) the direct gravity path needs
    anyway. Per-chip pair WORK is O(N S / D) kernel + O(N) layout/event
    arithmetic — the 1M full-physics multi-chip step this unlocks was
    impossible with the dense O(N * N/D) temporaries.

    force_impl: "auto"/"pallas"/"jnp" = direct-sum rectangular (all-on-
    local); "pm" = particle-mesh on a pm_grid^3 isolated mesh, FFT work
    replicated per chip (O(g^3 log g), N-independent) and the local rows
    sliced out; "zero" = contact dynamics only.

    PRNG contract: `key` is consumed as-is and must be fresh per step
    (jax.random.fold_in(base, step)); it must also be IDENTICAL across
    chips (it is, unless the caller shards it) — fragment sampling is
    replicated arithmetic.

    Parity: step-for-step equal to the single-chip sequence
    [half-kick, drift, force, resolve_collisions_scaled(packed), zero acc
    on touched, half-kick, thermal.decay] with the same static layout
    arguments — gated by tests/test_shard.py on the virtual mesh.

    Returns jitted (state: ShardedBodyState, h, key) -> (state, counters)
    with counters = n_merges/n_fractures/n_bounces/n_overflow/n_dropped/
    cell_too_small (ScaledEvents' scalar fields; the event LOG arrays for
    the renderer stay single-chip — flashes at 1M are diagnosed from
    counters, drawn from the interactive path).
    """
    from nbx import thermal
    from nbx.collisions import _make_fragments
    from nbx.config import body_radius
    from nbx.ops.collide import epilogue_rows, packed_collision_blocks_slab
    from nbx.ops.p3m import take_rows

    if force_impl == "pm":
        from nbx.ops.pm import pm_acceleration

    impl = _resolve_impl("auto" if force_impl not in ("pallas", "jnp")
                         else force_impl)
    n_dev = mesh.devices.size
    g = n_cells
    n_cols = g * g
    if n_cols % n_dev:
        raise ValueError(
            f"n_cells^2 = {n_cols} columns must divide over {n_dev} devices"
        )
    n_slab = n_cols // n_dev
    mats = cfg.materials
    f_cap = cfg.max_fractures

    @jax.jit
    def step(state: ShardedBodyState, h, key):
        def local(pos, vel, acc, mass, mat, temp, partner, t_prev):
            i32 = jnp.int32
            nl = pos.shape[0]
            me = jax.lax.axis_index("b").astype(i32)
            gidx = me * nl + jnp.arange(nl, dtype=i32)
            gather = lambda x: jax.lax.all_gather(x, "b", axis=0, tiled=True)
            sl = lambda x: jax.lax.dynamic_slice_in_dim(x, me * nl, nl, 0)

            # ---- KDK first half + force on pre-collision state ----------
            vel = vel + acc * (0.5 * h)
            pos = pos + vel * h
            pos_g = gather(pos)
            mass_g = gather(mass)
            n = pos_g.shape[0]
            if force_impl == "zero":
                acc_new = jnp.zeros_like(pos)
            elif force_impl == "pm":
                acc_new = sl(pm_acceleration(
                    pos_g, mass_g, cfg.G, box_size, g=pm_grid, isolated=True
                ))
            else:
                acc_new = _local_acc(
                    pos_g, mass_g, pos, cfg.G, cfg.softening, impl
                )

            # ---- packed collision sweep on this chip's column slab -------
            radius = body_radius(mass, mat, mats)
            rad_g = gather(radius)
            vel_g = gather(vel)
            delta, evt, body_slot, novf = packed_collision_blocks_slab(
                pos_g, vel_g, mass_g, rad_g, box_size, g, band_cells,
                packed_caps, cfg.restitution, cfg.friction,
                me * n_slab, n_slab, interpret,
            )
            out_d, out_e = epilogue_rows(delta, evt, body_slot)
            in_slab = (body_slot < delta.shape[0])[:, None]
            out_d = jax.lax.psum(jnp.where(in_slab, out_d, 0.0), "b")
            out_e = jax.lax.psum(jnp.where(in_slab, out_e, 0.0), "b")
            n_overflow = jax.lax.psum(novf, "b")
            n_bounces = (jnp.sum(out_d[:, 7]) / 2.0).astype(i32)
            too_small = 2.0 * jax.lax.pmax(jnp.max(radius), "b") > box_size / g
            od, oe = sl(out_d), sl(out_e)

            # winner's pair quantities from the gathered PRE-PASS state
            # (same formulas as _collide_epilogue, j is a GLOBAL index)
            has = oe[:, 0] > 0.0
            j_idx = jnp.where(has, oe[:, 1].astype(i32), -1)
            jcl = jnp.clip(j_idx, 0, n - 1)
            dd = pos_g[jcl] - pos
            r2b = jnp.sum(dd * dd, axis=-1)
            invb = jax.lax.rsqrt(jnp.where(r2b > 0.0, r2b, 1.0))
            vnb = jnp.sum((vel_g[jcl] - vel) * dd, axis=-1) * invb
            m_j = mass_g[jcl]
            m_sum = mass + m_j
            r_msb = 1.0 / jnp.where(m_sum > 0.0, m_sum, 1.0)
            e_b = 0.5 * (mass * m_j * r_msb) * vnb * vnb
            q_l = jnp.where(has, e_b * r_msb, 0.0)
            appr_l = has & (vnb < 0.0)

            # apply the sweep's Jacobi deltas (resolve_collisions_scaled)
            pos = pos + od[:, 3:6]
            vel = vel + od[:, 0:3]
            temp = temp + od[:, 6]

            # ---- contact timers on the deepest partner (L314-319) --------
            same = j_idx == partner
            contact_t = jnp.where(
                has, jnp.where(same, t_prev + h, h), 0.0
            )
            partner_new = jnp.where(has, j_idx, -1)

            # ---- event gates on mutual partners (L340-359) ---------------
            partner_g = gather(partner_new)
            t_g = gather(contact_t)
            jc = jnp.clip(partner_new, 0, n - 1)
            mutual = has & (partner_g[jc] == gidx)
            t_pair = jnp.minimum(contact_t, t_g[jc])
            # vn/q/E are bitwise symmetric between the two owners (the
            # subtractions negate, products cancel), so local-only gates
            # reach the same decision on both chips — no appr/q gather
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
            primary_m = merge_m & (gidx < jc)
            killed_m = merge_m & (gidx > jc)
            primary_f = fract_m & (gidx < jc)

            # ---- merges in place into the lower slot (L392-409) ----------
            pos2_g = gather(pos)  # post-delta values for merge/fracture math
            vel2_g = gather(vel)
            temp2_g = gather(temp)
            mat_g = gather(mat)
            mjc = mass_g[jc]
            tot = mass + mjc
            safe_tot = jnp.where(tot > 0, tot, 1.0)
            mpos = (pos * mass[:, None] + pos2_g[jc] * mjc[:, None]) / safe_tot[:, None]
            mvel = (vel * mass[:, None] + vel2_g[jc] * mjc[:, None]) / safe_tot[:, None]
            mtemp = (temp * mass + temp2_g[jc] * mjc) / safe_tot
            mmat = jnp.where(mass > mjc, mat, mat_g[jc])  # heavier (L403)

            # fracture payload BEFORE the merge/kill writes (gates are
            # exclusive, so these rows are untouched by them)
            f_tot_l = mass + mjc
            f_safe_l = jnp.where(fract_m, f_tot_l, 1.0)
            f_com = (pos * mass[:, None] + pos2_g[jc] * mjc[:, None]) / f_safe_l[:, None]
            f_bvel = (vel * mass[:, None] + vel2_g[jc] * mjc[:, None]) / f_safe_l[:, None]
            e_best = jnp.where(fract_m, e_b, 0.0)
            f_temp = jnp.maximum(temp, temp2_g[jc]) + (e_best / f_safe_l) * 0.1
            f_mat = jnp.where(mass > mjc, mat, mat_g[jc])
            f_rsum = radius + rad_g[jc]

            pm2 = primary_m[:, None]
            pos = jnp.where(pm2, mpos, pos)
            vel = jnp.where(pm2, mvel, jnp.where(killed_m[:, None], 0.0, vel))
            temp = jnp.where(primary_m, mtemp, jnp.where(killed_m, 0.0, temp))
            mat = jnp.where(primary_m, mmat, mat)
            mass = jnp.where(primary_m, tot, jnp.where(killed_m, 0.0, mass))

            # ---- fractures: replicated extraction + fragment sampling ----
            pf_g = gather(primary_f)
            fi_g, f_valid = take_rows(pf_g, f_cap)  # identical on all chips
            fj_g = jnp.clip(partner_g, 0, n - 1)[fi_g]
            frag = _make_fragments(
                key, cfg, f_valid,
                gather(f_com)[fi_g], gather(f_bvel)[fi_g],
                jnp.where(f_valid, gather(e_best)[fi_g], 0.0),
                gather(f_tot_l)[fi_g], gather(f_temp)[fi_g],
                gather(f_mat)[fi_g], gather(f_rsum)[fi_g],
            )

            # kill the parents of the VALID (capped) events only — events
            # past f_cap survive untouched and are counted into n_dropped
            # (collisions_scaled semantics, unlike the dense sharded step)
            kill_g = jnp.zeros((n,), bool)
            kill_g = kill_g.at[jnp.where(f_valid, fi_g, n)].set(
                True, mode="drop"
            )
            kill_g = kill_g.at[jnp.where(f_valid, fj_g, n)].set(
                True, mode="drop"
            )
            fkill = sl(kill_g)
            mass = jnp.where(fkill, 0.0, mass)
            vel = jnp.where(fkill[:, None], 0.0, vel)
            temp = jnp.where(fkill, 0.0, temp)

            # ---- global dead-slot census -> rank-scatter placement -------
            mass_g2 = gather(mass)
            col = jnp.arange(n, dtype=i32)
            fk = frag["mask"].shape[0]  # F * K
            dead_g = mass_g2 <= 0.0
            drank = jnp.cumsum(dead_g.astype(i32)) - 1
            slot_of_rank = jnp.full((fk,), n, i32).at[
                jnp.where(dead_g & (drank < fk), drank, fk)
            ].set(col, mode="drop")
            frank = jnp.cumsum(frag["mask"].astype(i32)) - 1
            slot = jnp.where(
                frag["mask"], slot_of_rank[jnp.clip(frank, 0, fk - 1)], n
            )
            placed = frag["mask"] & (slot < n)
            lslot = jnp.where(
                placed & (slot >= me * nl) & (slot < (me + 1) * nl),
                slot - me * nl, nl,
            )
            mass = mass.at[lslot].set(frag["mass"], mode="drop")
            pos = pos.at[lslot].set(frag["pos"], mode="drop")
            vel = vel.at[lslot].set(frag["vel"], mode="drop")
            temp = temp.at[lslot].set(frag["temp"], mode="drop")
            mat = mat.at[lslot].set(frag["mat"], mode="drop")

            touched = primary_m | killed_m | fkill
            touched = touched.at[lslot].set(True, mode="drop")
            partner_new = jnp.where(touched, -1, partner_new)
            contact_t = jnp.where(touched, 0.0, contact_t)
            # reborn slots are NEWBORN: acc = 0 (index.html:217)
            acc_new = jnp.where(touched[:, None], 0.0, acc_new)

            # ---- second half-kick + thermal decay ------------------------
            vel = vel + acc_new * (0.5 * h)
            temp = thermal.decay(temp, cfg.heat_decay)

            # ---- counters (ScaledEvents parity) --------------------------
            n_merges = jax.lax.psum(jnp.sum(primary_m.astype(i32)), "b")
            n_fracts = jax.lax.psum(jnp.sum(primary_f.astype(i32)), "b")
            pm_g = gather(primary_m)
            _, m_valid = take_rows(pm_g, cfg.max_merges)
            n_dropped = (
                (n_fracts - jnp.sum(f_valid.astype(i32)))
                + (n_merges - jnp.sum(m_valid.astype(i32)))
                + (jnp.sum(frag["mask"].astype(i32))
                   - jnp.sum(placed.astype(i32)))
            )
            return (pos, vel, acc_new, mass, mat, temp, partner_new,
                    contact_t, n_merges, n_fracts, n_bounces, n_overflow,
                    n_dropped, too_small)

        out = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                P("b", None), P("b", None), P("b", None), P("b"), P("b"),
                P("b"), P("b"), P("b"),
            ),
            out_specs=(
                P("b", None), P("b", None), P("b", None), P("b"), P("b"),
                P("b"), P("b"), P("b"),
                P(), P(), P(), P(), P(), P(),
            ),
            # pallas_call's out_shape carries no vma annotation (see
            # make_sharded_binned_collision_pass)
            check_vma=False,
        )(state.pos, state.vel, state.acc, state.mass, state.mat,
          state.temp, state.partner, state.contact_t)
        new_state = ShardedBodyState(*out[:8])
        return new_state, {
            "n_merges": out[8], "n_fractures": out[9], "n_bounces": out[10],
            "n_overflow": out[11], "n_dropped": out[12],
            "cell_too_small": out[13],
        }

    return step
