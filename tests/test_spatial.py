"""Halo-exchange spatially-owned sharded granular step (nbx.parallel.spatial).

Runs on the 8-virtual-device CPU mesh (tests/conftest.py). The collision
window kernel runs in the Pallas interpreter; the parity target is the
single-device
collisions_scaled sequence, matched per-UID (slot order is owner-dependent
by design).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbx.config import Materials, SimConfig, default_materials
from nbx.parallel import shard, spatial

BOX = 100.0
G8 = 8  # collision grid: 8 x-layers over 8 chips -> W = 1 layer/chip


@pytest.fixture(scope="module")
def mesh(eight_devices):
    return shard.make_mesh(8)


def _fat_materials():
    dm = default_materials()
    return Materials(density=dm.density * 0.1, color1=dm.color1,
                     color2=dm.color2)


def _cloud(n=512, seed=9, lo=20.0, hi=60.0, vsig=2.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    vel = rng.normal(0, vsig, (n, 3)).astype(np.float32)
    mass = rng.uniform(2.0, 8.0, n).astype(np.float32)
    return pos, vel, mass


def _single_loop(pos, vel, mass, cfg, h, n_steps, g, band, caps, key0):
    """The single-chip sequence the spatial step mirrors (zero gravity)."""
    from nbx import thermal
    from nbx.collisions_scaled import (
        make_granular_state, resolve_collisions_scaled,
    )

    st = make_granular_state(pos, vel, mass, key=key0)
    acc = jnp.zeros_like(st.pos)
    evs = []
    for _ in range(n_steps):
        v = st.vel + acc * (0.5 * h)
        p = st.pos + v * h
        st = st._replace(pos=p, vel=v)
        st, ev = resolve_collisions_scaled(
            st, cfg, h, BOX, g, band_cells=band, packed_caps=caps,
            interpret=True,
        )
        acc = jnp.zeros_like(st.pos)
        st = st._replace(
            vel=st.vel + jnp.where(ev.touched[:, None], 0.0, acc) * (0.5 * h),
            temp=thermal.decay(st.temp, cfg.heat_decay),
        )
        evs.append(ev)
    return st, evs


def _by_uid(state):
    """uid -> row for live rows of a SpatialState (host side)."""
    uid = np.asarray(state.uid)
    mass = np.asarray(state.mass)
    return {int(u): i for i, u in enumerate(uid) if u >= 0 and mass[i] > 0}


def _totals(state, also_temp=False):
    m = np.asarray(state.mass)
    v = np.asarray(state.vel)
    out = [float(m.sum()), (m[:, None] * v).sum(axis=0)]
    if also_temp:
        out.append(float((np.asarray(state.temp) * (m > 0)).sum()))
    return out


def test_spatial_state_distribution(mesh):
    pos, vel, mass = _cloud()
    mass[-10:] = 0.0  # dead input rows must be dropped, not distributed
    st = spatial.spatial_state_for(mesh, pos, vel, mass, BOX, G8)
    uid = np.asarray(st.uid)
    live = uid >= 0
    assert live.sum() == 502
    assert int(st.uid_next) == 512
    nl = uid.shape[0] // 8
    cell = BOX / G8
    p = np.asarray(st.pos)
    for c in range(8):
        rows = np.nonzero(live[c * nl:(c + 1) * nl])[0] + c * nl
        cx = np.clip((p[rows, 0] / cell).astype(int), 0, G8 - 1)
        assert (np.clip(cx, 0, 7) == c).all()
    # uid maps back to the original body
    m = _by_uid(st)
    for u in (0, 17, 501):
        np.testing.assert_array_equal(p[m[u]], pos[u])


def test_spatial_matches_single_chip(mesh):
    """Per-UID parity with the single-chip collisions_scaled sequence on a
    merge-rich cloud (fractures off: their RNG streams are per-chip by
    design). Counters exact per step; state to interpret-mode fp
    tolerance (same caveat as the slab-sharded parity test)."""
    pos, vel, mass = _cloud(n=512, seed=9)
    cfg = SimConfig(merge_time=0.005, fracture_threshold=1e9,
                    materials=_fat_materials())
    h = 0.016
    n_steps = 4
    band, caps = 2, (96, 160)

    st1, evs = _single_loop(pos, vel, mass, cfg, h, n_steps, G8, band,
                            caps, key0=7)

    step = spatial.make_spatial_granular_step(
        mesh, cfg, BOX, G8, band, caps, halo_cap=192, mig_cap=128,
        force_impl="zero", interpret=True,
    )
    st = spatial.spatial_state_for(mesh, pos, vel, mass, BOX, G8)
    key = jax.random.PRNGKey(7)
    counters = []
    for i in range(n_steps):
        st, c = step(st, h, jax.random.fold_in(key, i))
        counters.append(c)

    tot = {k: sum(int(c[k]) for c in counters)
           for k in ("n_merges", "n_bounces")}
    assert tot["n_bounces"] > 0 and tot["n_merges"] > 0
    assert sum(int(c["n_overflow"]) for c in counters) == 0
    assert sum(int(c["n_halo_over"]) for c in counters) == 0
    assert sum(int(c["n_dropped"]) for c in counters) == 0
    for k, ref in (("n_merges", "n_merges"), ("n_bounces", "n_bounces")):
        got = [int(c[k]) for c in counters]
        want = [int(getattr(ev, ref)) for ev in evs]
        assert got == want, (k, got, want)

    # per-uid state parity: single-chip row u <-> spatial uid u
    m1 = np.asarray(st1.mass)
    rows = _by_uid(st)
    live1 = set(np.nonzero(m1 > 0)[0].tolist())
    assert set(rows.keys()) == live1
    idx = np.asarray(sorted(live1))
    sel = np.asarray([rows[int(u)] for u in idx])
    for fld, tol in (("pos", 1e-5), ("vel", 1e-5), ("mass", 1e-6),
                     ("temp", 1e-5), ("contact_t", 0.0)):
        a = np.asarray(getattr(st, fld))[sel]
        b = np.asarray(getattr(st1, fld))[idx]
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                   err_msg=fld)
    np.testing.assert_array_equal(np.asarray(st.mat)[sel],
                                  np.asarray(st1.mat)[idx])
    # partner identity: spatial stores uids, single-chip stores indices
    np.testing.assert_array_equal(np.asarray(st.partner_uid)[sel],
                                  np.asarray(st1.partner)[idx])


def test_spatial_migration_free_stream(mesh):
    """Contact-free bodies crossing slab boundaries keep their uid and
    their free-streaming trajectory; ownership follows position."""
    n = 64
    rng = np.random.default_rng(3)
    pos = np.stack([
        rng.uniform(5.0, 20.0, n),
        rng.uniform(10.0, 90.0, n),
        rng.uniform(10.0, 90.0, n),
    ], axis=1).astype(np.float32)
    vel = np.zeros((n, 3), np.float32)
    vel[:, 0] = 6.0  # +x, ~ half a slab (12.5) per step at h = 1
    mass = np.full(n, 0.01, np.float32)  # tiny radii -> no contacts
    cfg = SimConfig(materials=default_materials())
    step = spatial.make_spatial_granular_step(
        mesh, cfg, BOX, G8, 2, (64, 96), halo_cap=64, mig_cap=64,
        force_impl="zero", interpret=True,
    )
    st = spatial.spatial_state_for(mesh, pos, vel, mass, BOX, G8, nl=64)
    key = jax.random.PRNGKey(0)
    h = 1.0
    n_steps = 8
    for i in range(n_steps):
        st, c = step(st, h, jax.random.fold_in(key, i))
        assert int(c["n_dropped"]) == 0
        assert int(c["n_bounces"]) == 0
    assert int(c["in_transit"]) == 0
    rows = _by_uid(st)
    assert len(rows) == n  # nothing lost
    p = np.asarray(st.pos)
    want = pos + vel * (h * n_steps)
    got = np.asarray([p[rows[u]] for u in range(n)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # ownership followed the bodies
    nl = np.asarray(st.uid).shape[0] // 8
    cell = BOX / G8
    for u in range(n):
        chip = rows[u] // nl
        cx = int(np.clip(got[u, 0] // cell, 0, G8 - 1))
        assert chip == cx  # W = 1 layer per chip


def test_spatial_cross_boundary_merge_conserves(mesh):
    """A sustained contact straddling the x = 12.5 slab boundary (chips
    0/1) merges into the lower-uid slot; global mass and momentum are
    conserved through bounce + merge."""
    pos = np.asarray([[12.0, 50.0, 50.0], [13.0, 50.0, 50.0]], np.float32)
    vel = np.asarray([[0.2, 0.0, 0.0], [-0.2, 0.0, 0.0]], np.float32)
    mass = np.asarray([5.0, 4.0], np.float32)  # fat radii (low density)
    cfg = SimConfig(merge_time=0.01, fracture_threshold=1e9,
                    materials=_fat_materials())
    step = spatial.make_spatial_granular_step(
        mesh, cfg, BOX, G8, 2, (16, 32), halo_cap=8, mig_cap=8,
        force_impl="zero", interpret=True,
    )
    st = spatial.spatial_state_for(mesh, pos, vel, mass, BOX, G8, nl=8)
    m0, p0 = _totals(st)[:2]
    key = jax.random.PRNGKey(1)
    h = 0.016
    merges = 0
    for i in range(6):
        st, c = step(st, h, jax.random.fold_in(key, i))
        merges += int(c["n_merges"])
    assert merges == 1
    rows = _by_uid(st)
    assert set(rows.keys()) == {0}  # lower uid survives
    m1, p1 = _totals(st)[:2]
    assert m1 == pytest.approx(m0, rel=1e-6)
    np.testing.assert_allclose(p1, p0, rtol=1e-5, atol=1e-5)
    # merged mass on the surviving body
    assert float(np.asarray(st.mass)[rows[0]]) == pytest.approx(9.0)


def test_spatial_cross_boundary_fracture(mesh):
    """A violent impact across the slab boundary fractures: both parents
    die (one per chip — the kill-flag exchange), fragments are born on
    the primary owner with fresh uids, and mass is conserved."""
    pos = np.asarray([[11.2, 50.0, 50.0], [13.8, 50.0, 50.0]], np.float32)
    vel = np.asarray([[40.0, 0.0, 0.0], [-40.0, 0.0, 0.0]], np.float32)
    mass = np.asarray([5.0, 4.0], np.float32)
    cfg = SimConfig(merge_time=1e9, fracture_threshold=0.5,
                    min_fragment_mass=0.2, materials=_fat_materials())
    step = spatial.make_spatial_granular_step(
        mesh, cfg, BOX, G8, 2, (16, 32), halo_cap=8, mig_cap=8,
        force_impl="zero", interpret=True,
    )
    st = spatial.spatial_state_for(mesh, pos, vel, mass, BOX, G8, nl=32)
    m0 = _totals(st)[0]
    key = jax.random.PRNGKey(2)
    h = 0.016
    fracts = drops = 0
    for i in range(4):
        st, c = step(st, h, jax.random.fold_in(key, i))
        fracts += int(c["n_fractures"])
        drops += int(c["n_dropped"])
    assert fracts == 1
    assert drops == 0
    rows = _by_uid(st)
    assert 0 not in rows and 1 not in rows  # both parents dead
    assert len(rows) >= 2  # fragments live
    assert min(rows.keys()) >= 2  # fresh uids
    assert int(st.uid_next) > 2
    assert _totals(st)[0] == pytest.approx(m0, rel=1e-5)


def test_spatial_caps_counted_not_silent(mesh):
    """Starved halo/migration caps surface in the counters instead of
    losing bodies silently; waiting migrants are delayed, not dropped."""
    pos, vel, mass = _cloud(n=256, seed=5)
    vel[:, 0] += 8.0  # everyone marches +x across slab boundaries
    cfg = SimConfig(merge_time=1e9, fracture_threshold=1e9,
                    materials=_fat_materials())
    step = spatial.make_spatial_granular_step(
        mesh, cfg, BOX, G8, 2, (96, 160), halo_cap=2, mig_cap=2,
        force_impl="zero", interpret=True,
    )
    st = spatial.spatial_state_for(mesh, pos, vel, mass, BOX, G8)
    key = jax.random.PRNGKey(4)
    waits = halo_over = 0
    for i in range(3):
        st, c = step(st, 1.0, jax.random.fold_in(key, i))
        waits += int(c["n_mig_wait"])
        halo_over += int(c["n_halo_over"])
        assert int(c["n_dropped"]) == 0  # delayed, never lost
    assert waits > 0
    assert halo_over > 0
    assert len(_by_uid(st)) == 256


def test_spatial_pm_gravity_close_to_single(mesh):
    """With PM gravity the spatial step (per-chip deposit + grid psum +
    replicated solve) tracks the single-chip granular PM loop to f32
    deposit-order tolerance."""
    from nbx.collisions_scaled import granular_full_kdk_scan, make_granular_state

    pos, vel, mass = _cloud(n=512, seed=13, vsig=0.5)
    cfg = SimConfig(G=2.0, merge_time=1e9, fracture_threshold=1e9,
                    materials=default_materials())
    h = cfg.dt / cfg.sub_steps
    band, caps = 2, (96, 160)
    n_steps = 3

    st1, _ = granular_full_kdk_scan(
        make_granular_state(pos, vel, mass, key=0), cfg, BOX,
        n_steps=n_steps, n_cells=G8, band_cells=band, packed_caps=caps,
        force_impl="pm", pm_grid=32, interpret=True,
    )

    step = spatial.make_spatial_granular_step(
        mesh, cfg, BOX, G8, band, caps, halo_cap=128, mig_cap=64,
        force_impl="pm", pm_grid=32, interpret=True,
    )
    st = spatial.spatial_state_for(mesh, pos, vel, mass, BOX, G8)
    # granular_full_kdk_scan's first half-kick uses acc0 = force(pos0)
    from nbx.ops.pm import pm_acceleration
    from jax.sharding import NamedSharding, PartitionSpec as P

    uid = np.asarray(st.uid)
    acc0 = np.zeros((uid.shape[0], 3), np.float32)
    live = uid >= 0
    a0 = np.asarray(pm_acceleration(
        jnp.asarray(pos), jnp.asarray(mass), cfg.G, BOX, g=32,
        isolated=True,
    ))
    acc0[live] = a0[uid[live]]
    st = st._replace(acc=jax.device_put(
        jnp.asarray(acc0), NamedSharding(mesh, P("b", None))
    ))
    key = jax.random.PRNGKey(0)
    for i in range(n_steps):
        st, c = step(st, h, jax.random.fold_in(key, i))

    rows = _by_uid(st)
    m1 = np.asarray(st1.mass)
    idx = np.asarray(sorted(set(np.nonzero(m1 > 0)[0].tolist())))
    assert set(rows.keys()) == set(idx.tolist())
    sel = np.asarray([rows[int(u)] for u in idx])
    np.testing.assert_allclose(
        np.asarray(st.pos)[sel], np.asarray(st1.pos)[idx],
        rtol=2e-4, atol=2e-4,
    )
    np.testing.assert_allclose(
        np.asarray(st.vel)[sel], np.asarray(st1.vel)[idx],
        rtol=2e-4, atol=2e-4,
    )


def test_spatial_rejects_bad_config(mesh):
    cfg = SimConfig()
    with pytest.raises(ValueError, match="divide"):
        spatial.make_spatial_granular_step(
            mesh, cfg, BOX, 12, 2, (16, 32), halo_cap=8, mig_cap=8,
        )
    with pytest.raises(ValueError, match="all-gather"):
        spatial.make_spatial_granular_step(
            mesh, cfg, BOX, G8, 2, (16, 32), halo_cap=8, mig_cap=8,
            force_impl="pallas",
        )


# ---------------------------------------------------------------------------
# 2D (x, y) slab decomposition — ROADMAP 4d's y-axis split
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh2d(eight_devices):
    m = shard.make_mesh(8, axes=("bx", "by"))  # factored (2, 4)
    assert m.devices.shape == (2, 4)
    return m


def test_spatial2d_state_distribution(mesh2d):
    pos, vel, mass = _cloud()
    st = spatial.spatial_state_for(mesh2d, pos, vel, mass, BOX, G8)
    uid = np.asarray(st.uid)
    live = uid >= 0
    assert live.sum() == 512
    nl = uid.shape[0] // 8
    cell = BOX / G8
    p = np.asarray(st.pos)
    w_x, w_y = G8 // 2, G8 // 4
    for c in range(8):
        rows = np.nonzero(live[c * nl:(c + 1) * nl])[0] + c * nl
        cx = np.clip((p[rows, 0] / cell).astype(int), 0, G8 - 1)
        cy = np.clip((p[rows, 1] / cell).astype(int), 0, G8 - 1)
        np.testing.assert_array_equal((cx // w_x) * 4 + cy // w_y, c)


def test_spatial2d_matches_single_chip(mesh2d):
    """Per-UID parity of the 2D (x, y)-slab step with the single-chip
    collisions_scaled sequence (merge-rich cloud, fractures off) —
    the 2D analog of test_spatial_matches_single_chip."""
    pos, vel, mass = _cloud(n=512, seed=9)
    cfg = SimConfig(merge_time=0.005, fracture_threshold=1e9,
                    materials=_fat_materials())
    h = 0.016
    n_steps = 4
    band, caps = 2, (96, 160)

    st1, evs = _single_loop(pos, vel, mass, cfg, h, n_steps, G8, band,
                            caps, key0=7)

    step = spatial.make_spatial_granular_step(
        mesh2d, cfg, BOX, G8, band, caps, halo_cap=256, mig_cap=128,
        force_impl="zero", interpret=True,
    )
    st = spatial.spatial_state_for(mesh2d, pos, vel, mass, BOX, G8)
    key = jax.random.PRNGKey(7)
    counters = []
    for i in range(n_steps):
        st, c = step(st, h, jax.random.fold_in(key, i))
        counters.append(c)

    assert sum(int(c["n_overflow"]) for c in counters) == 0
    assert sum(int(c["n_halo_over"]) for c in counters) == 0
    assert sum(int(c["n_dropped"]) for c in counters) == 0
    for k in ("n_merges", "n_bounces"):
        got = [int(c[k]) for c in counters]
        want = [int(getattr(ev, k)) for ev in evs]
        assert got == want, (k, got, want)

    m1 = np.asarray(st1.mass)
    rows = _by_uid(st)
    live1 = set(np.nonzero(m1 > 0)[0].tolist())
    assert set(rows.keys()) == live1
    idx = np.asarray(sorted(live1))
    sel = np.asarray([rows[int(u)] for u in idx])
    for fld, tol in (("pos", 1e-5), ("vel", 1e-5), ("mass", 1e-6),
                     ("temp", 1e-5), ("contact_t", 0.0)):
        np.testing.assert_allclose(
            np.asarray(getattr(st, fld))[sel],
            np.asarray(getattr(st1, fld))[idx],
            rtol=tol, atol=tol, err_msg=fld,
        )
    np.testing.assert_array_equal(np.asarray(st.partner_uid)[sel],
                                  np.asarray(st1.partner)[idx])


def test_spatial2d_diagonal_migration(mesh2d):
    """Bodies free-streaming DIAGONALLY (+x, +y) cross both slab axes;
    the x-then-y hop lands them in one step, uid-stable, nothing lost."""
    n = 32
    rng = np.random.default_rng(6)
    pos = np.stack([
        rng.uniform(5.0, 20.0, n),
        rng.uniform(5.0, 15.0, n),
        rng.uniform(10.0, 90.0, n),
    ], axis=1).astype(np.float32)
    vel = np.zeros((n, 3), np.float32)
    vel[:, 0] = 6.0
    vel[:, 1] = 6.0
    mass = np.full(n, 0.01, np.float32)
    cfg = SimConfig(materials=default_materials())
    step = spatial.make_spatial_granular_step(
        mesh2d, cfg, BOX, G8, 2, (64, 96), halo_cap=64, mig_cap=64,
        force_impl="zero", interpret=True,
    )
    st = spatial.spatial_state_for(mesh2d, pos, vel, mass, BOX, G8, nl=64)
    key = jax.random.PRNGKey(0)
    h = 1.0
    n_steps = 8
    for i in range(n_steps):
        st, c = step(st, h, jax.random.fold_in(key, i))
        assert int(c["n_dropped"]) == 0
    assert int(c["in_transit"]) == 0
    rows = _by_uid(st)
    assert len(rows) == n
    p = np.asarray(st.pos)
    want = pos + vel * (h * n_steps)
    got = np.asarray([p[rows[u]] for u in range(n)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # ownership follows position on BOTH axes
    nl = np.asarray(st.uid).shape[0] // 8
    cell = BOX / G8
    w_x, w_y = G8 // 2, G8 // 4
    for u in range(n):
        chip = rows[u] // nl
        cx = int(np.clip(got[u, 0] // cell, 0, G8 - 1))
        cy = int(np.clip(got[u, 1] // cell, 0, G8 - 1))
        assert chip == (cx // w_x) * 4 + cy // w_y


def test_spatial2d_cross_corner_merge(mesh2d):
    """A sustained contact straddling BOTH slab axes (owners on DIAGONAL
    chips — the corner-forwarded halo path) merges into the lower-uid
    slot with global mass/momentum conserved."""
    # boundaries: x at 50 (w_x = 4 layers), y at 25 (w_y = 2 layers)
    pos = np.asarray([[49.4, 24.4, 50.0], [50.6, 25.6, 50.0]], np.float32)
    vel = np.asarray([[0.2, 0.2, 0.0], [-0.2, -0.2, 0.0]], np.float32)
    mass = np.asarray([5.0, 4.0], np.float32)
    cfg = SimConfig(merge_time=0.01, fracture_threshold=1e9,
                    materials=_fat_materials())
    step = spatial.make_spatial_granular_step(
        mesh2d, cfg, BOX, G8, 2, (16, 32), halo_cap=8, mig_cap=8,
        force_impl="zero", interpret=True,
    )
    st = spatial.spatial_state_for(mesh2d, pos, vel, mass, BOX, G8, nl=8)
    # owners are diagonal chips
    uid = np.asarray(st.uid)
    nl = uid.shape[0] // 8
    chips = {int(u): i // nl for i, u in enumerate(uid) if u >= 0}
    cx0, cy0 = chips[0] // 4, chips[0] % 4
    cx1, cy1 = chips[1] // 4, chips[1] % 4
    assert abs(cx0 - cx1) == 1 and abs(cy0 - cy1) == 1
    m0, p0 = _totals(st)[:2]
    key = jax.random.PRNGKey(1)
    merges = 0
    for i in range(6):
        st, c = step(st, 0.016, jax.random.fold_in(key, i))
        merges += int(c["n_merges"])
    assert merges == 1
    rows = _by_uid(st)
    assert set(rows.keys()) == {0}
    m1, p1 = _totals(st)[:2]
    assert m1 == pytest.approx(m0, rel=1e-6)
    np.testing.assert_allclose(p1, p0, rtol=1e-5, atol=1e-5)
    assert float(np.asarray(st.mass)[rows[0]]) == pytest.approx(9.0)


def test_spatial2d_cross_corner_fracture(mesh2d):
    """A violent impact across the corner fractures: both parents die —
    the secondary's kill flag retraces the two-hop corner route (y-return
    OR-ed into the x-return) — and mass is conserved."""
    pos = np.asarray([[48.8, 23.8, 50.0], [51.2, 26.2, 50.0]], np.float32)
    vel = np.asarray([[30.0, 30.0, 0.0], [-30.0, -30.0, 0.0]], np.float32)
    mass = np.asarray([5.0, 4.0], np.float32)
    cfg = SimConfig(merge_time=1e9, fracture_threshold=0.5,
                    min_fragment_mass=0.2, materials=_fat_materials())
    step = spatial.make_spatial_granular_step(
        mesh2d, cfg, BOX, G8, 2, (16, 32), halo_cap=8, mig_cap=8,
        force_impl="zero", interpret=True,
    )
    st = spatial.spatial_state_for(mesh2d, pos, vel, mass, BOX, G8, nl=32)
    m0 = _totals(st)[0]
    key = jax.random.PRNGKey(2)
    fracts = drops = 0
    for i in range(4):
        st, c = step(st, 0.016, jax.random.fold_in(key, i))
        fracts += int(c["n_fractures"])
        drops += int(c["n_dropped"])
    assert fracts == 1
    assert drops == 0
    rows = _by_uid(st)
    assert 0 not in rows and 1 not in rows  # both parents dead
    assert len(rows) >= 2 and min(rows.keys()) >= 2
    assert _totals(st)[0] == pytest.approx(m0, rel=1e-5)


def test_spatial_bucketed_matches_packed(mesh):
    """The spatial step with the occupancy-bucketed local layout matches
    the same step with uniform packed caps (both covering: same
    counters, same state bit-for-fp)."""
    pos, vel, mass = _cloud(n=512, seed=9)
    cfg = SimConfig(merge_time=0.005, fracture_threshold=1e9,
                    materials=_fat_materials())
    h = 0.016
    band, caps = 2, (96, 160)
    buckets = spatial.spatial_buckets_for(mesh, pos, BOX, G8, band,
                                          split_quantile=0.6)

    def run(buck):
        step = spatial.make_spatial_granular_step(
            mesh, cfg, BOX, G8, band, caps if buck is None else (8, 8),
            halo_cap=192, mig_cap=128, force_impl="zero", interpret=True,
            buckets=buck,
        )
        st = spatial.spatial_state_for(mesh, pos, vel, mass, BOX, G8)
        key = jax.random.PRNGKey(7)
        cs = []
        for i in range(3):
            st, c = step(st, h, jax.random.fold_in(key, i))
            cs.append(c)
        return st, cs

    # reference covering caps: at least the tail bucket's
    stp, cp = run(None)
    stb, cb = run(buckets)
    for k in ("n_merges", "n_bounces", "n_overflow"):
        assert [int(c[k]) for c in cb] == [int(c[k]) for c in cp], k
    assert sum(int(c["n_overflow"]) for c in cb) == 0
    rb, rp = _by_uid(stb), _by_uid(stp)
    assert set(rb.keys()) == set(rp.keys())
    idx = sorted(rb.keys())
    selb = np.asarray([rb[u] for u in idx])
    selp = np.asarray([rp[u] for u in idx])
    for fld in ("pos", "vel", "mass", "temp", "contact_t"):
        np.testing.assert_allclose(
            np.asarray(getattr(stb, fld))[selb],
            np.asarray(getattr(stp, fld))[selp],
            rtol=1e-5, atol=1e-5, err_msg=fld,
        )


def test_spatial2d_bucketed_smoke(mesh2d):
    """Bucketed local layout on the 2D mesh: runs, conserves mass, zero
    overflow with covering buckets."""
    pos, vel, mass = _cloud(n=256, seed=4)
    cfg = SimConfig(merge_time=0.01, fracture_threshold=1e9,
                    materials=_fat_materials())
    buckets = spatial.spatial_buckets_for(mesh2d, pos, BOX, G8, 2,
                                          split_quantile=0.7)
    step = spatial.make_spatial_granular_step(
        mesh2d, cfg, BOX, G8, 2, (8, 8), halo_cap=192, mig_cap=64,
        force_impl="zero", interpret=True, buckets=buckets,
    )
    st = spatial.spatial_state_for(mesh2d, pos, vel, mass, BOX, G8)
    m0 = _totals(st)[0]
    key = jax.random.PRNGKey(3)
    for i in range(3):
        st, c = step(st, 0.016, jax.random.fold_in(key, i))
        assert int(c["n_overflow"]) == 0
        assert int(c["n_dropped"]) == 0
    assert int(c["n_bounces"]) >= 0
    assert _totals(st)[0] == pytest.approx(m0, rel=1e-6)


def test_spatial2d_pm_gravity_close_to_single(mesh2d):
    """PM gravity on the 2D mesh (per-chip deposit + grid psum over BOTH
    axes + replicated solve) tracks the single-chip granular PM loop."""
    from nbx.collisions_scaled import granular_full_kdk_scan, make_granular_state

    pos, vel, mass = _cloud(n=256, seed=15, vsig=0.5)
    cfg = SimConfig(G=2.0, merge_time=1e9, fracture_threshold=1e9,
                    materials=default_materials())
    h = cfg.dt / cfg.sub_steps
    band, caps = 2, (96, 160)
    n_steps = 2

    st1, _ = granular_full_kdk_scan(
        make_granular_state(pos, vel, mass, key=0), cfg, BOX,
        n_steps=n_steps, n_cells=G8, band_cells=band, packed_caps=caps,
        force_impl="pm", pm_grid=32, interpret=True,
    )

    step = spatial.make_spatial_granular_step(
        mesh2d, cfg, BOX, G8, band, caps, halo_cap=128, mig_cap=64,
        force_impl="pm", pm_grid=32, interpret=True,
    )
    st = spatial.spatial_state_for(mesh2d, pos, vel, mass, BOX, G8)
    from jax.sharding import NamedSharding, PartitionSpec as P
    from nbx.ops.pm import pm_acceleration

    uid = np.asarray(st.uid)
    acc0 = np.zeros((uid.shape[0], 3), np.float32)
    live = uid >= 0
    a0 = np.asarray(pm_acceleration(
        jnp.asarray(pos), jnp.asarray(mass), cfg.G, BOX, g=32,
        isolated=True,
    ))
    acc0[live] = a0[uid[live]]
    st = st._replace(acc=jax.device_put(
        jnp.asarray(acc0), NamedSharding(mesh2d, P(("bx", "by"), None))
    ))
    key = jax.random.PRNGKey(0)
    for i in range(n_steps):
        st, c = step(st, h, jax.random.fold_in(key, i))

    rows = _by_uid(st)
    m1 = np.asarray(st1.mass)
    idx = np.asarray(sorted(set(np.nonzero(m1 > 0)[0].tolist())))
    assert set(rows.keys()) == set(idx.tolist())
    sel = np.asarray([rows[int(u)] for u in idx])
    np.testing.assert_allclose(
        np.asarray(st.pos)[sel], np.asarray(st1.pos)[idx],
        rtol=2e-4, atol=2e-4,
    )


def test_spatial_single_device_no_self_clones(eight_devices):
    """D=1 (the real-chip bench configuration): the cyclic halo ppermute
    must NOT self-deliver boundary bodies as in-slab clones — a clone
    shares the body's uid and cell, hijacks its deepest-partner record,
    and silently suppresses merges. Gate: a boundary-cell contact merges
    exactly as the single-chip sequence does."""
    mesh1 = shard.make_mesh(1)
    # pair inside the FIRST x-cell layer (the boundary layer a cyclic
    # self-send would clone)
    pos = np.asarray([[1.0, 50.0, 50.0], [2.0, 50.0, 50.0]], np.float32)
    vel = np.asarray([[0.2, 0.0, 0.0], [-0.2, 0.0, 0.0]], np.float32)
    mass = np.asarray([5.0, 4.0], np.float32)
    cfg = SimConfig(merge_time=0.01, fracture_threshold=1e9,
                    materials=_fat_materials())
    step = spatial.make_spatial_granular_step(
        mesh1, cfg, BOX, G8, 2, (16, 32), halo_cap=8, mig_cap=8,
        force_impl="zero", interpret=True,
    )
    st = spatial.spatial_state_for(mesh1, pos, vel, mass, BOX, G8, nl=8)
    key = jax.random.PRNGKey(1)
    merges = 0
    for i in range(6):
        st, c = step(st, 0.016, jax.random.fold_in(key, i))
        merges += int(c["n_merges"])
    assert merges == 1  # self-clones would keep this at 0
    rows = _by_uid(st)
    assert set(rows.keys()) == {0}
    assert float(np.asarray(st.mass)[rows[0]]) == pytest.approx(9.0)


def test_spatial_p3m_matches_single_chip_force(mesh):
    """force_impl='p3m': the spatial step's acceleration (PM on the
    psummed grid + erfc short-range FUSED into the collision kernel,
    riding the existing +-1-cell halo) matches the single-chip
    p3m_acceleration at the same split (n_cells=G8, a=cell/3) per UID.
    Differences: A&S-polynomial erfc (abs err 1.5e-7), reduction order,
    and the band guard's superset pairs beyond one cell (erfc(>3) ~ 2e-5
    weights) — tolerance-level, not semantic."""
    from nbx.ops.p3m import p3m_acceleration

    pos, vel, mass = _cloud(n=384, seed=3)
    cfg = SimConfig(merge_time=1e9, fracture_threshold=1e9)
    pm_grid = 32  # >= 3 * G8
    step = spatial.make_spatial_granular_step(
        mesh, cfg, BOX, G8, 2, (96, 160), halo_cap=192, mig_cap=128,
        force_impl="p3m", pm_grid=pm_grid, interpret=True,
    )
    st = spatial.spatial_state_for(mesh, pos, vel, mass, BOX, G8)
    # h = 0: no kick/drift, so state.acc after one step IS the P3M force
    # at the input positions
    st, c = step(st, 0.0, jax.random.PRNGKey(0))
    assert int(c["n_overflow"]) == 0 and int(c["n_dropped"]) == 0
    assert int(c["in_transit"]) == 0

    acc_ref, unc = p3m_acceleration(
        jnp.asarray(pos), jnp.asarray(mass), cfg.G, BOX, g=pm_grid,
        n_cells=G8, max_per_cell=256, eps=cfg.softening, max_residual=256,
    )
    assert int(unc) == 0
    acc_ref = np.asarray(acc_ref)
    got = np.asarray(st.acc)
    m = _by_uid(st)
    idx = np.array([m[u] for u in range(384)])
    scale = np.linalg.norm(acc_ref, axis=1).mean()
    np.testing.assert_allclose(
        got[idx], acc_ref, rtol=2e-3, atol=2e-4 * scale
    )


def test_spatial_p3m_2d_mesh(eight_devices):
    """The fused-p3m spatial step also compiles and agrees on the 2D
    (x, y)-slab mesh (corner halo traffic carries short-range sources)."""
    from nbx.ops.p3m import p3m_acceleration

    mesh2 = shard.make_mesh(8, axes=("bx", "by"))
    pos, vel, mass = _cloud(n=256, seed=5)
    cfg = SimConfig(merge_time=1e9, fracture_threshold=1e9)
    step = spatial.make_spatial_granular_step(
        mesh2, cfg, BOX, G8, 2, (96, 160), halo_cap=192, mig_cap=128,
        force_impl="p3m", pm_grid=32, interpret=True,
    )
    st = spatial.spatial_state_for(mesh2, pos, vel, mass, BOX, G8)
    st, c = step(st, 0.0, jax.random.PRNGKey(0))
    assert int(c["n_overflow"]) == 0
    acc_ref, unc = p3m_acceleration(
        jnp.asarray(pos), jnp.asarray(mass), cfg.G, BOX, g=32,
        n_cells=G8, max_per_cell=256, eps=cfg.softening, max_residual=256,
    )
    assert int(unc) == 0
    acc_ref = np.asarray(acc_ref)
    got = np.asarray(st.acc)
    m = _by_uid(st)
    idx = np.array([m[u] for u in range(256)])
    scale = np.linalg.norm(acc_ref, axis=1).mean()
    np.testing.assert_allclose(
        got[idx], acc_ref, rtol=2e-3, atol=2e-4 * scale
    )


def test_render_spatial_matches_gathered(mesh):
    """Per-chip splat of slab-owned slots + image psum equals the
    single-device splat of the gathered state (additive splats commute;
    fp addition-order tolerance)."""
    from nbx.config import body_radius
    from nbx.render.colormap import tonemap
    from nbx.render.splat import Camera, splat_bodies_hdr

    pos, vel, mass = _cloud(n=256, seed=11)
    cfg = SimConfig()
    st = spatial.spatial_state_for(mesh, pos, vel, mass, BOX, G8)
    cam = Camera.default()
    img = np.asarray(spatial.render_spatial(
        mesh, st, cfg, cam, width=160, height=90))

    mats = cfg.materials
    mass_h = jnp.asarray(np.asarray(st.mass))
    mat_h = jnp.asarray(np.asarray(st.mat))
    hdr = splat_bodies_hdr(
        jnp.asarray(np.asarray(st.pos)),
        body_radius(mass_h, mat_h, mats),
        jnp.asarray(np.asarray(st.temp)), mat_h, mass_h > 0,
        mats.color1, mats.color2, cam, width=160, height=90,
    )
    ref = np.asarray(tonemap(hdr, 4.0))
    assert img.shape == ref.shape == (90, 160, 3)
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-5)


def test_render_spatial_2d_mesh(eight_devices):
    from nbx.render.splat import Camera

    mesh2 = shard.make_mesh(8, axes=("bx", "by"))
    pos, vel, mass = _cloud(n=128, seed=12)
    st = spatial.spatial_state_for(mesh2, pos, vel, mass, BOX, G8)
    img = np.asarray(spatial.render_spatial(
        mesh2, st, SimConfig(), Camera.default(), width=96, height=54))
    assert np.isfinite(img).all() and img.max() > 0
