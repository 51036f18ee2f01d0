"""Multi-device tests on the 8-virtual-CPU-device mesh
(SURVEY.md section 4.5): the sharded step must match the single-device
step bit-for-bit in f32 (same op order per shard row)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbx import forces, integrators, scene
from nbx.parallel import shard


@pytest.fixture
def mesh(eight_devices):
    return shard.make_mesh(8)


def _setup(n=512, seed=0):
    sc = scene.plummer(n=n, total_mass=float(n), scale_radius=10.0, G=0.5, seed=seed)
    return sc["pos"], sc["vel"], sc["mass"]


def test_sharded_matches_single_device(mesh):
    pos, vel, mass = _setup()
    G, eps, h = 0.5, 0.5, 0.01

    st = shard.shard_state(mesh, pos, vel, mass)
    step = shard.make_sharded_step(mesh, impl="jnp")
    for _ in range(5):
        st = step(st, G, eps, h)

    # single-device reference with identical physics
    f = lambda p: forces.accelerations_blocked(
        jnp.asarray(p, jnp.float32), jnp.asarray(mass, jnp.float32), G, eps, 64
    )
    s = integrators.init_phase(
        jnp.asarray(pos, jnp.float32), jnp.asarray(vel, jnp.float32)
    )
    for _ in range(5):
        s = integrators.kdk_step(s, h, f)

    np.testing.assert_allclose(
        np.asarray(st.pos), np.asarray(s.pos), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(st.vel), np.asarray(s.vel), rtol=1e-5, atol=1e-5
    )


def test_sharded_2d_matches_1d(eight_devices):
    pos, vel, mass = _setup(n=512, seed=1)
    G, eps, h = 0.5, 0.5, 0.01

    mesh1 = shard.make_mesh(8, axes=("b",))
    st1 = shard.shard_state(mesh1, pos, vel, mass)
    step1 = shard.make_sharded_step(mesh1, impl="jnp")

    mesh2 = shard.make_mesh(8, axes=("b", "j"))
    st2 = shard.shard_state2d(mesh2, pos, vel, mass)
    step2 = shard.make_sharded_step_2d(mesh2, impl="jnp")

    for _ in range(3):
        st1 = step1(st1, G, eps, h)
        st2 = step2(st2, G, eps, h)

    np.testing.assert_allclose(
        np.asarray(st2.pos), np.asarray(st1.pos), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(st2.vel), np.asarray(st1.vel), rtol=1e-5, atol=1e-6
    )


def test_sharded_energy(mesh):
    pos, vel, mass = _setup(n=256, seed=2)
    st = shard.shard_state(mesh, pos, vel, mass)
    ke, pe = shard.sharded_energy(mesh, st, 0.5, 0.5)
    ke_ref = forces.kinetic_energy(jnp.asarray(vel), jnp.asarray(mass))
    pe_ref = forces.potential_energy(jnp.asarray(pos), jnp.asarray(mass), 0.5, 0.5)
    np.testing.assert_allclose(float(ke), float(ke_ref), rtol=1e-5)
    np.testing.assert_allclose(float(pe), float(pe_ref), rtol=1e-5)


def test_sharded_drift_short(mesh):
    """Energy stays bounded over a short sharded Plummer run (scanned on
    device in ONE dispatch via run_sharded — also avoids a rare XLA-CPU
    shutdown abort seen with dozens of sequential multi-device dispatches)."""
    pos, vel, mass = _setup(n=512, seed=3)
    st = shard.shard_state(mesh, pos, vel, mass)
    step = shard.make_sharded_step(mesh, impl="jnp")
    ke0, pe0 = shard.sharded_energy(mesh, st, 0.5, 0.5)
    e0 = float(ke0 + pe0)
    st, energies = shard.run_sharded(
        st, step, 0.5, 0.5, 0.005, n_steps=50, diag_every=25, mesh=mesh,
    )
    assert energies.shape == (2, 2)
    ke1, pe1 = shard.sharded_energy(mesh, st, 0.5, 0.5)
    drift = abs(float(ke1 + pe1) - e0) / abs(e0)
    assert drift < 1e-3, f"sharded energy drift {drift}"


def test_indivisible_n_rejected(mesh):
    pos, vel, mass = _setup(n=500)
    with pytest.raises(ValueError, match="divisible"):
        shard.shard_state(mesh, pos, vel, mass)


def test_ring_matches_allgather(mesh):
    """Ring-systolic step == all-gather step to f32 summation-order noise."""
    pos, vel, mass = _setup(n=256, seed=5)
    st1 = shard.shard_state(mesh, pos, vel, mass)
    st2 = shard.shard_state(mesh, pos, vel, mass)
    step1 = shard.make_sharded_step(mesh, impl="jnp")
    step_r = shard.make_sharded_step_ring(mesh, impl="jnp")
    for _ in range(3):
        st1 = step1(st1, 0.5, 0.5, 0.01)
        st2 = step_r(st2, 0.5, 0.5, 0.01)
    np.testing.assert_allclose(
        np.asarray(st2.pos), np.asarray(st1.pos), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(st2.vel), np.asarray(st1.vel), rtol=1e-5, atol=1e-6
    )


def test_sharded_physics_bounce_and_heat(mesh):
    """Full-physics sharded step: a cross-shard overlapping pair bounces
    with global momentum conserved and impact heating applied."""
    from nbx.config import SimConfig

    cfg = SimConfig(G=0.0, merge_time=1e9, fracture_threshold=1e9)
    n = 16  # 2 bodies per shard; the pair spans shards 0 and 7
    pos = np.full((n, 3), 500.0, np.float32)
    pos += np.arange(n)[:, None] * 50.0  # park everyone far apart
    pos[0] = [0.0, 0.0, 0.0]
    pos[15] = [1.0, 0.0, 0.0]  # overlapping with body 0 (radius ~ 1.24)
    vel = np.zeros((n, 3), np.float32)
    vel[0, 0] = 1.0
    vel[15, 0] = -1.0
    mass = np.zeros(n, np.float32)
    mass[0] = mass[15] = 8.0

    st = shard.shard_body_state(mesh, pos, vel, mass)
    step = shard.make_sharded_physics_step(mesh, cfg, impl="jnp")
    st2, ev = step(st, 0.008, jax.random.PRNGKey(0))
    assert int(ev["n_bounces"]) == 1
    v = np.asarray(st2.vel)
    # impulse applied symmetrically: momentum conserved, speeds reduced
    p_tot = (np.asarray(st2.mass)[:, None] * v).sum(0)
    np.testing.assert_allclose(p_tot, 0.0, atol=1e-4)
    assert v[0, 0] < 1.0 and v[15, 0] > -1.0
    assert float(np.asarray(st2.temp)[0]) > 0  # impact heating
    # partners recorded mutually across shards
    pn = np.asarray(st2.partner)
    assert pn[0] == 15 and pn[15] == 0


def test_sharded_merge_across_shards(mesh):
    """A sustained cross-shard contact merges: the lower GLOBAL slot (on
    chip 0) hosts the merged body, the copy on chip 7 dies, and global
    mass/momentum are conserved — the round-1 'sharded full-physics' gap."""
    from nbx.config import SimConfig

    cfg = SimConfig(G=0.5, merge_time=0.05, fracture_threshold=1e9)
    n = 16
    pos = np.full((n, 3), 500.0, np.float32)
    pos += np.arange(n)[:, None] * 50.0
    pos[0] = [0.0, 0.0, 0.0]
    pos[15] = [1.1, 0.0, 0.0]
    vel = np.zeros((n, 3), np.float32)
    mass = np.zeros(n, np.float32)
    mass[0] = mass[15] = 8.0

    st = shard.shard_body_state(mesh, pos, vel, mass)
    step = shard.make_sharded_physics_step(mesh, cfg, impl="jnp")
    total_merges = 0
    for _ in range(40):  # gravity holds them together until the timer fires
        st, ev = step(st, 0.016, jax.random.PRNGKey(0))
        total_merges += int(ev["n_merges"])
        if total_merges:
            break
    assert total_merges == 1, "cross-shard pair must merge"
    m = np.asarray(st.mass)
    np.testing.assert_allclose(m.sum(), 16.0, rtol=1e-6)
    assert m[0] == 16.0 and m[15] == 0.0  # lower slot hosts, copy died
    p_tot = (m[:, None] * np.asarray(st.vel)).sum(0)
    np.testing.assert_allclose(p_tot, 0.0, atol=1e-3)
    pn = np.asarray(st.partner)
    assert pn[0] == -1 and float(np.asarray(st.contact_t)[0]) == 0.0


def test_sharded_fracture_across_shards(mesh):
    """A violent cross-shard impact fractures: both parents (on different
    chips) die, momentum-conserving fragments are written into global dead
    slots by the replicated rank-scatter allocation, and no mass is created
    (reference index.html:411-443; docs/DESIGN.md sharded fractures)."""
    from nbx.config import SimConfig

    cfg = SimConfig(G=0.0, merge_time=1e9, fracture_threshold=0.5,
                    min_fragment_mass=0.2)
    n = 16
    pos = np.full((n, 3), 500.0, np.float32)
    pos += np.arange(n)[:, None] * 50.0
    pos[0] = [0.0, 0.0, 0.0]
    pos[15] = [1.2, 0.0, 0.0]
    vel = np.zeros((n, 3), np.float32)
    vel[0, 0] = 4.0
    vel[15, 0] = -4.0
    mass = np.zeros(n, np.float32)
    mass[0] = mass[15] = 10.0

    st = shard.shard_body_state(mesh, pos, vel, mass)
    step = shard.make_sharded_physics_step(mesh, cfg, impl="jnp")
    st, ev = step(st, 0.016, jax.random.PRNGKey(3))
    assert int(ev["n_fractures"]) == 1
    m = np.asarray(st.mass)
    n_frag = int((m > 0).sum())
    assert n_frag >= 3  # reference minimum fragment count (L418)
    assert m.sum() <= 20.0 + 1e-4  # never creates mass
    # fragment jets bound the residual momentum (see test_fracture_at_scale)
    p1 = (m[:, None] * np.asarray(st.vel)).sum(0)
    e_imp = 0.5 * (10.0 * 10.0 / 20.0) * 8.0**2  # mu/2 vn^2
    assert np.abs(p1).max() < 20.0 * 1.5 * np.sqrt(e_imp / 20.0)
    assert np.isfinite(np.asarray(st.pos)).all()
    # fragments carry impact heat
    assert float(np.asarray(st.temp)[m > 0].max()) > 0


def test_sharded_fracture_matches_scaled_semantics(mesh):
    """The sharded fracture fires under exactly the same gate as the
    single-chip scaled path on the same scene (same q, same thresholds)."""
    from nbx.collisions_scaled import make_granular_state, resolve_collisions_scaled
    from nbx.config import SimConfig

    cfg = SimConfig(G=0.0, merge_time=1e9, fracture_threshold=0.5,
                    min_fragment_mass=0.2)
    n = 16
    pos = np.full((n, 3), 80.0, np.float32)
    pos[0] = [30.0, 30, 30]
    pos[15] = [31.2, 30, 30]
    vel = np.zeros((n, 3), np.float32)
    vel[0, 0] = 4.0
    vel[15, 0] = -4.0
    mass = np.zeros(n, np.float32)
    mass[0] = mass[15] = 10.0

    gst = make_granular_state(pos, vel, mass, key=3)
    gst, gev = resolve_collisions_scaled(
        gst, cfg, 0.016, 100.0, n_cells=8, packed_caps=(64, 64),
        interpret=True
    )
    st = shard.shard_body_state(mesh, pos, vel, mass)
    step = shard.make_sharded_physics_step(mesh, cfg, impl="jnp")
    st, ev = step(st, 0.016, jax.random.PRNGKey(3))
    assert int(ev["n_fractures"]) == int(gev.n_fractures) == 1
    # same total fragment mass budget consumed (identical _make_fragments
    # sampling is keyed differently, so compare conservation not draws)
    assert float(np.asarray(st.mass).sum()) <= 20.0 + 1e-4
    assert float(jnp.sum(gst.mass)) <= 20.0 + 1e-4


def test_sharded_binned_collision_matches_single(mesh):
    """Column-slab sharded packed collision sweep == single-device
    binned_collision_pass: identical partner sets and counters, deltas to
    the psum's trivial fp tolerance (one nonzero term per body)."""
    from nbx.config import body_radius, default_materials
    from nbx.ops.collide import binned_collision_pass

    rng = np.random.default_rng(5)
    n = 1024
    box = 100.0
    pos = rng.uniform(10, 90, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    mass = rng.uniform(2.0, 8.0, n).astype(np.float32)
    mass[-64:] = 0.0  # dead slots
    radius = np.asarray(
        body_radius(jnp.asarray(mass), jnp.zeros(n, jnp.int32),
                    default_materials())
    ) * 2.0  # plenty of overlaps

    single = binned_collision_pass(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass),
        jnp.asarray(radius), box, 4, band_cells=2, packed_caps=(256, 384),
        interpret=True,
    )

    sharded_pass = shard.make_sharded_binned_collision_pass(
        mesh, box, 4, 2, (256, 384), interpret=True
    )
    s3 = jax.NamedSharding(mesh, jax.sharding.PartitionSpec("b", None))
    s1 = jax.NamedSharding(mesh, jax.sharding.PartitionSpec("b"))
    out = sharded_pass(
        jax.device_put(jnp.asarray(pos), s3),
        jax.device_put(jnp.asarray(vel), s3),
        jax.device_put(jnp.asarray(mass), s1),
        jax.device_put(jnp.asarray(radius), s1),
    )

    dv0, dp0, dt0, best0, nb0, ovf0, small0 = single
    dv1, dp1, dt1, best1, nb1, ovf1, small1 = out
    assert int(nb1) == int(nb0) > 0
    assert int(ovf1) == int(ovf0) == 0
    assert bool(small1) == bool(small0)
    np.testing.assert_array_equal(np.asarray(best1["j"]),
                                  np.asarray(best0["j"]))
    np.testing.assert_allclose(np.asarray(dv1), np.asarray(dv0),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(dp1), np.asarray(dp0),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(dt1), np.asarray(dt0),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(best1["vn"]),
                               np.asarray(best0["vn"]),
                               rtol=1e-6, atol=1e-7)


def test_sharded_binned_rejects_bad_mesh_split(eight_devices):
    """Column count must divide over the device count."""
    m = shard.make_mesh(8)
    with pytest.raises(ValueError, match="columns"):
        shard.make_sharded_binned_collision_pass(m, 100.0, 3, 2, (64, 96))


# ---------------------------------------------------------------------------
# Sharded granular (binned full-physics) step
# ---------------------------------------------------------------------------

def _granular_cloud_cfg(n=512, seed=9):
    """A contact-rich cloud + a config whose thresholds make bounces,
    merges AND fractures all fire within a few substeps."""
    import dataclasses

    from nbx.config import Materials, SimConfig, default_materials

    rng = np.random.default_rng(seed)
    pos = rng.uniform(20.0, 60.0, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    mass = rng.uniform(2.0, 8.0, n).astype(np.float32)
    mass[-64:] = 0.0  # dead slots for fragments
    dm = default_materials()
    mats = Materials(  # low density -> fat radii -> plenty of contacts
        density=dm.density * 0.1, color1=dm.color1, color2=dm.color2
    )
    cfg = SimConfig(
        merge_time=0.005,  # first sustained contact merges
        fracture_threshold=0.5,
        min_fragment_mass=0.2,
        materials=mats,
    )
    return pos, vel, mass, cfg


def _single_chip_granular_loop(pos, vel, mass, cfg, h, n_steps, box, g,
                               band, caps, key0):
    """The exact single-chip sequence make_sharded_granular_step mirrors
    (granular_full_kdk_scan's body with zero gravity, acc0 = 0)."""
    from nbx import thermal
    from nbx.collisions_scaled import make_granular_state, resolve_collisions_scaled

    st = make_granular_state(pos, vel, mass, key=key0)
    acc = jnp.zeros_like(st.pos)
    evs = []
    for _ in range(n_steps):
        v = st.vel + acc * (0.5 * h)
        p = st.pos + v * h
        st = st._replace(pos=p, vel=v)
        st, ev = resolve_collisions_scaled(
            st, cfg, h, box, g, band_cells=band, packed_caps=caps,
            interpret=True,
        )
        acc = jnp.where(ev.touched[:, None], 0.0, jnp.zeros_like(st.pos))
        st = st._replace(
            vel=st.vel + acc * (0.5 * h),
            temp=thermal.decay(st.temp, cfg.heat_decay),
        )
        evs.append(ev)
    return st, evs


def test_sharded_granular_step_matches_single(mesh):
    """The at-scale sharded full-physics step (packed Pallas sweep per
    column slab + collisions_scaled event machinery) reproduces the
    single-chip sequence over several substeps, including merges,
    fractures, fragment placement, timers and all counters.

    Tolerance note: counters/partners/timers/materials match EXACTLY;
    pos/vel/temp to f32 ulp tolerance — the interpreted kernel is traced
    into the surrounding XLA graph, so FMA/fusion choices (e.g.
    a2*dx - ft*rvx) can differ between the single-device and sharded
    programs."""
    box, g, band, caps = 100.0, 4, 2, (256, 384)
    h = 0.016
    n_steps = 4
    pos, vel, mass, cfg = _granular_cloud_cfg()

    key0 = jax.random.PRNGKey(7)
    st1, evs = _single_chip_granular_loop(
        pos, vel, mass, cfg, h, n_steps, box, g, band, caps, key0
    )

    step = shard.make_sharded_granular_step(
        mesh, cfg, box, g, band, caps, force_impl="zero", interpret=True
    )
    st = shard.shard_body_state(mesh, pos, vel, mass)
    key = key0
    counters = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        st, c = step(st, h, sub)
        counters.append(c)

    # the scene must actually exercise every event type
    tot = {k: sum(int(c[k]) for c in counters)
           for k in ("n_merges", "n_fractures", "n_bounces")}
    assert tot["n_bounces"] > 0
    assert tot["n_merges"] > 0
    assert tot["n_fractures"] > 0
    assert sum(int(c["n_overflow"]) for c in counters) == 0

    for k in ("n_merges", "n_fractures", "n_bounces", "n_dropped"):
        ref_key = k
        got = [int(c[k]) for c in counters]
        want = [int(getattr(ev, ref_key)) for ev in evs]
        assert got == want, (k, got, want)

    np.testing.assert_allclose(
        np.asarray(st.mass), np.asarray(st1.mass), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(st.pos), np.asarray(st1.pos), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(st.vel), np.asarray(st1.vel), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(st.temp), np.asarray(st1.temp), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(st.mat), np.asarray(st1.mat))
    np.testing.assert_array_equal(
        np.asarray(st.partner), np.asarray(st1.partner)
    )
    np.testing.assert_array_equal(
        np.asarray(st.contact_t), np.asarray(st1.contact_t)
    )


def test_sharded_granular_gravity_close_to_single(mesh):
    """With direct gravity on, the sharded step tracks the single-chip
    sequence to f32 reduction-order tolerance (the rectangular all-on-local
    sum orders differ from the dense single-chip path)."""
    from nbx import thermal
    from nbx.collisions_scaled import make_granular_state, resolve_collisions_scaled
    from nbx.sim import gravity

    box, g, band, caps = 100.0, 4, 2, (256, 384)
    h = 0.008
    n_steps = 3
    pos, vel, mass, cfg = _granular_cloud_cfg(seed=11)

    key0 = jax.random.PRNGKey(3)
    st1 = make_granular_state(pos, vel, mass, key=key0)
    acc = gravity(st1.pos, st1.mass, cfg.G, cfg.softening, "dense")
    for _ in range(n_steps):
        v = st1.vel + acc * (0.5 * h)
        p = st1.pos + v * h
        a2 = gravity(p, st1.mass, cfg.G, cfg.softening, "dense")
        st1 = st1._replace(pos=p, vel=v)
        st1, ev = resolve_collisions_scaled(
            st1, cfg, h, box, g, band_cells=band, packed_caps=caps,
            interpret=True,
        )
        a2 = jnp.where(ev.touched[:, None], 0.0, a2)
        st1 = st1._replace(
            vel=st1.vel + a2 * (0.5 * h),
            temp=thermal.decay(st1.temp, cfg.heat_decay),
        )
        acc = a2

    step = shard.make_sharded_granular_step(
        mesh, cfg, box, g, band, caps, force_impl="jnp", interpret=True
    )
    st = shard.shard_body_state(mesh, pos, vel, mass)
    # prime acc to the initial force, as the single-chip loop does
    from jax.sharding import NamedSharding, PartitionSpec as P

    acc0 = gravity(jnp.asarray(pos), jnp.asarray(mass), cfg.G,
                   cfg.softening, "dense")
    st = st._replace(
        acc=jax.device_put(acc0, NamedSharding(mesh, P("b", None)))
    )
    key = key0
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        st, c = step(st, h, sub)

    np.testing.assert_allclose(
        np.asarray(st.pos), np.asarray(st1.pos), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(st.vel), np.asarray(st1.vel), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_array_equal(
        np.asarray(st.mass > 0), np.asarray(st1.mass > 0)
    )


def test_sharded_granular_rejects_bad_mesh_split(eight_devices):
    from nbx.config import SimConfig

    m = shard.make_mesh(8)
    with pytest.raises(ValueError, match="columns"):
        shard.make_sharded_granular_step(m, SimConfig(), 100.0, 3, 2, (64, 96))
