"""P3M solver tests: cell binning, short-range split, accuracy vs direct."""

import jax.numpy as jnp
import numpy as np

from nbx import forces
from nbx.ops.p3m import cell_bin, p3m_acceleration, short_range_acc


def _uniform(n=2048, seed=1, box=100.0, lo=10.0, hi=40.0):
    rng = np.random.default_rng(seed)
    pos = jnp.asarray(rng.uniform(lo, hi, (n, 3)), jnp.float32)
    mass = jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32)
    return pos, mass, box


def test_cell_bin_roundtrip():
    pos, mass, box = _uniform(256)
    table, counts, ovf = cell_bin(pos, box, 8, 32)
    t = np.asarray(table)
    assert int(ovf) == 0
    # every body appears exactly once
    idx = t[t < 256]
    assert sorted(idx.tolist()) == list(range(256))
    assert int(counts.sum()) == 256


def test_cell_bin_overflow_counted():
    # 100 bodies in one point -> one cell, K=8 -> 92 overflow
    pos = jnp.ones((100, 3)) * 5.0
    table, counts, ovf = cell_bin(pos, 100.0, 8, 8)
    assert int(ovf) == 92
    assert int(counts.max()) == 100


def test_short_range_matches_direct_within_cutoff():
    """With a >> system size, erfc ~ 1 and the short-range term alone is the
    full (softened) force; a tight cluster inside one cell reproduces the
    direct sum."""
    rng = np.random.default_rng(2)
    pos = jnp.asarray(5.0 + rng.uniform(0, 1.5, (64, 3)), jnp.float32)
    mass = jnp.asarray(rng.uniform(0.5, 2.0, 64), jnp.float32)
    eps = 0.2
    box, n_cells = 100.0, 10  # cell = 10 >> cluster extent
    a = 1e3  # erfc(r/a) ~ 1 for all pairs
    acc, ovf = short_range_acc(
        pos, mass, 1.0, a, box, n_cells, max_per_cell=64, eps=eps
    )
    want = forces.accelerations(pos, mass, 1.0, eps)
    assert int(ovf) == 0
    np.testing.assert_allclose(
        np.asarray(acc), np.asarray(want), rtol=2e-3, atol=1e-4
    )


def test_p3m_accuracy_uniform():
    """Quasi-uniform scene: P3M within ~1% of direct sum (PM alone is ~5%)."""
    pos, mass, box = _uniform(2048)
    eps = 0.1
    direct = np.asarray(forces.accelerations_blocked(pos, mass, 1.0, eps, 1024))
    acc, ovf = p3m_acceleration(
        pos, mass, 1.0, box, g=128, n_cells=25, max_per_cell=32, eps=eps
    )
    acc = np.asarray(acc)
    assert int(ovf) == 0
    err = np.linalg.norm(acc - direct, axis=1) / (
        np.linalg.norm(direct, axis=1) + 1e-9
    )
    assert np.median(err) < 0.01, f"median {np.median(err):.4f}"
    assert np.percentile(err, 90) < 0.03, f"p90 {np.percentile(err, 90):.4f}"


def test_p3m_momentum_balance():
    pos, mass, box = _uniform(1024, seed=3)
    acc, _ = p3m_acceleration(
        pos, mass, 1.0, box, g=64, n_cells=16, max_per_cell=32, eps=0.1
    )
    acc = np.asarray(acc)
    total = np.abs((np.asarray(mass)[:, None] * acc).sum(0)).max()
    scale = float(np.abs(np.asarray(mass)[:, None] * acc).sum())
    assert total < 0.02 * scale


def test_p3m_kdk_scan_runs():
    from nbx.ops.p3m import p3m_kdk_scan

    pos, mass, box = _uniform(512, seed=4)
    vel = jnp.zeros_like(pos)
    p, v, ovf = p3m_kdk_scan(
        pos, vel, mass, 1.0, box, 1e-3, 5, g=64, n_cells=16, max_per_cell=64,
        eps=0.1,
    )
    assert int(ovf) == 0
    assert np.isfinite(np.asarray(p)).all()
    assert np.abs(np.asarray(v)).max() > 0


def _plummer_core(n=4096, seed=11, box=100.0):
    """Strongly clustered Plummer-like core — the scene that overflows
    max_per_cell (the regime VERDICT round 1 flagged as silently degraded)."""
    rng = np.random.default_rng(seed)
    r = 1.5 / np.sqrt(rng.uniform(0.02, 1, n) ** (-2 / 3) - 1)
    r = np.clip(r, 0, 20)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = (box / 2 + r[:, None] * d).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return jnp.asarray(pos), jnp.asarray(mass), box


def test_p3m_adaptive_residual_on_clustered_core():
    """Clustered core: cells overflow, but the residual pass keeps the
    force exact — uncorrected == 0 and accuracy matches the uniform gate."""
    from nbx.ops.p3m import cell_bin

    pos, mass, box = _plummer_core()
    eps = 0.1
    n_cells, k = 25, 8
    _, _, raw_overflow = cell_bin(pos, box, n_cells, k)
    assert int(raw_overflow) > 100, "scene must actually overflow the cells"
    direct = np.asarray(forces.accelerations_blocked(pos, mass, 1.0, eps, 1024))
    # the core is extreme: most of the scene overflows, so size the residual
    # cap to the scene (it is a static buffer bound, same as max_per_cell)
    acc, uncorrected = p3m_acceleration(
        pos, mass, 1.0, box, g=128, n_cells=n_cells, max_per_cell=k, eps=eps,
        max_residual=4096,
    )
    assert int(uncorrected) == 0
    err = np.linalg.norm(np.asarray(acc) - direct, axis=1) / (
        np.linalg.norm(direct, axis=1) + 1e-9
    )
    assert np.median(err) < 0.01, f"median {np.median(err):.4f}"
    # the dense-core bodies themselves (the previously-degraded ones) too
    core = np.linalg.norm(np.asarray(pos) - 50.0, axis=1) < 2.0
    assert np.median(err[core]) < 0.01, f"core median {np.median(err[core]):.4f}"


def test_p3m_residual_cap_surfaced():
    """Overflow beyond max_residual is counted, never silent."""
    pos, mass, box = _plummer_core(n=1024, seed=12)
    _, uncorrected = p3m_acceleration(
        pos, mass, 1.0, box, g=32, n_cells=25, max_per_cell=1,
        max_residual=64, eps=0.1,
    )
    assert int(uncorrected) > 0


def test_chunk_boundary_no_double_count():
    """Cells beyond c_total in the final chunk must not re-add the last
    cell's forces (regression: clamped duplicates gave 25x forces when the
    corner cell was occupied)."""
    rng = np.random.default_rng(9)
    # bodies in the LAST cell of a 10^3 grid (c_total=1000, chunk=512)
    pos = jnp.asarray(95.0 + rng.uniform(0, 4.0, (32, 3)), jnp.float32)
    mass = jnp.asarray(rng.uniform(0.5, 2.0, 32), jnp.float32)
    acc, ovf = short_range_acc(
        pos, mass, 1.0, 1e3, 100.0, 10, max_per_cell=32, eps=0.2
    )
    want = forces.accelerations(pos, mass, 1.0, 0.2)
    assert int(ovf) == 0
    np.testing.assert_allclose(
        np.asarray(acc), np.asarray(want), rtol=2e-3, atol=1e-4
    )


def test_p3m_twolevel_residual_matches_dense():
    """residual_mode='twolevel' replaces the dense [M, M] residual block
    with a refined submesh + fine binned PP at near-dense accuracy — the
    O(M) two-level path for cluster cores (ROADMAP item 8)."""
    pos, mass, box = _plummer_core(n=2048, seed=13)
    eps = 0.1
    direct = np.asarray(forces.accelerations_blocked(pos, mass, 1.0, eps, 1024))
    nrm = np.linalg.norm(direct, axis=1) + 1e-9
    errs = {}
    for mode in ("dense", "twolevel"):
        acc, uncorrected = p3m_acceleration(
            pos, mass, 1.0, box, g=128, n_cells=25, max_per_cell=8, eps=eps,
            max_residual=2048, residual_mode=mode,
            sub_g=64, sub_cells=12, sub_k=256,
        )
        assert int(uncorrected) == 0, mode
        errs[mode] = np.linalg.norm(np.asarray(acc) - direct, axis=1) / nrm
    assert np.median(errs["twolevel"]) < 0.01, np.median(errs["twolevel"])
    # no worse than ~3x the dense-exact error anywhere that matters
    assert np.median(errs["twolevel"]) < 3 * np.median(errs["dense"]) + 1e-3


def test_p3m_twolevel_fine_binning_drop_counted():
    """Bodies dropped from the submesh's FINE binning surface through
    n_uncorrected (no-silent-caps)."""
    pos, mass, box = _plummer_core(n=1024, seed=14)
    _, uncorrected = p3m_acceleration(
        pos, mass, 1.0, box, g=64, n_cells=25, max_per_cell=1, eps=0.1,
        max_residual=1024, residual_mode="twolevel",
        sub_g=32, sub_cells=8, sub_k=1,
    )
    assert int(uncorrected) > 0


def test_p3m_twolevel_robust_to_outlier_residuals():
    """Satellite clumps far from the main core must not inflate the
    two-level submesh (regression: max-extent sizing squeezed the core
    into ~2 submesh cells — 26k fine-binning drops and core error 0.38 on
    the 1M+30k bench scene; a coverage-quantile box failed the same way
    once outliers exceeded its trim fraction). Median/IQR sizing keeps
    the submesh on the core and routes the clumps through the exact
    outlier fallback: twolevel must match dense within tolerance with
    nothing uncorrected."""
    rng = np.random.default_rng(0)
    box = 100.0
    field = rng.uniform(2.0, 98.0, (6200, 3))
    core = np.clip(rng.normal(50.0, 1.5, (1752, 3)), 2, 98)
    clump1 = np.clip(rng.normal(15.0, 0.3, (120, 3)), 2, 98)
    clump2 = np.clip(rng.normal(85.0, 0.3, (120, 3)), 2, 98)
    pos = jnp.asarray(np.concatenate([field, core, clump1, clump2]),
                      jnp.float32)
    mass = jnp.asarray(rng.uniform(0.5, 1.5, pos.shape[0]), jnp.float32)
    eps = 0.1
    direct = np.asarray(
        forces.accelerations_blocked(pos, mass, 1.0, eps, 1024)
    )
    nrm = np.linalg.norm(direct, axis=1) + 1e-9
    errs = {}
    for mode in ("dense", "twolevel"):
        acc, unc = p3m_acceleration(
            pos, mass, 1.0, box, g=64, n_cells=25, max_per_cell=8, eps=eps,
            max_residual=4096, residual_mode=mode,
            sub_g=64, sub_cells=16, sub_k=128,
        )
        assert int(unc) == 0, mode
        errs[mode] = np.linalg.norm(np.asarray(acc) - direct, axis=1) / nrm
    for seg, sl in (("core", slice(6200, 7952)), ("clumps", slice(7952, None))):
        tw = float(np.median(errs["twolevel"][sl]))
        de = float(np.median(errs["dense"][sl]))
        assert tw < 1.5 * de + 1e-3, (seg, tw, de)


def test_p3m_tune_for_clustered_scene():
    """Scene-census tuner: on a field+core scene the chosen tune respects
    its own budgets and is kwargs-compatible with p3m_acceleration, which
    then corrects every overflowing body."""
    from nbx.ops.p3m import p3m_tune_for

    rng = np.random.default_rng(2)
    box = 50.0
    field = rng.uniform(0.5, box / 2 - 0.5, (30000, 3))
    core = np.clip(rng.normal(box / 4, 0.8, (3000, 3)), 0.5, box / 2 - 0.5)
    pos = jnp.asarray(np.concatenate([field, core]), jnp.float32)
    tune = p3m_tune_for(pos, box, g_candidates=(64,),
                        cells_candidates=(8, 12, 16))
    assert tune["g"] == 64
    assert tune["g"] >= 3 * tune["n_cells"]
    assert tune["n_residual"] <= tune["max_residual"]
    # the four p3m_acceleration keys are directly usable
    acc, unc = p3m_acceleration(
        pos, jnp.ones(pos.shape[0], jnp.float32), 1.0, box,
        g=tune["g"], n_cells=tune["n_cells"],
        max_per_cell=tune["max_per_cell"],
        max_residual=tune["max_residual"],
    )
    assert int(unc) == 0
    assert np.isfinite(np.asarray(acc)).all()
