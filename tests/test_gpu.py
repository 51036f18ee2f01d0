"""On-card gates: the compiled Triton kernels at real widths against their
references, and the interpreter off by default. Every test is marked `gpu`
and skips unless JAX's backend is a GPU (tests/conftest.py). Run on the
card with

    python -m pytest -m gpu tests/test_gpu.py

(chip_smoke.py runs it as a phase)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _f64_acc(pos, mass, targets, G, eps):
    p = np.asarray(pos, np.float64)
    m = np.asarray(mass, np.float64)
    d = p[None, :, :] - p[targets][:, None, :]
    r2 = (d * d).sum(-1) + eps * eps
    return G * np.einsum("ij,ijc->ic", m[None] * r2 ** -1.5, d)


def _granular(n=131072):
    from nbx.bench.granular import granular_cloud
    from nbx.config import body_radius, default_materials

    pos, vel, mass = (jnp.asarray(x) for x in granular_cloud(n))
    rad = body_radius(mass, jnp.zeros(n, jnp.int32), default_materials())
    return pos, vel, mass, rad


@pytest.mark.parametrize("n", [65536, 100003])
def test_gravity_kernel_compiled_matches_float64(n):
    """The compiled kernel at a real width (and one not a multiple of any
    block) against a float64 direct sum on 256 targets: <= 1e-5."""
    from nbx import scene
    from nbx.ops.pairwise import pairwise_acc

    sc = scene.cold_collapse_disk(n=n, seed=1)
    got = np.asarray(pairwise_acc(jnp.asarray(sc["pos"]),
                                  jnp.asarray(sc["mass"]), 0.5, 0.5))
    idx = np.random.default_rng(0).choice(n, 256, replace=False)
    ref = _f64_acc(sc["pos"], sc["mass"], idx, 0.5, 0.5)
    assert np.abs(got[idx] - ref).max() / np.abs(ref).max() <= 1e-5


def test_gravity_kernel_rectangular_compiled():
    """target_pos (the sharded path) against the plain blocked sum at
    matmul precision highest."""
    from nbx import forces, scene
    from nbx.ops.pairwise import pairwise_acc

    sc = scene.cold_collapse_disk(n=65536, seed=2)
    pos, mass = jnp.asarray(sc["pos"]), jnp.asarray(sc["mass"])
    tgt = pos[1000:17000]
    got = np.asarray(pairwise_acc(pos, mass, 0.5, 0.5, target_pos=tgt))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(forces.accelerations_blocked(
            pos, mass, 0.5, 0.5, 1024, target_pos=tgt))
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


@pytest.mark.parametrize("layout", ["bucketed", "packed"])
def test_collision_kernel_compiled_matches_xla_sweep(layout):
    """The compiled window kernel against the plain XLA sweep at 131k
    bodies (serve --big's grid): deltas to rtol 1e-5 / atol 1e-6, equal
    bounce counts and partners."""
    from nbx.bench.kernels import gpu_choice
    from nbx.ops.collide import (binned_collision_pass, bucketed_layout_for,
                                 packed_caps_for)

    pos, vel, mass, rad = _granular()
    if layout == "bucketed":
        kw = dict(buckets=bucketed_layout_for(pos, 100.0, 40, 12))
    else:
        kw = dict(packed_caps=packed_caps_for(pos, 100.0, 40, 12))

    def one(p, v, m, r):
        return binned_collision_pass(p, v, m, r, 100.0, 40, band_cells=12,
                                     **kw)

    kern = jax.jit(one)
    assert "nbx_collide" in kern.lower(pos, vel, mass, rad).as_text()
    got = kern(pos, vel, mass, rad)
    with gpu_choice("collide", "xla"):
        want = jax.jit(one)(pos, vel, mass, rad)
    for k in (0, 1, 2):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
    assert int(got[4]) == int(want[4]) > 0
    assert int(got[5]) == int(want[5]) == 0
    np.testing.assert_array_equal(np.asarray(got[3]["j"]),
                                  np.asarray(want[3]["j"]))


def test_collision_kernel_short_gravity_compiled():
    """The kernel's fused P3M short-range gravity against the XLA sweep
    on random windows: deltas and events to the collision tolerance, the
    gravity to 1e-5 of its largest value."""
    from nbx.bench.kernels import gpu_choice
    from nbx.ops.collide import _collide_par, collide_windows

    rng = np.random.default_rng(0)
    n_win, t_rows, s_rows = 512, 40, 9 * 45

    def feats(k):  # [k, 16] feature rows: dense overlaps, distinct gidx
        f = np.zeros((k, 16), np.float32)
        f[:, 0:3] = rng.uniform(0, 4, (k, 3))
        f[:, 3:6] = rng.normal(0, 1, (k, 3))
        f[:, 6] = rng.uniform(1, 5, k)
        f[:, 7] = rng.uniform(0.3, 0.9, k)
        f[:, 8] = rng.permutation(10**6)[:k]
        return f

    tgt = feats(n_win * t_rows)
    src = feats(n_win * s_rows).reshape(n_win, s_rows, 16)
    src = src.transpose(0, 2, 1).reshape(n_win * 16, s_rows)
    par = _collide_par(0.2, 0.5, (0.5, 1.5, 0.1))
    tgt, src = jnp.asarray(tgt), jnp.asarray(src)
    run = jax.jit(lambda p, t, s: collide_windows(p, t, s, n_win, t_rows,
                                                  s_rows))
    got = run(par, tgt, src)
    with gpu_choice("collide", "xla"):
        want = jax.jit(lambda p, t, s: collide_windows(
            p, t, s, n_win, t_rows, s_rows))(par, tgt, src)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
    # the gravity sums cancel (hundreds of terms of both signs per target):
    # float32 sum-order error scales with the largest term, not the result
    g, w = np.asarray(got[2]), np.asarray(want[2])
    assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


def test_interpreter_off_by_default():
    """The public entry points compile the kernels for the card: the
    lowered programs hold Triton custom calls, not interpreted loops."""
    from nbx import sim
    from nbx.backend import kernel_impl
    from nbx.ops.collide import binned_collision_pass

    assert kernel_impl("gravity") == "triton"
    pos = jnp.zeros((4096, 3), jnp.float32)
    mass = jnp.ones((4096,), jnp.float32)
    hlo = jax.jit(lambda p, m: sim.gravity(p, m, 1.0, 0.1)).lower(
        pos, mass).as_text()
    assert "__gpu$xla.gpu.triton" in hlo
    p, v, m, r = _granular(4096)
    hlo = jax.jit(lambda p, v, m, r: binned_collision_pass(
        p, v, m, r, 100.0, 8, packed_caps=(256, 256))).lower(
        p, v, m, r).as_text()
    assert "__gpu$xla.gpu.triton" in hlo
