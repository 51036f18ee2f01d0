"""Direct-sum gravity: the Triton kernel (interpreted on the CPU) and the
plain blocked sums against the dense formulation and float64. The compiled
kernel is gated on the card by tests/test_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbx import forces
from nbx.ops.pairwise import pairwise_acc


def _rand(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = jnp.asarray(rng.normal(size=(n, 3)) * 20, jnp.float32)
    mass = jnp.asarray(rng.uniform(0.5, 5, n), jnp.float32)
    return pos, mass


def _f64_acc(pos, mass, G, eps, targets=None):
    p = np.asarray(pos, np.float64)
    m = np.asarray(mass, np.float64)
    t = p if targets is None else np.asarray(targets, np.float64)
    d = p[None, :, :] - t[:, None, :]
    r2 = (d * d).sum(-1) + eps * eps
    return G * ((m[None] * r2 ** -1.5)[..., None] * d).sum(1)


@pytest.mark.parametrize("n", [64, 300, 777])
@pytest.mark.parametrize("tiles", [(8, 16), (64, 128), (128, 32)])
def test_acc_matches_dense(n, tiles):
    """Block sweep including N not divisible by either block (SURVEY.md
    section 4.4): masked tails read mass 0."""
    pos, mass = _rand(n, n)
    want = forces.accelerations(pos, mass, 0.5, 0.5)
    got = pairwise_acc(
        pos, mass, 0.5, 0.5, block_i=tiles[0], block_j=tiles[1],
        interpret=True,
    )
    scale = float(jnp.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-6 * scale)


@pytest.mark.parametrize("tiles", [(64, 64), (32, 128)])
def test_acc_matches_float64(tiles):
    """The kernel's float32 sum against a float64 direct sum: the 1e-5
    max-error budget the on-card gate uses, at the GPU's block shapes."""
    pos, mass = _rand(500, 7)
    want = _f64_acc(pos, mass, 0.5, 0.5)
    got = np.asarray(pairwise_acc(pos, mass, 0.5, 0.5, block_i=tiles[0],
                                  block_j=tiles[1], interpret=True))
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


def test_rectangular_targets():
    """Sharded path: force of all sources on a target subset whose size is
    not a multiple of the block."""
    pos, mass = _rand(300, 1)
    tpos = pos[37:137]
    want = forces.accelerations(pos, mass, 0.5, 0.5)[37:137]
    got = pairwise_acc(
        pos, mass, 0.5, 0.5, target_pos=tpos, block_i=16, block_j=32,
        interpret=True,
    )
    scale = float(jnp.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-6 * scale)


def test_mass_zero_padding_is_inert():
    """Dead/padding bodies (mass 0) contribute exactly zero force."""
    pos, mass = _rand(100, 2)
    mass = mass.at[50:].set(0.0)
    want = forces.accelerations(pos[:50], mass[:50], 0.5, 0.5)
    got = pairwise_acc(pos, mass, 0.5, 0.5, block_i=8, block_j=16,
                       interpret=True)[:50]
    scale = float(jnp.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-6 * scale)


def test_block_sizes_must_be_powers_of_two():
    pos, mass = _rand(64)
    with pytest.raises(ValueError, match="powers of two"):
        pairwise_acc(pos, mass, 0.5, 0.5, block_i=48, interpret=True)


def test_gravity_kernel_lowers_for_cuda():
    """The compiled route: pairwise_acc lowers to Triton IR for the CUDA
    platform at the default blocks, without a GPU present."""
    from jax import export

    pos, mass = _rand(1000)
    exp = export.export(
        jax.jit(lambda p, m: pairwise_acc(p, m, 0.5, 0.5)),
        platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")],
    )(pos, mass)
    text = exp.mlir_module()
    assert "__gpu$xla.gpu.triton" in text and "nbx_gravity" in text


@pytest.mark.parametrize("block", [32, 100])
def test_blocked_rectangular_any_target_count(block):
    """The plain blocked sum pads targets to its block: any Nt works."""
    pos, mass = _rand(250, 8)
    tpos = pos[11:88]
    want = _f64_acc(pos, mass, 0.5, 0.5, targets=tpos)
    got = np.asarray(forces.accelerations_blocked(pos, mass, 0.5, 0.5, block,
                                                  target_pos=tpos))
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


@pytest.mark.parametrize("n", [64, 300])
def test_acc_jerk_matches_dense(n):
    """The blocked Hermite force (acc + jerk) matches the dense jnp
    formulation (itself finite-difference gated, tests/test_integrators.py)."""
    rng = np.random.default_rng(n)
    pos = jnp.asarray(rng.normal(size=(n, 3)) * 20, jnp.float32)
    vel = jnp.asarray(rng.normal(size=(n, 3)) * 2, jnp.float32)
    mass = jnp.asarray(rng.uniform(0.5, 5, n), jnp.float32)
    want_a, want_j = forces.acc_and_jerk(pos, mass, vel, 0.5, 0.5)
    got_a, got_j = forces.acc_and_jerk_blocked(pos, mass, vel, 0.5, 0.5,
                                               block=48)
    sa = float(jnp.abs(want_a).max())
    sj = float(jnp.abs(want_j).max())
    np.testing.assert_allclose(np.asarray(got_a), np.asarray(want_a),
                               atol=2e-6 * sa)
    np.testing.assert_allclose(np.asarray(got_j), np.asarray(want_j),
                               atol=2e-6 * sj)


def test_acc_jerk_rectangular_targets():
    rng = np.random.default_rng(5)
    pos = jnp.asarray(rng.normal(size=(300, 3)) * 20, jnp.float32)
    vel = jnp.asarray(rng.normal(size=(300, 3)) * 2, jnp.float32)
    mass = jnp.asarray(rng.uniform(0.5, 5, 300), jnp.float32)
    want_a, want_j = forces.acc_and_jerk(pos, mass, vel, 0.5, 0.5)
    got_a, got_j = forces.acc_and_jerk_blocked(
        pos, mass, vel, 0.5, 0.5, block=64, target_pos=pos[37:137],
        target_vel=vel[37:137],
    )
    np.testing.assert_allclose(np.asarray(got_a), np.asarray(want_a[37:137]),
                               atol=2e-6 * float(jnp.abs(want_a).max()))
    np.testing.assert_allclose(np.asarray(got_j), np.asarray(want_j[37:137]),
                               atol=2e-6 * float(jnp.abs(want_j).max()))


def test_potential_matches_dense():
    pos, mass = _rand(256, 3)
    want = float(forces.potential_energy(pos, mass, 0.5, 0.5))
    phi = forces.potential_per_body(pos, mass, 0.5, 0.5, block=100)
    got = float(0.5 * jnp.sum(mass * phi))
    assert abs(got - want) / abs(want) < 1e-5


def test_potential_rectangular_self_term():
    """Per-body phi with targets = a source slice subtracts exactly one
    self term per target."""
    pos, mass = _rand(200, 4)
    phi_full = forces.potential_per_body(pos, mass, 0.5, 0.5, block=64)
    phi_slice = forces.potential_per_body(
        pos, mass, 0.5, 0.5, target_pos=pos[60:90],
        target_mass=mass[60:90], block=16,
    )
    np.testing.assert_allclose(
        np.asarray(phi_slice), np.asarray(phi_full[60:90]), rtol=1e-5
    )
