"""The backend switch (nbx.backend): which implementation each mechanism
runs, that the Pallas interpreter runs only when asked, and where the
compile cache goes."""

import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbx import backend
from nbx.backend import GPU_CHOICE, kernel_impl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _has_pallas_call(fn, *args) -> bool:
    return "pallas_call" in str(jax.make_jaxpr(fn)(*args))


@pytest.mark.parametrize("mechanism", sorted(GPU_CHOICE))
def test_switch_picks_xla_on_cpu(mechanism):
    assert jax.default_backend() == "cpu"
    assert kernel_impl(mechanism) == "xla"
    assert kernel_impl(mechanism, interpret=True) == "triton"


@pytest.mark.parametrize("mechanism", sorted(GPU_CHOICE))
def test_switch_gives_gpu_its_measured_choice(mechanism, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert kernel_impl(mechanism) == GPU_CHOICE[mechanism]


def test_switch_rejects_unknown_mechanism():
    with pytest.raises(ValueError, match="unknown mechanism"):
        kernel_impl("tree")


def test_gravity_auto_runs_no_kernel_on_cpu():
    """sim.gravity("auto") above the dense threshold runs the plain blocked
    sum on the CPU: no pallas_call, interpreted or not."""
    from nbx import sim

    pos = jnp.zeros((4096, 3), jnp.float32)
    mass = jnp.ones((4096,), jnp.float32)
    assert not _has_pallas_call(
        lambda p, m: sim.gravity(p, m, 1.0, 0.1), pos, mass)
    assert _has_pallas_call(
        lambda p, m: sim.gravity(p, m, 1.0, 0.1, impl="pallas"), pos, mass)


def test_gravity_auto_takes_kernel_on_gpu(monkeypatch):
    from nbx import sim

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    pos = jnp.zeros((4096, 3), jnp.float32)
    mass = jnp.ones((4096,), jnp.float32)
    assert _has_pallas_call(
        lambda p, m: sim.gravity(p, m, 1.0, 0.1), pos, mass)


def test_collision_interpreter_only_when_asked():
    """The collision pass runs the XLA sweep on the CPU by default and the
    (interpreted) kernel only under interpret=True."""
    from nbx.ops.collide import binned_collision_pass

    rng = np.random.default_rng(0)
    pos = jnp.asarray(rng.uniform(0, 10, (64, 3)), jnp.float32)
    vel = jnp.zeros((64, 3), jnp.float32)
    mass = jnp.ones((64,), jnp.float32)
    rad = jnp.full((64,), 0.5, jnp.float32)

    def run(interpret):
        return lambda p: binned_collision_pass(
            p, vel, mass, rad, 10.0, 2, packed_caps=(64, 64),
            interpret=interpret)[0]

    assert not _has_pallas_call(run(False), pos)
    assert _has_pallas_call(run(True), pos)


def _public_callables():
    import nbx.collisions_scaled
    import nbx.ops.collide
    import nbx.ops.pairwise
    import nbx.parallel.shard
    import nbx.parallel.spatial
    import nbx.serve
    import nbx.bench.drift

    for mod in (nbx.ops.collide, nbx.ops.pairwise, nbx.collisions_scaled,
                nbx.parallel.shard, nbx.parallel.spatial, nbx.serve,
                nbx.bench.drift):
        for name, obj in vars(mod).items():
            if name.startswith("_") or not callable(obj):
                continue
            try:
                sig = inspect.signature(obj)
            except (TypeError, ValueError):
                continue
            if "interpret" in sig.parameters:
                yield f"{mod.__name__}.{name}", sig.parameters["interpret"]


def test_no_public_entry_defaults_to_interpret():
    found = dict(_public_callables())
    assert "nbx.ops.collide.binned_collision_pass" in found
    assert "nbx.serve.BigLiveSim" in found
    for name, param in found.items():
        assert param.default is False, name


def _cache_probe(env_dir):
    """Run a compile with the cache helper in a fresh CPU process; return
    the directory the helper reported."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = (
        "import jax, jax.numpy as jnp\n"
        "from nbx.backend import enable_compile_cache\n"
        "d = enable_compile_cache()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(8)).block_until_ready()\n"
        "print(d)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_uses_env_dir_and_nothing_else(tmp_path):
    target = tmp_path / "cache"
    default = os.path.join(REPO, ".jax_cache")
    before = set(os.listdir(default)) if os.path.isdir(default) else set()
    assert _cache_probe(str(target)) == str(target)
    assert any(target.iterdir())  # written there
    after = set(os.listdir(default)) if os.path.isdir(default) else set()
    assert after == before  # and not in the repo's default


def test_compile_cache_default_is_repo_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    d = backend.enable_compile_cache()
    assert d == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", d)]
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    calls.clear()
    assert backend.enable_compile_cache() == "/elsewhere"
    assert calls == []  # nothing set: JAX reads the variable itself
