"""Test-session bootstrap.

The suite runs on the CPU backend with 8 virtual devices, so the
multi-device tests (tests/test_shard.py, tests/test_spatial.py, the sharded
checkpoint tests) get a mesh: the device-count flag goes into XLA_FLAGS
here, before anything imports JAX. Tests marked `gpu` run only when JAX's
backend is a GPU (`python -m pytest -m gpu tests/test_gpu.py` on the card);
elsewhere the `_gpu_only` fixture skips them with a reason.
"""

import os

_FLAG = "--xla_force_host_platform_device_count"
if _FLAG not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + f" {_FLAG}=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")


def _n_maps() -> int:
    """Current VMA count of this process (Linux); 0 where unreadable."""
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


@pytest.fixture(autouse=True)
def _map_count_guard():
    """Drop jit caches when the process nears the kernel's vm.max_map_count.

    Every XLA:CPU executable the suite compiles stays alive in jax's
    in-process caches, and each holds JIT code pages + guard mappings: a
    long session accumulates tens of thousands of VMAs, and at the
    kernel's default vm.max_map_count=65530 LLVM's next mmap fails (a
    SIGSEGV inside a compile). Clearing caches frees the executables and
    their mappings; the threshold keeps the recompiles rare."""
    if _n_maps() > 45_000:
        jax.clear_caches()
    yield


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip tests marked `gpu` unless JAX's backend is a GPU (decided when
    the test runs, never at import: every xdist worker collects the same
    tests)."""
    if request.node.get_closest_marker("gpu") is not None:
        backend = jax.default_backend()
        if backend != "gpu":
            pytest.skip(f"needs a GPU (backend is {backend})")
    yield


@pytest.fixture(scope="session")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jax.devices()[:8]
