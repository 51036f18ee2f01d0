"""The one place that decides how each mechanism runs, and where compiled
code is cached.

Two mechanisms have a hand-written kernel beside their plain XLA version:
direct-sum gravity (nbx.ops.pairwise) and the collision window sweep
(nbx.ops.collide). On an NVIDIA GPU each runs whichever of the two measured
faster on an H100 (PERF.md, "Kernel choices on the H100"); every other
backend runs the plain XLA version. The Pallas interpreter runs a kernel only
when a caller passes interpret=True, which only tests do.
"""

from __future__ import annotations

import os

import jax

# Winner on the GPU per mechanism: "triton" (the Pallas-Triton kernel) or
# "xla" (the plain jax.numpy version).
GPU_CHOICE = {"gravity": "triton", "collide": "triton"}

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_impl(mechanism: str, interpret: bool = False) -> str:
    """"triton" or "xla" for `mechanism` on the default backend.

    interpret=True selects the Triton kernel, to be run by the Pallas
    interpreter: the way tests reach the kernel's arithmetic on the CPU."""
    if mechanism not in GPU_CHOICE:
        raise ValueError(f"unknown mechanism {mechanism!r}")
    if interpret:
        return "triton"
    if jax.default_backend() == "gpu":
        return GPU_CHOICE[mechanism]
    return "xla"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    set here. Otherwise the cache goes to <repo>/.jax_cache (git-ignored),
    a fixed path, so later processes find what earlier ones compiled."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
