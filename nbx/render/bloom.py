"""Bloom post-process — the UnrealBloomPass analog.

The reference composites RenderPass + UnrealBloomPass(strength 1.2,
radius 0.5, threshold 0.3) (/root/reference/index.html:724-732). This is the
device-side equivalent: threshold the HDR buffer, separable Gaussian blur
at two scales, add back scaled by strength. Pure elementwise + small convs —
XLA fuses it into the frame pipeline.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

STRENGTH = 1.2  # index.html:726
THRESHOLD = 0.3  # index.html:728


def _gauss_kernel(sigma: float, radius: int) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def _blur_axis(img: jax.Array, kernel: jnp.ndarray, axis: int) -> jax.Array:
    """Separable 1D Gaussian along `axis` via shift-and-add over a
    zero-padded copy (static taps — XLA turns this into a fused stencil).
    Zero padding clamps the halo at image edges, matching the reference's
    UnrealBloomPass; jnp.roll would wrap a bright edge body's glow onto the
    opposite border."""
    radius = kernel.shape[0] // 2
    n = img.shape[axis]
    pad = [(0, 0)] * img.ndim
    pad[axis] = (radius, radius)
    padded = jnp.pad(img, pad)
    out = jnp.zeros_like(img)
    for t in range(kernel.shape[0]):
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(t, t + n)
        out = out + kernel[t] * padded[tuple(sl)]
    return out


@partial(jax.jit, static_argnames=("radius",))
def bloom(
    hdr: jax.Array,  # [H, W, 3]
    strength: float = STRENGTH,
    threshold: float = THRESHOLD,
    sigma: float = 3.0,
    radius: int = 8,
) -> jax.Array:
    """hdr -> hdr + strength * blur(max(hdr - threshold, 0)) at two scales
    (a small and a 2x-wider pass approximating the mip-chain bloom)."""
    bright = jnp.maximum(hdr - threshold, 0.0)
    k1 = _gauss_kernel(sigma, radius)
    b1 = _blur_axis(_blur_axis(bright, k1, 0), k1, 1)
    k2 = _gauss_kernel(sigma * 2.5, radius * 2)
    b2 = _blur_axis(_blur_axis(bright, k2, 0), k2, 1)
    return hdr + strength * (0.6 * b1 + 0.4 * b2)
