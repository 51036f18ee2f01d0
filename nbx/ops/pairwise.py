"""Direct-sum softened gravity on the GPU: a Pallas-Triton kernel.

Physics: the reference's computeGravity (/root/reference/index.html:264-291),
Plummer softening, acc_i = G sum_j m_j (p_j - p_i) (d^2 + eps^2)^(-3/2).

Each program owns `block_i` targets, kept in registers, and streams every
source through in tiles of `block_j` with a loop inside the program (the
programs are independent; nothing is carried between them). Per pair the
work is three subtractions, three FMAs for r^2, one rsqrt and four FMAs into
a [block_i, block_j] tile of partial sums that stays in registers across the
loop and is reduced to [block_i] once at the end. It runs on the CUDA cores
in float32, not on the tensor cores: the force law is not a matrix product,
and the mass-folded matrix form of the sum loses digits to cancellation.

Sources past N are masked loads of mass 0, and dead bodies carry mass 0, so
neither exerts force. The self pair cancels exactly (finite weight times a
zero displacement), so eps must be > 0 (nbx.forces.accelerations masks the
diagonal for eps == 0). Targets may differ from the sources (target_pos):
the sharded path computes the force of all bodies on its local shard.

The plain XLA version of the same sum is nbx.forces.accelerations_blocked;
nbx.backend picks between the two.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt


def _gravity_kernel(par_ref, tgt_ref, src_ref, out_ref, *, nt: int, ns: int,
                    block_i: int, block_j: int):
    """par_ref [2] = G, eps^2; tgt_ref [3, nt] target x, y, z;
    src_ref [4, ns] source x, y, z, m; out_ref [3, nt] acceleration."""
    ti = pl.program_id(0) * block_i + jnp.arange(block_i)
    t_ok = ti < nt
    xi, yi, zi = (
        plt.load(tgt_ref.at[c, ti], mask=t_ok, other=0.0)[:, None]
        for c in range(3)
    )
    eps2 = par_ref[1]

    def tile(j, acc):
        sj = j * block_j + jnp.arange(block_j)
        s_ok = sj < ns
        xj, yj, zj, mj = (
            plt.load(src_ref.at[c, sj], mask=s_ok, other=0.0)[None, :]
            for c in range(4)
        )
        dx = xj - xi
        dy = yj - yi
        dz = zj - zi
        inv = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz + eps2)
        w = inv * inv * inv * mj
        ax, ay, az = acc
        return ax + w * dx, ay + w * dy, az + w * dz

    zero = jnp.zeros((block_i, block_j), jnp.float32)
    sums = jax.lax.fori_loop(0, pl.cdiv(ns, block_j), tile, (zero,) * 3)
    g = par_ref[0]
    for c, s in enumerate(sums):
        plt.store(out_ref.at[c, ti], g * jnp.sum(s, axis=1), mask=t_ok)


@functools.partial(
    jax.jit,
    static_argnames=("block_i", "block_j", "interpret"),
)
def pairwise_acc(
    pos: jax.Array,
    mass: jax.Array,
    G,
    softening,
    target_pos: jax.Array | None = None,
    block_i: int = 64,
    block_j: int = 64,
    interpret: bool = False,
) -> jax.Array:
    """Softened gravitational acceleration by the Triton kernel.

    pos [Ns, 3], mass [Ns] -> acceleration at target_pos [Nt, 3] (targets
    default to the sources). block_i and block_j (powers of two) shape the
    [block_i, block_j] pair tile; the defaults were the fastest of a sweep
    on an H100 at 262k (PERF.md: tiles of 8k elements or more spill).
    interpret=True runs the kernel in the Pallas interpreter (tests)."""
    for b in (block_i, block_j):
        if b & (b - 1):
            raise ValueError(f"block sizes must be powers of two, got {b}")
    if target_pos is None:
        target_pos = pos
    nt, ns = target_pos.shape[0], pos.shape[0]
    f32 = jnp.float32
    tgt = target_pos.astype(f32).T
    src = jnp.concatenate([pos.astype(f32).T, mass.astype(f32)[None]], 0)
    par = jnp.stack([jnp.asarray(G, f32), jnp.asarray(softening, f32) ** 2])
    kernel = functools.partial(
        _gravity_kernel, nt=nt, ns=ns, block_i=block_i, block_j=block_j
    )
    out = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(nt, block_i),),
        out_shape=jax.ShapeDtypeStruct((3, nt), f32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="nbx_gravity",
    )(par, tgt, src)
    return out.T
