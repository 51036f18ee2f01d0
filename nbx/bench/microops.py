"""Micro-benchmark: scatter-shaped event-machinery primitives vs
scatter-free rewrites.

The collision event machinery (nbx.collisions_scaled) is built from a
handful of O(N) primitives; several have a scatter form and a scatter-free
form, and which is faster depends on the device (on a GPU a scatter is
atomics or a sort):

  * take_rows (first-k indices of a mask): rank-scatter vs searchsorted
    over the mask's cumsum (k binary searches, no scatter; the form the
    code uses);
  * merge-secondary kill flags: N-scatter of True at partner indices vs
    pure arithmetic `mask & (i > partner)` (valid because the gates are
    bitwise-symmetric between mutual partners — nbx.parallel.spatial
    module docstring; the form the code uses);
  * inverse permutation: N-scatter of arange vs argsort(order) (the form
    the code uses).

Each variant is one lax.scan whose iterations form a data-dependency
chain; after a warm-up call, the best of 3 calls ended by
block_until_ready is reported, all variants in ONE process.

    python -m nbx.bench.microops [n ...]   # default 131072 1048576
"""

from __future__ import annotations

import functools
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

K = 256  # extraction cap (f_cap * frag_k scale)
STEPS = 300


def _take_rows_scatter(mask, k):
    n = mask.shape[0]
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    tgt = jnp.where(mask & (rank < k), rank, k)
    idx = jnp.full((k,), n, jnp.int32).at[tgt].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop"
    )
    return jnp.minimum(idx, n - 1), idx < n


def _take_rows_searchsorted(mask, k):
    n = mask.shape[0]
    csum = jnp.cumsum(mask.astype(jnp.int32))
    want = jnp.arange(1, k + 1, dtype=jnp.int32)
    idx = jnp.searchsorted(csum, want, side="left").astype(jnp.int32)
    valid = want <= csum[-1]
    return jnp.minimum(idx, n - 1), valid


def _kill_scatter(mask, partner):
    n = mask.shape[0]
    prim = mask & (jnp.arange(n, dtype=jnp.int32) < partner)
    return jnp.zeros((n,), bool).at[
        jnp.where(prim, partner, n)
    ].set(True, mode="drop")


def _kill_arith(mask, partner):
    n = mask.shape[0]
    return mask & (jnp.arange(n, dtype=jnp.int32) > partner)


def _inv_scatter(order):
    n = order.shape[0]
    return jnp.zeros((n,), jnp.int32).at[order].set(
        jnp.arange(n, dtype=jnp.int32)
    )


def _inv_argsort(order):
    return jnp.argsort(order).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("variant", "steps", "n"))
def _loop(mask0, partner, order, variant, steps, n):
    """Chained scan: each iteration's output perturbs the next input."""

    def body(carry, _):
        mask, acc = carry
        if variant == "take_scatter":
            idx, valid = _take_rows_scatter(mask, K)
            out = jnp.sum(jnp.where(valid, idx, 0))
        elif variant == "take_search":
            idx, valid = _take_rows_searchsorted(mask, K)
            out = jnp.sum(jnp.where(valid, idx, 0))
        elif variant == "kill_scatter":
            out = jnp.sum(_kill_scatter(mask, partner).astype(jnp.int32))
        elif variant == "kill_arith":
            out = jnp.sum(_kill_arith(mask, partner).astype(jnp.int32))
        elif variant == "inv_scatter":
            out = jnp.sum(_inv_scatter(jnp.roll(order, acc % 7)))
        elif variant == "inv_argsort":
            out = jnp.sum(_inv_argsort(jnp.roll(order, acc % 7)))
        else:
            raise ValueError(variant)
        # data dependency: rotate the mask by a result-derived amount
        mask = jnp.roll(mask, (out % 3) + 1)
        return (mask, acc + out), None

    (mask, acc), _ = jax.lax.scan(body, (mask0, jnp.int32(0)), None,
                                  length=steps)
    return acc


def main(argv):
    ns = [int(x) for x in argv] or [131072, 1048576]
    rng = np.random.default_rng(0)
    for n in ns:
        mask0 = jnp.asarray(rng.random(n) < 0.01)
        partner = jnp.asarray(
            rng.integers(0, n, n, dtype=np.int32)
        )
        order = jnp.asarray(rng.permutation(n).astype(np.int32))
        for variant in ("take_scatter", "take_search", "kill_scatter",
                        "kill_arith", "inv_scatter", "inv_argsort"):
            # warm the exact executable
            jax.block_until_ready(
                _loop(mask0, partner, order, variant, STEPS, n))
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                jax.block_until_ready(
                    _loop(mask0, partner, order, variant, STEPS, n))
                best = min(best, time.perf_counter() - t0)
            print(json.dumps(dict(
                n=n, variant=variant,
                us_per_op=round(best / STEPS * 1e6, 1),
            )), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
