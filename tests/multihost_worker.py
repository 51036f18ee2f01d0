"""Worker for tests/test_multihost.py: one process of a two-process
CPU mesh (4 virtual devices each -> 8 global). Every process runs this
same program (the JAX multi-controller model).

Run with env: JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID,
JAX_PLATFORMS=cpu, XLA_FLAGS=--xla_force_host_platform_device_count=4,
NBX_MH_CKPT=<dir>."""

import os
import sys

import numpy as np


def main():
    import jax

    from nbx.parallel import multihost, shard

    multihost.initialize()
    pid = jax.process_index()
    n_proc = jax.process_count()
    assert n_proc == 2, n_proc
    assert len(jax.devices()) == 8, len(jax.devices())
    assert len(jax.local_devices()) == 4

    mesh = multihost.make_host_mesh()
    # host-major axis order: this process's devices are contiguous
    axis_devs = list(mesh.devices.reshape(-1))
    mine = [i for i, d in enumerate(axis_devs) if d.process_index == pid]
    assert mine == list(range(pid * 4, pid * 4 + 4)), mine

    # deterministic global scene; each process passes only ITS slice
    rng = np.random.default_rng(0)
    n = 128
    pos = rng.normal(0, 10, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 1, (n, 3)).astype(np.float32)
    mass = rng.uniform(1, 5, n).astype(np.float32)
    lo, hi = pid * (n // 2), (pid + 1) * (n // 2)
    st = multihost.shard_state_multihost(
        mesh, pos[lo:hi], vel[lo:hi], mass[lo:hi]
    )

    G, eps, h = 0.5, 0.5, 0.01
    step = shard.make_sharded_step(mesh, impl="jnp")
    for _ in range(3):
        st = step(st, G, eps, h)
    ke, pe = shard.sharded_energy(mesh, st, G, eps)
    e = float(ke + pe)
    assert np.isfinite(e)

    # shard-by-shard multi-host checkpoint round trip (orbax)
    try:
        import orbax.checkpoint  # noqa: F401
    except ImportError:
        print(f"MULTIHOST OK pid={pid} E={e:.6f} ckpt=skipped", flush=True)
        return
    from nbx import checkpoint

    d = os.environ["NBX_MH_CKPT"]
    checkpoint.save_sharded_orbax(d, st)
    import jax.numpy as jnp

    like = shard.ShardedState(
        pos=jnp.zeros_like(st.pos), vel=jnp.zeros_like(st.vel),
        acc=jnp.zeros_like(st.acc), mass=jnp.zeros_like(st.mass),
    )
    st2 = checkpoint.load_sharded_orbax(d, like)
    for a, b in zip(st, st2):
        for sa, sb in zip(a.addressable_shards, b.addressable_shards):
            np.testing.assert_array_equal(
                np.asarray(sa.data), np.asarray(sb.data)
            )
    ke2, pe2 = shard.sharded_energy(mesh, st2, G, eps)
    assert float(ke2 + pe2) == e
    print(f"MULTIHOST OK pid={pid} E={e:.6f} ckpt=ok", flush=True)


if __name__ == "__main__":
    sys.exit(main())
