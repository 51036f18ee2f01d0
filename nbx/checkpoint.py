"""Checkpoint / resume.

Not present in the reference — a page reload loses everything and
resetScenario is the only restore (/root/reference/index.html:744-766,
SURVEY.md section 5). nbx needs real snapshots: long drift gates,
preemptible jobs, and the 10k-step conservation runs all resume
mid-trajectory.

Format: a single .npz holding the flattened SimState pytree (including the
PRNG key and step counter) plus the dynamic SimConfig fields, versioned.
Sharded gravity-only states save the same way (arrays are gathered to host).
orbax is available in the image for async multi-host checkpointing; plain
npz keeps the dependency surface minimal and is byte-stable for tests.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from nbx.config import Materials, SimConfig
from nbx.state import SimState

FORMAT_VERSION = 1


def save_state_orbax(dirpath: str, state: SimState, cfg: SimConfig | None = None):
    """Optional orbax backend (async-capable, multi-host-aware) for large
    sharded states; the npz format remains the default. Stores the same
    pytree; restore with load_state_orbax."""
    import orbax.checkpoint as ocp

    payload = {"state": dataclasses.asdict(state)}
    if payload["state"].get("contact") is None:
        payload["state"].pop("contact")
    if cfg is not None:
        payload["cfg"] = dataclasses.asdict(cfg)
    ckpt = ocp.StandardCheckpointer()
    import os

    ckpt.save(os.path.abspath(dirpath), payload, force=True)
    ckpt.wait_until_finished()


def load_state_orbax(dirpath: str) -> tuple[SimState, SimConfig | None]:
    import os

    import orbax.checkpoint as ocp

    ckpt = ocp.StandardCheckpointer()
    payload = ckpt.restore(os.path.abspath(dirpath))
    skw = dict(payload["state"])
    if "contact" not in skw:
        skw["contact"] = None
    state = SimState(**{k: jnp.asarray(v) if v is not None else None
                        for k, v in skw.items()})
    cfg = None
    if "cfg" in payload:
        ckw = dict(payload["cfg"])
        mats = ckw.pop("materials")
        cfg = SimConfig(
            materials=Materials(**{k: jnp.asarray(v) for k, v in mats.items()}),
            **{k: (v.item() if hasattr(v, "item") and getattr(v, "ndim", 1) == 0
                   else v) for k, v in ckw.items()},
        )
    return state, cfg


def save_sharded_orbax(dirpath: str, state) -> None:
    """Checkpoint a SHARDED state NamedTuple (nbx.parallel.shard
    ShardedState / ShardedBodyState / GranularState on a mesh) via orbax.

    orbax writes jax.Arrays shard-by-shard (multi-host aware), so an N=1M
    state sharded over a slice never materializes on one host — the
    production checkpoint path for BASELINE config 5. Restore with
    load_sharded_orbax into any mesh of the same total shape."""
    import os

    import orbax.checkpoint as ocp

    ckpt = ocp.StandardCheckpointer()
    ckpt.save(os.path.abspath(dirpath), dict(state._asdict()), force=True)
    ckpt.wait_until_finished()


def load_sharded_orbax(dirpath: str, like):
    """Restore a sharded checkpoint INTO the sharding layout of `like` — a
    same-structure state living on the target mesh (e.g. freshly built with
    shard_body_state on zeros). Returns type(like)(**restored): each device
    reads only its own shards, and the mesh may differ from the one that
    saved (orbax reshards on read)."""
    import os

    import orbax.checkpoint as ocp

    abstract = {
        k: jax.ShapeDtypeStruct(v.shape, v.dtype, sharding=v.sharding)
        for k, v in like._asdict().items()
    }
    ckpt = ocp.StandardCheckpointer()
    payload = ckpt.restore(os.path.abspath(dirpath), abstract)
    return type(like)(**payload)


def save_state(path: str, state: SimState, cfg: SimConfig | None = None) -> None:
    """Snapshot a SimState (and optionally the dynamic config) to .npz."""
    arrays = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is not None:
            arrays[f"state.{f.name}"] = np.asarray(v)
    arrays["format_version"] = np.int32(FORMAT_VERSION)
    if cfg is not None:
        for f in dataclasses.fields(cfg):
            v = getattr(cfg, f.name)
            if isinstance(v, Materials):
                arrays["cfg.materials.density"] = np.asarray(v.density)
                arrays["cfg.materials.color1"] = np.asarray(v.color1)
                arrays["cfg.materials.color2"] = np.asarray(v.color2)
            else:
                arrays[f"cfg.{f.name}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_state(path: str) -> tuple[SimState, SimConfig | None]:
    """Restore (state, cfg_or_None). The PRNG key round-trips exactly, so a
    resumed run reproduces the original fracture outcomes bit-for-bit."""
    z = np.load(path)
    version = int(z["format_version"])
    if version != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {version} != {FORMAT_VERSION}")
    skw = {}
    for f in dataclasses.fields(SimState):
        k = f"state.{f.name}"
        if k in z:
            # legacy uint32[2] PRNG keys round-trip as plain arrays
            skw[f.name] = jnp.asarray(z[k])
        elif f.name == "contact":
            skw[f.name] = None
    state = SimState(**skw)

    cfg = None
    if "cfg.G" in z:
        ckw = {}
        for f in dataclasses.fields(SimConfig):
            if f.name == "materials":
                ckw["materials"] = Materials(
                    density=jnp.asarray(z["cfg.materials.density"]),
                    color1=jnp.asarray(z["cfg.materials.color1"]),
                    color2=jnp.asarray(z["cfg.materials.color2"]),
                )
            else:
                k = f"cfg.{f.name}"
                if k in z:
                    v = z[k]
                    ckw[f.name] = v.item() if v.ndim == 0 else v
        cfg = SimConfig(**ckw)
    return state, cfg
