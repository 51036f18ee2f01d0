"""nbx — N-body simulation on XLA: a GPU simulation engine in JAX.

Re-implements the capabilities of the reference browser N-body simulator
(Arecibo130117/N-body-sim, a single index.html: three.js + scalar-JS physics)
as an idiomatic JAX/XLA/Pallas framework:

  - fixed-capacity SoA state pytree (nbx.state) instead of a dynamic object array
  - jit-compiled KDK leapfrog stepped under lax.scan (nbx.integrators, nbx.sim)
  - masked data-parallel collision/merge/fracture resolution (nbx.collisions)
  - Pallas-Triton direct-sum kernel for the O(N^2) hot loop (nbx.ops.pairwise)
  - body sharding over a device mesh with per-step all-gather (nbx.parallel)
  - device-side point-splat rendering with async readback (nbx.render)
"""

from nbx.config import SimConfig, Materials, default_materials, ROCK, METAL, ICE
from nbx.state import SimState, empty_state, add_body, add_bodies

__version__ = "0.1.0"
__all__ = [
    "SimConfig", "Materials", "default_materials", "ROCK", "METAL", "ICE",
    "SimState", "empty_state", "add_body", "add_bodies",
]
