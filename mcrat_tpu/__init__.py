"""mcrat_tpu: a JAX Monte Carlo radiative-transfer framework.

A from-scratch JAX/XLA re-design of the capabilities of lazzati-astro/MCRaT
(special-relativistic Monte Carlo photon transport through hydrodynamic GRB-jet
outflows, with polarized Klein-Nishina Compton scattering and cyclo-synchrotron
emission/absorption).

Design principles
-----------------
* Photons are a fixed-capacity structure-of-arrays pytree advanced by batched,
  jit-compiled transport steps (replacing the reference's serial per-event loop,
  Src/mclib.c:1107).
* All physics kernels are pure vectorized functions over ``(N,)`` photon axes.
* Randomness comes from ``jax.random`` keys split per round (ops.rng.make_key
  picks the implementation).
* Multi-device scaling uses ``jax.sharding`` over a device mesh: the photon axis is
  sharded (the analogue of MCRaT's embarrassingly-parallel MPI photon batches),
  the decimated hydro frame is replicated, and statistics ride XLA collectives.
"""

__version__ = "0.1.0"

from . import constants  # noqa: F401
from .config import (  # noqa: F401
    BFieldCalc,
    Config,
    Dims,
    Geometry,
    HydroSim,
    McPar,
    NonthermalDist,
    PhotonType,
    SimType,
    Spectrum,
    TauCalculation,
)
