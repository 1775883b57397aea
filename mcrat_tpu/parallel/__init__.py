"""Distribution layer: device meshes, photon-axis sharding, collectives.

The reference distributes work with MPI over two embarrassingly-parallel axes —
viewing-angle bins x injection frames — plus OpenMP threads within a rank
(SURVEY.md section 2.6).  Photons never migrate between ranks; communication is
limited to startup metadata, a cross-section-table broadcast, and merge-time
file collectives.

The JAX analogue implemented here:

* photon-population sharding over a ``jax.sharding.Mesh`` axis ("batch"):
  each device transports its photon shard independently inside ``shard_map``
  (the per-shard ``while_loop`` mirrors ranks running ahead independently);
* the decimated hydro frame and the spatial index are replicated (they are
  small by construction — the reference decimates every frame to the photon
  shell, Src/mclib_flash.c:284-328);
* statistics ride XLA collectives (``psum``) instead of MPI_Reduce;
* the angle-bin x injection-frame outer sweep remains embarrassingly parallel
  and is scheduled over hosts/slices by the driver.
"""

from .mesh import make_mesh, pad_capacity, shard_photons, sharded_transport_frame  # noqa: F401
