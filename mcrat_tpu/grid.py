"""Hydro frame data structures and device-side spatial indexing.

JAX re-design of the reference's ``struct hydro_dataframe``
(Src/mcrat.h:194-244) and its containing-cell search (Src/geometry.c:350-676).

Two structural upgrades over the reference:

* The reference's uniform-bin ``SpatialGrid`` exists but is **disabled** in the
  hot path (``hydro_data->grid = NULL`` at Src/mcrat_io.c:1985), so every
  photon-cell lookup falls back to an O(N_cells) scan.  Here the spatial index
  is a first-class device structure: a *rectilinear* index (two/three
  ``searchsorted`` calls) for structured grids, and a padded uniform-bin CSR
  index (gather + vectorized AABB tests) for AMR-derived cell lists.
* Frames are structures-of-arrays living directly in HBM; lookups are gathers,
  not pointer chasing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from . import pytree as struct

from .config import Config, Dims, Geometry
from . import geometry as geo
from .constants import A_RAD


@struct.dataclass
class HydroFrame:
    """One hydro snapshot as a pytree of (Ncell,) device arrays.

    Field names mirror the reference hydro_dataframe (Src/mcrat.h:205-225);
    r/theta are the spherical cache used by injection and analytic overwrites
    (filled by fillHydroCoordinateToSpherical, Src/geometry.c:156-174).
    """

    r0: jax.Array
    r1: jax.Array
    r2: jax.Array
    dr0: jax.Array
    dr1: jax.Array
    dr2: jax.Array
    r: jax.Array
    theta: jax.Array
    v0: jax.Array
    v1: jax.Array
    v2: jax.Array
    dens: jax.Array
    dens_lab: jax.Array
    pres: jax.Array
    temp: jax.Array
    gamma: jax.Array
    B0: jax.Array
    B1: jax.Array
    B2: jax.Array
    # domain bounds in hydro coordinates, shape (3, 2)
    domain: jax.Array
    # non-thermal electron number density per cell (zeros when off)
    nonthermal_dens: jax.Array
    # hot-path property matrix (16, Ncell), TRANSPOSED so that gathered
    # per-photon columns are (16, N): the minor axis is the photon axis, so
    # every per-row elementwise op reads a contiguous (N,) vector.  One matrix
    # gather per search replaces ~12 scalar-array gathers.  Row layout in PCOL
    # below; None until to_device packs it.
    packed: Optional[jax.Array] = None

    @property
    def num_elements(self) -> int:
        return self.r0.shape[0]

    def fluid_beta_at(self, cfg: Config, idx, ph_x, ph_y):
        """Fluid 3-velocity (units of c) in MCRaT Cartesian at photon positions.

        Mirrors the hydroVectorToCartesian call pattern at the reference's
        lookup sites (Src/mclib.c:546-555, Src/optical_depth.c:27-36): in 2-D /
        2.5-D the azimuth comes from the photon, atan2(ph_y, ph_x).
        """
        v0 = self.v0[idx]
        v1 = self.v1[idx]
        v2 = self.v2[idx] if cfg.dims is not Dims.TWO else jnp.zeros_like(v0)
        if cfg.dims is Dims.THREE:
            x2 = self.r2[idx]
        else:
            x2 = jnp.arctan2(ph_y, ph_x)
        bx, by, bz = geo.hydro_vector_to_cartesian(
            cfg, v0, v1, v2, self.r0[idx], self.r1[idx], x2
        )
        return jnp.stack([bx, by, bz], axis=-1)


# Row layout of HydroFrame.packed (padded to a multiple of 8 rows; whether
# the padding still pays on the GPU is unmeasured).  For 3-D configs v0..v2 hold the fluid velocity ALREADY in
# MCRaT Cartesian (it is per-cell constant there, so to_device pre-transforms
# it); in 2-D/2.5-D they stay in the hydro basis and the azimuth comes from
# the photon position.  sin1/cos1 cache sin/cos of the cell's angular r1
# coordinate (theta in spherical, phi in 3-D polar) so the membership and
# fluid-basis hot paths need no per-photon inverse trig; 3-D SPHERICAL grids
# additionally cache sin2/cos2 of the cell's azimuth (its phi membership test
# runs in cosine space too), widening the packed matrix from 16 to 24 rows
# for that geometry only.
PCOL = dict(
    r0=0, r1=1, r2=2, dr0=3, dr1=4, dr2=5,
    v0=6, v1=7, v2=8, gamma=9, dens_lab=10, temp=11, nonthermal_dens=12,
    sin1=13, cos1=14,
    sin2=16, cos2=17,  # 3-D spherical only (rows 16+ absent otherwise)
)
PACKED_WIDTH = 16


def packed_width(cfg: Config) -> int:
    """Rows in HydroFrame.packed for this config (16, or 24 for 3-D spherical)."""
    if cfg.dims is Dims.THREE and cfg.geometry is Geometry.SPHERICAL:
        return 24
    return PACKED_WIDTH


def fluid_beta_from_rows(cfg: Config, rows, ph_x, ph_y):
    """Fluid 3-velocity in MCRaT Cartesian from gathered packed columns (16, N).

    Transcendental-free version of the reference's per-lookup
    hydroVectorToCartesian call (Src/mclib.c:546-555): the photon azimuth
    enters only through cos/sin, taken directly from the position components
    (cos phi = x/rho, sin phi = y/rho), and the cell's angular coordinate trig
    is precomputed in the packed rows.
    """
    v0 = rows[PCOL["v0"]]
    v1 = rows[PCOL["v1"]]
    if cfg.dims is Dims.THREE:
        # already Cartesian (pre-transformed in to_device)
        return jnp.stack([v0, v1, rows[PCOL["v2"]]], axis=-1)
    v2 = rows[PCOL["v2"]] if cfg.dims is not Dims.TWO else jnp.zeros_like(v0)
    rho = jnp.sqrt(ph_x * ph_x + ph_y * ph_y)
    has_rho = rho > 0
    safe_rho = jnp.where(has_rho, rho, 1.0)
    c2 = jnp.where(has_rho, ph_x / safe_rho, 1.0)
    s2 = jnp.where(has_rho, ph_y / safe_rho, 0.0)
    g = cfg.geometry
    if g in (Geometry.CARTESIAN, Geometry.CYLINDRICAL):
        # 2-D: (v_r, v_z); 2.5-D adds a phi-hat component v2
        # (reference: Src/geometry.c:199-204, 214-218)
        return jnp.stack([v0 * c2 - v2 * s2, v0 * s2 + v2 * c2, v1], axis=-1)
    if g is Geometry.SPHERICAL:
        s1 = rows[PCOL["sin1"]]
        c1 = rows[PCOL["cos1"]]
        vr_plane = v0 * s1 + v1 * c1  # component in the (x, y) plane
        return jnp.stack(
            [vr_plane * c2 - v2 * s2, vr_plane * s2 + v2 * c2, v0 * c1 - v1 * s1],
            axis=-1,
        )
    raise ValueError(f"unsupported 2-D geometry {g}")


def frame_from_numpy(cfg: Config, arrays: dict, domain=None) -> "HydroFrameHost":
    """Build a host-side frame from a dict of numpy arrays.

    Required keys: r0, r1, dr0, dr1, v0, v1, dens, pres.
    Optional: r2, dr2, v2, B0, B1, B2, dens_lab, temp, gamma.
    Derived quantities follow the reference readers (Src/mclib_flash.c:377-379):
    gamma = 1/sqrt(1 - v^2), dens_lab = rho * gamma, temp = (3 p / a)^(1/4).
    """
    n = len(arrays["r0"])
    z = np.zeros(n)
    r0 = np.asarray(arrays["r0"], dtype=np.float64)
    r1 = np.asarray(arrays["r1"], dtype=np.float64)
    r2 = np.asarray(arrays.get("r2", z), dtype=np.float64)
    v0 = np.asarray(arrays["v0"], dtype=np.float64)
    v1 = np.asarray(arrays["v1"], dtype=np.float64)
    v2 = np.asarray(arrays.get("v2", z), dtype=np.float64)
    dens = np.asarray(arrays["dens"], dtype=np.float64)
    pres = np.asarray(arrays["pres"], dtype=np.float64)
    if "gamma" in arrays:
        gamma = np.asarray(arrays["gamma"], dtype=np.float64)
    else:
        v2sum = v0 * v0 + v1 * v1 + (v2 * v2 if cfg.dims is not Dims.TWO else 0.0)
        gamma = 1.0 / np.sqrt(np.maximum(1.0 - v2sum, 1e-30))
    dens_lab = np.asarray(arrays.get("dens_lab", dens * gamma), dtype=np.float64)
    temp = np.asarray(
        arrays.get("temp", (3.0 * pres / A_RAD) ** 0.25), dtype=np.float64
    )
    import jax.numpy as jnp  # local to keep module import light

    sph_r, sph_theta = geo.hydro_to_spherical(cfg, r0, r1, r2)
    if domain is None:
        dr0 = np.asarray(arrays["dr0"], dtype=np.float64)
        dr1 = np.asarray(arrays["dr1"], dtype=np.float64)
        dr2 = np.asarray(arrays.get("dr2", z), dtype=np.float64)
        domain = np.array(
            [
                [(r0 - dr0 / 2).min(), (r0 + dr0 / 2).max()],
                [(r1 - dr1 / 2).min(), (r1 + dr1 / 2).max()],
                [(r2 - dr2 / 2).min() if cfg.dims is Dims.THREE else 0.0,
                 (r2 + dr2 / 2).max() if cfg.dims is Dims.THREE else 0.0],
            ]
        )
    return HydroFrameHost(
        cfg=cfg,
        r0=r0,
        r1=r1,
        r2=r2,
        dr0=np.asarray(arrays["dr0"], dtype=np.float64),
        dr1=np.asarray(arrays["dr1"], dtype=np.float64),
        dr2=np.asarray(arrays.get("dr2", z), dtype=np.float64),
        r=np.asarray(sph_r),
        theta=np.asarray(sph_theta),
        v0=v0,
        v1=v1,
        v2=v2,
        dens=dens,
        dens_lab=dens_lab,
        pres=pres,
        temp=temp,
        gamma=gamma,
        B0=np.asarray(arrays.get("B0", z), dtype=np.float64),
        B1=np.asarray(arrays.get("B1", z), dtype=np.float64),
        B2=np.asarray(arrays.get("B2", z), dtype=np.float64),
        domain=np.asarray(domain, dtype=np.float64),
    )


@dataclasses.dataclass
class HydroFrameHost:
    """Host (numpy, float64) view of a frame: readers and injection work here."""

    cfg: Config
    r0: np.ndarray
    r1: np.ndarray
    r2: np.ndarray
    dr0: np.ndarray
    dr1: np.ndarray
    dr2: np.ndarray
    r: np.ndarray
    theta: np.ndarray
    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    dens: np.ndarray
    dens_lab: np.ndarray
    pres: np.ndarray
    temp: np.ndarray
    gamma: np.ndarray
    B0: np.ndarray
    B1: np.ndarray
    B2: np.ndarray
    domain: np.ndarray
    nonthermal_dens: Optional[np.ndarray] = None
    # jet axis of the theta cache: "z" (default) or "y" (RIKEN 3-D runs put
    # the jet along +y and measure injection wedges as theta' = acos(y/r),
    # reference: Src/mclib_riken.c:965); the reader that remaps theta sets it
    jet_axis: str = "z"

    @property
    def num_elements(self) -> int:
        return len(self.r0)

    def volumes(self) -> np.ndarray:
        return np.asarray(
            geo.element_volume(self.cfg, self.r0, self.r1, self.r2, self.dr0, self.dr1, self.dr2)
        )

    def to_device(self, dtype=None) -> HydroFrame:
        dt = np.dtype(dtype or self.cfg.dtype)
        n = self.num_elements
        nt = self.nonthermal_dens if self.nonthermal_dens is not None else np.zeros(n)

        def put(a):
            return jnp.asarray(np.asarray(a), dtype=dt)

        packed = np.zeros((packed_width(self.cfg), n))
        if self.cfg.dims is Dims.THREE:
            # 3-D: the Cartesian fluid velocity is per-cell constant, so the
            # hot path never needs a coordinate transform — pre-apply it here.
            vx, vy, vz = geo.hydro_vector_to_cartesian(
                self.cfg, self.v0, self.v1, self.v2, self.r0, self.r1, self.r2
            )
            pv0, pv1, pv2 = np.asarray(vx), np.asarray(vy), np.asarray(vz)
        else:
            pv0, pv1, pv2 = self.v0, self.v1, self.v2
        cols = dict(
            r0=self.r0, r1=self.r1, r2=self.r2,
            dr0=self.dr0, dr1=self.dr1, dr2=self.dr2,
            v0=pv0, v1=pv1, v2=pv2,
            gamma=self.gamma, dens_lab=self.dens_lab, temp=self.temp,
            nonthermal_dens=nt,
            sin1=np.sin(self.r1), cos1=np.cos(self.r1),
        )
        if packed.shape[0] > PACKED_WIDTH:
            cols.update(sin2=np.sin(self.r2), cos2=np.cos(self.r2))
        for name, val in cols.items():
            packed[PCOL[name], :] = val
        return HydroFrame(
            r0=put(self.r0), r1=put(self.r1), r2=put(self.r2),
            dr0=put(self.dr0), dr1=put(self.dr1), dr2=put(self.dr2),
            r=put(self.r), theta=put(self.theta),
            v0=put(self.v0), v1=put(self.v1), v2=put(self.v2),
            dens=put(self.dens), dens_lab=put(self.dens_lab), pres=put(self.pres),
            temp=put(self.temp), gamma=put(self.gamma),
            B0=put(self.B0), B1=put(self.B1), B2=put(self.B2),
            domain=put(self.domain),
            nonthermal_dens=put(nt),
            packed=put(packed),
        )


# ---------------------------------------------------------------------------
# Spatial indices
# ---------------------------------------------------------------------------


@struct.dataclass
class RectilinearIndex:
    """Structured-grid index: cell (i, j[, k]) from the edge arrays.

    Exact point location for rectilinear grids (PLUTO .dbl grids from
    grid.out cell edges, synthetic/analytic grids, RIKEN remapped grids).
    Uniformly-spaced axes (detected at build time) use O(1) arithmetic
    ``floor((x - lo) * inv_d)`` in place of a search; non-uniform axes fall
    back to a compare-all search.  Cell SoA order must be C-order raveled
    meshgrid: idx = (i*n1 + j)*n2 + k.
    """

    edges0: jax.Array
    edges1: jax.Array
    edges2: jax.Array  # length 2 dummy for 2-D
    # per-axis uniform-spacing parameters: lo[a] = edges[0], inv_d[a] = 1/dx
    # (unused entries are 0/1 so the pytree shape is static)
    lo: jax.Array = struct.field(default=None)
    inv_d: jax.Array = struct.field(default=None)
    uniform: tuple = struct.field(pytree_node=False, default=(False, False, False))
    three_d: bool = struct.field(pytree_node=False, default=False)

    def axis_index(self, axis: int, x):
        """Cell index along one axis (clipped), arithmetic or searchsorted."""
        edges = (self.edges0, self.edges1, self.edges2)[axis]
        n = edges.shape[0] - 1
        if self.uniform[axis] and self.lo is not None:
            i = jnp.floor((x - self.lo[axis]) * self.inv_d[axis]).astype(jnp.int32)
        else:
            # method="compare_all": one broadcast compare over the (small)
            # edge table instead of log-depth dependent gathers
            i = jnp.searchsorted(edges, x, side="right", method="compare_all") - 1
        return jnp.clip(i, 0, n - 1)

    def find(self, r0, r1, r2, frame: HydroFrame, cached):
        n1 = self.edges1.shape[0] - 1
        i = self.axis_index(0, r0)
        j = self.axis_index(1, r1)
        inside = (
            (r0 >= self.edges0[0]) & (r0 <= self.edges0[-1])
            & (r1 >= self.edges1[0]) & (r1 <= self.edges1[-1])
        )
        if self.three_d:
            n2 = self.edges2.shape[0] - 1
            k = self.axis_index(2, r2)
            inside = inside & (r2 >= self.edges2[0]) & (r2 <= self.edges2[-1])
            idx = (i * n1 + j) * n2 + k
        else:
            idx = i * n1 + j
        return jnp.where(inside, idx, -1)


@struct.dataclass
class BinnedIndex:
    """Uniform-bin CSR index over an unstructured cell list (AMR output).

    JAX version of the reference's (disabled) SpatialGrid
    (Src/geometry.c:423-676): cells are counting-sorted into uniform bins; a
    photon gathers the candidate lists of its bin's +/-1 neighborhood (the bin
    size is >= the largest cell size per axis, so the containing cell's center
    is always within one bin of the photon) and runs a vectorized AABB test
    over a fixed-width padded candidate slab.
    """

    cell_ids: jax.Array  # (ncell,) cells sorted by flat bin id
    bin_start: jax.Array  # (nbins,)
    bin_count: jax.Array  # (nbins,)
    grid_min: jax.Array  # (3,)
    inv_bin: jax.Array  # (3,) 1/bin_size
    dims: tuple = struct.field(pytree_node=False, default=(1, 1, 1))
    max_slab: int = struct.field(pytree_node=False, default=64)

    def find(self, r0, r1, r2, frame: HydroFrame, cached):
        d0, d1, d2 = self.dims
        use_r2 = d2 > 1
        i = jnp.clip(((r0 - self.grid_min[0]) * self.inv_bin[0]).astype(jnp.int32), 0, d0 - 1)
        j = jnp.clip(((r1 - self.grid_min[1]) * self.inv_bin[1]).astype(jnp.int32), 0, d1 - 1)
        k = jnp.clip(((r2 - self.grid_min[2]) * self.inv_bin[2]).astype(jnp.int32), 0, d2 - 1)

        found = jnp.full(r0.shape, -1, dtype=jnp.int32)
        offs = [-1, 0, 1]
        for dz in (offs if use_r2 else [0]):
            for dy in offs:
                for dx in offs:
                    ii = jnp.clip(i + dx, 0, d0 - 1)
                    jj = jnp.clip(j + dy, 0, d1 - 1)
                    kk = jnp.clip(k + dz, 0, d2 - 1)
                    flat = (kk * d1 + jj) * d0 + ii
                    start = self.bin_start[flat]
                    count = self.bin_count[flat]
                    # padded gather of up to max_slab candidates from this bin
                    lane = jnp.arange(self.max_slab, dtype=jnp.int32)
                    gidx = start[..., None] + lane
                    valid = lane < count[..., None]
                    cand = self.cell_ids[jnp.clip(gidx, 0, self.cell_ids.shape[0] - 1)]
                    ok = geo.in_block(
                        r0[..., None], r1[..., None], r2[..., None],
                        frame.r0[cand], frame.r1[cand], frame.r2[cand],
                        frame.dr0[cand], frame.dr1[cand], frame.dr2[cand],
                        use_r2=use_r2,
                    ) & valid
                    hit = jnp.argmax(ok, axis=-1)
                    any_hit = jnp.any(ok, axis=-1)
                    cand_hit = jnp.take_along_axis(cand, hit[..., None], axis=-1)[..., 0]
                    found = jnp.where((found < 0) & any_hit, cand_hit, found)
        return found


def build_binned_index(host: HydroFrameHost, target_bins: int = 1 << 20, max_slab_cap: int = 512):
    """Host-side construction of a BinnedIndex (counting sort + prefix sums).

    Equivalent of buildSpatialGrid (reference: Src/geometry.c:526-676) with one
    correctness fix: bin sizes are floored at the largest cell size per axis so
    the +/-1 neighborhood search cannot miss a containing cell (the reference
    hard-codes a cubic ~20-cells-per-bin grid and hopes).
    """
    cfg = host.cfg
    use_r2 = cfg.dims is Dims.THREE
    n = host.num_elements
    lo = np.array([
        (host.r0 - host.dr0 / 2).min(),
        (host.r1 - host.dr1 / 2).min(),
        (host.r2 - host.dr2 / 2).min() if use_r2 else 0.0,
    ])
    hi = np.array([
        (host.r0 + host.dr0 / 2).max(),
        (host.r1 + host.dr1 / 2).max(),
        (host.r2 + host.dr2 / 2).max() if use_r2 else 1.0,
    ])
    span = np.maximum(hi - lo, 1e-300)
    max_cell = np.array([
        host.dr0.max(),
        host.dr1.max(),
        host.dr2.max() if use_r2 else span[2],
    ])
    ndim = 3 if use_r2 else 2
    per_axis = max(1, int(round(target_bins ** (1.0 / ndim))))
    bin_size = np.maximum(span / per_axis, max_cell)
    dims = np.maximum((span / bin_size).astype(int), 1)
    if not use_r2:
        dims[2] = 1
        bin_size[2] = span[2]
    inv_bin = 1.0 / bin_size

    from . import native

    order, starts, counts = native.build_binned_index(
        host.r0, host.r1, host.r2, lo, 1.0 / bin_size, dims
    )
    max_slab = int(min(max(counts.max(), 1), max_slab_cap))
    dt = host.cfg.np_dtype()
    return BinnedIndex(
        cell_ids=jnp.asarray(order),
        bin_start=jnp.asarray(starts),
        bin_count=jnp.asarray(counts),
        grid_min=jnp.asarray(lo, dtype=dt),
        inv_bin=jnp.asarray(inv_bin, dtype=dt),
        dims=(int(dims[0]), int(dims[1]), int(dims[2])),
        max_slab=max_slab,
    )


def _axis_uniform(edges: np.ndarray) -> bool:
    d = np.diff(edges)
    return bool(d.size > 0 and np.allclose(d, d[0], rtol=1e-5, atol=0.0))


def build_rectilinear_index(edges0, edges1, edges2=None, dtype=np.float64):
    e0 = np.asarray(edges0)
    e1 = np.asarray(edges1)
    e2 = np.asarray(edges2) if edges2 is not None else np.array([0.0, 1.0])
    uniform = (_axis_uniform(e0), _axis_uniform(e1), _axis_uniform(e2))
    lo = np.array([e0[0], e1[0], e2[0]])
    d = np.array([
        (e0[-1] - e0[0]) / max(e0.size - 1, 1),
        (e1[-1] - e1[0]) / max(e1.size - 1, 1),
        (e2[-1] - e2[0]) / max(e2.size - 1, 1),
    ])
    inv_d = 1.0 / np.where(d > 0, d, 1.0)
    return RectilinearIndex(
        edges0=jnp.asarray(e0, dtype=dtype),
        edges1=jnp.asarray(e1, dtype=dtype),
        edges2=jnp.asarray(e2, dtype=dtype),
        lo=jnp.asarray(lo, dtype=dtype),
        inv_d=jnp.asarray(inv_d, dtype=dtype),
        uniform=uniform,
        three_d=edges2 is not None,
    )


def find_cell_rows(cfg: Config, index, frame: HydroFrame, pos, cached, row):
    """Containing-cell lookup carrying the (16, N) packed property columns.

    The carried columns make the reference's per-photon ``checkInBlock`` fast
    path (Src/mclib.c:510-520) a pure elementwise AABB test — no gather needed to
    decide whether a photon stayed in its cell.  The index search + one packed
    gather then resolve the movers; photons still in their cached cell keep the
    carried values (this also pins the cell choice for points on cell seams).

    The search runs unconditionally, not under ``lax.cond(any(miss))``: a
    cond whose branches return (16, N) buffers splits the fusion of the
    surrounding round body.

    Vectorizes findContainingHydroCell (reference: Src/mclib.c:436-615).
    Returns (cell, row, in_grid).
    """
    r0, r1, r2 = geo.mcrat_to_hydro(cfg, pos[..., 0], pos[..., 1], pos[..., 2])
    use_r2 = cfg.dims is Dims.THREE
    dom = frame.domain
    inside = (
        (r0 > dom[0, 0]) & (r0 < dom[0, 1]) & (r1 > dom[1, 0]) & (r1 < dom[1, 1])
    )
    if use_r2:
        inside = inside & (r2 > dom[2, 0]) & (r2 < dom[2, 1])
    in_cached = (cached >= 0) & geo.in_block(
        r0, r1, r2,
        row[PCOL["r0"]], row[PCOL["r1"]], row[PCOL["r2"]],
        row[PCOL["dr0"]], row[PCOL["dr1"]], row[PCOL["dr2"]],
        use_r2=use_r2,
    )
    s_cell = index.find(r0, r1, r2, frame, cached)
    s_row = frame.packed[:, jnp.clip(s_cell, 0, frame.num_elements - 1)]
    cell = jnp.where(in_cached, cached, s_cell)
    row_out = jnp.where(in_cached[None, :], row, s_row)
    cell = jnp.where(inside, cell, -1)
    return cell, row_out, inside & (cell >= 0)


def gather_rows(frame: HydroFrame, cell):
    """One packed-column gather (seeds the carried (16, N) rows before a loop)."""
    safe = jnp.clip(cell, 0, frame.num_elements - 1)
    return frame.packed[:, safe]


def find_cell(cfg: Config, index, frame: HydroFrame, pos, cached):
    """Containing-cell lookup with cached fast path.

    Vectorized findContainingHydroCell core (reference: Src/mclib.c:436-615):
    first the cached cell is AABB-tested; only the misses take the index search
    result.  Photons outside the domain get cell = -1 (huge-mfp sentinel,
    reference: mclib.c:589-595).
    """
    r0, r1, r2 = geo.mcrat_to_hydro(cfg, pos[..., 0], pos[..., 1], pos[..., 2])
    use_r2 = cfg.dims is Dims.THREE
    dom = frame.domain
    inside = (
        (r0 > dom[0, 0]) & (r0 < dom[0, 1]) & (r1 > dom[1, 0]) & (r1 < dom[1, 1])
    )
    if use_r2:
        inside = inside & (r2 > dom[2, 0]) & (r2 < dom[2, 1])
    safe_cached = jnp.clip(cached, 0, frame.num_elements - 1)
    if frame.packed is not None:
        crow = frame.packed[:, safe_cached]
        c0, c1, c2 = crow[PCOL["r0"]], crow[PCOL["r1"]], crow[PCOL["r2"]]
        s0, s1, s2 = crow[PCOL["dr0"]], crow[PCOL["dr1"]], crow[PCOL["dr2"]]
    else:
        c0, c1, c2 = frame.r0[safe_cached], frame.r1[safe_cached], frame.r2[safe_cached]
        s0, s1, s2 = frame.dr0[safe_cached], frame.dr1[safe_cached], frame.dr2[safe_cached]
    in_cached = (cached >= 0) & geo.in_block(
        r0, r1, r2, c0, c1, c2, s0, s1, s2, use_r2=use_r2,
    )

    # Skip the index search entirely when every in-domain photon is still in
    # its cached cell — in optically thick regions (mfp << cell size) most
    # rounds take this branch (lax.cond with a scalar predicate).
    need_search = inside & ~in_cached

    def do_search(_):
        return index.find(r0, r1, r2, frame, cached)

    def no_search(_):
        return jnp.full_like(cached, -1)

    searched = jax.lax.cond(jnp.any(need_search), do_search, no_search, None)
    idx = jnp.where(in_cached, cached, searched)
    return jnp.where(inside, idx, -1), in_cached
