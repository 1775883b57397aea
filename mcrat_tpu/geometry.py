"""Vectorized coordinate geometry.

JAX re-design of the reference geometry layer (Src/geometry.c).  The
reference selects one (DIMENSIONS x GEOMETRY) combination at compile time via
``#if`` forests; here every transform is a pure batched function dispatching on
the static :class:`~mcrat_tpu.config.Config` at trace time, so a single build
supports the full geometry matrix and XLA sees only straight-line vector code.

Coordinate conventions (reference: Src/mcrat.h:196-204):

====================  =========================================
Grid system           coordinate order (r0, r1, r2) / (v0, v1, v2)
====================  =========================================
3-D Cartesian         x, y, z
3-D Spherical         r, theta, phi
3-D Polar             r, phi, z
2-D Cartesian         x, z
2-D Cylindrical       r, z (phi)   [2.5-D stores a phi-hat vector comp.]
2-D Spherical         r, theta, (phi)
====================  =========================================

Photons always live in 3-D Cartesian "MCRaT coordinates".
"""
from __future__ import annotations

import jax.numpy as jnp

from ._xp import xp_for
from .config import Config, Dims, Geometry


def mcrat_to_hydro(cfg: Config, x, y, z):
    """Photon Cartesian position -> hydro-native coordinates.

    Vectorized equivalent of mcratCoordinateToHydroCoordinate
    (reference: Src/geometry.c:15-64). Returns (r0, r1, r2); in 2-D, r2 is 0.
    """
    jnp = xp_for(x, y, z)  # numpy on host, jax.numpy when traced
    if cfg.dims is Dims.THREE:
        if cfg.geometry is Geometry.CARTESIAN:
            return x, y, z
        if cfg.geometry is Geometry.SPHERICAL:
            r = jnp.sqrt(x * x + y * y + z * z)
            theta = jnp.arccos(jnp.clip(z / r, -1.0, 1.0))
            # phi in [0, 2pi) (reference: geometry.c:49 uses fmod(atan2+360, 360))
            phi = jnp.mod(jnp.arctan2(y, x) + 2.0 * jnp.pi, 2.0 * jnp.pi)
            return r, theta, phi
        if cfg.geometry is Geometry.POLAR:
            r = jnp.sqrt(x * x + y * y)
            phi = jnp.mod(jnp.arctan2(y, x) + 2.0 * jnp.pi, 2.0 * jnp.pi)
            return r, phi, z
        raise ValueError(f"unsupported 3-D geometry {cfg.geometry}")
    # 2-D / 2.5-D, axisymmetric about the jet (z) axis
    if cfg.geometry in (Geometry.CARTESIAN, Geometry.CYLINDRICAL):
        r0 = jnp.sqrt(x * x + y * y)
        r1 = z
    elif cfg.geometry is Geometry.SPHERICAL:
        r0 = jnp.sqrt(x * x + y * y + z * z)
        r1 = jnp.arccos(jnp.clip(z / r0, -1.0, 1.0))
    else:
        raise ValueError(f"unsupported 2-D geometry {cfg.geometry}")
    return r0, r1, jnp.zeros_like(r0)


def hydro_to_spherical(cfg: Config, r0, r1, r2):
    """Hydro coordinates -> spherical (r, theta measured from jet axis).

    Vectorized equivalent of hydroCoordinateToSpherical (reference:
    Src/geometry.c:66-106).
    """
    jnp = xp_for(r0, r1, r2)  # numpy on host, jax.numpy when traced
    if cfg.dims is Dims.THREE:
        if cfg.geometry is Geometry.CARTESIAN:
            r = jnp.sqrt(r0 * r0 + r1 * r1 + r2 * r2)
            theta = jnp.arccos(jnp.clip(r2 / r, -1.0, 1.0))
            return r, theta
        if cfg.geometry is Geometry.SPHERICAL:
            return r0, r1
        if cfg.geometry is Geometry.POLAR:
            r = jnp.sqrt(r0 * r0 + r2 * r2)
            theta = jnp.arccos(jnp.clip(r2 / r, -1.0, 1.0))
            return r, theta
        raise ValueError(f"unsupported 3-D geometry {cfg.geometry}")
    if cfg.geometry in (Geometry.CARTESIAN, Geometry.CYLINDRICAL):
        r = jnp.sqrt(r0 * r0 + r1 * r1)
        # NB: atan2(r0, r1) measures theta from the jet (r1) axis, matching the
        # reference exactly (Src/geometry.c:75).
        theta = jnp.arctan2(r0, r1)
        return r, theta
    if cfg.geometry is Geometry.SPHERICAL:
        return r0, r1
    raise ValueError(f"unsupported 2-D geometry {cfg.geometry}")


def hydro_to_mcrat(cfg: Config, r0, r1, r2):
    """Hydro coordinates -> MCRaT 3-D Cartesian.

    Vectorized equivalent of hydroCoordinateToMcratCoordinate (reference:
    Src/geometry.c:108-154). In 2-D, pass the azimuth phi in ``r2`` (the system
    is axisymmetric, so the caller chooses phi).
    """
    jnp = xp_for(r0, r1, r2)  # numpy on host, jax.numpy when traced
    if cfg.dims is Dims.THREE:
        if cfg.geometry is Geometry.CARTESIAN:
            return r0, r1, r2
        if cfg.geometry is Geometry.SPHERICAL:
            st, ct = jnp.sin(r1), jnp.cos(r1)
            return r0 * st * jnp.cos(r2), r0 * st * jnp.sin(r2), r0 * ct
        if cfg.geometry is Geometry.POLAR:
            return r0 * jnp.cos(r1), r0 * jnp.sin(r1), r2
        raise ValueError(f"unsupported 3-D geometry {cfg.geometry}")
    if cfg.geometry in (Geometry.CARTESIAN, Geometry.CYLINDRICAL):
        return r0 * jnp.cos(r2), r0 * jnp.sin(r2), r1
    if cfg.geometry is Geometry.SPHERICAL:
        st, ct = jnp.sin(r1), jnp.cos(r1)
        return r0 * st * jnp.cos(r2), r0 * st * jnp.sin(r2), r0 * ct
    raise ValueError(f"unsupported 2-D geometry {cfg.geometry}")


def hydro_vector_to_cartesian(cfg: Config, v0, v1, v2, x0, x1, x2):
    """Hydro-basis vector at position (x0,x1,x2) -> 3-D Cartesian components.

    Vectorized equivalent of hydroVectorToCartesian (reference:
    Src/geometry.c:189-253). In 2-D/2.5-D pass the azimuth phi as ``x2``.
    2.5-D carries a phi-hat component in v2 with (r, z, phi) ordering
    (reference: geometry.c:214-218).
    """
    jnp = xp_for(v0, v1, v2, x0, x1, x2)  # numpy on host, jax.numpy when traced
    g, d = cfg.geometry, cfg.dims
    if d is Dims.TWO:
        if g in (Geometry.CARTESIAN, Geometry.CYLINDRICAL):
            return v0 * jnp.cos(x2), v0 * jnp.sin(x2), v1
        if g is Geometry.SPHERICAL:
            s1, c1 = jnp.sin(x1), jnp.cos(x1)
            s2, c2 = jnp.sin(x2), jnp.cos(x2)
            # no phi-hat component of the vector in 2-D (reference: geometry.c:206)
            return (
                v0 * s1 * c2 + v1 * c1 * c2,
                v0 * s1 * s2 + v1 * c1 * s2,
                v0 * c1 - v1 * s1,
            )
        raise ValueError(f"unsupported 2-D geometry {g}")
    if d is Dims.TWO_POINT_FIVE:
        if g in (Geometry.CARTESIAN, Geometry.CYLINDRICAL):
            s2, c2 = jnp.sin(x2), jnp.cos(x2)
            return v0 * c2 - v2 * s2, v0 * s2 + v2 * c2, v1
        if g is Geometry.SPHERICAL:
            s1, c1 = jnp.sin(x1), jnp.cos(x1)
            s2, c2 = jnp.sin(x2), jnp.cos(x2)
            return (
                v0 * s1 * c2 + v1 * c1 * c2 - v2 * s2,
                v0 * s1 * s2 + v1 * c1 * s2 + v2 * c2,
                v0 * c1 - v1 * s1,
            )
        raise ValueError(f"unsupported 2.5-D geometry {g}")
    # 3-D
    if g is Geometry.CARTESIAN:
        return v0, v1, v2
    if g is Geometry.SPHERICAL:
        s1, c1 = jnp.sin(x1), jnp.cos(x1)
        s2, c2 = jnp.sin(x2), jnp.cos(x2)
        return (
            v0 * s1 * c2 + v1 * c1 * c2 - v2 * s2,
            v0 * s1 * s2 + v1 * c1 * s2 + v2 * c2,
            v0 * c1 - v1 * s1,
        )
    if g is Geometry.POLAR:
        s1, c1 = jnp.sin(x1), jnp.cos(x1)
        return v0 * c1 - v1 * s1, v0 * s1 + v1 * c1, v2
    raise ValueError(f"unsupported 3-D geometry {g}")


def element_volume(cfg: Config, r0, r1, r2, dr0, dr1, dr2):
    """Cell volumes; axisymmetric (2 pi swept) in 2-D.

    Vectorized equivalent of hydroElementVolume (reference: Src/geometry.c:255-296).
    """
    jnp = xp_for(r0, r1, dr0, dr1)  # numpy on host, jax.numpy when traced
    r0_min, r0_max = r0 - 0.5 * dr0, r0 + 0.5 * dr0
    r1_min, r1_max = r1 - 0.5 * dr1, r1 + 0.5 * dr1
    g = cfg.geometry
    if cfg.dims is not Dims.THREE:
        if g in (Geometry.CARTESIAN, Geometry.CYLINDRICAL):
            return jnp.pi * (r0_max * r0_max - r0_min * r0_min) * dr1
        if g is Geometry.SPHERICAL:
            return (
                (2.0 * jnp.pi / 3.0)
                * (r0_max**3 - r0_min**3)
                * (jnp.cos(r1_min) - jnp.cos(r1_max))
            )
        raise ValueError(f"unsupported 2-D geometry {g}")
    r2_min, r2_max = r2 - 0.5 * dr2, r2 + 0.5 * dr2
    if g is Geometry.CARTESIAN:
        return dr0 * dr1 * dr2
    if g is Geometry.SPHERICAL:
        return (
            (1.0 / 3.0)
            * (r0_max**3 - r0_min**3)
            * (jnp.cos(r1_min) - jnp.cos(r1_max))
            * (r2_max - r2_min)
        )
    if g is Geometry.POLAR:
        return 0.5 * (r0_max * r0_max - r0_min * r0_min) * dr1 * dr2
    raise ValueError(f"unsupported 3-D geometry {g}")


def in_block(r0, r1, r2, c0, c1, c2, s0, s1, s2, use_r2: bool):
    """AABB point-in-cell test, 2|x-c| - size <= 0 per axis.

    Vectorized equivalent of checkInBlock (reference: Src/geometry.c:394-417).
    Broadcasts photon coords against candidate cell centers/sizes.
    """
    jnp = xp_for(r0, r1, c0, c1)  # numpy on host, jax.numpy when traced
    ok = (2.0 * jnp.abs(r0 - c0) - s0 <= 0) & (2.0 * jnp.abs(r1 - c1) - s1 <= 0)
    if use_r2:
        ok = ok & (2.0 * jnp.abs(r2 - c2) - s2 <= 0)
    return ok
