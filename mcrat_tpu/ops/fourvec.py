"""Batched special-relativistic four-vector operations.

JAX replacement for the reference's GSL-based single-photon routines
(lorentzBoost, Src/mclib.c:302-407; zeroNorm, Src/mclib.c:409-434).  Instead of
building a 4x4 matrix and calling dgemv per photon, the boost is expressed in
closed form on ``(..., 4)`` arrays so XLA fuses it into surrounding elementwise
work.

Conventions: four-vectors are arrays with trailing axis 4 laid out as
(p0, p1, p2, p3) = (E/c, px, py, pz); boosts take the 3-velocity ``beta`` of the
new frame measured in the old frame, with the same sign convention as the
reference (boost by +beta takes lab -> comoving when beta is the fluid velocity).
"""
from __future__ import annotations

import jax.numpy as jnp

from .._xp import xp_for


def lorentz_boost(beta, p, photon: bool = True):
    """Boost four-momenta ``p`` (..., 4) by 3-velocity ``beta`` (..., 3).

    Closed form of the matrix in reference Src/mclib.c:330-350:

        p0' = g (p0 - b . p)
        p'  = p + [(g - 1)(b . p)/b^2 - g p0] b

    For |beta| == 0 the identity is returned (reference: mclib.c:381-397).
    When ``photon`` is True the null-norm condition is re-imposed on the result
    (reference applies zeroNorm to photons only).
    """
    jnp = xp_for(beta, p)  # numpy on host, jax.numpy when traced
    b2 = jnp.sum(beta * beta, axis=-1, keepdims=True)
    # Guard the b2 -> 0 limit: (g-1)/b2 -> g^2/(g+1), finite. Use safe divide.
    safe_b2 = jnp.where(b2 > 0, b2, 1.0)
    gamma = 1.0 / jnp.sqrt(jnp.maximum(1.0 - b2, 1e-30))
    p0 = p[..., :1]
    pv = p[..., 1:]
    bdotp = jnp.sum(beta * pv, axis=-1, keepdims=True)
    p0_new = gamma * (p0 - bdotp)
    coef = (gamma - 1.0) * bdotp / safe_b2 - gamma * p0
    pv_new = pv + coef * beta
    # identity when beta == 0
    p0_new = jnp.where(b2 > 0, p0_new, p0)
    pv_new = jnp.where(b2 > 0, pv_new, pv)
    out = jnp.concatenate([p0_new, pv_new], axis=-1)
    if photon:
        out = zero_norm(out)
    return out


def zero_norm(p):
    """Re-impose the photon null-norm |p| == p0, trusting the energy.

    Vectorized zeroNorm (reference: Src/mclib.c:409-434): rescales the spatial
    part so its norm equals p0.
    """
    jnp = xp_for(p)  # numpy on host, jax.numpy when traced
    pv = p[..., 1:]
    norm = jnp.sqrt(jnp.sum(pv * pv, axis=-1, keepdims=True))
    scale = jnp.where(norm > 0, p[..., :1] / jnp.maximum(norm, jnp.finfo(p.dtype).tiny), 1.0)
    return jnp.concatenate([p[..., :1], pv * scale], axis=-1)


def beta_from_gamma(gamma):
    """|v|/c from the Lorentz factor."""
    return jnp.sqrt(jnp.maximum(1.0 - 1.0 / (gamma * gamma), 0.0))


def gamma_from_beta_vec(beta):
    b2 = jnp.sum(beta * beta, axis=-1)
    return 1.0 / jnp.sqrt(jnp.maximum(1.0 - b2, 1e-30))


def normalize(v, eps=0.0):
    """Unit vectors along trailing axis (rsqrt-mul: one reciprocal square root
    instead of a sqrt plus three divides)."""
    import jax

    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    floor = jnp.asarray(eps * eps if eps else jnp.finfo(v.dtype).tiny, v.dtype)
    inv = jax.lax.rsqrt(jnp.maximum(n2, floor))
    return v * jnp.where(n2 > 0, inv, 0.0)


def cross(a, b):
    return jnp.cross(a, b)


def rotate_about_z(v, angle):
    """Rotate 3-vectors about z by ``angle`` (CCW looking down +z).

    Matches the rot0 matrix used in the scatter kernel (reference:
    Src/mcrat_scattering.c:247-252 with angle = -phi0 plugged into that form).
    """
    c, s = jnp.cos(angle), jnp.sin(angle)
    x = c * v[..., 0] - s * v[..., 1]
    y = s * v[..., 0] + c * v[..., 1]
    return jnp.stack([x, y, v[..., 2]], axis=-1)


def rotate_about_y(v, angle):
    """Rotate 3-vectors about y, matching rot1 (reference: mcrat_scattering.c:278-283).

    Note the reference's rot1 convention: x' = c*x - s*z, z' = s*x + c*z for
    angle passed as -phi1 — i.e. this is the same sign structure as rot0 read in
    the (x, z) plane.
    """
    c, s = jnp.cos(angle), jnp.sin(angle)
    x = c * v[..., 0] - s * v[..., 2]
    z = s * v[..., 0] + c * v[..., 2]
    return jnp.stack([x, v[..., 1], z], axis=-1)


def rotate_about_x(v, angle):
    c, s = jnp.cos(angle), jnp.sin(angle)
    y = c * v[..., 1] - s * v[..., 2]
    z = s * v[..., 1] + c * v[..., 2]
    return jnp.stack([v[..., 0], y, z], axis=-1)


# --- cos/sin-parameterized rotations -----------------------------------------
# The hot transport path never needs the *angles* themselves, only their
# cosines/sines, which are available directly from vector components.  These
# variants skip the atan2 -> cos/sin round trip (3 transcendentals per use).


def rotate_about_z_cs(v, c, s):
    """rotate_about_z with the angle given as (cos, sin)."""
    x = c * v[..., 0] - s * v[..., 1]
    y = s * v[..., 0] + c * v[..., 1]
    return jnp.stack([x, y, v[..., 2]], axis=-1)


def rotate_about_y_cs(v, c, s):
    """rotate_about_y with the angle given as (cos, sin)."""
    x = c * v[..., 0] - s * v[..., 2]
    z = s * v[..., 0] + c * v[..., 2]
    return jnp.stack([x, v[..., 1], z], axis=-1)


def rotate_about_x_cs(v, c, s):
    """rotate_about_x with the angle given as (cos, sin)."""
    y = c * v[..., 1] - s * v[..., 2]
    z = s * v[..., 1] + c * v[..., 2]
    return jnp.stack([v[..., 0], y, z], axis=-1)
