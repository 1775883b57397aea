"""Batched polarized Compton / Klein-Nishina scattering.

JAX re-design of the reference scattering kernel
(Src/mcrat_scattering.c:151-623).  The reference performs one scattering at a
time with GSL matrix algebra; here the full pipeline — boost to the electron
rest frame, the two alignment rotations, KN angle sampling (batched rejection),
the Compton energy shift, the Fano Stokes scatter, and the inverse rotations
and boost — runs over an ``(N,)`` photon axis as straight-line vector code.

All four-momenta are dimensionless (units of m_e c), so the KN "energy ratio"
h nu / m_e c^2 is simply ``p[..., 0]``.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .fourvec import lorentz_boost, rotate_about_y_cs, rotate_about_z_cs
from .rng import batched_rejection
from .stokes import Z_HAT, fano_scatter_stokes, rotate_basis_vectors, stokes_rotation


def kn_cross_section(energy_ratio):
    """Total KN cross section / Thomson cross section.

    Vectorized kleinNishinaCrossSection (reference:
    Src/mcrat_scattering.c:597-623): grmonty-style closed form with the linear
    Taylor limit below e = 1e-3.
    """
    e = energy_ratio
    safe_e = jnp.maximum(e, 1e-10)
    full = 0.75 * (
        2.0 / (safe_e * safe_e)
        + (1.0 / (2.0 * safe_e) - (1.0 + safe_e) / (safe_e**3)) * jnp.log1p(2.0 * safe_e)
        + (1.0 + safe_e) / ((1.0 + 2.0 * safe_e) ** 2)
    )
    return jnp.where(e >= 1e-3, full, 1.0 - 2.0 * e)


def sample_kn_angles_cs(key, e0, q, u, stokes_on: bool, max_iters: int = 16):
    """Sample scattering angles from the polarized KN differential cross
    section, returned as (cos t, sin t, cos phi, sin phi).

    Vectorized kleinNishinaScatter's angle stage (reference:
    Src/mcrat_scattering.c:532-585).  ``e0`` is the photon energy in the
    electron rest frame over m_e c^2; (q, u) the Stokes parameters in the
    scattering-aligned basis.  The KN accept/reject against sigma_KN/sigma_T is
    handled by the caller so it composes with the acceptance statistics.

    theta: rejection sampling of
      f(c) = (1 + e(1-c))^-2 (e(1-c) + 1/(1+e(1-c)) + c^2), envelope 2.
    phi: the reference proposes a uniform angle and rejects against the
      phi-dependent factor normalized at phi_max = |atan2(-u, q)|/2
      (uniform when unpolarized).  Here the uniform angle is proposed as a
      point in the unit disk — (cos phi, sin phi) = (x, y)/r with
      cos 2phi = (x^2 - y^2)/r^2, sin 2phi = 2xy/r^2 — which multiplies the
      acceptance by pi/4 but removes every trig call from the rejection loop
      and hands the caller the (cos, sin) pair it actually needs.
    """
    shape = e0.shape
    dtype = e0.dtype
    k_theta, k_phi = jax.random.split(key)

    def propose_theta(k):
        k1, k2 = jax.random.split(k)
        c = jax.random.uniform(k1, shape, dtype=dtype, minval=-1.0, maxval=1.0)
        y = jax.random.uniform(k2, shape, dtype=dtype) * 2.0
        return (c, y)

    def accept_theta(c, y):
        m = 1.0 + e0 * (1.0 - c)
        f = (e0 * (1.0 - c) + 1.0 / m + c * c) / (m * m)
        return y < f

    cos_theta, _ = batched_rejection(
        k_theta,
        shape,
        propose_theta,
        accept_theta,
        init=(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype)),
        max_iters=max_iters,
    )
    cos_theta = jnp.clip(cos_theta, -1.0, 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))

    if stokes_on:
        # phi-dependent factor (reference: mcrat_scattering.c:541-584)
        mu = 1.0 + e0 * (1.0 - cos_theta)
        f_theta = (1.0 / mu + mu**-3 - (sin_theta * sin_theta) / (mu * mu)) * sin_theta
        pol_amp = sin_theta**3 / (mu * mu)
        phi_max = jnp.abs(jnp.arctan2(-u, q)) / 2.0
        norm = f_theta + pol_amp * (q * jnp.cos(2 * phi_max) - u * jnp.sin(2 * phi_max))
        unpolarized = (q == 0.0) & (u == 0.0)
        safe_norm = jnp.where(norm != 0, norm, 1.0)

    def propose_phi(k):
        xy = jax.random.uniform(k, shape + (2,), dtype=dtype, minval=-1.0, maxval=1.0)
        return (xy[..., 0], xy[..., 1])

    def accept_phi(x, y):
        # For (x, y) uniform in the unit disk, r^2 is Uniform(0, 1) and
        # independent of the angle, so it doubles as the acceptance variate —
        # no third random word needed.
        r2 = x * x + y * y
        in_disk = (r2 <= 1.0) & (r2 > jnp.finfo(dtype).tiny)
        if not stokes_on:
            return in_disk
        safe_r2 = jnp.maximum(r2, jnp.finfo(dtype).tiny)
        c2 = (x * x - y * y) / safe_r2
        s2 = (2.0 * x * y) / safe_r2
        f = (f_theta + pol_amp * (q * c2 - u * s2)) / safe_norm
        return in_disk & (unpolarized | (r2 < f))

    x, y = batched_rejection(
        k_phi,
        shape,
        propose_phi,
        accept_phi,
        init=(jnp.ones(shape, dtype), jnp.zeros(shape, dtype)),
        max_iters=max_iters,
    )
    inv_r = 1.0 / jnp.sqrt(jnp.maximum(x * x + y * y, jnp.finfo(dtype).tiny))
    return cos_theta, sin_theta, x * inv_r, y * inv_r


def sample_kn_angles(key, e0, q, u, stokes_on: bool, max_iters: int = 24):
    """(theta, phi) form of :func:`sample_kn_angles_cs` (angles in radians)."""
    ct, st, cp, sp = sample_kn_angles_cs(key, e0, q, u, stokes_on, max_iters)
    return jnp.arccos(ct), jnp.arctan2(sp, cp) % (2.0 * jnp.pi)


class ScatterResult(NamedTuple):
    ph_p: jax.Array  # (N, 4) comoving photon four-momentum after (possible) scatter
    s: jax.Array  # (N, 4) Stokes vector
    scattered: jax.Array  # (N,) bool — did the scattering occur


def single_scatter(key, el_p, ph_p, s, stokes_on: bool = True) -> ScatterResult:
    """Batched photon-electron scattering in the fluid comoving frame.

    Vectorized singleScatter (reference: Src/mcrat_scattering.c:151-485):

    1. boost photon into the electron rest frame with beta_e = p_e / E_e;
    2. Stokes-rotate across the boost;
    3. rotate about z by -phi0 then about y by -phi1 so the photon lies on +x;
    4. accept/reject the event with probability sigma_KN/sigma_T, then sample
       (theta, phi) from the polarized KN differential cross section;
    5. Compton-shift the energy, build the scattered direction
       (cos t, sin t sin phi, sin t cos phi) scaled by e1;
    6. undo rotation 2 then rotation 1;
    7. scatter the Stokes vector with the Fano matrix in the k0-k plane,
       bracketed by the two basis rotations;
    8. boost back with -beta_e and Stokes-rotate again.

    Photons whose event is rejected keep their inputs and report
    ``scattered = False`` (the caller treats this as a null collision, which is
    distributionally identical to the reference's retry-next-candidate walk
    because all free paths are resampled after every event there,
    Src/mcrat.c:768-774).
    """
    k_accept, k_angles = jax.random.split(key)
    dtype = ph_p.dtype

    el_v = el_p[..., 1:] / el_p[..., :1]
    # Boost into the electron rest frame (reference: mcrat_scattering.c:217-218).
    ph_rest = lorentz_boost(el_v, ph_p, photon=True)

    s_work = s
    if stokes_on:
        s_work = stokes_rotation(el_v, ph_p[..., 1:], ph_rest[..., 1:], s_work)

    ph_orig_vec = ph_rest[..., 1:]
    e0 = ph_rest[..., 0]
    tiny = jnp.finfo(dtype).tiny

    # Alignment rotations (reference: mcrat_scattering.c:244-298), with the
    # rotation cosines/sines taken directly from the components instead of
    # atan2 -> cos/sin: phi0 = atan2(py, px) about z, then phi1 = atan2(z', x')
    # about y put the photon exactly along +x with |p| = e0.
    rho0 = jnp.sqrt(ph_rest[..., 1] ** 2 + ph_rest[..., 2] ** 2)
    has_xy = rho0 > 0
    safe_rho0 = jnp.maximum(rho0, tiny)
    c0 = jnp.where(has_xy, ph_rest[..., 1] / safe_rho0, 1.0)
    s0 = jnp.where(has_xy, ph_rest[..., 2] / safe_rho0, 0.0)
    # after rotate_about_z by -phi0: x' = rho0, y' = 0, z' = pz.
    # e0 == 0 (dead/padded lanes) keeps everything finite: identity rotation.
    inv_e0 = jnp.where(e0 > 0, 1.0 / jnp.maximum(e0, tiny), 0.0)
    c1 = jnp.where(e0 > 0, rho0 * inv_e0, 1.0)
    s1 = ph_rest[..., 3] * inv_e0

    # KN acceptance (reference: mcrat_scattering.c:518-521).
    accept_u = jax.random.uniform(k_accept, e0.shape, dtype=dtype)
    scattered = accept_u <= kn_cross_section(e0)

    ct, st, c_phi, s_phi = sample_kn_angles_cs(
        k_angles, e0, s_work[..., 1], s_work[..., 2], stokes_on=stokes_on
    )

    # Compton shift in m_e c units (reference: mcrat_scattering.c:322).
    e1 = e0 / (1.0 + e0 * (1.0 - ct))
    # Scattered direction: phi measured clockwise from z to y
    # (reference: mcrat_scattering.c:323-325).
    scat_aligned = jnp.stack(
        [e1 * ct, e1 * st * s_phi, e1 * st * c_phi], axis=-1
    )

    # Undo rotation about y then about z (reference: mcrat_scattering.c:360-386).
    scat_vec = rotate_about_y_cs(scat_aligned, c1, s1)
    scat_vec = rotate_about_z_cs(scat_vec, c0, s0)

    if stokes_on:
        z = jnp.broadcast_to(Z_HAT.astype(dtype), ph_orig_vec.shape)
        # Rotate the Stokes basis into the k0-k scattering plane
        # (reference: mcrat_scattering.c:402-405).
        s_work2 = rotate_basis_vectors(ph_orig_vec, z, scat_vec, ph_orig_vec, s_work)
        # Scattering angle from the actual vectors (reference: :408).
        cos_sc = jnp.sum(ph_orig_vec * scat_vec, axis=-1) / jnp.maximum(e0 * e1, jnp.finfo(e0.dtype).tiny)
        cos_sc = jnp.clip(cos_sc, -1.0, 1.0)
        s_work2 = fano_scatter_stokes(s_work2, e0, e1, cos_sc)
        # Rotate from the scattering plane back to the z-hat basis
        # (reference: :438-447).
        s_work2 = rotate_basis_vectors(scat_vec, ph_orig_vec, scat_vec, z, s_work2)
    else:
        s_work2 = s_work

    ph_rest_new = jnp.concatenate([e1[..., None], scat_vec], axis=-1)
    # De-boost to the comoving frame (reference: mcrat_scattering.c:461-465).
    ph_comv_new = lorentz_boost(-el_v, ph_rest_new, photon=True)
    if stokes_on:
        s_work2 = stokes_rotation(
            -el_v, ph_rest_new[..., 1:], ph_comv_new[..., 1:], s_work2
        )

    mask = scattered[..., None]
    return ScatterResult(
        ph_p=jnp.where(mask, ph_comv_new, ph_p),
        s=jnp.where(mask, s_work2, s) if stokes_on else s,
        scattered=scattered,
    )
