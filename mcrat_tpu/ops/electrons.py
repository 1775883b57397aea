"""Batched electron sampling.

JAX re-design of the reference electron module (Src/electron.c):
thermal Maxwell-Juttner / low-temperature Maxwell-Boltzmann draws, the relative
polar-angle inverse CDF, the rotation into the photon's frame, and the
non-thermal power-law / broken-power-law inverse-CDF samplers.

Electron four-momenta are dimensionless (units of m_e c): el_p0 = gamma,
|el_p| = gamma beta.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import KB_OVER_MEC2
from .fourvec import rotate_about_x_cs, rotate_about_y_cs
from .rng import batched_rejection, uniform_pos


def sample_thermal_gamma_beta(key, temp, max_iters: int = 12):
    """Sample (gamma, gamma*beta) from an exact Maxwell-Juttner at ``temp`` [K].

    Replaces the reference's sampler (sampleThermalElectron, Src/electron.c:
    202-237) with a distribution-identical one that is uniformly efficient at
    every temperature.  The reference proposes gamma uniform on (0, 1+100
    theta) under a constant envelope; that scheme's acceptance is 2 theta /
    (1 + 100 theta) <= 2% — fine for its scalar retry-until-accept loop, fatal
    for a batched fixed-trial loop (at T = 1e9 K most lanes would exhaust
    their trials).

    Here the MJ density is written in xi = (gamma - 1)/theta:

        f(xi) ∝ (1 + a) sqrt(a (2 + a)) e^-xi,   a = theta xi,

    and bounded by the pure-Gamma mixture envelope (chain of exact
    inequalities (1+a)^{3/2} <= sqrt(2)(1 + a^{3/2}), then
    2 sqrt(xi) <= 1 + xi):

        E(xi) = [ sqrt(theta) (1 + xi) + 2 theta^2 xi^2 ] e^-xi,

    a mixture of Exp(1), Gamma(2), Gamma(3) with weights
    (1/2, 1/2, 2 theta^{3/2}) / (1 + 2 theta^{3/2}).  Every component is a
    -log of a product of uniforms, so a trial needs five random words, ONE
    log, and no normal draw (the previous envelope's Gamma(3/2) component
    cost an erfinv per trial).  Acceptance is >= 0.44 for ALL theta (the
    sqrt(pi theta)-mass MB limit keeps the nonrelativistic branch exact, the
    Gamma(3) term the ultrarelativistic one), so 12 unrolled trials leave a
    < 1e-3 worst-case fallback fraction.

    Returns (gamma, gamma*beta); the second form keeps full precision for
    nonrelativistic lanes where gamma - 1 ~ theta underflows in float32.
    """
    dtype = temp.dtype
    shape = temp.shape
    theta = jnp.maximum(KB_OVER_MEC2 * temp, jnp.finfo(dtype).tiny)
    sqrt_theta = jnp.sqrt(theta)
    # cumulative mixture weights over (Exp(1), Gamma(2), Gamma(3))
    m3 = 2.0 * theta * sqrt_theta
    inv_mass = 1.0 / (1.0 + m3)
    cum1 = 0.5 * inv_mass
    cum2 = inv_mass  # cum1 + 0.5/mass

    def propose(k):
        u = uniform_pos(k, shape + (5,), dtype)
        p2 = u[..., 0] * u[..., 1]
        um = u[..., 3]
        prod = jnp.where(um < cum1, u[..., 0], jnp.where(um < cum2, p2, p2 * u[..., 2]))
        # a product of float32 uniforms can underflow to 0 (a raw draw of
        # exactly 0 becomes tiny, and tiny * u flushes); -log(0) = inf would
        # be accepted as an infinite-gamma electron
        xi = -jnp.log(jnp.maximum(prod, jnp.finfo(dtype).tiny))
        return (xi, u[..., 4])

    def accept(xi, u_acc):
        a = theta * xi
        target = (1.0 + a) * jnp.sqrt(jnp.maximum(a * (2.0 + a), 0.0))
        envelope = sqrt_theta * (1.0 + xi) + 2.0 * (theta * theta) * (xi * xi)
        return u_acc * envelope <= target

    xi, _ = batched_rejection(
        key, shape, propose, accept,
        init=(jnp.full(shape, 1.5, dtype), jnp.zeros(shape, dtype)),
        max_iters=max_iters,
    )
    a = theta * xi
    gamma = 1.0 + a
    gamma_beta = jnp.sqrt(jnp.maximum(a * (2.0 + a), 0.0))
    return gamma, gamma_beta


def sample_thermal_gamma(key, temp, max_iters: int = 16):
    """Sample electron Lorentz factors from a thermal distribution at ``temp`` [K]."""
    gamma, _ = sample_thermal_gamma_beta(key, temp, max_iters=max_iters)
    return gamma


def sample_electron_cos_theta(key, beta):
    """cos of the relative polar angle between electron and photon.

    Inverse CDF of (1 - beta cos t) sin t (vectorized from reference
    Src/electron.c:196, RAIKOU eq. 56):
        cos t = (1 - sqrt(1 + beta^2 + 2 beta - 4 beta u)) / beta
    with the beta -> 0 limit cos t = 2u - 1.
    """
    u = jax.random.uniform(key, beta.shape, dtype=beta.dtype)
    safe_beta = jnp.maximum(beta, 1e-8)
    arg = 1.0 + safe_beta * safe_beta + 2.0 * safe_beta - 4.0 * safe_beta * u
    cos_t = (1.0 - jnp.sqrt(jnp.maximum(arg, 0.0))) / safe_beta
    cos_t = jnp.where(beta < 1e-6, 2.0 * u - 1.0, cos_t)
    return jnp.clip(cos_t, -1.0, 1.0)


def sample_electron_theta(key, beta):
    """Relative polar angle between electron and photon (angle form)."""
    return jnp.arccos(sample_electron_cos_theta(key, beta))


def rotate_electron_to_photon_frame(el_p, ph_p):
    """Rotate sampled electron momenta into each photon's axes.

    Vectorized rotateElectron (reference: Src/electron.c:126-175).  The sampled
    electron direction treats the photon as the polar axis with components
    ordered (E, p cos t, p sin t sin phi, p sin t cos phi); the reference
    computes photon angles phi = atan2(p2, p3), theta = atan2(sqrt(p2^2+p3^2),
    p1), then rotates the spatial part about y by theta and about x by -phi.
    Here the rotation sines/cosines come directly from the photon components
    (no atan2/trig round trip): cos th = p1/|p|, sin th = rho/|p|,
    cos ph = p3/rho, sin ph = p2/rho with rho = sqrt(p2^2 + p3^2).
    """
    dtype = ph_p.dtype
    tiny = jnp.finfo(dtype).tiny
    rho2 = ph_p[..., 2] ** 2 + ph_p[..., 3] ** 2
    rho = jnp.sqrt(rho2)
    norm = jnp.sqrt(rho2 + ph_p[..., 1] ** 2)
    inv_norm = 1.0 / jnp.maximum(norm, tiny)
    c_th = ph_p[..., 1] * inv_norm
    s_th = rho * inv_norm
    # rho -> 0: photon along +/-x; phi is arbitrary, atan2(0, 0) = 0 in the
    # reference, i.e. (cos, sin) = (1, 0)
    safe_rho = jnp.maximum(rho, tiny)
    c_ph = jnp.where(rho > 0, ph_p[..., 3] / safe_rho, 1.0)
    s_ph = jnp.where(rho > 0, ph_p[..., 2] / safe_rho, 0.0)
    v = el_p[..., 1:]
    v = rotate_about_y_cs(v, c_th, s_th)
    v = rotate_about_x_cs(v, c_ph, -s_ph)
    return jnp.concatenate([el_p[..., :1], v], axis=-1)


def sample_thermal_electron(key, temp, ph_p):
    """Full thermal electron draw aligned to each photon.

    Vectorized singleThermalElectron (reference: Src/electron.c:70-94).
    ``temp`` is (N,) cell temperature [K]; ``ph_p`` the (N, 4) comoving photon
    four-momentum (dimensionless units are fine — only the direction is used).
    Returns (N, 4) electron four-momentum in units of m_e c.
    """
    k_g, k_phi, k_th = jax.random.split(key, 3)
    gamma, gb = sample_thermal_gamma_beta(k_g, temp)
    beta = gb / gamma
    phi = jax.random.uniform(k_phi, temp.shape, dtype=temp.dtype, maxval=2.0 * jnp.pi)
    cos_t = sample_electron_cos_theta(k_th, beta)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    el_p = jnp.stack(
        [
            gamma,
            gb * cos_t,
            gb * sin_t * jnp.sin(phi),
            gb * sin_t * jnp.cos(phi),
        ],
        axis=-1,
    )
    return rotate_electron_to_photon_frame(el_p, ph_p)


# ----------------------------------------------------------------------------
# Non-thermal distributions (reference: Src/electron.c:253-332, 334-536)
# ----------------------------------------------------------------------------

def sample_power_law(key, shape, dtype, p, gamma_min, gamma_max):
    """Inverse-CDF power-law sampler n(g) ~ g^-p on [gamma_min, gamma_max].

    Vectorized samplePowerLaw (reference: Src/electron.c:253-270) including the
    p -> 1 limit.
    """
    u = uniform_pos(key, shape, dtype)
    if abs(p - 1.0) < 1e-6:
        return gamma_min * (gamma_max / gamma_min) ** u
    g = 1.0 + u * ((gamma_max / gamma_min) ** (1.0 - p) - 1.0)
    return gamma_min * g ** (1.0 / (1.0 - p))


def power_law_norm(p, gamma_min, gamma_max):
    """Normalization A of n(g) = A g^-p (reference: Src/electron.c:447-476)."""
    import math

    if abs(p - 1.0) < 1e-10:
        return 1.0 / math.log(gamma_max / gamma_min)
    return (1.0 - p) / (gamma_max ** (1.0 - p) - gamma_min ** (1.0 - p))


def broken_power_law_norm(p1, p2, gamma_min, gamma_max, gamma_break):
    """Normalization A of the broken power law (reference: Src/electron.c:334-371)."""
    import math

    p1_is_1 = abs(p1 - 1.0) < 1e-10
    p2_is_1 = abs(p2 - 1.0) < 1e-10
    if not p1_is_1 and not p2_is_1:
        t1 = (gamma_break ** (1 - p1) - gamma_min ** (1 - p1)) / (1 - p1)
        t2 = gamma_break ** (p2 - p1) * (
            gamma_max ** (1 - p2) - gamma_break ** (1 - p2)
        ) / (1 - p2)
    elif p1_is_1 and not p2_is_1:
        t1 = math.log(gamma_break / gamma_min)
        t2 = gamma_break ** (p2 - 1.0) * (
            gamma_max ** (1 - p2) - gamma_break ** (1 - p2)
        ) / (1 - p2)
    elif not p1_is_1 and p2_is_1:
        t1 = (gamma_break ** (1 - p1) - gamma_min ** (1 - p1)) / (1 - p1)
        t2 = gamma_break ** (1 - p1) * math.log(gamma_max / gamma_break)
    else:
        return 0.0
    return 1.0 / (t1 + t2)


def power_law_pdf(g, p, gamma_min, gamma_max):
    """n(g) = A g^-p inside the range, 0 outside (reference: electron.c:479-504)."""
    a = power_law_norm(p, gamma_min, gamma_max)
    val = a * g ** (-p)
    return jnp.where((g >= gamma_min) & (g <= gamma_max), val, 0.0)


def broken_power_law_pdf(g, p1, p2, gamma_min, gamma_max, gamma_break):
    """Broken power law with continuity factor (reference: electron.c:374-406)."""
    a = broken_power_law_norm(p1, p2, gamma_min, gamma_max, gamma_break)
    cont = gamma_break ** (p2 - p1)
    val = jnp.where(g <= gamma_break, a * g ** (-p1), a * cont * g ** (-p2))
    return jnp.where((g >= gamma_min) & (g <= gamma_max), val, 0.0)


def sample_broken_power_law(key, shape, dtype, p1, p2, gamma_min, gamma_max, gamma_break):
    """Inverse-CDF broken-power-law sampler.

    Vectorized sampleBrokenPowerLaw (reference: Src/electron.c:272-332),
    including the reference's sign correction for the g > gamma_break branch
    (comment at electron.c:289-292) and both p -> 1 limits.
    """
    import math

    u = uniform_pos(key, shape, dtype)
    p1_is_1 = abs(p1 - 1.0) < 1e-6
    p2_is_1 = abs(p2 - 1.0) < 1e-6
    if not p1_is_1 and not p2_is_1:
        a = 1.0 / (
            (gamma_break ** (1 - p1) - gamma_min ** (1 - p1)) / (1 - p1)
            + gamma_break ** (p2 - p1)
            * (gamma_max ** (1 - p2) - gamma_break ** (1 - p2))
            / (1 - p2)
        )
        xi_break = a * (gamma_break ** (1 - p1) - gamma_min ** (1 - p1)) / (1 - p1)
        g_lo = (gamma_min ** (1 - p1) + (1 - p1) * u / a) ** (1.0 / (1 - p1))
        g_hi = (
            gamma_break ** (1 - p2)
            + (1 - p2)
            * gamma_break ** (p1 - p2)
            * ((gamma_min ** (1 - p1) - gamma_break ** (1 - p1)) / (1 - p1) + u / a)
        ) ** (1.0 / (1 - p2))
    elif p1_is_1 and not p2_is_1:
        a = 1.0 / (
            math.log(gamma_break / gamma_min)
            + gamma_break ** (p2 - p1)
            * (gamma_max ** (1 - p2) - gamma_break ** (1 - p2))
            / (1 - p2)
        )
        xi_break = a * math.log(gamma_break / gamma_min)
        g_lo = gamma_min * jnp.exp(u / a)
        g_hi = (
            gamma_break ** (1 - p2)
            - (1 - p2)
            * gamma_break ** (p1 - p2)
            * (math.log(gamma_break / gamma_min) - u / a)
        ) ** (1.0 / (1 - p2))
    elif not p1_is_1 and p2_is_1:
        a = 1.0 / (
            (gamma_break ** (1 - p1) - gamma_min ** (1 - p1)) / (1 - p1)
            + gamma_break ** (p2 - p1) * math.log(gamma_max / gamma_break)
        )
        xi_break = a * (gamma_break ** (1 - p1) - gamma_min ** (1 - p1)) / (1 - p1)
        g_lo = (gamma_min ** (1 - p1) + (1 - p1) * u / a) ** (1.0 / (1 - p1))
        g_hi = gamma_break * jnp.exp(
            gamma_break ** (p1 - p2)
            * (u / a - (gamma_break ** (1 - p1) - gamma_min ** (1 - p1)) / (1 - p1))
        )
    else:
        raise ValueError("p1 == p2 == 1 broken power law is not supported")
    return jnp.where(u <= xi_break, g_lo, g_hi)


def norm_power_law_energy_dens(p, gamma_min, gamma_max):
    """<gamma m c^2> per electron for a power law (reference: electron.c:581-605)."""
    import math

    from ..constants import ME_C2

    if abs(p - 2.0) < 1e-10:
        r = math.log(gamma_max / gamma_min)
    else:
        r = (gamma_max ** (2.0 - p) - gamma_min ** (2.0 - p)) / (2.0 - p)
    return r * power_law_norm(p, gamma_min, gamma_max) * ME_C2


def norm_broken_power_law_energy_dens(p1, p2, gamma_min, gamma_max, gamma_break):
    """<gamma m c^2> per electron, broken power law (reference: electron.c:607-652)."""
    import math

    from ..constants import ME_C2

    p1_is_2 = abs(p1 - 2.0) < 1e-10
    p2_is_2 = abs(p2 - 2.0) < 1e-10
    if not p1_is_2 and not p2_is_2:
        t1 = (gamma_break ** (2 - p1) - gamma_min ** (2 - p1)) / (2 - p1)
        t2 = gamma_break ** (p2 - p1) * (
            gamma_max ** (2 - p2) - gamma_break ** (2 - p2)
        ) / (2 - p2)
        r = t1 + t2
    elif p1_is_2 and not p2_is_2:
        t1 = math.log(gamma_break / gamma_min)
        t2 = gamma_break ** (p2 - 2.0) * (
            gamma_max ** (2 - p2) - gamma_break ** (2 - p2)
        ) / (2 - p2)
        r = t1 + t2
    elif not p1_is_2 and p2_is_2:
        t1 = (gamma_break ** (2 - p1) - gamma_min ** (2 - p1)) / (2 - p1)
        t2 = gamma_break ** (2 - p1) * math.log(gamma_max / gamma_break)
        r = t1 + t2
    else:
        r = 0.0
    return r * broken_power_law_norm(p1, p2, gamma_min, gamma_max, gamma_break) * ME_C2


def power_law_cdf(g, p, gamma_min, gamma_max):
    """CDF of the normalized power law on [gamma_min, gamma_max]."""
    a = power_law_norm(p, gamma_min, gamma_max)
    if abs(p - 1.0) < 1e-10:
        return a * jnp.log(g / gamma_min)
    return a * (g ** (1.0 - p) - gamma_min ** (1.0 - p)) / (1.0 - p)


def broken_power_law_cdf(g, p1, p2, gamma_min, gamma_max, gamma_break):
    """Piecewise CDF of the normalized broken power law (continuity factor
    gamma_break^(p2-p1) above the break; reference pdf: electron.c:374-406)."""
    import math

    a = broken_power_law_norm(p1, p2, gamma_min, gamma_max, gamma_break)

    def seg(lo, hi, p):
        if abs(p - 1.0) < 1e-10:
            return jnp.log(hi / lo)
        return (hi ** (1.0 - p) - lo ** (1.0 - p)) / (1.0 - p)

    below = a * seg(gamma_min, jnp.minimum(g, gamma_break), p1)
    cont = gamma_break ** (p2 - p1)
    f_break = a * seg(gamma_min, gamma_break, p1)
    above = a * cont * seg(gamma_break, jnp.maximum(g, gamma_break), p2)
    return jnp.where(g <= gamma_break, below, f_break + above)


def sample_nonthermal_gamma_range(key, g_lo, g_hi, cfg):
    """Sample gamma from the configured nonthermal distribution restricted to
    per-lane subgroup ranges [g_lo, g_hi].

    Inverse-CDF on a remapped uniform: u' = F(g_lo) + u (F(g_hi) - F(g_lo)).
    NB: the reference's subgroup restriction is inert — its retry loop
    ``while (gamma < gmin && gamma > gmax)`` (Src/electron.c:102-105) can never
    trigger, so it samples the full distribution regardless of the chosen
    subgroup; this implementation restricts correctly.
    """
    from ..config import NonthermalDist

    dtype = g_lo.dtype
    u = uniform_pos(key, g_lo.shape, dtype)
    if cfg.nonthermal_e_dist is NonthermalDist.POWERLAW:
        f_lo = power_law_cdf(g_lo, cfg.powerlaw_index, cfg.gamma_min, cfg.gamma_max)
        f_hi = power_law_cdf(g_hi, cfg.powerlaw_index, cfg.gamma_min, cfg.gamma_max)
        up = f_lo + u * (f_hi - f_lo)
        p = cfg.powerlaw_index
        a = power_law_norm(p, cfg.gamma_min, cfg.gamma_max)
        if abs(p - 1.0) < 1e-6:
            return cfg.gamma_min * jnp.exp(up / a)
        return (cfg.gamma_min ** (1.0 - p) + (1.0 - p) * up / a) ** (1.0 / (1.0 - p))
    # broken power law: remap u then reuse the full inverse sampler formulas
    f_lo = broken_power_law_cdf(
        g_lo, cfg.powerlaw_index_1, cfg.powerlaw_index_2,
        cfg.gamma_min, cfg.gamma_max, cfg.gamma_break,
    )
    f_hi = broken_power_law_cdf(
        g_hi, cfg.powerlaw_index_1, cfg.powerlaw_index_2,
        cfg.gamma_min, cfg.gamma_max, cfg.gamma_break,
    )
    up = f_lo + u * (f_hi - f_lo)
    return _broken_power_law_inverse(up, cfg)


def _broken_power_law_inverse(u, cfg):
    """Inverse CDF of the broken power law at quantiles ``u`` (traced array)."""
    p1, p2 = cfg.powerlaw_index_1, cfg.powerlaw_index_2
    gmin, gmax, gbrk = cfg.gamma_min, cfg.gamma_max, cfg.gamma_break
    a = broken_power_law_norm(p1, p2, gmin, gmax, gbrk)
    import math

    def seg_int(lo, hi, p):
        if abs(p - 1.0) < 1e-10:
            return math.log(hi / lo)
        return (hi ** (1.0 - p) - lo ** (1.0 - p)) / (1.0 - p)

    f_break = a * seg_int(gmin, gbrk, p1)
    cont = gbrk ** (p2 - p1)
    # below-break inverse
    if abs(p1 - 1.0) < 1e-6:
        g_lo = gmin * jnp.exp(u / a)
    else:
        g_lo = (gmin ** (1.0 - p1) + (1.0 - p1) * u / a) ** (1.0 / (1.0 - p1))
    # above-break inverse
    u2 = (u - f_break) / (a * cont)
    if abs(p2 - 1.0) < 1e-6:
        g_hi = gbrk * jnp.exp(u2)
    else:
        g_hi = (gbrk ** (1.0 - p2) + (1.0 - p2) * u2) ** (1.0 / (1.0 - p2))
    return jnp.where(u <= f_break, g_lo, g_hi)


def sample_nonthermal_electron(key, subgroup, ph_p, cfg):
    """Nonthermal electron draw aligned to each photon, restricted to the
    chosen gamma subgroup (1-based index; reference: singleNonThermalElectron,
    Src/electron.c:96-124 and the subgroup-interval math at :55-62)."""
    import math

    k_g, k_phi, k_th = jax.random.split(key, 3)
    dtype = ph_p.dtype
    dg = (math.log10(cfg.gamma_max) - math.log10(cfg.gamma_min)) / cfg.n_gamma
    lg_lo = math.log10(cfg.gamma_min) + (subgroup - 1).astype(dtype) * dg
    g_lo = 10.0 ** lg_lo
    g_hi = 10.0 ** (lg_lo + dg)
    gamma = sample_nonthermal_gamma_range(k_g, g_lo, g_hi, cfg)
    beta = jnp.sqrt(jnp.maximum(1.0 - 1.0 / (gamma * gamma), 0.0))
    phi = jax.random.uniform(k_phi, gamma.shape, dtype=dtype, maxval=2.0 * jnp.pi)
    cos_t = sample_electron_cos_theta(k_th, beta)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    gb = gamma * beta
    el_p = jnp.stack(
        [gamma, gb * cos_t, gb * sin_t * jnp.sin(phi), gb * sin_t * jnp.cos(phi)],
        axis=-1,
    )
    return rotate_electron_to_photon_frame(el_p, ph_p)
