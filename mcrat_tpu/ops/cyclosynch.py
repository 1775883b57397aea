"""Cyclo-synchrotron emission, absorption, and rebinning.

JAX re-design of Src/mc_cyclosynch.c (~1100 LoC + 930 LoC rebinning):

* B-field models (equipartition with internal or total energy via EPSILON_B,
  or directly from the MHD simulation) and the cyclotron frequency;
* the Wardzinski & Zdziarski (2000) emissivity j_nu machinery and the
  Ghisellini & Svensson (1991) absorption cross section (kept available, as in
  the reference, which actually emits using the blackbody photon spectrum
  integrated 10 Hz -> nu_c, Src/mc_cyclosynch.c:1199-1285);
* pool-photon emission into the advected injection shell, one photon per draw
  at the cell center with E = h nu_c, isotropic in the comoving frame;
* absorption: any photon whose comoving frequency is <= nu_c of its cell is
  removed (injected/old-CS photons get the p0 = -1 marker first,
  Src/mc_cyclosynch.c:1571-1644);
* rebinning of scattered-CS photons onto a (log E, theta[, phi]) histogram
  with per-bin weighted averages (Src/mc_cyclosynch.c:244-710).

Emission counting and rebinning are host-side numpy (like injection, they run
once per frame); absorption masks are device-side.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

import jax.numpy as jnp

from ..config import BFieldCalc, Config, NonthermalDist, PhotonType
from ..constants import (
    A_RAD,
    C_LIGHT,
    CHARGE_EL,
    FINE_STRUCT,
    H_OVER_MEC2,
    K_B,
    KB_OVER_MEC2,
    M_EL,
    M_P,
    ME_C2,
    PL_CONST,
    R_EL,
    THOM_X_SECT,
)
from .. import geometry as geo
from ..grid import HydroFrameHost
from .._xp import xp_for


def dimless_theta(temp):
    """k T / m_e c^2 (reference: calcDimlessTheta, Src/mc_cyclosynch.c:48-52)."""
    return KB_OVER_MEC2 * temp


def calc_b(cfg: Config, el_dens, temp):
    """Equipartition B field (reference: calcB, Src/mc_cyclosynch.c:54-76).

    INTERNAL_E: B = sqrt(eps_B 8 pi (3/2) n_e k T);
    TOTAL_E:    B = sqrt(8 pi eps_B (n_e m_p c^2 + 4 a T^4 / 3)).
    """
    xp = xp_for(el_dens, temp)
    if cfg.b_field_calc is BFieldCalc.INTERNAL_E:
        return xp.sqrt(cfg.epsilon_b * 8.0 * math.pi * 3.0 * el_dens * K_B * temp / 2.0)
    if cfg.b_field_calc is BFieldCalc.TOTAL_E:
        return xp.sqrt(
            8.0 * math.pi * cfg.epsilon_b
            * (el_dens * M_P * C_LIGHT**2 + 4.0 * A_RAD * temp**4 / 3.0)
        )
    raise ValueError("calc_b called with B_FIELD_CALC == SIMULATION")


def b_magnitude(cfg: Config, frame, idx=None):
    """|B| per cell (reference: getMagneticFieldMagnitude, mc_cyclosynch.c:78-92)."""
    xp = xp_for(frame.dens if idx is None else frame.dens)
    if idx is None:
        dens, temp = frame.dens, frame.temp
        b0, b1, b2 = frame.B0, frame.B1, frame.B2
    else:
        dens, temp = frame.dens[idx], frame.temp[idx]
        b0, b1, b2 = frame.B0[idx], frame.B1[idx], frame.B2[idx]
    if cfg.b_field_calc is BFieldCalc.SIMULATION:
        return xp.sqrt(b0 * b0 + b1 * b1 + b2 * b2)
    return calc_b(cfg, dens / M_P, temp)


def cyclotron_freq(b):
    """nu_c = e B / (2 pi m_e c) (reference: calcCyclotronFreq, :30-34)."""
    return CHARGE_EL * b / (2.0 * math.pi * M_EL * C_LIGHT)


# ---------------------------------------------------------------------------
# Wardzinski & Zdziarski (2000) emissivity + Ghisellini & Svensson (1991)
# absorption cross section (reference: mc_cyclosynch.c:95-223) — available for
# physics studies; the emission integral below uses the BB photon spectrum like
# the reference does.
# ---------------------------------------------------------------------------


def n_el_mj(el_dens, theta, gamma):
    """Relativistic Maxwell-Juttner number density (reference: :95-99)."""
    from .special import bessel_k2e

    return (
        el_dens
        * gamma
        * np.sqrt(np.maximum(gamma**2 - 1.0, 0.0))
        * np.exp(-(gamma - 1.0) / theta)
        / (theta * bessel_k2e(1.0 / theta))
    )


def n_el_mb(el_dens, theta, gamma):
    """Non-relativistic Maxwell-Boltzmann form (reference: :102-108)."""
    temp = theta * ME_C2 / K_B
    v = C_LIGHT * np.sqrt(np.maximum(1.0 - 1.0 / gamma**2, 0.0))
    return (
        el_dens
        * 4.0
        * math.pi
        * (M_EL / (2.0 * math.pi * K_B * temp)) ** 1.5
        * (v * C_LIGHT**2 / gamma**3)
        * np.exp(-M_EL * v**2 / (2.0 * K_B * temp))
    )


def _Z(nu, nu_c, gamma):
    return (np.sqrt(gamma**2 - 1.0) * np.exp(1.0 / gamma) / (1.0 + gamma)) ** (
        2.0 * nu * gamma / nu_c
    )


def _Z_sec_der(nu, nu_c, gamma):
    g = gamma
    return nu * (
        -2.0 * g**3 * (1.0 + g)
        + 4.0 * g**4 * (1.0 + g - g**2 - g**3)
        * np.log(np.sqrt(g**2 - 1.0) * np.exp(1.0 / g) / (1.0 + g))
    ) / (nu_c * g**5 * (1.0 + g))


def _chi(theta, gamma):
    return np.where(
        theta <= 0.08,
        np.sqrt(2.0 * theta * (gamma**2 - 1.0) / (gamma * (3.0 * gamma**2 - 1.0))),
        np.sqrt(2.0 * theta / (3.0 * gamma)),
    )


def _gamma0(nu, nu_c, theta):
    x = nu * theta / nu_c
    return np.where(
        theta <= 0.08,
        np.sqrt((1.0 + 2.0 * x * (1.0 + 4.5 * x)) ** (-1.0 / 3.0)),
        np.sqrt((1.0 + 4.0 * x / 3.0) ** (2.0 / 3.0)),
    )


def jnu(nu, nu_c, theta, el_dens):
    """Wardzinski+2000 cyclo-synchrotron emissivity (reference: :152-170)."""
    theta_ref = dimless_theta(1e7)
    gamma = _gamma0(nu, nu_c, theta)
    n_el = np.where(
        theta < theta_ref, n_el_mb(el_dens, theta, gamma), n_el_mj(el_dens, theta, gamma)
    )
    pref = math.pi**1.5 * CHARGE_EL**2 / (2.0**1.5 * C_LIGHT)
    return (
        pref
        * np.sqrt(nu * nu_c)
        * n_el
        * _Z(nu, nu_c, gamma)
        * _chi(theta, gamma)
        / np.sqrt(np.abs(_Z_sec_der(nu, nu_c, gamma)))
    )


def syn_cross_section(cfg: Config, el_dens, temp, nu_ph, p_el):
    """Ghisellini & Svensson (1991) synchrotron absorption cross section
    (reference: synCrossSection, :197-223)."""
    b_cr = FINE_STRUCT * math.sqrt(ME_C2 / R_EL**3)
    b = calc_b(cfg, el_dens, temp)
    nu_c = cyclotron_freq(b)
    g = np.sqrt(p_el**2 + 1.0)
    logterm = np.log((g + 1.0) / p_el)
    C = ((2.0 * g**2 - 1.0) / (g * p_el**2)) + 2.0 * nu_ph * (
        g / p_el**2 - g * logterm
    ) / nu_c
    G = np.sqrt(1.0 - 2.0 * p_el**2 * (g * logterm - 1.0))
    G_prime = (3.0 * g - (3.0 * g**2 - 1.0) * logterm) / G
    return (
        (3.0 * math.pi**2 / 8.0)
        * (THOM_X_SECT / FINE_STRUCT)
        * (b_cr / b)
        * (nu_c / nu_ph) ** 2
        * np.exp(-2.0 * nu_ph * (g * logterm - 1.0) / nu_c)
        * (C / G - G_prime / G**2)
    )


# ---------------------------------------------------------------------------
# Emission
# ---------------------------------------------------------------------------


def cs_r_limits(scatt_frame: int, inj_frame: int, fps: float, r_inj: float):
    """Advected injection-shell bounds (reference: calcCyclosynchRLimits,
    Src/mc_cyclosynch.c:225-242)."""
    adv = C_LIGHT * (scatt_frame - inj_frame) / fps
    half = 0.5 * C_LIGHT / fps
    return r_inj + adv - half, r_inj + adv + half


def _bb_photon_count_to_nuc(temp: np.ndarray, nu_c: np.ndarray, n_nodes: int = 64):
    """Integral of the blackbody photon number spectrum from 10 Hz to nu_c.

    The reference evaluates this per cell with gsl_integration_qags on
    blackbody_ph_spect (Src/mc_cyclosynch.c:1199-1285); here a log-spaced
    Gauss-Legendre quadrature over the whole cell batch at once.
    """
    lo = np.log(10.0)
    hi = np.log(np.maximum(nu_c, 10.0 + 1e-6))
    x, w = np.polynomial.legendre.leggauss(n_nodes)
    x = 0.5 * (x + 1.0)  # [0, 1]
    ln_nu = lo + (hi - lo)[:, None] * x[None, :]
    nu = np.exp(ln_nu)
    # 8 pi nu^2 / (c^3 (e^{h nu/kT} - 1)) * nu  (log-space Jacobian)
    spect = 8.0 * math.pi * nu**2 / (
        np.expm1(PL_CONST * nu / (K_B * temp[:, None])) * C_LIGHT**3
    )
    return np.sum(spect * nu * w[None, :], axis=-1) * 0.5 * (hi - lo)


def emit_pool_photons(
    cfg: Config,
    host: HydroFrameHost,
    scatt_frame: int,
    inj_frame: int,
    fps: float,
    r_inj: float,
    ph_weight: float,
    max_photons: int,
    theta_min: float,
    theta_max: float,
    rng: np.random.Generator,
) -> Tuple[dict, float]:
    """Emit CS pool photons into the advected shell.

    Host-side numpy re-design of photonEmitCyclosynch's bulk path (reference:
    Src/mc_cyclosynch.c:1176-1554): per-cell expected counts are the BB tail
    photon number up to nu_c times the cell volume over the weight, Poisson
    drawn, with the x10/x0.5 auto-tune against max = REBIN_E_PERC*max_photons;
    each photon sits at its cell center with comoving E = h nu_c, isotropic
    comoving direction, type CS_POOL.
    Returns (photon array dict — may be empty, weight).
    """
    from ..transport import _injection_shell_mask
    from .fourvec import lorentz_boost

    rmin, rmax = cs_r_limits(scatt_frame, inj_frame, fps, r_inj)
    mask = _injection_shell_mask(host, rmin, rmax, theta_min, theta_max)
    sel = np.flatnonzero(mask)
    cap = cfg.cs_rebin_e_perc * max_photons
    if len(sel) == 0:
        return {}, ph_weight

    b = np.asarray(b_magnitude(cfg, host, sel))
    nu_c = cyclotron_freq(b)
    counts_dens = _bb_photon_count_to_nuc(host.temp[sel], nu_c)
    dv = host.volumes()[sel]
    mean_unw = counts_dens * dv

    w = ph_weight
    total = float(mean_unw.sum())
    if total <= 0:
        return {}, w
    while total / w > 10.0 * cap:
        w *= 10.0
    for _ in range(200):
        counts = rng.poisson(mean_unw / w)
        tot = int(counts.sum())
        if tot > cap:
            w *= 10.0
        elif tot < 1:
            w *= 0.5
            if total / w < 1e-12:
                return {}, w
        else:
            break
    else:
        return {}, w

    cell_idx = np.repeat(sel, counts)
    n = len(cell_idx)
    e_hat = PL_CONST * np.repeat(nu_c, counts) / ME_C2  # h nu_c / m_e c^2

    com_phi = rng.random(n) * 2.0 * math.pi
    com_cos = rng.random(n) * 2.0 - 1.0
    com_sin = np.sqrt(np.maximum(1.0 - com_cos**2, 0.0))
    p_comv = np.stack(
        [e_hat, e_hat * com_sin * np.cos(com_phi), e_hat * com_sin * np.sin(com_phi), e_hat * com_cos],
        axis=-1,
    )
    if cfg.dims.value == 3:
        pos_phi = np.zeros(n)
        x2 = host.r2[cell_idx]
    else:
        pos_phi = rng.random(n) * 2.0 * math.pi
        x2 = pos_phi
    v2 = host.v2[cell_idx] if cfg.dims.value != 2 else np.zeros(n)
    bx, by, bz = geo.hydro_vector_to_cartesian(
        cfg, host.v0[cell_idx], host.v1[cell_idx], v2,
        host.r0[cell_idx], host.r1[cell_idx], x2,
    )
    beta = -np.stack([np.asarray(bx), np.asarray(by), np.asarray(bz)], axis=-1)
    p_lab = lorentz_boost(beta, p_comv)

    px, py, pz = geo.hydro_to_mcrat(
        cfg, host.r0[cell_idx], host.r1[cell_idx],
        host.r2[cell_idx] if cfg.dims.value == 3 else pos_phi,
    )
    pos = np.stack([np.asarray(px), np.asarray(py), np.asarray(pz)], axis=-1)
    s = np.zeros((n, 4))
    s[:, 0] = 1.0
    return (
        dict(
            p=p_lab,
            comv_p=p_comv,
            pos=pos,
            s=s,
            weight=np.full(n, w),
            num_scatt=np.zeros(n),
            cell=cell_idx.astype(np.int32),
            ptype=np.full(n, int(PhotonType.CS_POOL), np.int32),
        ),
        w,
    )


# ---------------------------------------------------------------------------
# Absorption
# ---------------------------------------------------------------------------


def absorption_mask(cfg: Config, frame, photons):
    """Photons to absorb: comoving nu <= nu_c of their cell, or pool photons.

    Device-side equivalent of phAbsCyclosynch's criterion (reference:
    Src/mc_cyclosynch.c:1595-1640).  Returns (absorb, marker) boolean arrays:
    ``marker`` flags injected/unabsorbed-CS photons that receive the p0 = -1
    marker before being nulled.
    """
    safe = jnp.clip(photons.cell, 0, frame.num_elements - 1)
    b = b_magnitude(cfg, frame, safe)
    nu_c = cyclotron_freq(b)
    nu_comv = photons.comv_p[:, 0] / H_OVER_MEC2  # dimensionless -> Hz
    valid = photons.alive & (photons.cell >= 0)
    low = nu_comv <= nu_c
    is_pool = photons.ptype == int(PhotonType.CS_POOL)
    absorb = valid & (low | is_pool)
    marker = absorb & (
        (photons.ptype == int(PhotonType.INJECTED))
        | (photons.ptype == int(PhotonType.UNABSORBED_CS))
    )
    return absorb, marker


def apply_absorption(cfg: Config, frame, photons):
    """Null absorbed photons; returns (photons, n_absorbed, absorbed_weight).

    absorbed_weight counts only injected/unabsorbed-CS photons, matching the
    reference's abs_count return (Src/mc_cyclosynch.c:1616-1623).
    """
    absorb, marker = absorption_mask(cfg, frame, photons)
    n_abs = jnp.sum(absorb)
    w_abs = jnp.sum(jnp.where(marker, photons.weight, 0.0))
    p_new = photons.p.at[:, 0].set(
        jnp.where(marker, -1.0, photons.p[:, 0])
    )
    photons = photons.replace(
        p=p_new,
        weight=jnp.where(absorb, 0.0, photons.weight),
        ptype=jnp.where(absorb, int(PhotonType.NULL), photons.ptype),
    )
    return photons, n_abs, w_abs


# ---------------------------------------------------------------------------
# Rebinning
# ---------------------------------------------------------------------------


def rebin_comptonized(
    cfg: Config,
    photons_np: dict,
    max_photons: int,
    extra: Optional[dict] = None,
) -> dict:
    """Merge scattered-CS photons onto a (log E, theta[, phi]) histogram.

    Host-side numpy re-design of rebinCyclosynchCompPhotons (reference:
    Src/mc_cyclosynch.c:244-710): num_bins = REBIN_E_PERC * max_photons energy
    bins x CYCLOSYNCHROTRON_REBIN_ANG-degree theta bins (x REBIN_ANG_PHI in
    3-D); each non-empty bin becomes one photon with weight-summed,
    weight-averaged properties, type REBINNED equivalent (the reference labels
    the merged photons COMPTONIZED with recalc_properties=1).

    ``photons_np``: dict of numpy arrays for the photons to merge (lab p,
    comv_p, pos, s, weight, num_scatt).  ``extra`` maps names to additional
    per-photon scalars that get the same weighted per-bin average (the
    mid-frame rebin passes the remaining frame time through it).  Returns the
    merged dict (with the extra keys included).
    """
    w = photons_np["weight"]
    if len(w) == 0:
        return photons_np
    p = photons_np["p"]
    pos = photons_np["pos"]
    s = photons_np["s"]
    ns = photons_np["num_scatt"]

    e = p[:, 0]
    r = np.linalg.norm(pos, axis=1)
    theta = np.arccos(np.clip(pos[:, 2] / np.maximum(r, 1e-300), -1, 1))
    phi = np.arctan2(pos[:, 1], pos[:, 0])

    n_e_bins = max(int(cfg.cs_rebin_e_perc * max_photons), 1)
    e_edges = np.geomspace(max(e.min(), 1e-300) * 0.999, e.max() * 1.001, n_e_bins + 1)
    dtheta = math.radians(cfg.cs_rebin_ang)
    t_lo, t_hi = theta.min(), theta.max() + 1e-12
    n_t_bins = max(int(np.ceil((t_hi - t_lo) / dtheta)), 1)
    t_edges = np.linspace(t_lo, t_lo + n_t_bins * dtheta, n_t_bins + 1)

    ie = np.clip(np.searchsorted(e_edges, e, side="right") - 1, 0, n_e_bins - 1)
    it = np.clip(np.searchsorted(t_edges, theta, side="right") - 1, 0, n_t_bins - 1)
    if cfg.dims.value == 3:
        dphi = math.radians(cfg.cs_rebin_ang_phi)
        p_lo = phi.min()
        n_p_bins = max(int(np.ceil((phi.max() + 1e-12 - p_lo) / dphi)), 1)
        ip = np.clip(((phi - p_lo) / dphi).astype(int), 0, n_p_bins - 1)
    else:
        n_p_bins, ip = 1, np.zeros(len(e), dtype=int)

    flat = (ie * n_t_bins + it) * n_p_bins + ip
    nbins = n_e_bins * n_t_bins * n_p_bins
    wsum = np.bincount(flat, weights=w, minlength=nbins)
    occupied = np.flatnonzero(wsum > 0)

    def wavg(q):
        return np.bincount(flat, weights=w * q, minlength=nbins)[occupied] / wsum[occupied]

    merged_p = np.stack([wavg(p[:, i]) for i in range(4)], axis=-1)
    # renormalize the spatial part to preserve the null norm after averaging
    pv = merged_p[:, 1:]
    norm = np.linalg.norm(pv, axis=1, keepdims=True)
    merged_p[:, 1:] = pv / np.maximum(norm, 1e-300) * merged_p[:, :1]
    merged_pos = np.stack([wavg(pos[:, i]) for i in range(3)], axis=-1)
    merged_s = np.stack([wavg(s[:, i]) for i in range(4)], axis=-1)
    merged_s[:, 0] = 1.0
    out = dict(
        p=merged_p,
        comv_p=np.zeros_like(merged_p),  # recomputed on next cell lookup
        pos=merged_pos,
        s=merged_s,
        weight=wsum[occupied],
        num_scatt=wavg(ns),
        cell=np.zeros(len(occupied), np.int32),
        ptype=np.full(len(occupied), int(PhotonType.COMPTONIZED), np.int32),
    )
    if extra:
        for k, v in extra.items():
            out[k] = wavg(np.asarray(v))
    return out


def nonthermal_electron_dens(cfg: Config, host: HydroFrameHost) -> np.ndarray:
    """n_e,nonthermal = B^2 / (8 pi <gamma m c^2>) per cell.

    Reference: calculateNonthermalElectronDens (Src/electron.c:677-706).
    """
    from .electrons import norm_broken_power_law_energy_dens, norm_power_law_energy_dens

    if cfg.nonthermal_e_dist is NonthermalDist.POWERLAW:
        e_per = norm_power_law_energy_dens(cfg.powerlaw_index, cfg.gamma_min, cfg.gamma_max)
    else:
        e_per = norm_broken_power_law_energy_dens(
            cfg.powerlaw_index_1, cfg.powerlaw_index_2,
            cfg.gamma_min, cfg.gamma_max, cfg.gamma_break,
        )
    b = np.asarray(b_magnitude(cfg, host))
    return b * b / (8.0 * math.pi * e_per)


def electron_dist_subgroup_dens(cfg: Config) -> np.ndarray:
    """Fraction of the nonthermal distribution in each gamma subgroup.

    Reference: calculateElectronDistSubgroupDens (Src/electron.c:655-675),
    evaluated with Gauss-Legendre quadrature instead of QAGS.
    """
    from .electrons import broken_power_law_pdf, power_law_pdf

    lgmin, lgmax = math.log10(cfg.gamma_min), math.log10(cfg.gamma_max)
    dg = (lgmax - lgmin) / cfg.n_gamma
    out = np.zeros(cfg.n_gamma)
    x01, w01 = np.polynomial.legendre.leggauss(256)
    for i in range(cfg.n_gamma):
        g_lo, g_hi = 10.0 ** (lgmin + i * dg), 10.0 ** (lgmin + (i + 1) * dg)
        x = 0.5 * (g_hi - g_lo) * x01 + 0.5 * (g_hi + g_lo)
        w = 0.5 * (g_hi - g_lo) * w01
        if cfg.nonthermal_e_dist is NonthermalDist.POWERLAW:
            pdf = power_law_pdf(x, cfg.powerlaw_index, cfg.gamma_min, cfg.gamma_max)
        else:
            pdf = broken_power_law_pdf(
                x, cfg.powerlaw_index_1, cfg.powerlaw_index_2,
                cfg.gamma_min, cfg.gamma_max, cfg.gamma_break,
            )
        out[i] = float(np.sum(np.asarray(pdf) * w))
    return out


def average_dimless_theta(cfg: Config, host: HydroFrameHost) -> float:
    """Volume-averaged dimensionless temperature (reference:
    calculateAverageDimlessTheta, Src/mclib.c:1537-1550)."""
    v = host.volumes()
    return float(np.sum(dimless_theta(host.temp) * v) / np.sum(v))


def emit_pool_replacements(
    cfg: Config,
    host: HydroFrameHost,
    scatt_frame: int,
    inj_frame: int,
    fps: float,
    r_inj: float,
    weight: float,
    count: int,
    theta_min: float,
    theta_max: float,
    rng: np.random.Generator,
) -> dict:
    """Emit exactly ``count`` pool photons to replace scattered ones.

    The reference replaces each scattered pool photon immediately and in the
    same cell (photonEmitCyclosynch single-injection path, reference:
    Src/mc_cyclosynch.c:1465-1554 driven from Src/mcrat.c:791-808); here the
    replacement happens at frame granularity with cells drawn from the
    emission-rate distribution over the advected shell — the stationary
    distribution the one-for-one rule maintains.
    """
    from ..transport import _injection_shell_mask
    from .fourvec import lorentz_boost

    if count <= 0:
        return {}
    rmin, rmax = cs_r_limits(scatt_frame, inj_frame, fps, r_inj)
    mask = _injection_shell_mask(host, rmin, rmax, theta_min, theta_max)
    sel = np.flatnonzero(mask)
    if len(sel) == 0:
        return {}
    b = np.asarray(b_magnitude(cfg, host, sel))
    nu_c_all = cyclotron_freq(b)
    weights_cells = _bb_photon_count_to_nuc(host.temp[sel], nu_c_all) * host.volumes()[sel]
    tot = weights_cells.sum()
    if tot <= 0:
        return {}
    pick = rng.choice(len(sel), size=count, p=weights_cells / tot)
    cell_idx = sel[pick]
    nu_c = nu_c_all[pick]
    e_hat = PL_CONST * nu_c / ME_C2

    com_phi = rng.random(count) * 2.0 * math.pi
    com_cos = rng.random(count) * 2.0 - 1.0
    com_sin = np.sqrt(np.maximum(1.0 - com_cos**2, 0.0))
    p_comv = np.stack(
        [e_hat, e_hat * com_sin * np.cos(com_phi), e_hat * com_sin * np.sin(com_phi), e_hat * com_cos],
        axis=-1,
    )
    if cfg.dims.value == 3:
        pos_phi = np.zeros(count)
        x2 = host.r2[cell_idx]
    else:
        pos_phi = rng.random(count) * 2.0 * math.pi
        x2 = pos_phi
    v2 = host.v2[cell_idx] if cfg.dims.value != 2 else np.zeros(count)
    bx, by, bz = geo.hydro_vector_to_cartesian(
        cfg, host.v0[cell_idx], host.v1[cell_idx], v2,
        host.r0[cell_idx], host.r1[cell_idx], x2,
    )
    beta = -np.stack([np.asarray(bx), np.asarray(by), np.asarray(bz)], axis=-1)
    p_lab = lorentz_boost(beta, p_comv)
    px, py, pz = geo.hydro_to_mcrat(
        cfg, host.r0[cell_idx], host.r1[cell_idx],
        host.r2[cell_idx] if cfg.dims.value == 3 else pos_phi,
    )
    pos = np.stack([np.asarray(px), np.asarray(py), np.asarray(pz)], axis=-1)
    s = np.zeros((count, 4))
    s[:, 0] = 1.0
    return dict(
        p=p_lab,
        comv_p=p_comv,
        pos=pos,
        s=s,
        weight=np.full(count, weight),
        num_scatt=np.zeros(count),
        cell=cell_idx.astype(np.int32),
        ptype=np.full(count, int(PhotonType.CS_POOL), np.int32),
    )


def rebin_population(
    cfg: Config, photons, meta, max_photons: int, n_cs: Optional[int] = None,
    t_rem=None,
):
    """Rebin the scattered-CS photons of a device population if they exceed
    ``max_photons``.

    Device/host split re-design of the reference trigger (Src/mcrat.c:819-830,
    853-877): the CS lanes are gathered into a compact buffer and nulled in
    ONE device executable (transport.extract_cs_subset), the compact subset —
    not the full population — is fetched in ONE transfer, merged on the host
    (:func:`rebin_comptonized`), and the caller appends the merged set back.
    ``n_cs`` is the live scattered-CS count from frame_stats / the chunk
    fetch; passing it avoids any extra device round-trip for the trigger
    test.  ``t_rem`` (mid-frame rebin) rides along and comes back as the
    merged photons' weighted-average remaining frame time.

    Returns (photons, merged_arrays | None, merged_t | None); merged weights
    are in normalized population units.
    """
    import jax

    from .. import transport as tr

    if n_cs is None:
        from ..parallel.mesh import fetch_global

        n_cs = int(np.asarray(fetch_global(tr._count_cs(photons))).reshape(-1)[0])
    if n_cs <= max_photons:
        return photons, None, None
    npad = tr._pow2(n_cs)
    nulled, sub, sub_t = tr.extract_cs_subset(photons, npad, t_rem=t_rem)
    from ..parallel.mesh import fetch_global

    host = fetch_global(
        [sub.p, sub.comv_p, sub.pos, sub.s, sub.weight, sub.num_scatt, sub_t]
    )
    p, comv_p, pos, s, w, ns, t_sub = (
        np.asarray(a, dtype=np.float64) for a in host
    )
    live = w > 0
    subd = dict(
        p=p[live], comv_p=comv_p[live], pos=pos[live], s=s[live],
        weight=w[live], num_scatt=ns[live],
    )
    extra = {"t_rem": t_sub[live]} if t_rem is not None else None
    merged = rebin_comptonized(cfg, subd, max_photons, extra=extra)
    merged_t = merged.pop("t_rem", None)
    return nulled, merged, merged_t
