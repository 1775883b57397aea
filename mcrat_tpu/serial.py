"""Serial-equivalent transport: the reference's exact event ordering.

The batched engine (mcrat_tpu.transport) advances every photon through its own
free-path chain concurrently; the reference instead globally orders events:
sample *all* free paths, walk candidates from the smallest, advance the whole
population to each candidate's time, scatter that single photon, then resample
everything (Src/mclib.c:617-714, 1107-1356).  The two are equivalent in
distribution (exponential memorylessness); this module implements the
reference ordering directly — O(N) work per event, host-driven — as the
validation oracle for that claim (SURVEY.md section 7 "serial-equivalence
mode") and as a debugging tool for small populations.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import Config, PhotonType, TauCalculation
from .constants import C_LIGHT, KB_OVER_MEC2, M_P, THOM_X_SECT
from .grid import find_cell
from .ops import compton, electrons
from .ops.fourvec import lorentz_boost
from .ops.stokes import stokes_rotation
from .transport import DEFAULT_MFP, Photons, _tau_rate


# ---------------------------------------------------------------------------
# Independent hot-cross-section / biased-population machinery (numpy).
#
# The batched engine's TABLE + nonthermal path rests on ops.hot_xsec
# (Gauss-Legendre tensor quadrature -> bilinear table) and
# transport._tau_rate's bias bookkeeping; a bug shared by those would be
# invisible to comparisons between runs of the engine itself.  Everything
# below re-derives sigma_hat and the generateSingleElectron ordering from the
# published formulas with plain numpy trapezoid quadrature and inverse-CDF
# sampling — no code shared with ops.hot_xsec or _tau_rate.  Reference:
# Src/hot_x_section.c:324-459 (integrals), Src/optical_depth.c:60-112
# (biased multi-population tau), Src/electron.c:7-68 (population pick).
# ---------------------------------------------------------------------------


def _sigma_kn_np(e):
    """Total KN cross section / sigma_T, closed form (grmonty style;
    reference: kleinNishinaCrossSection, Src/mcrat_scattering.c:597-623)."""
    e = np.asarray(e, np.float64)
    small = e < 1e-3
    es = np.where(small, 1.0, e)
    full = 0.75 * (
        2.0 / (es * es)
        + (1.0 / (2.0 * es) - (1.0 + es) / es**3) * np.log1p(2.0 * es)
        + (1.0 + es) / (1.0 + 2.0 * es) ** 2
    )
    return np.where(small, 1.0 - 2.0 * e, full)


def _k2e_np(x):
    """Scaled modified Bessel K2(x) e^x by direct quadrature of the cosh
    integral (independent of ops.special's implementation; the scaling keeps
    cold cells — x = 1/theta up to ~1e5 — finite)."""
    t = np.linspace(0.0, 30.0, 20001)
    return np.trapezoid(
        np.exp(-np.asarray(x)[..., None] * (np.cosh(t) - 1.0))
        * np.cosh(2.0 * t), t, axis=-1,
    )


def _sigma_hat_thermal_np(eps, theta, n_g=96, n_mu=64):
    """sigma_hat(eps', theta): MJ-averaged KN over the reference's
    [1, 1+12 theta] x [-1, 1] box, trapezoid rule."""
    eps = np.atleast_1d(np.asarray(eps, np.float64))
    theta = np.atleast_1d(np.asarray(theta, np.float64))
    x = np.linspace(0.0, 1.0, n_g)[None, :, None]         # (1, G, 1)
    mu = np.linspace(-1.0, 1.0, n_mu)[None, None, :]      # (1, 1, M)
    th = theta[:, None, None]
    g = 1.0 + 12.0 * th * x                               # (N, G, 1)
    beta = np.sqrt(np.maximum(1.0 - 1.0 / (g * g), 0.0))
    # n_MJ(g) = g^2 beta exp(-g/th) / (th K2(1/th)); written against the
    # SCALED Bessel so exp(-g/th)/exp(-1/th) = exp((1-g)/th) stays finite
    # down to cold cells
    mj = (
        g * np.sqrt(np.maximum(g * g - 1.0, 0.0))
        * np.exp((1.0 - g) / th)
        / (th * _k2e_np(1.0 / theta)[:, None, None])
    )
    integrand = 0.5 * mj * _sigma_kn_np(eps[:, None, None] * g * (1.0 - mu * beta)) * (
        1.0 - mu * beta
    )
    inner = np.trapezoid(integrand, np.broadcast_to(mu, integrand.shape), axis=-1)
    return np.trapezoid(inner, np.broadcast_to(g[..., 0], inner.shape), axis=-1)


def _subgroup_bounds_np(cfg: Config):
    lg = np.linspace(np.log10(cfg.gamma_min), np.log10(cfg.gamma_max),
                     cfg.n_gamma + 1)
    return 10.0 ** lg


def _subgroup_frac_np(cfg: Config, n_g=4001):
    """Number fraction of the power-law distribution per gamma subgroup
    (reference: calculateElectronDistSubgroupDens, Src/electron.c:655-675)."""
    assert cfg.powerlaw_index is not None, "oracle covers POWERLAW"
    p = cfg.powerlaw_index
    g = np.geomspace(cfg.gamma_min, cfg.gamma_max, n_g)
    pdf = g ** (-p)
    total = np.trapezoid(pdf, g)
    bounds = _subgroup_bounds_np(cfg)
    out = []
    for i in range(cfg.n_gamma):
        m = (g >= bounds[i]) & (g <= bounds[i + 1])
        out.append(np.trapezoid(pdf[m], g[m]) / total)
    return np.asarray(out)


def _sigma_hat_subgroup_np(eps, cfg: Config, i: int, n_g=96, n_mu=64):
    """Power-law-averaged KN over subgroup i's gamma interval."""
    eps = np.atleast_1d(np.asarray(eps, np.float64))
    p = cfg.powerlaw_index
    bounds = _subgroup_bounds_np(cfg)
    g = np.geomspace(bounds[i], bounds[i + 1], n_g)[None, :, None]
    mu = np.linspace(-1.0, 1.0, n_mu)[None, None, :]
    beta = np.sqrt(np.maximum(1.0 - 1.0 / (g * g), 0.0))
    pdf = g ** (-p)
    norm = np.trapezoid(pdf[0, :, 0], g[0, :, 0])
    integrand = 0.5 * (pdf / norm) * _sigma_kn_np(
        eps[:, None, None] * g * (1.0 - mu * beta)
    ) * (1.0 - mu * beta)
    inner = np.trapezoid(integrand, np.broadcast_to(mu, integrand.shape), axis=-1)
    return np.trapezoid(inner, np.broadcast_to(g[..., 0], inner.shape), axis=-1)


def _independent_tau_rate(cfg: Config, frame, photons: Photons, cell, comv,
                          fluid_beta, break_bias: bool = False, cache=None):
    """Biased multi-population tau rate, re-derived with numpy.

    Returns (rate, tau0, tau_i, bias_i) as numpy arrays.  ``break_bias=True``
    drops the bias_i tau_i == tau_norm collapse (bias_i = 1) — the deliberate
    defect the oracle-vs-batched equivalence test must detect at 3 sigma.

    ``cache`` (a dict the caller carries across events) memoizes the
    quadrature sigma_hats per photon keyed on (eps', theta): between serial
    events only the ONE scattered photon's comoving energy changes (plus any
    photons whose cell temperature changed), so the O(N x nodes) quadrature
    collapses to O(changed lanes) after the first event.
    """
    safe = np.clip(np.asarray(cell), 0, frame.num_elements - 1)
    dens_lab = np.asarray(frame.dens_lab)[safe]
    temp = np.asarray(frame.temp)[safe]
    gam = np.asarray(frame.gamma)[safe]
    nt_dens = np.asarray(frame.nonthermal_dens)[safe]
    fb = np.asarray(fluid_beta)
    pv = np.asarray(photons.p[:, 1:])
    fl_norm = np.linalg.norm(fb, axis=-1)
    ph_norm = np.linalg.norm(pv, axis=-1)
    cos_ang = np.sum(fb * pv, axis=-1) / np.maximum(fl_norm * ph_norm, 1e-300)
    beta = np.sqrt(np.maximum(1.0 - 1.0 / (gam * gam), 0.0))
    fluid_factor = 1.0 - beta * cos_ang
    eps = np.asarray(comv[:, 0], np.float64)
    theta_e = KB_OVER_MEC2 * temp

    from .config import NonthermalDist

    with_nt = cfg.nonthermal_e_dist is not NonthermalDist.OFF
    if cache is not None and "eps" in cache:
        stale = (eps != cache["eps"]) | (theta_e != cache["th"])
        sig0 = cache["sig0"]
        if stale.any():
            sig0[stale] = _sigma_hat_thermal_np(eps[stale], theta_e[stale])
            if with_nt:
                for i in range(cfg.n_gamma):
                    cache["sig_sub"][stale, i] = _sigma_hat_subgroup_np(
                        eps[stale], cfg, i
                    )
    else:
        sig0 = _sigma_hat_thermal_np(eps, theta_e)
        if cache is not None:
            cache["sig0"] = sig0
            if with_nt:
                cache["sig_sub"] = np.stack(
                    [_sigma_hat_subgroup_np(eps, cfg, i) for i in range(cfg.n_gamma)],
                    axis=-1,
                )
    if cache is not None:
        cache["eps"] = eps.copy()
        cache["th"] = theta_e.copy()

    n_e_lab = dens_lab / M_P
    tau0 = n_e_lab * THOM_X_SECT * sig0 * fluid_factor

    if not with_nt:
        return tau0, tau0, None, None
    frac = _subgroup_frac_np(cfg)
    if cache is not None and "sig_sub" in cache:
        sig_sub = cache["sig_sub"]
    else:
        sig_sub = np.stack(
            [_sigma_hat_subgroup_np(eps, cfg, i) for i in range(cfg.n_gamma)],
            axis=-1,
        )
    n_nt_lab = nt_dens * gam
    tau_i = (
        n_nt_lab[:, None] * frac[None, :] * THOM_X_SECT
        * sig_sub * fluid_factor[:, None]
    )
    tau_norm = np.where(tau0 > 0, tau0, tau_i[:, 0])
    if break_bias:
        bias_i = np.ones_like(tau_i)
    else:
        bias_i = tau_norm[:, None] / np.maximum(tau_i, 1e-300)
    rate = tau0 + np.sum(bias_i * tau_i, axis=-1)
    return rate, tau0, tau_i, bias_i


class SerialResult(NamedTuple):
    photons: Photons
    n_scatt: int
    n_events_attempted: int
    # frame time actually consumed (== dt_max unless max_events capped the
    # walk); scattering RATES need it — a broken bias changes the event
    # tempo by orders of magnitude, so equal-count comparisons deadlock
    t_advanced: float = 0.0


def transport_frame_serial(
    cfg: Config,
    photons: Photons,
    frame,
    index,
    dt_max: float,
    key,
    xsec_table=None,
    stokes_on: bool = True,
    max_events: int = 10_000_000,
    break_bias: bool = False,
) -> SerialResult:
    """One frame window with the reference's global-min-time event loop.

    In TABLE mode (``cfg.tau_calculation``) the tau rates, subgroup optical
    depths, scattering biases and the generateSingleElectron population pick
    all come from the INDEPENDENT numpy machinery above — the oracle shares
    no rate/cross-section code with the batched engine there.
    ``break_bias`` injects the deliberate bias defect for the discrimination
    test.
    """
    rng_key = key
    t_remaining = float(dt_max)
    n_scatt = 0
    attempts = 0
    use_indep = cfg.tau_calculation is TauCalculation.TABLE
    sig_cache = {}
    rng_np = np.random.default_rng(
        int(np.asarray(jax.random.randint(jax.random.fold_in(key, 40507),
                                          (), 0, 2**31 - 1)))
    )

    while t_remaining > 0 and attempts < max_events:
        rng_key, k_mfp, k_el, k_sc = jax.random.split(rng_key, 4)
        # 1. cells + rates + free paths for everyone (calcMeanFreePath)
        pop_parts = None
        if use_indep:
            # geometry (fluid beta) is shared, separately-validated code; the
            # rate itself is the independent quadrature path
            cell, fluid_beta, comv = _event_setup(cfg, photons, frame, index)
            photons = photons.replace(cell=cell)
            rate_np, tau0, tau_i, bias_i = _independent_tau_rate(
                cfg, frame, photons, cell, comv, fluid_beta,
                break_bias=break_bias, cache=sig_cache,
            )
            if tau_i is not None:
                pop_parts = (tau0, tau_i, bias_i)
        else:
            cell, rate, fluid_beta, comv = _event_setup_rate(
                cfg, photons, frame, index, xsec_table
            )
            photons = photons.replace(cell=cell)
            rate_np = np.asarray(rate)
        alive = np.asarray(photons.alive)
        in_grid = np.asarray(cell) >= 0
        u = np.asarray(jax.random.uniform(k_mfp, (photons.capacity,), dtype=photons.p.dtype))
        u = np.maximum(u, np.finfo(np.float64).tiny)
        mfp = np.where(in_grid, -np.log(u) / np.maximum(rate_np, 1e-300), DEFAULT_MFP)
        t_scatt = mfp / C_LIGHT
        t_scatt = np.where(alive, t_scatt, np.inf)

        # 2. walk candidates in time order (photonEvent)
        order = np.argsort(t_scatt)
        consumed = 0.0
        event_done = False
        for idx in order:
            attempts += 1
            t_cand = float(t_scatt[idx])
            if t_cand >= t_remaining or not np.isfinite(t_cand):
                # advance everyone to the frame boundary and finish
                photons = _advance_all(photons, t_remaining - consumed)
                consumed = t_remaining
                event_done = True
                break
            # advance ALL photons to this candidate's time
            photons = _advance_all(photons, t_cand - consumed)
            consumed = t_cand
            # attempt the single scattering
            photons, ok = _attempt_one(
                cfg, photons, frame, int(idx), fluid_beta, comv,
                jax.random.fold_in(k_sc, int(idx)), stokes_on,
                pop_parts=pop_parts, rng_np=rng_np,
            )
            if ok:
                n_scatt += 1
                event_done = True
                break
        t_remaining -= consumed
        if not event_done:
            break
    return SerialResult(
        photons=photons, n_scatt=n_scatt, n_events_attempted=attempts,
        t_advanced=float(dt_max) - t_remaining,
    )


@jax.jit
def _advance_all_j(photons: Photons, dt) -> Photons:
    moves = photons.alive & (photons.ptype != PhotonType.CS_POOL)
    inv_p0 = 1.0 / jnp.maximum(photons.p[:, 0], 1e-300)
    step = photons.p[:, 1:] * inv_p0[:, None] * (C_LIGHT * dt)
    return photons.replace(pos=jnp.where(moves[:, None], photons.pos + step, photons.pos))


def _advance_all(photons: Photons, dt: float) -> Photons:
    if dt <= 0:
        return photons
    return _advance_all_j(photons, jnp.asarray(dt, photons.p.dtype))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _event_setup(cfg: Config, photons: Photons, frame, index):
    """cells + fluid beta + comoving momenta for one event iteration, as ONE
    executable (the eager per-op version cost ~100 ms of pure dispatch per
    event on a small host)."""
    cell, _ = find_cell(cfg, index, frame, photons.pos, photons.cell)
    ph2 = photons.replace(cell=cell)
    _, fluid_beta, _aux = _tau_rate(cfg, frame, ph2, cell, None)
    comv = lorentz_boost(fluid_beta, ph2.p, photon=True)
    return cell, fluid_beta, comv


@functools.partial(jax.jit, static_argnames=("cfg",))
def _event_setup_rate(cfg: Config, photons: Photons, frame, index, xsec_table):
    """_event_setup + the engine tau rate (DIRECT / shared-table mode)."""
    cell, _ = find_cell(cfg, index, frame, photons.pos, photons.cell)
    ph2 = photons.replace(cell=cell)
    rate, fluid_beta, _aux = _tau_rate(cfg, frame, ph2, cell, xsec_table)
    comv = lorentz_boost(fluid_beta, ph2.p, photon=True)
    return cell, rate, fluid_beta, comv


@functools.partial(jax.jit, static_argnames=("cfg", "stokes_on", "use_sub"))
def _attempt_core(cfg: Config, photons: Photons, frame, idx, fluid_beta, comv,
                  key, stokes_on: bool, use_sub: bool, gamma_sub):
    """The jax half of one scatter attempt (one compiled executable).

    ``idx`` is a traced scalar; with ``use_sub`` the electron gamma comes in
    precomputed (the oracle's independent host-side inverse-CDF draw) and
    only the angles are sampled here.
    """
    k_el, k_sc, k_th, k_phi = jax.random.split(key, 4)
    take = lambda a: jax.lax.dynamic_slice_in_dim(a, idx, 1, axis=0)
    comv_i = take(comv)
    beta_i = take(fluid_beta)
    p_i = take(photons.p)
    s_i = take(photons.s)
    if stokes_on:
        s_i = stokes_rotation(beta_i, p_i[:, 1:], comv_i[:, 1:], s_i)
    if use_sub:
        gamma = jnp.reshape(gamma_sub, (1,)).astype(comv_i.dtype)
        beta_e = jnp.sqrt(jnp.maximum(1.0 - 1.0 / (gamma * gamma), 0.0))
        cos_t = electrons.sample_electron_cos_theta(k_th, beta_e)
        sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
        phi = jax.random.uniform(k_phi, (1,), dtype=comv_i.dtype,
                                 maxval=2.0 * jnp.pi)
        gb = gamma * beta_e
        el = jnp.stack(
            [gamma, gb * cos_t, gb * sin_t * jnp.sin(phi),
             gb * sin_t * jnp.cos(phi)], axis=-1,
        )
        el = electrons.rotate_electron_to_photon_frame(el, comv_i)
    else:
        safe = jnp.clip(take(photons.cell), 0, frame.num_elements - 1)
        temp = frame.temp[safe]
        el = electrons.sample_thermal_electron(k_el, temp, comv_i)
    res = compton.single_scatter(k_sc, el, comv_i, s_i, stokes_on=stokes_on)
    new_lab = lorentz_boost(-beta_i, res.ph_p, photon=True)
    if stokes_on:
        s_new = stokes_rotation(-beta_i, res.ph_p[:, 1:], new_lab[:, 1:], res.s)
    else:
        s_new = res.s
    ptype_i = take(photons.ptype)
    is_pool = ptype_i == int(PhotonType.CS_POOL)
    new_type = jnp.where(is_pool, int(PhotonType.COMPTONIZED), ptype_i)
    ok = res.scattered[0]

    def write(ph):
        upd = lambda a, v: jax.lax.dynamic_update_slice_in_dim(
            a, v.astype(a.dtype), idx, axis=0
        )
        return ph.replace(
            p=upd(ph.p, new_lab),
            comv_p=upd(ph.comv_p, res.ph_p),
            s=upd(ph.s, s_new),
            num_scatt=upd(ph.num_scatt, take(ph.num_scatt) + 1.0),
            ptype=upd(ph.ptype, new_type),
        )

    photons = jax.lax.cond(ok, write, lambda ph: ph, photons)
    return photons, ok


def _attempt_one(cfg, photons, frame, idx, fluid_beta, comv, key, stokes_on,
                 pop_parts=None, rng_np=None):
    """Attempt the scattering of photon ``idx`` (photonEvent inner step).

    With ``pop_parts`` = (tau0, tau_i, bias_i) the scattering electron's
    population is picked from the biased cumulative optical depths — the
    reference's generateSingleElectron ordering (Src/electron.c:7-68, with
    the proper uniform draw; the reference carries a leftover testing
    override random_num = 0.6 at :21).  The population pick and the subgroup
    gamma draw run HOST-side (independent numpy inverse-CDF of the power law
    restricted to the subgroup interval, reference: samplePowerLaw,
    Src/electron.c:253-270); the batched jax half is one compiled executable.
    """
    sub = None
    if pop_parts is not None:
        tau0, tau_i, bias_i = pop_parts
        weights = np.concatenate(
            [[float(tau0[idx])], bias_i[idx] * tau_i[idx]]
        )
        total = weights.sum()
        u_pop = rng_np.random()
        pick = int(np.searchsorted(np.cumsum(weights) / total, u_pop))
        if pick > 0:
            sub = min(pick - 1, cfg.n_gamma - 1)
    gamma_sub = 1.0
    if sub is not None:
        p = cfg.powerlaw_index
        b = _subgroup_bounds_np(cfg)
        u = rng_np.random()
        if abs(p - 1.0) < 1e-12:
            gamma_sub = b[sub] * (b[sub + 1] / b[sub]) ** u
        else:
            a = 1.0 - p
            gamma_sub = (b[sub] ** a + u * (b[sub + 1] ** a - b[sub] ** a)) ** (1.0 / a)
    photons, ok = _attempt_core(
        cfg, photons, frame, jnp.asarray(idx, jnp.int32), fluid_beta, comv,
        key, stokes_on, sub is not None,
        jnp.asarray(gamma_sub, photons.p.dtype),
    )
    return photons, bool(ok)
