r"""Hot (energy/temperature-dependent) Compton cross-section tables.

JAX re-design of the reference hot-cross-section module
(Src/hot_x_section.c, 1239 LoC): "hot" total cross sections a la Dolence+2009 /
Canfield+1987,

    sigma_hat(eps', theta) = 0.5 \int_1^{1+12 theta} dgamma \int_{-1}^{1} dmu
                             n_MJ(gamma; theta) * sigma_KN(eps' gamma (1 - mu beta))
                             * (1 - mu beta)

normalized by the Thomson cross section (integrand: hot_x_section.c:359-400).

Where the reference builds each of the 221x81 table entries with 5e5-call GSL
plain Monte Carlo integration on rank 0, writes text files, and MPI_Bcasts
the result (hot_x_section.c:82-305, 710-826), this module evaluates the whole
table as one vectorized Gauss-Legendre tensor quadrature on device (a few 1e8
fused FLOPs), caches it to a single .npz with the same header-validation idea,
and the "broadcast" is simply a replicated device array.

Table extents match the reference exactly (Src/hot_x_section.h:1-10):
log10 eps' in [-12, 6] with 220 intervals, log10 theta in [-4, 4] with 80.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from .. import pytree as struct

from ..config import Config, NonthermalDist
from .compton import kn_cross_section
from .special import maxwell_juttner_pdf

# Reference grid constants (Src/hot_x_section.h:1-10)
LOG_PH_E_MIN = -12.0
LOG_PH_E_MAX = 6.0
N_PH_E = 220
LOG_T_MIN = -4.0
LOG_T_MAX = 4.0
N_T = 80


@struct.dataclass
class HotCrossSectionTable:
    """Device-resident tables of log10(sigma_hat/sigma_T)."""

    log_e: jax.Array  # (N_PH_E + 1,) log10 eps'
    log_t: jax.Array  # (N_T + 1,) log10 theta
    thermal: jax.Array  # (N_PH_E + 1, N_T + 1)
    nonthermal: Optional[jax.Array] = None  # (N_PH_E + 1, N_GAMMA)
    # fraction of the nonthermal distribution in each gamma subgroup
    # (reference: electron_dens_subgroup, Src/electron.c:655-675)
    subgroup_frac: Optional[jax.Array] = None  # (N_GAMMA,)
    # (4, (N_PH_E+1)*(N_T+1)) bilinear corner matrix: rows are the flattened
    # thermal table shifted by 0 / 1 / ny / ny+1, so the four corners of every
    # lane's interpolation cell come from ONE minor-axis matrix gather.  Kept
    # as a real input array so the gather's operand is never a fusion product
    # (see _bilinear).  None => built on the fly.
    thermal_quad: Optional[jax.Array] = None


def _boosted_xsec(eps, mu, gamma):
    """sigma_KN(eps gamma (1 - mu beta)) (1 - mu beta), vectorized.

    Mirrors boostedCrossSection (reference: hot_x_section.c:370-400).
    """
    beta = jnp.sqrt(jnp.maximum(gamma * gamma - 1.0, 0.0)) / gamma
    doppler = 1.0 - mu * beta
    return kn_cross_section(eps * gamma * doppler) * doppler


def _gauss_legendre(n, a, b):
    x, w = np.polynomial.legendre.leggauss(n)
    x = 0.5 * (b - a) * x + 0.5 * (b + a)
    w = 0.5 * (b - a) * w
    return x, w


def _host_f64():
    """Context forcing table construction onto the host CPU in true float64.

    The build MUST NOT run on the accelerator with the session's default
    precision: the x64 flag is usually off there, silently degrading the
    quadrature to float32, and a cache built that way carried 1237
    underflowed floor entries in the table INTERIOR, which the bilinear
    interpolation amplified into wildly wrong cross sections.  The CPU
    backend is present beside the GPU one, so this works on a GPU host too.
    """
    import contextlib

    stack = contextlib.ExitStack()
    stack.enter_context(jax.default_device(jax.devices("cpu")[0]))
    stack.enter_context(jax.enable_x64())
    return stack


# log10 sigma_hat never falls below ~-11 anywhere on the physical table
# domain (the worst corner, eps'=1e6 with theta=1e4, has sigma_KN of the
# boosted energy ~1e-11); any entry at the 1e-30 numerical floor is
# therefore an underflow artifact, not physics.
_TABLE_SANITY_FLOOR = -20.0


def build_thermal_table(n_gamma_nodes: int = 96, n_mu_nodes: int = 64) -> tuple:
    """Compute the (221, 81) thermal table via tensor-product quadrature.

    Equivalent of calculateTotalThermalCrossSection over the full grid
    (reference: hot_x_section.c:324-357), with deterministic Gauss-Legendre
    nodes instead of plain Monte Carlo.  The gamma integral spans
    [1, 1 + 12 theta] like the reference's integration box; below the table's
    theta floor the reference returns sigma_KN(eps') directly (:336-340) and so
    do we.

    Returns numpy (log_e, log_t, table) in float64.
    """
    log_e = np.linspace(LOG_PH_E_MIN, LOG_PH_E_MAX, N_PH_E + 1)
    log_t = np.linspace(LOG_T_MIN, LOG_T_MAX, N_T + 1)
    eps = 10.0**log_e
    theta = 10.0**log_t

    mu_x, mu_w = _gauss_legendre(n_mu_nodes, -1.0, 1.0)
    # gamma nodes on [0, 1] mapped per-theta to [1, 1 + 12 theta]
    g_x01, g_w01 = np.polynomial.legendre.leggauss(n_gamma_nodes)
    g_x01 = 0.5 * (g_x01 + 1.0)
    g_w01 = 0.5 * g_w01

    with _host_f64():
        th = jnp.asarray(theta, jnp.float64)[:, None]  # (T, 1)
        gamma = 1.0 + 12.0 * th * jnp.asarray(g_x01)[None, :]  # (T, G)
        g_w = 12.0 * th * jnp.asarray(g_w01)[None, :]  # (T, G)
        mj = maxwell_juttner_pdf(gamma, th)  # (T, G)

        @jax.jit
        def entry_for_eps(e):
            # integrand over (T, G, M)
            val = _boosted_xsec(e, jnp.asarray(mu_x)[None, None, :], gamma[..., None])
            inner = jnp.sum(val * jnp.asarray(mu_w)[None, None, :], axis=-1)  # (T, G)
            return 0.5 * jnp.sum(mj * inner * g_w, axis=-1)  # (T,)

        rows = []
        for e in eps:
            rows.append(np.asarray(entry_for_eps(jnp.float64(e)), dtype=np.float64))
    table = np.stack(rows, axis=0)  # (E, T)
    # clip away quadrature noise before taking logs; the floor must survive a
    # float32 cast (1e-300 underflows to 0 there, and log10(0) = -inf poisons
    # the bilinear interpolation with -inf * 0 = NaN at patch corners)
    table = np.maximum(table, 1e-30)
    return log_e, log_t, np.log10(table)


def build_nonthermal_table(cfg: Config, n_gamma_nodes: int = 128, n_mu_nodes: int = 64):
    """Per-subgroup nonthermal tables (221, N_GAMMA).

    Equivalent of calculateTotalNonThermalCrossSection (reference:
    hot_x_section.c:432-459): the electron pdf is the *full-range* normalized
    power law / broken power law evaluated over each log-spaced gamma subgroup
    interval (subgroup fractions are handled separately via
    electron_dens_subgroup, Src/electron.c:655-675).
    """
    from .electrons import broken_power_law_pdf, power_law_pdf

    log_e = np.linspace(LOG_PH_E_MIN, LOG_PH_E_MAX, N_PH_E + 1)
    eps = 10.0**log_e
    lg_min, lg_max = np.log10(cfg.gamma_min), np.log10(cfg.gamma_max)
    dg = (lg_max - lg_min) / cfg.n_gamma
    mu_x, mu_w = _gauss_legendre(n_mu_nodes, -1.0, 1.0)

    cols = []
    with _host_f64():
        for i in range(cfg.n_gamma):
            g_lo, g_hi = 10.0 ** (lg_min + i * dg), 10.0 ** (lg_min + (i + 1) * dg)
            g_x, g_w = _gauss_legendre(n_gamma_nodes, g_lo, g_hi)
            if cfg.nonthermal_e_dist is NonthermalDist.POWERLAW:
                pdf = power_law_pdf(
                    jnp.asarray(g_x), cfg.powerlaw_index, cfg.gamma_min, cfg.gamma_max
                )
            else:
                pdf = broken_power_law_pdf(
                    jnp.asarray(g_x),
                    cfg.powerlaw_index_1,
                    cfg.powerlaw_index_2,
                    cfg.gamma_min,
                    cfg.gamma_max,
                    cfg.gamma_break,
                )

            @jax.jit
            def col(e):
                val = _boosted_xsec(
                    e, jnp.asarray(mu_x)[None, :], jnp.asarray(g_x)[:, None]
                )
                inner = jnp.sum(val * jnp.asarray(mu_w)[None, :], axis=-1)  # (G,)
                return 0.5 * jnp.sum(pdf * inner * jnp.asarray(g_w))

            cols.append(
                np.asarray([col(jnp.float64(e)) for e in eps], dtype=np.float64)
            )
    table = np.stack(cols, axis=-1)
    # 1e-30 floor: float32-safe (see build_thermal_table)
    return log_e, np.log10(np.maximum(table, 1e-30))


# ---------------------------------------------------------------------------
# Disk cache (replaces the reference's text files + header validation,
# hot_x_section.c:852-1235)
# ---------------------------------------------------------------------------

# v2: float32-safe 1e-30 table floor (was 1e-300 -> -inf)
# v3: build forced onto host CPU in true float64 — a v2 cache built on the
#     accelerator with x64 off carried underflowed interior entries that
#     poisoned the interpolation
CACHE_VERSION = 3


def _cache_header(cfg: Config) -> dict:
    h = dict(
        version=CACHE_VERSION,
        log_e_min=LOG_PH_E_MIN,
        log_e_max=LOG_PH_E_MAX,
        n_e=N_PH_E,
        log_t_min=LOG_T_MIN,
        log_t_max=LOG_T_MAX,
        n_t=N_T,
        dist=cfg.nonthermal_e_dist.value,
    )
    if cfg.nonthermal_e_dist is not NonthermalDist.OFF:
        h.update(
            n_gamma=cfg.n_gamma,
            gamma_min=cfg.gamma_min,
            gamma_max=cfg.gamma_max,
            p=cfg.powerlaw_index or 0.0,
            p1=cfg.powerlaw_index_1 or 0.0,
            p2=cfg.powerlaw_index_2 or 0.0,
            gamma_break=cfg.gamma_break or 0.0,
        )
    return h


def load_or_build(cfg: Config, cache_path: Optional[str] = None, dtype=None) -> HotCrossSectionTable:
    """Load the cached table if its header matches, else build and cache.

    The header check mirrors validateThermalFile/validateNonthermalFile
    (reference: hot_x_section.c:852-1235): grid extents and distribution
    parameters must match the current config or the table is rebuilt.
    """
    header = _cache_header(cfg)
    data = None
    if cache_path and os.path.exists(cache_path):
        try:
            loaded = np.load(cache_path, allow_pickle=True)
            stored = loaded["header"].item()
            if stored == header and np.asarray(loaded["thermal"]).min() > _TABLE_SANITY_FLOOR:
                data = loaded
        except Exception:
            data = None
    if data is None:
        log_e, log_t, thermal = build_thermal_table()
        out = dict(header=np.asarray(header, dtype=object), log_e=log_e, log_t=log_t, thermal=thermal)
        if cfg.nonthermal_e_dist is not NonthermalDist.OFF:
            _, nonthermal = build_nonthermal_table(cfg)
            out["nonthermal"] = nonthermal
        if cache_path:
            # atomic write-then-swap (the reference instead keeps an _old copy
            # of files it overwrites, Src/mcrat_io.c:857)
            tmp = cache_path + ".tmp.npz"
            np.savez(tmp, **out)
            os.replace(tmp, cache_path)
        data = out
    dt = np.dtype(dtype or cfg.dtype)
    nt = data["nonthermal"] if "nonthermal" in getattr(data, "files", data) else None
    frac = None
    if cfg.nonthermal_e_dist is not NonthermalDist.OFF:
        from .cyclosynch import electron_dist_subgroup_dens

        frac = electron_dist_subgroup_dens(cfg)
    return HotCrossSectionTable(
        log_e=jnp.asarray(np.asarray(data["log_e"]), dtype=dt),
        log_t=jnp.asarray(np.asarray(data["log_t"]), dtype=dt),
        thermal=jnp.asarray(np.asarray(data["thermal"]), dtype=dt),
        nonthermal=jnp.asarray(np.asarray(nt), dtype=dt) if nt is not None else None,
        subgroup_frac=jnp.asarray(frac, dtype=dt) if frac is not None else None,
        thermal_quad=jnp.asarray(
            _corner_quad(np.asarray(data["thermal"])), dtype=dt
        ),
    )


def _corner_quad(table: np.ndarray) -> np.ndarray:
    """(4, nx*ny) flattened-and-shifted corner rows for one-gather bilinear."""
    ny = table.shape[1]
    flat = table.reshape(-1)
    return np.stack([
        flat,
        np.roll(flat, -1),
        np.roll(flat, -ny),
        np.roll(flat, -(ny + 1)),
    ])


# ---------------------------------------------------------------------------
# Interpolation (replaces the GSL bilinear 2-D spline, hot_x_section.c:545-605)
# ---------------------------------------------------------------------------


def _bilinear(table, x_grid, y_grid, x, y, quad=None):
    nx, ny = table.shape
    dx = x_grid[1] - x_grid[0]
    dy = y_grid[1] - y_grid[0]
    fx = jnp.clip((x - x_grid[0]) / dx, 0.0, nx - 1.000001)
    fy = jnp.clip((y - y_grid[0]) / dy, 0.0, ny - 1.000001)
    i0 = jnp.floor(fx).astype(jnp.int32)
    j0 = jnp.floor(fy).astype(jnp.int32)
    tx = fx - i0
    ty = fy - j0
    base = i0 * ny + j0
    # ONE minor-axis matrix gather instead of four flat-vector gathers, from
    # a PRE-MATERIALIZED corner matrix (the barrier below keeps the rolls and
    # stack from being fused into the gather's operand when it is built on
    # the fly).  The shifted rows alias the four bilinear corners; the wrap
    # elements are never addressed (base + ny + 1 <= nx*ny - 1 by the clips).
    if quad is None:
        flat = table.reshape(-1)
        quad = jnp.stack([
            flat,
            jnp.roll(flat, -1),
            jnp.roll(flat, -ny),
            jnp.roll(flat, -(ny + 1)),
        ])
        quad = jax.lax.optimization_barrier(quad)
    v = quad[:, base]
    v00, v01, v10, v11 = v[0], v[1], v[2], v[3]
    return (
        v00 * (1 - tx) * (1 - ty)
        + v01 * (1 - tx) * ty
        + v10 * tx * (1 - ty)
        + v11 * tx * ty
    )


def direct_sigma_hat(e_comv, theta, n_gamma_nodes: int = 32, n_mu_nodes: int = 24):
    """Per-lane direct evaluation of the hot cross-section integral.

    The out-of-table fallback: the reference recomputes the Monte Carlo
    integral on the fly when a lookup leaves the table
    (interpolateThermalHotCrossSection, hot_x_section.c:545-605).  Here the
    same [1, 1+12 theta] x [-1, 1] box is integrated by Gauss-Legendre
    quadrature, accumulated node-by-node in a fori_loop so no (N, nodes)
    intermediate ever materializes.
    """
    dt = jnp.result_type(e_comv, theta)
    gx01, gw01 = np.polynomial.legendre.leggauss(n_gamma_nodes)
    gx01 = jnp.asarray(0.5 * (gx01 + 1.0), dtype=dt)
    gw01 = jnp.asarray(0.5 * gw01, dtype=dt)
    mu_x, mu_w = _gauss_legendre(n_mu_nodes, -1.0, 1.0)
    mu_x, mu_w = jnp.asarray(mu_x, dtype=dt), jnp.asarray(mu_w, dtype=dt)

    def body(k, acc):
        i, j = k // n_mu_nodes, k % n_mu_nodes
        gamma = 1.0 + 12.0 * theta * gx01[i]
        mj = maxwell_juttner_pdf(gamma, theta)
        val = _boosted_xsec(e_comv, mu_x[j], gamma)
        return acc + (0.5 * 12.0) * theta * gw01[i] * mu_w[j] * mj * val

    acc = jax.lax.fori_loop(
        0, n_gamma_nodes * n_mu_nodes, body, jnp.zeros_like(e_comv + theta)
    )
    return acc


def interp_thermal(table: HotCrossSectionTable, e_comv, temp):
    """sigma_hat/sigma_T for photons of comoving energy ``e_comv`` (units of
    m_e c^2) in cells at temperature ``temp`` [K].

    Vectorized interpolateThermalHotCrossSection + getThermalCrossSection
    (reference: Src/optical_depth.c:132-149, hot_x_section.c:545-605): bilinear
    in (log10 eps', log10 theta), with the reference's out-of-range behavior —
    below the theta floor the cross section is the plain KN value, and lanes
    past any other table edge recompute the integral directly
    (hot_x_section.c:545-605); the recompute runs under a scalar lax.cond so
    in-range populations (the typical case) never pay for it.
    """
    from ..constants import KB_OVER_MEC2

    theta = KB_OVER_MEC2 * temp
    log_e = jnp.log10(jnp.maximum(e_comv, 1e-300))
    log_th = jnp.log10(jnp.maximum(theta, 1e-300))
    val = 10.0 ** _bilinear(table.thermal, table.log_e, table.log_t,
                            log_e, log_th, quad=table.thermal_quad)
    # Below the eps' table floor the KN correction is identically Thomson, so
    # the bilinear edge clamp IS the exact value there — crucially, dead/padded
    # lanes carry e_comv == 0 and must not trigger the recompute.  Only
    # overflow past the HIGH eps'/theta edges (hyper-energetic tails) needs
    # the direct integral.
    oor = (log_e > table.log_e[-1]) | (log_th > table.log_t[-1])

    def recompute(v):
        # Fixed-size bucket: overflow lanes are rare, so gather up to K of
        # them, run the 768-node quadrature on the bucket only (the full-lane
        # recompute costs ~0.5 s per call at 1M lanes), and scatter back.
        # Beyond-K offenders keep the edge-clamped value — a bounded, capped
        # approximation of the reference's recompute-all
        # (hot_x_section.c:545-605).
        k = min(4096, v.shape[0] if v.ndim else 1)
        flat_oor = oor.reshape(-1)
        idx = jnp.nonzero(flat_oor, size=k, fill_value=0)[0]
        n_oor = jnp.sum(flat_oor.astype(jnp.int32))
        valid = jnp.arange(k) < n_oor
        e_flat = jnp.broadcast_to(e_comv, flat_oor.shape).reshape(-1)
        th_flat = jnp.broadcast_to(theta, flat_oor.shape).reshape(-1)
        exact = direct_sigma_hat(e_flat[idx], th_flat[idx])
        v_flat = v.reshape(-1)
        v_flat = v_flat.at[idx].set(jnp.where(valid, exact, v_flat[idx]))
        return v_flat.reshape(v.shape)

    val = jax.lax.cond(jnp.any(oor), recompute, lambda v: v, val)
    cold = theta < 10.0**LOG_T_MIN
    return jnp.where(cold, kn_cross_section(e_comv), val)


def interp_nonthermal(table: HotCrossSectionTable, e_comv):
    """Per-subgroup sigma_hat/sigma_T, shape (N, N_GAMMA).

    Vectorized interpolateSubgroupNonThermalHotCrossSection (reference:
    hot_x_section.c; consumed at Src/optical_depth.c:151-168).
    """
    log_e = jnp.log10(jnp.maximum(e_comv, 1e-300))
    ne = table.nonthermal.shape[0]
    dx = table.log_e[1] - table.log_e[0]
    fx = jnp.clip((log_e - table.log_e[0]) / dx, 0.0, ne - 1.000001)
    i0 = jnp.floor(fx).astype(jnp.int32)
    tx = (fx - i0)[..., None]
    v0 = table.nonthermal[i0]
    v1 = table.nonthermal[i0 + 1]
    return 10.0 ** (v0 * (1 - tx) + v1 * tx)
