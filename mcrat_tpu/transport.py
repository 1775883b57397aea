"""Batched photon transport engine.

JAX re-design of the reference transport layer (Src/mclib.c).  The
reference's event loop is serial per rank: find the globally-smallest scatter
time, advance *all* photons to it, scatter *one* photon, then resample every
mean free path and re-sort (Src/mclib.c:617-714, 1107-1356) — O(N log N) work
per scattering event.  Here every photon advances through its own exponential
free-path sequence within the frame's time window concurrently:

    while any photon has frame-time left:
        lookup cell -> tau-rate -> sample dt -> move -> attempt KN scatter

Each photon's chain is independent given the frozen hydro frame (the same
assumption MCRaT itself makes across MPI ranks), and failed KN attempts are
null collisions, so the event statistics agree with the reference in
distribution; the exponential's memorylessness covers the resampling-after-
every-event behavior of the C code.

Photon state is a fixed-capacity structure-of-arrays pytree with masking
replacing the reference's null-photon slot recycling (Src/photons.c).
Four-momenta are dimensionless (units of m_e c); positions are in cm.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from . import pytree as struct

from .config import Config, Dims, PhotonType, Spectrum, TauCalculation
from .constants import C_LIGHT, H_OVER_MEC2, K_B, M_P, PL_CONST, THOM_X_SECT
from . import geometry as geo
from .grid import HydroFrame, HydroFrameHost, find_cell
from .ops import compton, electrons
from .ops.fourvec import lorentz_boost
from .ops.stokes import stokes_rotation

# Default mean free path for photons outside the grid [cm]
# (reference: Src/mclib.c:620,684)
DEFAULT_MFP = 1e12

# Number-density coefficients xi such that n_gamma = xi T'^3 [cm^-3 K^-3]
# (reference: Src/mclib.c:20-28; MCRaT paper)
NUM_DENS_COEFF_BB = 20.29
NUM_DENS_COEFF_WIEN = 8.44


@struct.dataclass
class Photons:
    """Photon population: pytree of (N,) / (N,k) device arrays.

    Mirrors struct photon (reference: Src/mcrat.h:142-171) as SoA.  ``weight``
    is normalized by the python-side ``weight_norm`` carried in PhotonsMeta to
    keep float32-friendly dynamic range.
    """

    p: jax.Array  # (N, 4) lab four-momentum, units m_e c
    comv_p: jax.Array  # (N, 4) comoving four-momentum
    pos: jax.Array  # (N, 3) MCRaT Cartesian position [cm]
    s: jax.Array  # (N, 4) Stokes (I, Q, U, V), I == 1
    weight: jax.Array  # (N,) normalized statistical weight; 0 => null slot
    num_scatt: jax.Array  # (N,)
    cell: jax.Array  # (N,) int32 containing-cell index; -1 = outside/unknown
    ptype: jax.Array  # (N,) int32 PhotonType

    @property
    def capacity(self) -> int:
        return self.p.shape[0]

    @property
    def alive(self) -> jax.Array:
        return (self.weight > 0) & (self.ptype != PhotonType.NULL)


class PhotonsMeta(NamedTuple):
    """Host-side bookkeeping for a photon population."""

    weight_norm: float  # physical weight = weight * weight_norm
    n_injected: int


def empty_photons(capacity: int, dtype) -> Photons:
    z4 = jnp.zeros((capacity, 4), dtype)
    return Photons(
        p=z4,
        comv_p=z4,
        pos=jnp.zeros((capacity, 3), dtype),
        s=z4,
        weight=jnp.zeros((capacity,), dtype),
        num_scatt=jnp.zeros((capacity,), dtype),
        cell=jnp.full((capacity,), -1, jnp.int32),
        ptype=jnp.full((capacity,), int(PhotonType.NULL), jnp.int32),
    )


# ---------------------------------------------------------------------------
# Injection (host side, numpy float64)
# ---------------------------------------------------------------------------


def _injection_shell_mask(host: HydroFrameHost, rmin, rmax, theta_min, theta_max):
    """Cells whose corner-spherical extent intersects the injection shell.

    Mirrors the triple-repeated selection in photonInjection (reference:
    Src/mclib.c:37-70): inner/outer cell corners mapped to spherical (r, theta)
    with |coords| in 3-D.
    """
    cfg = host.cfg
    if cfg.dims is Dims.THREE and getattr(host, "jet_axis", "z") != "z":
        # Off-z jet axis (RIKEN 3-D): the wedge is measured from the reader's
        # theta' cache at cell CENTERS, exactly like photonInjection3D
        # (Src/mclib_riken.c:965-1014 — acos(y/r) per cell, strict "< max,
        # >= min", and no corner extents).  The radial shell test stays
        # corner-extended in r (axis-independent).
        r_lo = host.r - host.dr0 / 2
        r_hi = host.r + host.dr0 / 2
        return (
            (rmin <= r_hi) & (r_lo <= rmax)
            & (host.theta >= theta_min) & (host.theta < theta_max)
        )
    if cfg.dims is Dims.THREE:
        a0, a1, a2 = np.abs(host.r0), np.abs(host.r1), np.abs(host.r2)
        r_in, t_in = geo.hydro_to_spherical(
            cfg, a0 - host.dr0 / 2, a1 - host.dr1 / 2, a2 - host.dr2 / 2
        )
        r_out, t_out = geo.hydro_to_spherical(
            cfg, a0 + host.dr0 / 2, a1 + host.dr1 / 2, a2 + host.dr2 / 2
        )
    else:
        r_in, t_in = geo.hydro_to_spherical(
            cfg, host.r0 - host.dr0 / 2, host.r1 - host.dr1 / 2, 0.0
        )
        r_out, t_out = geo.hydro_to_spherical(
            cfg, host.r0 + host.dr0 / 2, host.r1 + host.dr1 / 2, 0.0
        )
    r_in, t_in, r_out, t_out = map(np.asarray, (r_in, t_in, r_out, t_out))
    return (rmin <= r_out) & (r_in <= rmax) & (t_out >= theta_min) & (t_in <= theta_max)


def sample_bb_frequency(rng: np.random.Generator, temp: np.ndarray) -> np.ndarray:
    """Blackbody photon frequencies via the Bjorkman & Wood (2001) zeta-series
    inverse method (reference: Src/mclib.c:199-214).
    """
    n = len(temp)
    u1 = rng.random(n)
    # smallest m with sum_{k<=m} k^-4 >= (pi^4/90) * u1
    kmax = 128
    cum = np.cumsum(1.0 / np.arange(1, kmax + 1, dtype=np.float64) ** 4)
    target = (np.pi**4 / 90.0) * u1
    m = np.searchsorted(cum, target, side="left") + 1
    u = rng.random((4, n))
    u = np.maximum(u, np.finfo(np.float64).tiny)
    x = -np.log(u[0] * u[1] * u[2] * u[3]) / m
    return x * K_B * temp / PL_CONST


def sample_wien_frequency(rng: np.random.Generator, temp: np.ndarray) -> np.ndarray:
    """Wien-spectrum frequencies by rejection (reference: Src/mclib.c:177-190)."""
    n = len(temp)
    out = np.zeros(n)
    todo = np.ones(n, dtype=bool)
    while todo.any():
        t = temp[todo]
        fr = rng.random(len(t)) * 6.3e11 * t
        y = rng.random(len(t))
        f = (1.0 / 1.29e31) * (fr / t) ** 3 / np.expm1(PL_CONST * fr / (K_B * t))
        acc = y <= f
        idx = np.flatnonzero(todo)[acc]
        out[idx] = fr[acc]
        todo[idx] = False
    return out


def inject_photons(
    host: HydroFrameHost,
    r_inj: float,
    ph_weight: float,
    min_photons: int,
    max_photons: int,
    spect: Spectrum,
    theta_min: float,
    theta_max: float,
    fps: float,
    rng: np.random.Generator,
) -> Tuple[dict, float]:
    """Inject thermal photons into the shell r_inj +/- c/(2 fps).

    Host-side numpy re-design of photonInjection (reference: Src/mclib.c:9-300):
    per-cell expected counts n_i = (4/3) dV Gamma xi T'^3 / w drawn Poisson,
    with the weight auto-tuned x10 / x0.5 until min <= N <= max; per photon a
    comoving BB/Wien frequency, isotropic comoving direction boosted to the
    lab, uniform position inside the cell, Stokes (1,0,0,0).

    Returns (dict of numpy photon arrays, adjusted_weight).
    """
    cfg = host.cfg
    xi = NUM_DENS_COEFF_WIEN if spect is Spectrum.WIEN else NUM_DENS_COEFF_BB
    rmin = r_inj - 0.5 * C_LIGHT / fps
    rmax = r_inj + 0.5 * C_LIGHT / fps
    mask = _injection_shell_mask(host, rmin, rmax, theta_min, theta_max)
    sel = np.flatnonzero(mask)
    if len(sel) == 0:
        raise ValueError(
            f"no hydro cells intersect injection shell r={r_inj:.3e} +/- "
            f"{0.5*C_LIGHT/fps:.3e}, theta in [{theta_min}, {theta_max}]"
        )
    dv = host.volumes()[sel]
    mean_unw = (4.0 / 3.0) * dv * host.gamma[sel] * xi * host.temp[sel] ** 3

    w = ph_weight
    # Coarse pre-scaling without sampling: brings the expected total into a
    # range where the Poisson draws are well defined (numpy rejects lam >
    # ~9e18; the reference's x10/x0.5 loop would get there eventually anyway,
    # Src/mclib.c:121-131).
    total = float(mean_unw.sum())
    while total / w > 10.0 * max_photons:
        w *= 10.0
    while total / w < 0.1 * max(min_photons, 1):
        w *= 0.5
    for _ in range(200):
        counts = rng.poisson(mean_unw / w)
        ph_tot = int(counts.sum())
        if ph_tot > max_photons:
            w *= 10.0
        elif ph_tot < min_photons:
            w *= 0.5
        else:
            break
    else:
        raise RuntimeError("injection weight auto-tune did not converge")

    cell_idx = np.repeat(sel, counts)
    n = len(cell_idx)
    temp = host.temp[cell_idx]

    if spect is Spectrum.WIEN:
        fr = sample_wien_frequency(rng, temp)
    else:
        fr = sample_bb_frequency(rng, temp)
    # dimensionless photon energy h nu / (m_e c^2)
    e_hat = fr * H_OVER_MEC2

    # isotropic comoving direction (reference: mclib.c:225-233)
    com_phi = rng.random(n) * 2.0 * np.pi
    com_cos_t = rng.random(n) * 2.0 - 1.0
    com_sin_t = np.sqrt(np.maximum(1.0 - com_cos_t**2, 0.0))
    p_comv = np.stack(
        [
            e_hat,
            e_hat * com_sin_t * np.cos(com_phi),
            e_hat * com_sin_t * np.sin(com_phi),
            e_hat * com_cos_t,
        ],
        axis=-1,
    )

    # fluid velocity in MCRaT Cartesian at the cell (az = position phi in 2-D)
    if cfg.dims is Dims.THREE:
        pos_phi = np.zeros(n)
        x2 = host.r2[cell_idx]
    else:
        pos_phi = rng.random(n) * 2.0 * np.pi
        x2 = pos_phi
    v2 = host.v2[cell_idx] if cfg.dims is not Dims.TWO else np.zeros(n)
    bx, by, bz = geo.hydro_vector_to_cartesian(
        cfg, host.v0[cell_idx], host.v1[cell_idx], v2,
        host.r0[cell_idx], host.r1[cell_idx], x2,
    )
    beta = -np.stack([np.asarray(bx), np.asarray(by), np.asarray(bz)], axis=-1)
    # comoving -> lab boost (boost velocity = -v_fluid; reference: mclib.c:245-250)
    # — on HOST numpy: injection is host-side work, and routing the boost
    # through the device would cost a full-population round-trip
    p_lab = np.asarray(lorentz_boost(beta, p_comv))

    # uniform position inside the cell (reference: mclib.c:263-270)
    u0 = (rng.random(n) - 0.5) * host.dr0[cell_idx]
    u1 = (rng.random(n) - 0.5) * host.dr1[cell_idx]
    if cfg.dims is Dims.THREE:
        u2 = (rng.random(n) - 0.5) * host.dr2[cell_idx]
        px, py, pz = geo.hydro_to_mcrat(
            cfg, host.r0[cell_idx] + u0, host.r1[cell_idx] + u1, host.r2[cell_idx] + u2
        )
    else:
        px, py, pz = geo.hydro_to_mcrat(
            cfg, host.r0[cell_idx] + u0, host.r1[cell_idx] + u1, pos_phi
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
            ptype=np.full(n, int(PhotonType.INJECTED), np.int32),
        ),
        w,
    )


def photons_from_arrays(arrays: dict, capacity: Optional[int], dtype, weight_norm=None):
    """Pack host photon arrays into a fixed-capacity device Photons + meta."""
    n = len(arrays["weight"])
    cap = capacity or n
    assert cap >= n
    if weight_norm is None:
        weight_norm = float(np.median(arrays["weight"])) or 1.0
    ph = empty_photons(cap, dtype)

    def fill(buf, val, fillval=0):
        out = np.full(buf.shape, fillval, dtype=np.asarray(val).dtype)
        out[:n] = val
        return jnp.asarray(out, dtype=buf.dtype)

    ph = ph.replace(
        p=fill(ph.p, arrays["p"]),
        comv_p=fill(ph.comv_p, arrays["comv_p"]),
        pos=fill(ph.pos, arrays["pos"]),
        s=fill(ph.s, arrays["s"]),
        weight=fill(ph.weight, arrays["weight"] / weight_norm),
        num_scatt=fill(ph.num_scatt, arrays["num_scatt"]),
        cell=fill(ph.cell, arrays["cell"], -1),
        ptype=fill(ph.ptype, arrays["ptype"], int(PhotonType.NULL)),
    )
    return ph, PhotonsMeta(weight_norm=weight_norm, n_injected=n)


# ---------------------------------------------------------------------------
# Transport (device, jitted)
# ---------------------------------------------------------------------------


class FrameResult(NamedTuple):
    photons: Photons
    n_scatt: int  # total scattering events this frame (weightless count)
    n_rounds: int  # while-loop trips taken (host ints: they come from the
    # chunk fetch, and re-wrapping them as device arrays would cost one more
    # device round-trip per frame)
    t_rem: Optional[jax.Array] = None  # (N,) remaining frame time (set when
    # the frame exits early for a mid-frame rebin, so the caller can resume)
    rebin_pending: bool = False  # True => scattered-CS population exceeded
    # cs_limit mid-frame; caller must rebin and re-enter with t_rem
    n_cs: Optional[int] = None  # live scattered-CS count from the last chunk
    # fetch (host int; set only when cs_limit was armed)


class ChunkResult(NamedTuple):
    photons: Photons
    t_rem: jax.Array  # (N,) frame time left per photon
    n_scatt: jax.Array
    n_rounds: jax.Array
    all_done: jax.Array  # scalar bool: no active photons remain this frame
    n_active: jax.Array  # scalar int32: photons still alive with time left
    n_cs: jax.Array  # scalar int32: live scattered-CS photons (COMPTONIZED |
    # UNABSORBED_CS) — the mid-frame rebin trigger count
    # (reference: Src/mcrat.c:819-830)


def _count_cs(photons: Photons) -> jax.Array:
    """Live scattered-CS photon count (rebin trigger population)."""
    is_cs = (photons.ptype == int(PhotonType.COMPTONIZED)) | (
        photons.ptype == int(PhotonType.UNABSORBED_CS)
    )
    return jnp.sum((photons.alive & is_cs).astype(jnp.int32)).astype(jnp.int32)


def _tau_rate(cfg: Config, frame: HydroFrame, photons: Photons, cell, xsec_table=None, rows=None):
    """Per-photon optical depth per unit length [1/cm].

    Vectorized calculateOpticalDepth, thermal path (reference:
    Src/optical_depth.c:7-59):
        rate = (dens_lab/m_p) sigma_T sigma_hat (1 - beta cos_angle)
    with cos_angle between the fluid velocity and the photon's lab momentum.
    DIRECT mode uses sigma_hat = 1 (Thomson); TABLE mode interpolates the hot
    cross section (ops.hot_xsec).
    """
    from .grid import PCOL, fluid_beta_from_rows

    safe = jnp.clip(cell, 0, frame.num_elements - 1)
    if rows is None:
        rows = frame.packed[:, safe] if frame.packed is not None else None
    if rows is not None:
        fluid_beta = fluid_beta_from_rows(cfg, rows, photons.pos[:, 0], photons.pos[:, 1])
        gam = rows[PCOL["gamma"]]
        dens_lab = rows[PCOL["dens_lab"]]
        temp = rows[PCOL["temp"]]
        nt_dens = rows[PCOL["nonthermal_dens"]]
    else:
        fluid_beta = frame.fluid_beta_at(cfg, safe, photons.pos[:, 0], photons.pos[:, 1])
        gam = frame.gamma[safe]
        dens_lab = frame.dens_lab[safe]
        temp = frame.temp[safe]
        nt_dens = frame.nonthermal_dens[safe]
    fl_norm = jnp.sqrt(jnp.sum(fluid_beta**2, axis=-1))
    pv = photons.p[:, 1:]
    ph_norm = jnp.sqrt(jnp.sum(pv * pv, axis=-1))
    denom = jnp.maximum(fl_norm * ph_norm, jnp.finfo(pv.dtype).tiny)
    cos_ang = jnp.sum(fluid_beta * pv, axis=-1) / denom
    beta = jnp.sqrt(jnp.maximum(1.0 - 1.0 / (gam * gam), 0.0))
    n_e_lab = dens_lab / M_P
    if cfg.tau_calculation is TauCalculation.TABLE and xsec_table is not None:
        from .ops import hot_xsec

        sigma_hat = hot_xsec.interp_thermal(
            xsec_table, photons.comv_p[:, 0], temp
        )
    else:
        sigma_hat = 1.0
    fluid_factor = 1.0 - beta * cos_ang
    tau0 = n_e_lab * THOM_X_SECT * sigma_hat * fluid_factor

    from .config import NonthermalDist

    if cfg.nonthermal_e_dist is NonthermalDist.OFF or xsec_table is None:
        return tau0, fluid_beta, None

    # Multi-population optical depths with scattering biases (vectorized
    # calculateOpticalDepth nonthermal path, reference: Src/optical_depth.c:
    # 60-112).  tau_i = n_nt,lab f_i sigma_T sigma_hat_i (1 - beta mu);
    # thermal bias = 1 (calculateThermalScatteringBias returns 1.0, :170-175);
    # bias_i = bias_0 tau_norm / tau_i (:177-183) with tau_norm = tau_0, or
    # the first subgroup's tau when the cell has no thermal electrons.
    from .ops import hot_xsec

    sigma_sub = hot_xsec.interp_nonthermal(xsec_table, photons.comv_p[:, 0])
    n_nt_lab = nt_dens * gam
    tiny = jnp.finfo(tau0.dtype).tiny
    tau_i = (
        n_nt_lab[:, None]
        * xsec_table.subgroup_frac[None, :]
        * THOM_X_SECT
        * sigma_sub
        * fluid_factor[:, None]
    )
    tau_norm = jnp.where(tau0 > 0, tau0, tau_i[:, 0])
    bias_i = tau_norm[:, None] / jnp.maximum(tau_i, tiny)
    total = tau0 + jnp.sum(bias_i * tau_i, axis=-1)
    return total, fluid_beta, (tau0, tau_i, bias_i, total)


@functools.partial(jax.jit, static_argnames=("cfg", "stokes_on", "max_rounds"))
def transport_rounds(
    cfg: Config,
    photons: Photons,
    frame: HydroFrame,
    index,
    t_rem,
    key,
    xsec_table=None,
    stokes_on: bool = True,
    max_rounds: int = 0,
) -> "ChunkResult":
    """Advance the population by up to ``max_rounds`` scatter rounds.

    Batched equivalent of the reference per-frame hot loop
    (Src/mcrat.c:761-846: findContainingHydroCell + calcMeanFreePath +
    photonEvent until the next frame boundary).  ``t_rem`` is the per-photon
    time left in the frame window; the loop exits when every photon's window is
    exhausted or after ``max_rounds`` trips (0 = unbounded up to the config
    safety cap), so callers can chunk very optically-thick frames into several
    device executions (progress logging, checkpoint cadence and compaction
    all want bounded kernels).
    """
    dtype = photons.p.dtype
    cap = photons.capacity
    round_cap = max_rounds if max_rounds > 0 else cfg.max_rounds_per_frame
    use_rows = frame.packed is not None

    def cond(carry):
        ph, rows, t_rem, key, n_scatt, rounds = carry
        active = ph.alive & (t_rem > 0)
        return jnp.any(active) & (rounds < round_cap)

    def body(carry):
        ph, rows, t_rem, key, n_scatt, rounds = carry
        key, k_mfp, k_el, k_sc = jax.random.split(key, 4)
        active = ph.alive & (t_rem > 0)
        # CS pool photons scatter in place but never move (the reference
        # excludes them from updatePhotonPosition, Src/mclib.c:1070, while
        # they still compete in the candidate queue)
        is_pool = ph.ptype == PhotonType.CS_POOL

        # 1.+2. containing cell and its packed property row.  The row is
        # carried across rounds, so the steady state (photon stays in its
        # cell) does zero gathers and zero index searches.
        if use_rows:
            from .grid import find_cell_rows

            cell, rows, in_grid = find_cell_rows(cfg, index, frame, ph.pos, ph.cell, rows)
        else:
            cell, _ = find_cell(cfg, index, frame, ph.pos, ph.cell)
            in_grid = cell >= 0
        rate, fluid_beta, tau_aux = _tau_rate(cfg, frame, ph, cell, xsec_table, rows=rows)
        comv_p = lorentz_boost(fluid_beta, ph.p, photon=True)
        ph = ph.replace(
            comv_p=jnp.where((active & in_grid)[:, None], comv_p, ph.comv_p),
            cell=jnp.where(active, cell, ph.cell),
        )

        # 3. exponential free path -> candidate time step
        u = jax.random.uniform(k_mfp, (cap,), dtype=dtype)
        u = jnp.maximum(u, jnp.finfo(dtype).tiny)
        mfp = jnp.where(
            in_grid & (rate > 0), -jnp.log(u) / jnp.maximum(rate, jnp.finfo(dtype).tiny), DEFAULT_MFP
        )
        dt_scatt = mfp / C_LIGHT
        will_scatter = active & in_grid & (dt_scatt < t_rem)
        dt = jnp.where(will_scatter, dt_scatt, t_rem)
        dt = jnp.where(active, dt, 0.0)

        # 4. advance along the lab direction at c (reference: mclib.c:1054-1100)
        inv_p0 = 1.0 / jnp.maximum(ph.p[:, 0], jnp.finfo(dtype).tiny)
        step = (ph.p[:, 1:] * inv_p0[:, None]) * (C_LIGHT * dt)[:, None]
        moves = active & ~is_pool
        ph = ph.replace(pos=jnp.where(moves[:, None], ph.pos + step, ph.pos))
        t_rem = t_rem - dt

        # 5. attempt the scattering for candidates (null collision on reject)
        if use_rows:
            from .grid import PCOL

            temp = rows[PCOL["temp"]]
        else:
            temp = frame.temp[jnp.clip(ph.cell, 0, frame.num_elements - 1)]
        if stokes_on:
            s_comv = stokes_rotation(fluid_beta, ph.p[:, 1:], ph.comv_p[:, 1:], ph.s)
        else:
            s_comv = ph.s
        el_p = electrons.sample_thermal_electron(k_el, temp, ph.comv_p)
        if tau_aux is not None:
            # Choose the scattering electron population per photon from the
            # biased cumulative optical depths (vectorized
            # generateSingleElectron, reference: Src/electron.c:7-68 — with
            # the proper uniform draw; the reference has a leftover testing
            # override random_num = 0.6 at electron.c:21).
            tau0, tau_i, bias_i, total = tau_aux
            k_pop, k_nt = jax.random.split(jax.random.fold_in(k_el, 1))
            u = jax.random.uniform(k_pop, tau0.shape, dtype=dtype)
            safe_total = jnp.maximum(total, jnp.finfo(dtype).tiny)
            cum_thermal = tau0 / safe_total
            is_thermal = cum_thermal >= u
            cum = cum_thermal[:, None] + jnp.cumsum(bias_i * tau_i, axis=-1) / safe_total[:, None]
            subgroup = 1 + jnp.sum((u[:, None] > cum).astype(jnp.int32), axis=-1)
            subgroup = jnp.clip(subgroup, 1, cfg.n_gamma)
            el_nt = electrons.sample_nonthermal_electron(k_nt, subgroup, ph.comv_p, cfg)
            el_p = jnp.where(is_thermal[:, None], el_p, el_nt)
        res = compton.single_scatter(k_sc, el_p, ph.comv_p, s_comv, stokes_on=stokes_on)
        scattered = will_scatter & res.scattered
        new_lab = lorentz_boost(-fluid_beta, res.ph_p, photon=True)
        if stokes_on:
            s_lab = stokes_rotation(-fluid_beta, res.ph_p[:, 1:], new_lab[:, 1:], res.s)
        else:
            s_lab = res.s
        mask = scattered[:, None]
        # a scattered pool photon is promoted to COMPTONIZED
        # (reference: Src/mcrat.c:791-808); the driver replenishes the pool
        # one-for-one at chunk boundaries
        new_type = jnp.where(
            scattered & is_pool, int(PhotonType.COMPTONIZED), ph.ptype
        )
        ph = ph.replace(
            p=jnp.where(mask, new_lab, ph.p),
            comv_p=jnp.where(mask, res.ph_p, ph.comv_p),
            s=jnp.where(mask, s_lab, ph.s),
            num_scatt=ph.num_scatt + scattered.astype(dtype),
            ptype=new_type,
        )
        n_scatt = n_scatt + jnp.sum(scattered).astype(n_scatt.dtype)
        return ph, rows, t_rem, key, n_scatt, rounds + 1

    if use_rows:
        from .grid import gather_rows

        rows0 = gather_rows(frame, photons.cell)
    else:
        rows0 = None
    ph, _, t_rem, _, n_scatt, rounds = jax.lax.while_loop(
        cond,
        body,
        (
            photons,
            rows0,
            jnp.asarray(t_rem, dtype),
            key,
            jnp.zeros((), jnp.int64 if dtype == jnp.float64 else jnp.int32),
            jnp.zeros((), jnp.int32),
        ),
    )
    active = ph.alive & (t_rem > 0)
    return ChunkResult(
        photons=ph, t_rem=t_rem, n_scatt=n_scatt, n_rounds=rounds,
        all_done=~jnp.any(active),
        n_active=jnp.sum(active.astype(jnp.int32)).astype(jnp.int32),
        n_cs=_count_cs(ph),
    )


def frame_time(photons: Photons, dt_max) -> jax.Array:
    """Initial per-photon frame time window."""
    dtype = photons.p.dtype
    return jnp.where(photons.alive, jnp.asarray(dt_max, dtype), 0.0)


def _gather_photons(photons: Photons, idx) -> Photons:
    return jax.tree_util.tree_map(lambda a: jnp.take(a, idx, axis=0), photons)


def _scatter_photons(dst: Photons, slots, src: Photons) -> Photons:
    """Write ``src`` lanes back into ``dst`` at ``slots``.

    Pad lanes carry ``slots == dst.capacity`` (out of bounds) and are dropped
    by the scatter, so the whole tree writes under one mask-free executable.
    """
    return jax.tree_util.tree_map(
        lambda d, s: d.at[slots].set(s, mode="drop"), dst, src
    )


def _compact_step_impl(result_ph: Photons, slots, work_ph: Photons, t_rem, new_cap: int):
    """One compaction: write the working set back, gather actives into a
    ``new_cap`` buffer — entirely on device.

    One executable instead of a host-side flatnonzero over a fetched alive
    mask plus ~60 un-jitted per-leaf dispatches.  Returns
    ``(result_ph, sub_ph, sub_t, sub_slots)`` where ``sub_slots`` maps working
    lanes to original slots, with pads set to ``result_ph.capacity`` so the
    write-back scatter drops them.

    Kept un-jitted so mesh callers can re-jit it with ``out_shardings`` (the
    compacted buffers then land already sharded over the mesh, with no eager
    per-leaf device_put reshard).
    """
    result_ph = _scatter_photons(result_ph, slots, work_ph)
    active = work_ph.alive & (t_rem > 0)
    idx = jnp.nonzero(active, size=new_cap, fill_value=-1)[0]
    valid = idx >= 0
    safe = jnp.where(valid, idx, 0)
    sub = _gather_photons(work_ph, safe)
    # dead-pad the fill lanes so they cannot transport twice
    sub = sub.replace(
        weight=jnp.where(valid, sub.weight, 0.0),
        ptype=jnp.where(
            valid, sub.ptype, jnp.asarray(int(PhotonType.NULL), sub.ptype.dtype)
        ),
    )
    sub_t = jnp.where(valid, t_rem[safe], jnp.zeros((), t_rem.dtype))
    sentinel = jnp.asarray(result_ph.capacity, slots.dtype)
    sub_slots = jnp.where(valid, slots[safe], sentinel)
    return result_ph, sub, sub_t, sub_slots


_compact_step = functools.partial(jax.jit, static_argnames=("new_cap",))(
    _compact_step_impl
)


def transport_frame(
    cfg: Config,
    photons: Photons,
    frame: HydroFrame,
    index,
    dt_max,
    key,
    xsec_table=None,
    stokes_on: bool = True,
    chunk_rounds: int = 0,
    progress=None,
    compact: bool = True,
    min_compact_capacity: int = 1024,
    step_fn=None,
    compact_fn=None,
    t_rem0=None,
    cs_limit: Optional[int] = None,
) -> FrameResult:
    """Advance the whole population through one hydro-frame time window.

    ``t_rem0`` resumes a partially-transported frame (per-photon time left,
    as returned by an early exit).  ``cs_limit`` arms the mid-frame rebin
    trigger (reference: every-1000-scatterings check, Src/mcrat.c:819-830):
    when the live scattered-CS count exceeds it at a chunk boundary, the
    frame exits early with ``rebin_pending=True`` and ``t_rem`` set so the
    driver can rebin the population and re-enter.

    Host-level wrapper over :func:`transport_rounds`: when ``chunk_rounds`` > 0
    the frame is executed in bounded-round device chunks with an optional
    ``progress(n_scatt_total, rounds_total)`` callback between chunks (the
    analogue of the reference's log-every-1000-scatterings cadence,
    Src/mcrat.c:810-817).

    With ``compact`` on, the working set shrinks between chunks: once fewer
    than a quarter of lanes are still active, the active photons are gathered
    into a half/quarter-size buffer and transport continues there.  A round's
    device cost is proportional to the *buffer* size, not the active count, so
    without compaction the "runaway photon" tail — one deep photon scattering
    1e4+ times (the effect the reference fights manually with mcrat_msp.sh) —
    dominates frame wall time.  Buffer capacities stay a geometric sequence so
    only O(log N) distinct shapes ever compile.

    ``step_fn(photons, t_rem, key) -> ChunkResult`` overrides the device step;
    parallel.mesh uses it to run the same chunk/compaction protocol with every
    step sharded over a device mesh.  ``compact_fn`` overrides the compaction
    executable (same signature/returns as ``_compact_step``; it may round
    ``new_cap`` up) — mesh callers use a re-jit with ``out_shardings`` so the
    shrunken buffers land balanced across their devices with no separate
    reshard step.
    """
    t_rem = frame_time(photons, dt_max) if t_rem0 is None else t_rem0
    n_scatt_total = 0
    rounds_total = 0
    # working-set state: photons/t_rem of the current buffer + original slots
    work_ph, work_t = photons, t_rem
    slots = None  # None => working set is the full population
    result_ph = photons
    rebin_pending = False

    while True:
        key, sub = jax.random.split(key)
        if step_fn is not None:
            res = step_fn(work_ph, work_t, sub)
        else:
            res = transport_rounds(
                cfg, work_ph, frame, index, work_t, sub,
                xsec_table=xsec_table, stokes_on=stokes_on, max_rounds=chunk_rounds,
            )
        work_ph, work_t = res.photons, res.t_rem
        # ONE host<->device fetch per chunk: each separate int()/bool() is a
        # device sync on the chunk loop's critical path.  The fetch is
        # scalars only; the compaction below runs on device.
        will_compact = (
            compact and chunk_rounds != 0
            and work_ph.capacity > min_compact_capacity
        )
        fetch = [res.n_scatt, res.n_rounds, res.all_done]
        if will_compact:
            fetch.append(res.n_active)
        if cs_limit is not None:
            fetch.append(res.n_cs)
        fetched = jax.device_get(fetch)
        n_scatt_total += int(fetched[0])
        rounds_total += int(fetched[1])
        if progress is not None:
            progress(n_scatt_total, rounds_total)
        done = bool(fetched[2])
        if cs_limit is not None and int(fetched[-1]) > cs_limit and not done:
            # mid-frame rebin trigger: exit with the frame time preserved so
            # the driver can merge the scattered-CS population and resume
            # (reference: Src/mcrat.c:819-830)
            rebin_pending = True
            break
        if done or chunk_rounds == 0 or rounds_total >= cfg.max_rounds_per_frame:
            break
        if will_compact:
            n_active = int(fetched[3])
            if n_active < work_ph.capacity // 4:
                if slots is None:
                    result_ph = work_ph
                    slots = jnp.arange(work_ph.capacity, dtype=jnp.int32)
                new_cap = max(min_compact_capacity, 1 << int(np.ceil(np.log2(max(n_active, 1)))))
                result_ph, work_ph, work_t, slots = (compact_fn or _compact_step)(
                    result_ph, slots, work_ph, work_t, new_cap
                )

    # final write-back (photon state + remaining frame time)
    if slots is None:
        result_ph, result_t = work_ph, work_t
    else:
        result_ph = _scatter_photons(result_ph, slots, work_ph)
        result_t = jnp.zeros((result_ph.capacity,), work_t.dtype).at[slots].set(
            work_t, mode="drop"
        )
    return FrameResult(
        photons=result_ph,
        n_scatt=n_scatt_total,
        n_rounds=rounds_total,
        t_rem=result_t,
        rebin_pending=rebin_pending,
        n_cs=int(fetched[-1]) if cs_limit is not None else None,
    )


# ---------------------------------------------------------------------------
# Statistics (reference: Src/mclib.c:1358-1515)
# ---------------------------------------------------------------------------


def average_photon_energy(photons: Photons):
    """Weighted mean lab energy [erg] (reference: averagePhotonEnergy, mclib.c:1358).

    Photon p0 is dimensionless (units m_e c^2 after multiplying by m_e c^2).
    """
    from .constants import ME_C2

    w = jnp.where(photons.alive, photons.weight, 0.0)
    e = jnp.sum(photons.p[:, 0] * w) / jnp.maximum(jnp.sum(w), jnp.finfo(w.dtype).tiny)
    return e * ME_C2


def scatt_stats(photons: Photons):
    """(max, min, mean) scatterings and mean radius over live photons
    (reference: phScattStats, Src/mclib.c:1385-1462)."""
    alive = photons.alive
    ns = photons.num_scatt
    big = jnp.asarray(jnp.inf, ns.dtype)
    mx = jnp.max(jnp.where(alive, ns, -big))
    mn = jnp.min(jnp.where(alive, ns, big))
    cnt = jnp.maximum(jnp.sum(alive), 1)
    mean = jnp.sum(jnp.where(alive, ns, 0.0)) / cnt
    r = jnp.sqrt(jnp.sum(photons.pos**2, axis=-1))
    r_mean = jnp.sum(jnp.where(alive, r, 0.0)) / cnt
    return mx, mn, mean, r_mean


@jax.jit
def frame_stats(photons: Photons) -> jax.Array:
    """All per-frame driver statistics as ONE (11,) device array.

    Coalesces scatt_stats + ph_min_max + the cyclo-synchrotron pool count so
    the driver issues a single host<->device fetch per frame instead of 8-10
    scalar round-trips (the same fix transport_frame applies to its
    per-chunk syncs).  Layout:

        [0:4] scatt_stats  (max, min, mean num_scatt, mean r)
        [4:8] ph_min_max   (r_min, r_max, theta_min, theta_max)
        [8]   live CS_POOL photon count
        [9]   live photon count (free slots = capacity - [9]; lets the driver
              run device-side appends without ever fetching the alive mask)
        [10]  live scattered-CS count (rebin trigger, Src/mcrat.c:819-830)
    """
    mx, mn, mean, r_mean = scatt_stats(photons)
    r_min, r_max, t_min, t_max = ph_min_max(photons)
    alive = photons.alive
    n_pool = jnp.sum(
        alive & (photons.ptype == int(PhotonType.CS_POOL))
    )
    dtype = photons.p.dtype
    return jnp.stack(
        [
            mx.astype(dtype), mn.astype(dtype), mean.astype(dtype),
            r_mean.astype(dtype), r_min, r_max, t_min, t_max,
            n_pool.astype(dtype),
            jnp.sum(alive).astype(dtype),
            _count_cs(photons).astype(dtype),
        ]
    )


# ---------------------------------------------------------------------------
# Device-side population surgery: append / subset-extract / live-compact.
# Each is ONE executable so the driver's cyclo-synchrotron frame boundary
# never fetches a full-population mask or array just to do bookkeeping.
# ---------------------------------------------------------------------------


def _pow2(n: int, floor: int = 1024) -> int:
    import math as _math

    return max(floor, 1 << int(np.ceil(np.log2(max(n, 1)))))


def _pad64k(n: int, floor: int = 1024) -> int:
    """Round up to a 64k multiple (pow2 below 64k).

    The persistence subset is fetched to the host every frame; pow-2 padding
    wastes up to 2x the transfer (a 440k-live population padded to 524k).
    64k granularity caps the waste at ~15% while bounding the number of
    compiled compact_live shapes at capacity/65536.
    """
    if n <= 65536:
        return _pow2(n, floor)
    return ((n + 65535) // 65536) * 65536


@functools.partial(jax.jit, static_argnames=("new_cap",))
def grow_photons(photons: Photons, new_cap: int, t_rem=None):
    """Copy the population into a larger zeroed buffer, as ONE executable.

    The host-side tree_map-of-set pattern this replaces cost one dispatch per
    leaf (8 round-trips) and, on a multi-process mesh, broke outright
    (locally-created empty buffers cannot mix with global arrays); inside jit
    the new buffers inherit the input sharding via GSPMD.  ``t_rem`` grows
    alongside when given (pads get zero time).
    """
    grown = empty_photons(new_cap, photons.p.dtype)
    grown = jax.tree_util.tree_map(
        lambda g, p: g.at[: p.shape[0]].set(p), grown, photons
    )
    if t_rem is None:
        return grown
    t_new = jnp.zeros((new_cap,), t_rem.dtype).at[: t_rem.shape[0]].set(t_rem)
    return grown, t_new


@jax.jit
def append_photons_device(photons: Photons, new: Photons, t_rem=None,
                          new_t=None):
    """Write ``new``'s live lanes into ``photons``' free slots, on device.

    Replaces the host-side free-slot search (np.flatnonzero over a fetched
    alive mask — a full-population fetch per append).  ``new`` is a padded
    fixed-capacity population whose dead lanes are dropped.  The caller must
    guarantee enough free slots (capacity - n_alive >= new live count, known
    from frame_stats); overflow lanes are silently dropped by the scatter.

    With ``t_rem``/``new_t`` the per-photon frame-time array is appended the
    same way (mid-frame rebin re-inserts merged photons with time left).
    """
    n_new = new.capacity
    valid = new.alive
    free = jnp.nonzero(~photons.alive, size=n_new, fill_value=photons.capacity)[0]
    slots = jnp.where(valid, free, photons.capacity)
    out = jax.tree_util.tree_map(
        lambda d, s: d.at[slots].set(s.astype(d.dtype), mode="drop"),
        photons, new,
    )
    if t_rem is None:
        return out
    return out, t_rem.at[slots].set(new_t.astype(t_rem.dtype), mode="drop")


@functools.partial(jax.jit, static_argnames=("n_out",))
def extract_cs_subset(photons: Photons, n_out: int, t_rem=None):
    """Gather the live scattered-CS lanes into an ``n_out`` buffer and null
    them in the population — the device half of rebinning.

    Returns (photons_with_cs_nulled, subset, subset_t) where ``subset`` is a
    Photons of capacity ``n_out`` (pad lanes dead) ready for ONE host fetch,
    and ``subset_t`` the matching frame-time slice (zeros when ``t_rem`` is
    None).  The caller sizes ``n_out`` from frame_stats' CS count (a power of
    two bounds the number of compiled shapes).
    """
    is_cs = photons.alive & (
        (photons.ptype == int(PhotonType.COMPTONIZED))
        | (photons.ptype == int(PhotonType.UNABSORBED_CS))
    )
    idx = jnp.nonzero(is_cs, size=n_out, fill_value=-1)[0]
    valid = idx >= 0
    safe = jnp.where(valid, idx, 0)
    sub = _gather_photons(photons, safe)
    sub = sub.replace(
        weight=jnp.where(valid, sub.weight, 0.0),
        ptype=jnp.where(
            valid, sub.ptype, jnp.asarray(int(PhotonType.NULL), sub.ptype.dtype)
        ),
    )
    sub_t = (
        jnp.where(valid, t_rem[safe], 0.0)
        if t_rem is not None
        else jnp.zeros((n_out,), photons.weight.dtype)
    )
    # Null ONLY the lanes actually gathered (scatter-with-drop at the valid
    # indices).  The caller sizes n_out from a count that may undercount the
    # full population's CS lanes (frame_stats counts the compacted working
    # set; alive CS photons whose frame time expired are excluded) — nulling
    # every is_cs lane here would zero-weight the overflow lanes without
    # merging them.  Overflow lanes survive untouched to the next trigger.
    drop_at = jnp.where(valid, safe, photons.capacity)
    nulled = photons.replace(
        weight=photons.weight.at[drop_at].set(0.0, mode="drop"),
        ptype=photons.ptype.at[drop_at].set(
            jnp.asarray(int(PhotonType.NULL), photons.ptype.dtype), mode="drop"
        ),
    )
    return nulled, sub, sub_t


@functools.partial(jax.jit, static_argnames=("n_out",))
def compact_live(photons: Photons, n_out: int) -> Photons:
    """Gather the live lanes into an ``n_out``-capacity buffer.

    The persistence path (checkpoint + HDF5 dump) fetches THIS instead of the
    full population: dead lanes are pure transfer traffic, and both
    consumers already ignore them.  ``n_out`` = pow2(n_alive) from
    frame_stats.
    """
    idx = jnp.nonzero(photons.alive, size=n_out, fill_value=-1)[0]
    valid = idx >= 0
    safe = jnp.where(valid, idx, 0)
    sub = _gather_photons(photons, safe)
    return sub.replace(
        weight=jnp.where(valid, sub.weight, 0.0),
        ptype=jnp.where(
            valid, sub.ptype, jnp.asarray(int(PhotonType.NULL), sub.ptype.dtype)
        ),
    )


def ph_min_max(photons: Photons):
    """(r_min, r_max, theta_min, theta_max) over live photons for hydro
    decimation (reference: phMinMax, Src/mclib.c:1465-1515)."""
    alive = photons.alive
    r = jnp.sqrt(jnp.sum(photons.pos**2, axis=-1))
    theta = jnp.arccos(
        jnp.clip(photons.pos[:, 2] / jnp.maximum(r, jnp.finfo(r.dtype).tiny), -1.0, 1.0)
    )
    big = jnp.asarray(jnp.inf, r.dtype)
    return (
        jnp.min(jnp.where(alive, r, big)),
        jnp.max(jnp.where(alive, r, -big)),
        jnp.min(jnp.where(alive, theta, big)),
        jnp.max(jnp.where(alive, theta, -big)),
    )
