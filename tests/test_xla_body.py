"""The XLA round body in float32 against the same body in float64.

``transport.transport_rounds`` is the only transport round body.  Production
runs it in float32 on the accelerator; here each configuration it covers runs
in float32 and in float64 on the same injected population, under different
random streams, and the two must agree in distribution: weight conserved
exactly, scattering counts, mean energy, radius and Stokes means within
Monte Carlo tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcrat_tpu import transport
from mcrat_tpu.config import (
    Config, Dims, Geometry, NonthermalDist, SimType, Spectrum, TauCalculation,
)
from mcrat_tpu.grid import build_rectilinear_index, frame_from_numpy
from mcrat_tpu.models.analytic import (
    apply_simulation_type,
    make_grid_2d,
    synthetic_spherical_frame,
)
from mcrat_tpu.ops.rng import make_key

CYL_EDGES = (np.linspace(0.0, 3.2e11, 33), np.linspace(1.8e12, 2.9e12, 65))


def _cylindrical(hot=False, table=False, seed=7, n_min=1500, n_max=4000):
    kw = dict(tau_calculation=TauCalculation.TABLE) if table else {}
    cfg = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
                 simulation_type=SimType.CYLINDRICAL_OUTFLOW, **kw)
    host = frame_from_numpy(cfg, make_grid_2d(cfg, *CYL_EDGES))
    apply_simulation_type(host)
    if hot:
        host.temp[:] = 5e8  # theta ~ 0.07: Maxwell-Juttner sampler branch
    arrays, _ = transport.inject_photons(
        host, r_inj=2e12, ph_weight=1e50, min_photons=n_min, max_photons=n_max,
        spect=Spectrum.BLACKBODY, theta_min=0.0, theta_max=np.pi / 30,
        fps=5.0, rng=np.random.default_rng(seed),
    )
    return cfg, host, CYL_EDGES, arrays


def _spherical():
    cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                 simulation_type=SimType.SPHERICAL_OUTFLOW)
    host, edges = synthetic_spherical_frame(
        cfg, r_min=5e12, r_max=4e13, nr=48, ntheta=6, theta_max=np.pi / 3
    )
    arrays, _ = transport.inject_photons(
        host, r_inj=1e13, ph_weight=1e50, min_photons=1000, max_photons=4000,
        spect=Spectrum.BLACKBODY, theta_min=0.0, theta_max=np.pi / 6,
        fps=5.0, rng=np.random.default_rng(3),
    )
    return cfg, host, edges, arrays


def _grid_3d(kind):
    """A 3-D spherical or polar uniform-outflow problem."""
    cfg = Config(
        dims=Dims.THREE,
        geometry=Geometry.SPHERICAL if kind == "spherical" else Geometry.POLAR,
        simulation_type=SimType.SPHERICAL_OUTFLOW if kind == "spherical"
        else SimType.CYLINDRICAL_OUTFLOW,
    )
    if kind == "spherical":
        edges = (np.geomspace(1e12, 2e13, 49),       # r
                 np.linspace(1e-3, np.pi / 3, 13),   # theta
                 np.linspace(0.0, 2 * np.pi, 9))     # phi
    else:
        edges = (np.linspace(1e10, 3.2e11, 17),      # r_cyl
                 np.linspace(0.0, 2 * np.pi, 9),     # phi
                 np.linspace(1.8e12, 2.9e12, 33))    # z
    centers = [0.5 * (e[:-1] + e[1:]) for e in edges]
    mesh = np.meshgrid(*centers, indexing="ij")
    widths = np.meshgrid(*[np.diff(e) for e in edges], indexing="ij")
    n = mesh[0].size
    host = frame_from_numpy(cfg, dict(
        r0=mesh[0].ravel(), r1=mesh[1].ravel(), r2=mesh[2].ravel(),
        dr0=widths[0].ravel(), dr1=widths[1].ravel(), dr2=widths[2].ravel(),
        v0=np.zeros(n), v1=np.zeros(n), v2=np.zeros(n),
        dens=np.ones(n), pres=np.ones(n),
    ))
    apply_simulation_type(host)
    arrays, _ = transport.inject_photons(
        host, r_inj=3e12 if kind == "spherical" else 2e12, ph_weight=1e50,
        min_photons=1500, max_photons=5000, spect=Spectrum.BLACKBODY,
        theta_min=0.0, theta_max=np.pi / 6 if kind == "spherical" else np.pi / 30,
        fps=5.0, rng=np.random.default_rng(31),
    )
    return cfg, host, edges, arrays


def _run(cfg, host, edges, arrays, dtype, dt, max_rounds, key, table=None):
    cfg = dataclasses.replace(cfg, dtype=dtype)
    photons, _ = transport.photons_from_arrays(arrays, capacity=None, dtype=dtype)
    frame = host.to_device(dtype=dtype)
    idx = build_rectilinear_index(*edges, dtype=dtype)
    t_rem = transport.frame_time(photons, jnp.asarray(dt, dtype))
    res = transport.transport_rounds(cfg, photons, frame, idx, t_rem, key,
                                     xsec_table=table, max_rounds=max_rounds)
    return res, photons, frame


def _stats(res):
    ph = jax.device_get(res.photons)
    alive = (ph.weight > 0) & (ph.ptype != 5)
    s = np.asarray(ph.s, np.float64)[alive]
    ns = np.asarray(ph.num_scatt, np.float64)[alive]
    return dict(
        w=float(np.sum(ph.weight, dtype=np.float64)),
        e=float(np.asarray(ph.p[:, 0], np.float64)[alive].mean()),
        ns=float(ns.mean()), ns_var_n=float(ns.var() / len(ns)),
        r=float(np.linalg.norm(np.asarray(ph.pos, np.float64), axis=1)[alive].mean()),
        q=float(s[:, 1].mean()), u=float(s[:, 2].mean()),
        n_scatt=int(res.n_scatt),
        finite=bool(np.isfinite(np.asarray(ph.p)).all()),
    )


def _compare(problem, dt, max_rounds, table32=None, table64=None, tol_e=0.08):
    cfg, host, edges, arrays = problem
    r32, _, _ = _run(cfg, host, edges, arrays, "float32", dt, max_rounds,
                     make_key(1), table=table32)
    r64, _, _ = _run(cfg, host, edges, arrays, "float64", dt, max_rounds,
                     jax.random.PRNGKey(2), table=table64)
    a, b = _stats(r64), _stats(r32)
    assert b["finite"] and a["finite"]
    assert b["w"] == pytest.approx(a["w"], rel=1e-6)  # weight conserved exactly
    assert b["n_scatt"] > 100
    # event totals within 5 Poisson sigma; per-photon means within 5 SE
    assert abs(b["n_scatt"] - a["n_scatt"]) < 5.0 * np.sqrt(b["n_scatt"] + a["n_scatt"])
    assert abs(b["ns"] - a["ns"]) < 5.0 * np.sqrt(b["ns_var_n"] + a["ns_var_n"])
    assert b["e"] == pytest.approx(a["e"], rel=tol_e)
    assert b["r"] == pytest.approx(a["r"], rel=1e-3)
    assert abs(b["q"] - a["q"]) < 0.05
    assert abs(b["u"] - a["u"]) < 0.05
    return b


@pytest.mark.parametrize("kind", ["cylindrical", "spherical"])
def test_float32_matches_float64_2d(kind):
    # window sized so both problems accumulate >~300 scatters (the spherical
    # problem is optically thin)
    if kind == "cylindrical":
        _compare(_cylindrical(), dt=0.05, max_rounds=24)
    else:
        _compare(_spherical(), dt=0.3, max_rounds=24)


def test_hot_frame_float32_matches_float64():
    """Above the 1e7 K sampler switch the thermal electrons come from the
    Maxwell-Juttner branch; hot electrons inverse-Compton heat the photons."""
    _compare(_cylindrical(hot=True, seed=11), dt=0.05, max_rounds=16, tol_e=0.15)


def test_dead_lanes_stay_dead():
    """Null lanes pass through the round body untouched."""
    cfg, host, edges, arrays = _cylindrical(n_min=200, n_max=600)
    photons, _ = transport.photons_from_arrays(arrays, capacity=None, dtype="float32")
    kill = (np.arange(photons.capacity) % 2) == 0
    photons = photons.replace(weight=photons.weight * jnp.asarray(~kill, jnp.float32))
    t_rem = transport.frame_time(photons, jnp.float32(0.02))
    res = transport.transport_rounds(
        dataclasses.replace(cfg, dtype="float32"), photons,
        host.to_device(dtype="float32"),
        build_rectilinear_index(*edges, dtype="float32"), t_rem, make_key(2),
        max_rounds=8,
    )
    ph = res.photons
    for name in ("p", "pos", "s", "num_scatt", "weight"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ph, name))[kill], np.asarray(getattr(photons, name))[kill]
        )
    assert int(res.n_scatt) > 0
    assert (np.asarray(ph.num_scatt)[~kill] > 0).any()


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Hot cross-section tables (thermal-only, +powerlaw) in float32 and
    float64, built once from the same cache file each."""
    from mcrat_tpu.ops import hot_xsec

    d = tmp_path_factory.mktemp("xsec")
    cfg_th = Config(tau_calculation=TauCalculation.TABLE)
    cfg_nt = Config(
        geometry=Geometry.SPHERICAL, simulation_type=SimType.SPHERICAL_OUTFLOW,
        tau_calculation=TauCalculation.TABLE,
        nonthermal_e_dist=NonthermalDist.POWERLAW,
        powerlaw_index=2.5, gamma_min=1.0, gamma_max=100.0,
    )
    out = {}
    for name, cfg in (("th", cfg_th), ("nt", cfg_nt)):
        for dt in ("float32", "float64"):
            out[name, dt] = hot_xsec.load_or_build(cfg, str(d / f"{name}.npz"), dtype=dt)
    out["nt_cfg"] = cfg_nt
    return out


def test_table_mode_float32_matches_float64(tables):
    """TABLE-mode hot cross sections on a hot frame, where sigma_hat sits
    measurably below Thomson: float32 agrees with float64, and DIRECT
    (sigma_hat = 1) scatters more."""
    problem = _cylindrical(hot=True, table=True, seed=23)
    b = _compare(problem, dt=0.05, max_rounds=16, table32=tables["th", "float32"],
                 table64=tables["th", "float64"], tol_e=0.15)
    cfg, host, edges, arrays = problem
    cfg_direct = dataclasses.replace(cfg, tau_calculation=TauCalculation.DIRECT)
    res_d, _, _ = _run(cfg_direct, host, edges, arrays, "float32", 0.05, 16, make_key(1))
    assert int(res_d.n_scatt) > 1.1 * b["n_scatt"]


def test_nonthermal_float32_matches_float64(tables):
    """Powerlaw electron populations: biased multi-population selection and
    inverse-CDF gamma draws; gamma <= 100 electrons upscatter."""
    from mcrat_tpu.ops import cyclosynch

    cfg = tables["nt_cfg"]
    host, edges = synthetic_spherical_frame(
        cfg, r_min=1e12, r_max=2e13, nr=96, ntheta=16, theta_max=np.pi / 3
    )
    host.nonthermal_dens = cyclosynch.nonthermal_electron_dens(cfg, host)
    assert (host.nonthermal_dens > 0).all()
    arrays, _ = transport.inject_photons(
        host, r_inj=4e12, ph_weight=1e50, min_photons=2000, max_photons=6000,
        spect=Spectrum.BLACKBODY, theta_min=0.0, theta_max=np.pi / 6,
        fps=5.0, rng=np.random.default_rng(29),
    )
    _compare((cfg, host, edges, arrays), dt=0.3, max_rounds=20,
             table32=tables["nt", "float32"], table64=tables["nt", "float64"],
             tol_e=0.25)


@pytest.mark.parametrize("kind", ["spherical", "polar"])
def test_3d_angular_geometries_float32_matches_float64(kind):
    """3-D spherical/polar cell membership runs in cosine space off the
    packed sin/cos caches (24 packed rows for spherical)."""
    problem = _grid_3d(kind)
    if kind == "spherical":
        assert problem[1].to_device(dtype="float32").packed.shape[0] == 24
    _compare(problem, dt=0.3 if kind == "spherical" else 0.05, max_rounds=16,
             tol_e=0.1)
