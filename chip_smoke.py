"""Smoke test of the main path on NVIDIA GPUs.

    python chip_smoke.py               # one card: phases 1-4
    python chip_smoke.py --four-cards  # four cards: the --mesh 4 path only

Everything runs in ONE process: a JAX process reserves most of a card's
memory, so a second process on the same card would fail.

1. Device and environment.  Anything but a GPU exits non-zero before any
   other phase runs.
2. Main path end to end: the README quick-start job (synthetic spherical
   outflow, DIRECT tau, Stokes on, ~1M photons, 3 frames at fps 5) through
   ``cli run ... --merge``, read back from the merged HDF5 files.  Where h5py
   is not installed, ``driver.run_rank(write_outputs=False)`` runs the same
   job and its per-frame log records are checked instead.
3. The bench's headline transport frame at full width (2-D cylindrical,
   160x512 cells, ~1M photons, chunk_rounds=64): Stokes on with the rbg and
   threefry2x32 keys, and TABLE mode with a nonthermal power law.
4. Correctness: the GPU's float32 engine against the CPU backend's float64
   engine on photons of the headline injection (20k DIRECT, ~160k
   TABLE+nonthermal), and against the serial float64 oracle on ~500 photons.

Timings printed here are smoke-test readings, not benchmark numbers.  The
last line printed is one JSON object naming the device; any failure raises.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

HEADLINE_N = (600_000, 1_400_000)  # bench.py's headline population
SMALL_N = (15_000, 25_000)  # "20k photons" for the float64 comparison
# TABLE+nonthermal: the upscattered tail leaves a 16k-photon mean energy ~1.4 %
# uncertain; ~160k photons put the 3 % limit at ~4.7 standard errors
TABLE_N = (150_000, 250_000)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


_T0 = time.perf_counter()


def _say(phase: str, **kw) -> None:
    kw["elapsed_s"] = time.perf_counter() - _T0
    print(f"{phase}: {json.dumps(kw, default=float)}", flush=True)


# ---------------------------------------------------------------------------
# Population statistics and the backend comparison (section-4 checks)
# ---------------------------------------------------------------------------


def population(photons) -> dict:
    """Live photons of a transport result as host arrays: lab energy ``e``
    (p0, units of m_e c), weight ``w``, scatterings ``ns``, Stokes ``q``/``u``
    (Q/I and U/I; I == 1)."""
    import jax

    from mcrat_tpu.config import PhotonType

    ph = jax.device_get(photons)
    alive = (np.asarray(ph.weight) > 0) & (np.asarray(ph.ptype) != int(PhotonType.NULL))
    return dict(
        e=np.asarray(ph.p[:, 0], np.float64)[alive],
        w=np.asarray(ph.weight, np.float64)[alive],
        ns=np.asarray(ph.num_scatt, np.float64)[alive],
        q=np.asarray(ph.s[:, 1], np.float64)[alive],
        u=np.asarray(ph.s[:, 2], np.float64)[alive],
    )


def compare_populations(ref: dict, test: dict) -> list:
    """(name, |difference|, limit) for each statistic; ``ref`` sets the bins.

    Weighted mean lab energy within 3 %; weighted fraction in each
    log-energy tercile of ``ref`` within 0.02; mean scatterings per photon
    within 3 %; mean Q/I and U/I within 4/sqrt(N) — each is bounded by 1 per
    photon, so that is at least four standard errors.
    """
    def wmean(p, key):
        return float(np.sum(p[key] * p["w"]) / np.sum(p["w"]))

    edges = np.quantile(np.log(ref["e"]), [1.0 / 3.0, 2.0 / 3.0])

    def terciles(p):
        b = np.digitize(np.log(p["e"]), edges)
        return np.array([p["w"][b == i].sum() for i in range(3)]) / p["w"].sum()

    m_ref, m_test = wmean(ref, "e"), wmean(test, "e")
    ns_ref, ns_test = float(ref["ns"].mean()), float(test["ns"].mean())
    stokes_tol = 4.0 / np.sqrt(min(len(ref["e"]), len(test["e"])))
    return [
        ("mean_energy", abs(m_test - m_ref), 0.03 * abs(m_ref)),
        ("tercile_fraction", float(np.abs(terciles(test) - terciles(ref)).max()), 0.02),
        ("mean_scatterings", abs(ns_test - ns_ref), 0.03 * abs(ns_ref)),
        ("stokes_q", abs(wmean(test, "q") - wmean(ref, "q")), stokes_tol),
        ("stokes_u", abs(wmean(test, "u") - wmean(ref, "u")), stokes_tol),
    ]


def _require_agreement(label: str, ref: dict, test: dict) -> None:
    rows = compare_populations(ref, test)
    _say(label, n_ref=len(ref["e"]), n_test=len(test["e"]),
         checks={name: {"diff": d, "limit": lim, "ok": bool(d <= lim)}
                 for name, d, lim in rows})
    bad = [name for name, d, lim in rows if not d <= lim]
    _check(not bad, f"{label}: {bad} outside tolerance")


@contextlib.contextmanager
def cpu_float64():
    """Run enclosed JAX work on the CPU backend in float64."""
    import jax

    with jax.default_device(jax.devices("cpu")[0]), jax.enable_x64():
        yield


# ---------------------------------------------------------------------------
# Phase 2: the main path end to end
# ---------------------------------------------------------------------------


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def main_path_par(n_min: int, n_max: int):
    """The README quick-start job: one injection at frame 10 (r = 8e12 cm,
    0-6 degrees), transported through frames 10-12 at fps 5."""
    from mcrat_tpu.config import McPar, Spectrum

    return McPar(
        fps=5.0, last_frame=12, r0_domain=(1e12, 5e13), r1_domain=(0.0, 1.0),
        r2_domain=(0.0, 0.0), theta_min_deg=0.0, theta_max_deg=6.0,
        n_theta_bins=1, frm0=(10,), frm2=(10,), inj_radius=(8e12,),
        spect=Spectrum.BLACKBODY, min_photons=n_min, max_photons=n_max,
        restart="i",
    )


def run_main_path(workdir: str, n_min: int, n_max: int, mesh: int = 0,
                  use_cli: bool = True) -> dict:
    """Run the quick-start job under ``workdir`` and check what comes out.

    ``use_cli`` runs ``cli.main(["run", ..., "--merge"])`` and reads the
    merged HDF5 files back; otherwise ``driver.run_rank`` runs the job
    without outputs.  Either way the driver's own per-frame log records are
    checked: every frame scatters, and every injected photon is still live.
    """
    import jax

    from mcrat_tpu import cli, driver
    from mcrat_tpu.io.mcpar import write_mcpar

    par = main_path_par(n_min, n_max)
    os.makedirs(workdir, exist_ok=True)
    mcpar = os.path.join(workdir, "mc.par")
    write_mcpar(par, mcpar)

    handler = _Records()
    logger = logging.getLogger("mcrat_tpu")
    logger.addHandler(handler)
    level = logger.level
    logger.setLevel(logging.INFO)
    t0 = time.perf_counter()
    try:
        if use_cli:
            argv = [
                "run", "--mcpar", mcpar, "--sim", "synthetic",
                "--geometry", "spherical", "--dims", "2",
                "--simulation-type", "spherical_outflow", "--merge",
                "--filepath", workdir + "/", "--mc-path", "MC/",
            ] + (["--mesh", str(mesh)] if mesh else [])
            _check(cli.main(argv) == 0, "cli run exit code")
        else:
            from mcrat_tpu.config import Config, Dims, Geometry, SimType
            from mcrat_tpu.io.hydro import HydroPaths
            from mcrat_tpu.parallel import make_mesh

            cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                         simulation_type=SimType.SPHERICAL_OUTFLOW)
            driver.run_rank(
                cfg, par, HydroPaths(filepath=workdir + "/", mc_path="MC/"),
                synthetic_frame_factory=driver.default_synthetic_factory(cfg, par),
                mesh=make_mesh(mesh) if mesh else None, write_outputs=False,
            )
        wall = time.perf_counter() - t0
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)

    injected = [r.args for r in handler.records
                if r.msg.startswith("rank %d: injected")]
    frames = [r.args for r in handler.records
              if r.msg.startswith("rank %d frame %d scatt %d")]
    _check(len(injected) == 1, "one injection")
    n_inj, w_inj = int(injected[0][1]), float(injected[0][3])
    _check(n_min <= n_inj <= n_max, f"injected {n_inj} in [{n_min}, {n_max}]")
    _check([f[2] for f in frames] == [10, 11, 12], "frames 10-12 transported")
    for f in frames:
        _check(f[3] > 0 and f[6] > 0, f"frame {f[2]} scattered")
        _check(f[8] == n_inj, f"frame {f[2]}: {f[8]} live of {n_inj} injected")
    out = dict(
        n_photons=n_inj, injected_weight=w_inj,
        total_scatterings=int(sum(f[3] for f in frames)),
        rounds=int(sum(f[4] for f in frames)),
        live_per_frame=[int(f[8]) for f in frames],
        mean_num_scatt=[float(f[6]) for f in frames], wall_s=wall,
        outputs="hdf5+merge" if use_cli else "none (h5py not installed)",
    )
    if use_cli:
        from mcrat_tpu.io.photons_h5 import read_frame

        mc_dir = os.path.join(workdir, "MC", "0-6")
        for fr in (10, 11, 12):
            d = read_frame(os.path.join(mc_dir, f"mcdata_{fr}.h5"))
            _check(len(d["PW"]) == n_inj, f"merged frame {fr} photon count")
            _check(
                abs(d["PW"].sum() - n_inj * w_inj) <= 1e-6 * n_inj * w_inj,
                f"merged frame {fr} weight",
            )
            _check(d["NS"].sum() > 0, f"merged frame {fr} NS > 0")
            _check(all(np.isfinite(v).all() for k, v in d.items() if k != "PT"),
                   f"merged frame {fr} finite")
        out["population"] = dict(
            e=d["P0"], w=d["PW"], ns=d["NS"], q=d["S1"], u=d["S2"],
        )
    out["peak_bytes_in_use"] = (
        jax.devices()[0].memory_stats() or {}
    ).get("peak_bytes_in_use")
    return out


# ---------------------------------------------------------------------------
# Phase 3: the headline frame at full width
# ---------------------------------------------------------------------------


def headline_config(table: bool = False):
    from mcrat_tpu.config import (
        Config, Dims, Geometry, NonthermalDist, SimType, TauCalculation,
    )

    kw = dict(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
              simulation_type=SimType.CYLINDRICAL_OUTFLOW)
    if table:
        kw.update(tau_calculation=TauCalculation.TABLE,
                  nonthermal_e_dist=NonthermalDist.POWERLAW,
                  powerlaw_index=2.5, gamma_min=1.0, gamma_max=100.0)
    return Config(**kw)


def headline_problem(cfg, n_min, n_max, seed, table=False):
    """bench.py's headline frame; ``table`` = the TABLE+nonthermal variant
    (hot frame with a nonthermal electron population)."""
    from bench import cylindrical_problem

    host, idx, arrays = cylindrical_problem(cfg, hot=table, n_min=n_min,
                                            n_max=n_max, seed=seed)
    if table:
        from mcrat_tpu.ops import cyclosynch

        host.nonthermal_dens = cyclosynch.nonthermal_electron_dens(cfg, host)
    return host, idx, arrays


def xsec_table(cfg, dtype: str):
    from mcrat_tpu.ops import hot_xsec
    from mcrat_tpu.runtime import work_dir

    return hot_xsec.load_or_build(
        cfg, os.path.join(work_dir("xsec"), "headline_nt.npz"), dtype=dtype
    )


def run_frame(cfg, host, idx, arrays, key, table=None, dtype="float32"):
    """One headline transport frame; returns (FrameResult, photons_in, s)."""
    import jax
    import jax.numpy as jnp

    from mcrat_tpu import transport

    photons, _ = transport.photons_from_arrays(arrays, capacity=None, dtype=dtype)
    frame = host.to_device(dtype=dtype)
    t0 = time.perf_counter()
    res = transport.transport_frame(
        cfg, photons, frame, idx, jnp.asarray(0.2, dtype), key,
        xsec_table=table, stokes_on=True, chunk_rounds=64,
    )
    jax.block_until_ready(res.photons.p)
    return res, photons, time.perf_counter() - t0


def check_frame(label, res, photons_in) -> None:
    import jax

    w_in = float(np.sum(jax.device_get(photons_in.weight), dtype=np.float64))
    w_out = float(np.sum(jax.device_get(res.photons.weight), dtype=np.float64))
    _check(abs(w_out - w_in) <= 1e-6 * w_in, f"{label}: weight conserved")
    _check(int(res.n_scatt) > 0, f"{label}: scatterings")
    for name in ("p", "pos", "s"):
        _check(bool(np.isfinite(jax.device_get(getattr(res.photons, name))).all()),
               f"{label}: finite {name}")


def time_headline(n_min=HEADLINE_N[0], n_max=HEADLINE_N[1], repeats=3) -> dict:
    """Stokes-on headline frame with each key implementation; times are
    medians of ``repeats`` (tools/profile_transport.py times the round body
    alone)."""
    from mcrat_tpu.ops.rng import make_key

    cfg = headline_config()
    host, idx, arrays = headline_problem(cfg, n_min, n_max, seed=0)
    n = len(arrays["weight"])
    out = dict(n_photons=n)
    for impl in ("rbg", "threefry2x32"):
        t_c = time.perf_counter()
        res, ph_in, _ = run_frame(cfg, host, idx, arrays, make_key(0, impl))
        first = time.perf_counter() - t_c
        check_frame(f"headline {impl}", res, ph_in)
        runs = sorted(
            (run_frame(cfg, host, idx, arrays, make_key(1 + r, impl))[::2]
             for r in range(repeats)),
            key=lambda x: x[1],
        )
        res, el = runs[len(runs) // 2]
        out[impl] = dict(
            first_call_s=first, frame_s=el, n_scatt=int(res.n_scatt),
            n_rounds=int(res.n_rounds),
            scatterings_per_s=int(res.n_scatt) / el,
            ns_per_photon_round=1e9 * el / (n * int(res.n_rounds)),
        )

    return out


def run_table_nonthermal(n_min=HEADLINE_N[0], n_max=HEADLINE_N[1]) -> dict:
    from mcrat_tpu.ops.rng import make_key

    cfg = headline_config(table=True)
    t0 = time.perf_counter()
    table = xsec_table(cfg, "float32")
    t_table = time.perf_counter() - t0
    host, idx, arrays = headline_problem(cfg, n_min, n_max, seed=3, table=True)
    t_c = time.perf_counter()
    res, ph_in, _ = run_frame(cfg, host, idx, arrays, make_key(30), table=table)
    first = time.perf_counter() - t_c
    check_frame("table+nonthermal", res, ph_in)
    res, ph_in, el = run_frame(cfg, host, idx, arrays, make_key(31), table=table)
    check_frame("table+nonthermal", res, ph_in)
    n = len(arrays["weight"])
    return dict(
        n_photons=n, table_build_s=t_table, first_call_s=first, frame_s=el,
        n_scatt=int(res.n_scatt), n_rounds=int(res.n_rounds),
        scatterings_per_s=int(res.n_scatt) / el,
        ns_per_photon_round=1e9 * el / (n * int(res.n_rounds)),
    )


# ---------------------------------------------------------------------------
# Phase 4: correctness against the plain references
# ---------------------------------------------------------------------------


def compare_with_cpu_float64(table: bool):
    """One headline frame of a seeded population (20k photons, ~160k with
    ``table``): accelerator float32 (production key) vs CPU float64."""
    import jax

    from mcrat_tpu.grid import build_rectilinear_index
    from mcrat_tpu.ops.rng import make_key

    cfg = headline_config(table=table)
    host, idx, arrays = headline_problem(cfg, *(TABLE_N if table else SMALL_N),
                                         seed=7, table=table)
    res_a, ph_a, _ = run_frame(cfg, host, idx, arrays, make_key(70),
                               table=xsec_table(cfg, "float32") if table else None)
    label = "table+nonthermal" if table else "direct"
    check_frame(f"{label} float32", res_a, ph_a)
    with cpu_float64():
        cfg64 = dataclasses.replace(cfg, dtype="float64")
        r0 = np.linspace(0.0, 3.2e11, 161)
        r1 = np.linspace(1.8e12, 2.9e12, 513)
        idx64 = build_rectilinear_index(r0, r1, dtype="float64")
        res_c, ph_c, _ = run_frame(
            cfg64, host, idx64, arrays, jax.random.PRNGKey(71),
            table=xsec_table(cfg64, "float64") if table else None, dtype="float64",
        )
        check_frame(f"{label} float64", res_c, ph_c)
        ref = population(res_c.photons)
    _require_agreement(f"phase 4a {label}: float32 vs cpu float64", ref,
                       population(res_a.photons))


def compare_with_serial_oracle():
    """~500 photons: batched engine on the accelerator (float32) vs the serial
    reference-ordered oracle (CPU float64), with the tolerances of
    tests/test_serial_equivalence.py."""
    import jax
    import jax.numpy as jnp

    from mcrat_tpu import transport
    from mcrat_tpu.config import Spectrum
    from mcrat_tpu.grid import build_rectilinear_index, frame_from_numpy
    from mcrat_tpu.models.analytic import apply_simulation_type, make_grid_2d
    from mcrat_tpu.ops.rng import make_key
    from mcrat_tpu.serial import transport_frame_serial

    cfg = headline_config()
    r0_edges = np.linspace(0.0, 3.2e11, 65)
    r1_edges = np.linspace(1.8e12, 2.6e12, 129)
    host = frame_from_numpy(cfg, make_grid_2d(cfg, r0_edges, r1_edges))
    apply_simulation_type(host)
    arrays, _ = transport.inject_photons(
        host, r_inj=2e12, ph_weight=1e50, min_photons=350, max_photons=700,
        spect=Spectrum.BLACKBODY, theta_min=0.0, theta_max=np.pi / 30,
        fps=5.0, rng=np.random.default_rng(0),
    )
    dt = 0.03
    ph_b, _ = transport.photons_from_arrays(arrays, capacity=None, dtype="float32")
    res_b = transport.transport_frame(
        cfg, ph_b, host.to_device(dtype="float32"),
        build_rectilinear_index(r0_edges, r1_edges, dtype="float32"),
        jnp.float32(dt), make_key(11),
    )
    with cpu_float64():
        cfg64 = dataclasses.replace(cfg, dtype="float64")
        ph_s, _ = transport.photons_from_arrays(arrays, capacity=None, dtype="float64")
        res_s = transport_frame_serial(
            cfg64, ph_s, host.to_device(dtype="float64"),
            build_rectilinear_index(r0_edges, r1_edges), dt,
            jax.random.PRNGKey(22),
        )
        e_s = float(transport.average_photon_energy(res_s.photons))
        ns_s = np.asarray(res_s.photons.num_scatt)
        r_s = np.linalg.norm(np.asarray(res_s.photons.pos), axis=1).mean()
    e_b = float(transport.average_photon_energy(res_b.photons))
    ns_b = np.asarray(res_b.photons.num_scatt, np.float64)
    r_b = np.linalg.norm(np.asarray(res_b.photons.pos, np.float64), axis=1).mean()
    nb, ns = int(res_b.n_scatt), int(res_s.n_scatt)
    se = np.sqrt(ns_b.var() / len(ns_b) + ns_s.var() / len(ns_s))
    rows = [
        ("events", abs(nb - ns), 5.0 * np.sqrt(nb + ns)),
        ("mean_energy_rel", abs(e_b - e_s) / e_s, 0.05),
        ("mean_scatterings", abs(ns_b.mean() - ns_s.mean()), 5.0 * se + 1e-9),
        ("mean_radius_rel", abs(r_b - r_s) / r_s, 1e-3),
    ]
    _say("phase 4b: float32 engine vs serial float64 oracle",
         n_photons=len(arrays["weight"]), events=[nb, ns],
         checks={k: {"diff": d, "limit": lim, "ok": bool(d < lim)}
                 for k, d, lim in rows})
    _check(nb > 50 and ns > 50, "oracle comparison has events")
    bad = [k for k, d, lim in rows if not d < lim]
    _check(not bad, f"serial oracle: {bad} outside tolerance")


# ---------------------------------------------------------------------------
# Four cards: the --mesh 4 path and its single-card comparison
# ---------------------------------------------------------------------------


def four_cards(use_cli: bool, n=(4 * HEADLINE_N[0], 4 * HEADLINE_N[1])) -> None:
    """The headline frame and the phase-2 job at ``n`` photons, each on the
    four-card mesh and on one card, compared."""
    import jax

    from mcrat_tpu import transport
    from mcrat_tpu.ops.rng import make_key
    from mcrat_tpu.parallel import make_mesh, shard_photons, sharded_transport_frame
    from mcrat_tpu.parallel.mesh import replicate
    from mcrat_tpu.runtime import work_dir

    # transport: the headline frame at 4x the population, sharded over the
    # four cards vs the same population on one card
    cfg = headline_config()
    host, idx, arrays = headline_problem(cfg, *n, seed=40)
    mesh = make_mesh(4)
    photons, _ = transport.photons_from_arrays(
        arrays, capacity=-(-len(arrays["weight"]) // 4) * 4, dtype="float32")
    frame = host.to_device(dtype="float32")
    t0 = time.perf_counter()
    res_m = sharded_transport_frame(
        cfg, mesh, shard_photons(photons, mesh), replicate(frame, mesh),
        replicate(idx, mesh), np.float32(0.2), make_key(41), chunk_rounds=64)
    jax.block_until_ready(res_m.photons.p)
    t_mesh = time.perf_counter() - t0
    check_frame("mesh-4 headline", res_m, photons)
    res_1, ph_1, t_one = run_frame(cfg, host, idx, arrays, make_key(42))
    check_frame("one-card headline", res_1, ph_1)
    _say("four-cards transport", n_photons=len(arrays["weight"]),
         mesh4_first_call_s=t_mesh, one_card_first_call_s=t_one,
         n_scatt=[int(res_m.n_scatt), int(res_1.n_scatt)])
    _require_agreement("four-cards transport: mesh 4 vs one card",
                       population(res_1.photons), population(res_m.photons))

    # the main path: the phase-2 job at 4x the photons with --mesh 4, and
    # the same job on one of the cards
    m4 = run_main_path(work_dir("smoke", "mesh4"), *n, mesh=4, use_cli=use_cli)
    m1 = run_main_path(work_dir("smoke", "mesh1"), *n, mesh=0, use_cli=use_cli)
    for r in (m4, m1):
        r.pop("peak_bytes_in_use")
    pops = (m1.pop("population", None), m4.pop("population", None))
    _say("four-cards main path --mesh 4", **m4)
    _say("four-cards main path one card", **m1)
    _check(m4["n_photons"] == m1["n_photons"]
           and m4["live_per_frame"] == m1["live_per_frame"],
           "main path: injected and live photons, mesh 4 vs one card")
    _check(abs(m4["injected_weight"] - m1["injected_weight"])
           <= 1e-6 * m1["injected_weight"],
           "main path: injected weight, mesh 4 vs one card")
    for s4, s1 in zip(m4["mean_num_scatt"], m1["mean_num_scatt"]):
        _check(abs(s4 - s1) <= 0.03 * s1,
               "main path: mean scatterings per frame, mesh 4 vs one card")
    if pops[0] is not None:
        _require_agreement("four-cards main path: mesh 4 vs one card", *pops)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the --mesh 4 path and its one-card comparison")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    import jax

    from mcrat_tpu.runtime import card_info, enable_compile_cache, require_gpu, work_dir

    devices = require_gpu(n_cards)
    dev = devices[0]

    cache = enable_compile_cache()
    try:
        import h5py  # noqa: F401
        have_h5py = True
    except ModuleNotFoundError:
        have_h5py = False
    import jaxlib

    print(f"device: {dev.device_kind} x {len(devices)}", flush=True)
    print(f"card: {card_info()}", flush=True)
    _say("phase 1: environment", jax=jax.__version__, jaxlib=jaxlib.__version__,
         h5py=have_h5py, compile_cache=cache)
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stderr)

    if args.four_cards:
        four_cards(use_cli=have_h5py)
    else:
        if not have_h5py:
            print("phase 2: h5py is not installed; running driver.run_rank "
                  "with write_outputs=False in place of cli run", flush=True)
        res = run_main_path(work_dir("smoke", "main"), *HEADLINE_N,
                            use_cli=have_h5py)
        res.pop("population", None)
        _say("phase 2: main path", **res)
        _say("phase 3: headline frame", **time_headline())
        _say("phase 3: table+nonthermal frame", **run_table_nonthermal())
        compare_with_cpu_float64(table=False)
        compare_with_cpu_float64(table=True)
        compare_with_serial_oracle()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
