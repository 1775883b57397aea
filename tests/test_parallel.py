"""Sharded transport on a virtual 8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcrat_tpu.config import Config, Dims, Geometry, SimType, Spectrum
from mcrat_tpu.grid import build_rectilinear_index
from mcrat_tpu.models.analytic import synthetic_spherical_frame
from mcrat_tpu import transport
from mcrat_tpu.parallel import make_mesh, pad_capacity, shard_photons, sharded_transport_frame
from mcrat_tpu.parallel.mesh import replicate

CFG = Config(
    dims=Dims.TWO,
    geometry=Geometry.SPHERICAL,
    simulation_type=SimType.SPHERICAL_OUTFLOW,
    dtype="float64",
)


def test_sharded_transport_matches_expectations():
    assert len(jax.devices()) == 8, "conftest should provide 8 virtual CPU devices"
    host, (r_edges, t_edges) = synthetic_spherical_frame(
        CFG, r_min=1e12, r_max=2e13, nr=96, ntheta=16, theta_max=np.pi / 3
    )
    idx = build_rectilinear_index(r_edges, t_edges)
    rng = np.random.default_rng(11)
    arrays, w = transport.inject_photons(
        host, r_inj=4e12, ph_weight=1e50, min_photons=400, max_photons=2000,
        spect=Spectrum.BLACKBODY, theta_min=0.0, theta_max=np.pi / 6,
        fps=5.0, rng=rng,
    )
    mesh = make_mesh()
    cap = pad_capacity(len(arrays["weight"]), mesh.devices.size, factor=1.25)
    ph, meta = transport.photons_from_arrays(arrays, capacity=cap, dtype=jnp.float64)
    ph = shard_photons(ph, mesh)
    frame = replicate(host.to_device(dtype=jnp.float64), mesh)
    idx_r = replicate(idx, mesh)

    res = sharded_transport_frame(
        CFG, mesh, ph, frame, idx_r, 0.2, jax.random.PRNGKey(0)
    )
    out = res.photons
    # population conserved
    np.testing.assert_allclose(
        float(jnp.sum(out.weight)), float(jnp.sum(ph.weight)), rtol=1e-12
    )
    # scattering happened and the count is a replicated global psum
    assert int(res.n_scatt) > 0
    # output keeps the batch sharding
    assert out.p.sharding.spec[0] == "batch"
    # all live photons moved
    alive = np.asarray(out.weight) > 0
    d = np.linalg.norm(np.asarray(out.pos) - np.asarray(ph.pos), axis=1)
    assert (d[alive] > 0).all()


def test_sharded_fused_chunked_compaction():
    """The production mesh path: the XLA round body under shard_map,
    bounded-round chunks, and tail compaction with shard rebalancing —
    statistics must match the single-device engine."""
    cfg = Config(
        dims=Dims.TWO, geometry=Geometry.SPHERICAL,
        simulation_type=SimType.SPHERICAL_OUTFLOW, dtype="float32",
    )
    host, (r_edges, t_edges) = synthetic_spherical_frame(
        cfg, r_min=1e12, r_max=2e13, nr=96, ntheta=16, theta_max=np.pi / 3
    )
    idx = build_rectilinear_index(r_edges, t_edges, dtype="float32")
    rng = np.random.default_rng(5)
    arrays, _ = transport.inject_photons(
        host, r_inj=4e12, ph_weight=1e50, min_photons=2000, max_photons=6000,
        spect=Spectrum.BLACKBODY, theta_min=0.0, theta_max=np.pi / 6,
        fps=5.0, rng=rng,
    )
    mesh = make_mesh()
    cap = pad_capacity(len(arrays["weight"]), mesh.devices.size, factor=1.3)
    ph, _ = transport.photons_from_arrays(arrays, capacity=cap, dtype=jnp.float32)
    ph_sh = shard_photons(ph, mesh)
    frame = replicate(host.to_device(dtype=jnp.float32), mesh)
    idx_r = replicate(idx, mesh)

    chunks = []
    res = sharded_transport_frame(
        cfg, mesh, ph_sh, frame, idx_r, 0.4, jax.random.PRNGKey(3),
        chunk_rounds=6, progress=lambda ns, nr: chunks.append((ns, nr)),
    )
    assert len(chunks) >= 2  # actually chunked
    np.testing.assert_allclose(
        float(jnp.sum(res.photons.weight)), float(jnp.sum(ph.weight)), rtol=1e-6
    )
    # single-device engine on the identical population
    res_x = transport.transport_frame(
        cfg, ph, host.to_device(dtype=jnp.float32), idx, 0.4,
        jax.random.PRNGKey(4), chunk_rounds=0,
    )
    for a, b, tol in [
        (int(res.n_scatt), int(res_x.n_scatt), 0.15),
    ]:
        assert a == pytest.approx(b, rel=tol), (a, b)
    alive_f = np.asarray(res.photons.alive)
    alive_x = np.asarray(res_x.photons.alive)
    e_f = np.asarray(res.photons.p[:, 0])[alive_f].mean()
    e_x = np.asarray(res_x.photons.p[:, 0])[alive_x].mean()
    assert e_f == pytest.approx(e_x, rel=0.1)
    r_f = np.linalg.norm(np.asarray(res.photons.pos), axis=1)[alive_f].mean()
    r_x = np.linalg.norm(np.asarray(res_x.photons.pos), axis=1)[alive_x].mean()
    assert r_f == pytest.approx(r_x, rel=0.01)


def test_mesh_kill_restart_merge_end_to_end(tmp_path):
    """Scaled BASELINE config-#5 shape on the 8-device mesh: a multi-frame
    sharded run is killed mid-run (checkpoint left at an intermediate scatt
    frame), restarted with restart='c', and the output merges cleanly across
    angle dirs into ALL_DATA (the production resilience loop)."""
    import os

    import h5py

    from mcrat_tpu.config import McPar
    from mcrat_tpu.driver import decompose_work, default_synthetic_factory, run_rank
    from mcrat_tpu.io.checkpoint import CheckpointState, load_checkpoint, save_checkpoint
    from mcrat_tpu.io.hydro import HydroPaths
    from mcrat_tpu.io.photons_h5 import merge_across_angles

    par = McPar(
        fps=5.0, last_frame=13, r0_domain=(1e12, 5e13), r1_domain=(0.0, 1.0),
        r2_domain=(0.0, 0.0), theta_min_deg=0.0, theta_max_deg=6.0,
        n_theta_bins=1, frm0=(10,), frm2=(11,), inj_radius=(8e12,),
        spect=Spectrum.BLACKBODY, min_photons=2000, max_photons=8000, restart="i",
    )
    paths = HydroPaths(filepath=str(tmp_path) + "/", mc_path="MC/")
    factory = default_synthetic_factory(CFG, par, nr=96, ntheta=16)
    mesh = make_mesh()

    # phase 1: full run (sharded, chunked)
    work = run_rank(
        CFG, par, paths, rank=0, num_ranks=1, chunk_rounds=8,
        synthetic_frame_factory=factory, progress=False, mesh=mesh,
    )
    # simulate a kill after inj frame 10 / scatt frame 11: rewind the
    # checkpoint to mid-run state and delete the later dumps
    loaded = load_checkpoint(work.mc_dir, 0)
    assert loaded is not None
    proc = os.path.join(work.mc_dir, "mc_proc_0.h5")
    # craft an interrupted state: injection frame 11 died at scatt frame 12
    host, _ = factory(10)
    rngk = np.random.default_rng(17)
    arrays, _ = transport.inject_photons(
        host, work.r_inj, 1e50, par.min_photons, par.max_photons,
        par.spect, work.theta_min, work.theta_max, par.fps, rngk,
    )
    cap = pad_capacity(len(arrays["weight"]), mesh.devices.size, factor=1.25)
    ph, meta = transport.photons_from_arrays(arrays, capacity=cap, dtype=jnp.float64)
    save_checkpoint(
        work.mc_dir, 0,
        CheckpointState(frame=11, frm2=11, scatt_frame=12, time_now=12 / par.fps,
                        restart="c", weight_norm=meta.weight_norm,
                        n_injected=meta.n_injected),
        ph,
    )
    # phase 2: restart with restart='c' picks up at frame 11 / scatt 12
    import dataclasses

    par_c = dataclasses.replace(par, restart="c")
    work2 = run_rank(
        CFG, par_c, paths, rank=0, num_ranks=1, chunk_rounds=8,
        synthetic_frame_factory=factory, progress=False, mesh=mesh,
    )
    assert work2.mc_dir == work.mc_dir
    with h5py.File(proc) as f:
        assert sorted(int(k) for k in f.keys()) == [10, 11, 12, 13]
    # phase 3: cross-angle merge (single angle dir -> ALL_DATA still works)
    base = os.path.dirname(work.mc_dir)
    counts = merge_across_angles(base)
    assert set(counts) == {10, 11, 12, 13}
    assert all(v > 0 for v in counts.values())


def test_driver_with_mesh(tmp_path):
    """Full driver pass with the photon axis sharded over the 8-device mesh."""
    import os

    from mcrat_tpu.config import McPar
    from mcrat_tpu.driver import default_synthetic_factory, run_rank
    from mcrat_tpu.io.hydro import HydroPaths

    par = McPar(
        fps=5.0, last_frame=12, r0_domain=(1e12, 5e13), r1_domain=(0.0, 1.0),
        r2_domain=(0.0, 0.0), theta_min_deg=0.0, theta_max_deg=6.0,
        n_theta_bins=1, frm0=(10,), frm2=(10,), inj_radius=(8e12,),
        spect=__import__("mcrat_tpu.config", fromlist=["Spectrum"]).Spectrum.BLACKBODY,
        min_photons=300, max_photons=1500, restart="i",
    )
    paths = HydroPaths(filepath=str(tmp_path) + "/", mc_path="MC/")
    factory = default_synthetic_factory(CFG, par, nr=96, ntheta=16)
    mesh = make_mesh()
    work = run_rank(
        CFG, par, paths, rank=0, num_ranks=1,
        synthetic_frame_factory=factory, progress=False, mesh=mesh,
    )
    assert os.path.exists(os.path.join(work.mc_dir, "mc_proc_0.h5"))
    import h5py

    with h5py.File(os.path.join(work.mc_dir, "mc_proc_0.h5")) as f:
        frames = sorted(int(k) for k in f.keys())
    assert frames == [10, 11, 12]
