"""True multi-process mesh execution: 2 jax.distributed processes x 4 virtual
CPU devices each, one logical rank's photon axis sharded over all 8 devices.

The reference's whole deployment story is multi-node MPI
(/root/reference/Src/mcrat.c:93-95,146; Doc/mcrat_doc.tex:214-275); the
mcrat_tpu analogue is jax.distributed + a cross-process Mesh.  This test
proves the driver end-to-end on such a mesh — checkpoint, kill/restart,
merge — which single-process virtual-device tests cannot (cross-host fetches
take a different code path: parallel.mesh.fetch_global's process_allgather).
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)

    pid = int(sys.argv[1]); port = sys.argv[2]; outdir = sys.argv[3]
    phase = sys.argv[4]
    from mcrat_tpu.parallel.mesh import init_distributed, make_mesh
    init_distributed(coordinator=f"127.0.0.1:{{port}}", num_processes=2,
                     process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 8 and len(jax.local_devices()) == 4
    mesh = make_mesh()

    from mcrat_tpu.config import Config, Dims, Geometry, McPar, SimType, Spectrum
    from mcrat_tpu.driver import default_synthetic_factory, merge_rank_outputs, run_rank
    from mcrat_tpu.io.hydro import HydroPaths

    cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                 simulation_type=SimType.SPHERICAL_OUTFLOW, dtype="float32")
    par = McPar(fps=5.0, last_frame=12, r0_domain=(1e12, 5e13),
                r1_domain=(0.0, 1.0), r2_domain=(0.0, 0.0), theta_min_deg=0.0,
                theta_max_deg=6.0, n_theta_bins=1, frm0=(10,), frm2=(10,),
                inj_radius=(8e12,), spect=Spectrum.BLACKBODY, min_photons=200,
                max_photons=900, restart="i" if phase == "start" else "c")
    paths = HydroPaths(filepath=outdir + "/", mc_path="MC/")
    factory = default_synthetic_factory(cfg, par, nr=96, ntheta=16)
    # phase "start": run only through scatt frame 11, then exit — the
    # "kill".  phase "resume": continue from the checkpoint to frame 12.
    last = 11 if phase == "start" else 12
    work = run_rank(cfg, par, paths, rank=0, num_ranks=1, chunk_rounds=8,
                    synthetic_frame_factory=factory, progress=False,
                    mesh=mesh, last_frame_override=last)
    if phase == "resume" and jax.process_index() == 0:
        counts = merge_rank_outputs(work, par, last_frame=12)
        import json
        print("MERGED " + json.dumps({{str(k): v for k, v in counts.items()}}),
              flush=True)
    print(f"WORKER_OK pid={{pid}} phase={{phase}}", flush=True)
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_phase(script_path, port, outdir, phase):
    procs = []
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    for pid in (0, 1):
        procs.append(
            subprocess.Popen(
                [sys.executable, script_path, str(pid), str(port), outdir, phase],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                text=True,
            )
        )
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} rc={p.returncode}:\n{out[-4000:]}"
        assert "WORKER_OK" in out, out[-4000:]
    return outs


@pytest.mark.slowish
def test_two_process_mesh_driver_e2e(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO))
    outdir = str(tmp_path / "run")
    os.makedirs(outdir)

    port = _free_port()
    _run_phase(str(script), port, outdir, "start")
    mc_dir = os.path.join(outdir, "MC", "0-6")
    assert os.path.exists(os.path.join(mc_dir, "mc_chkpt_0.npz"))
    assert os.path.exists(os.path.join(mc_dir, "mc_proc_0.h5"))
    import h5py

    with h5py.File(os.path.join(mc_dir, "mc_proc_0.h5")) as f:
        frames_before = sorted(int(k) for k in f.keys())
    assert frames_before == [10, 11]
    # simulate the KILL: the clean finish wrote the injection-complete
    # marker over the checkpoint; restore the .old backup = the state as of
    # the frame-11 checkpoint, exactly what a crash right before the marker
    # write would leave behind
    chk = os.path.join(mc_dir, "mc_chkpt_0.npz")
    os.replace(chk + ".old", chk)

    port = _free_port()
    outs = _run_phase(str(script), port, outdir, "resume")
    with h5py.File(os.path.join(mc_dir, "mc_proc_0.h5")) as f:
        frames_after = sorted(int(k) for k in f.keys())
        n12 = f["12"]["P0"].shape[0]
        w12 = np.asarray(f["12"]["PW"])
        e12 = np.asarray(f["12"]["P0"])
    assert frames_after == [10, 11, 12]
    assert n12 > 0 and (w12 > 0).all() and np.isfinite(e12).all()
    # merge ran on process 0 of the resume phase
    merged_line = [l for o in outs for l in o.splitlines() if l.startswith("MERGED")]
    assert merged_line, outs[0][-2000:]
    assert os.path.exists(os.path.join(mc_dir, "mcdata_12.h5"))
