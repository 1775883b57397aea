"""Command-line entry points.

Replaces the reference binaries (reference: Makefile:17-28):

    mpiexec -np N ./MCRAT          ->  python -m mcrat_tpu.cli run ...
    mpiexec -np N ./MERGE /dir/MC/ ->  python -m mcrat_tpu.cli merge ...

Ranks are independent OS processes or loop iterations (photon batches never
communicate), so "N ranks" is just --rank/--num-ranks; a shell loop, SLURM
array, or one host driving all ranks sequentially all work.  On a GPU host a
JAX process reserves most of its card's memory, so run ranks one after another
on a card, or one per card via CUDA_VISIBLE_DEVICES; one process drives all
of a host's cards for one rank with --mesh N.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys


def _build_config(args) -> "Config":
    from .config import (
        BFieldCalc, Config, Dims, Geometry, HydroSim, NonthermalDist, SimType,
        TauCalculation,
    )

    dims = {2: Dims.TWO, 25: Dims.TWO_POINT_FIVE, 3: Dims.THREE}[args.dims]
    kw = dict(
        sim_switch=HydroSim(args.sim),
        geometry=Geometry(args.geometry),
        dims=dims,
        simulation_type=SimType(args.simulation_type),
        hydro_l_scale=args.l_scale,
        hydro_d_scale=args.d_scale,
        stokes=not args.no_stokes,
        comv=not args.no_comv,
        save_type=not args.no_save_type,
        tau_calculation=TauCalculation(args.tau),
        cyclosynchrotron=args.cyclosynchrotron,
        b_field_calc=BFieldCalc(args.b_field),
        epsilon_b=args.epsilon_b,
        dtype=args.dtype,
    )
    if args.nonthermal != "off":
        kw.update(
            nonthermal_e_dist=NonthermalDist(args.nonthermal),
            gamma_min=args.gamma_min,
            gamma_max=args.gamma_max,
            powerlaw_index=args.powerlaw_index,
            powerlaw_index_1=args.powerlaw_index_1,
            powerlaw_index_2=args.powerlaw_index_2,
            gamma_break=args.gamma_break,
        )
    return Config(**kw)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="mcrat_tpu")
    sub = parser.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="run the Monte Carlo radiative transfer")
    run.add_argument("--mcpar", required=True, help="path to mc.par")
    run.add_argument("--filepath", default="./", help="hydro file directory (FILEPATH)")
    run.add_argument("--fileroot", default="", help="hydro file prefix (FILEROOT)")
    run.add_argument("--mc-path", default="MC/", help="output subdirectory (MC_PATH)")
    run.add_argument("--sim", default="synthetic",
                     choices=["flash", "pluto", "pluto_chombo", "riken", "synthetic"])
    run.add_argument("--geometry", default="spherical",
                     choices=["cartesian", "spherical", "cylindrical", "polar"])
    run.add_argument("--dims", type=int, default=2, choices=[2, 25, 3])
    run.add_argument("--simulation-type", default="science",
                     choices=["science", "cylindrical_outflow", "spherical_outflow",
                              "structured_spherical_outflow"])
    run.add_argument("--tau", default="direct", choices=["direct", "table"])
    run.add_argument("--cyclosynchrotron", action="store_true")
    run.add_argument("--b-field", default="total_e",
                     choices=["internal_e", "total_e", "simulation"])
    run.add_argument("--epsilon-b", type=float, default=0.5)
    run.add_argument("--nonthermal", default="off",
                     choices=["off", "powerlaw", "brokenpowerlaw"])
    run.add_argument("--gamma-min", type=float)
    run.add_argument("--gamma-max", type=float)
    run.add_argument("--powerlaw-index", type=float)
    run.add_argument("--powerlaw-index-1", type=float)
    run.add_argument("--powerlaw-index-2", type=float)
    run.add_argument("--gamma-break", type=float)
    run.add_argument("--l-scale", type=float, default=1.0)
    run.add_argument("--d-scale", type=float, default=1.0)
    run.add_argument("--no-stokes", action="store_true")
    run.add_argument("--no-comv", action="store_true")
    run.add_argument("--no-save-type", action="store_true")
    run.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    run.add_argument("--rank", type=int, default=0)
    run.add_argument("--num-ranks", type=int, default=1)
    run.add_argument("--last-frame", type=int, default=None,
                     help="override mc.par last frame (short test runs)")
    run.add_argument("--chunk-rounds", type=int, default=256)
    run.add_argument("--ph-weight", type=float, default=1e50,
                     help="initial injection weight before auto-tune "
                          "(reference passes this through photonInjection)")
    run.add_argument("--merge", action="store_true", help="merge after the run")
    run.add_argument("--elastic", action="store_true",
                     help="re-adopt unfinished old-rank checkpoints under this "
                          "job's --num-ranks (any size; the reference aborts "
                          "unless ranks map exactly, Src/mcrat.c:402-407)")
    run.add_argument("--mesh", type=int, default=0,
                     help="shard the photon axis over N devices (0 = single "
                          "device; -1 = all visible devices)")
    run.add_argument("--coordinator", default=None,
                     help="multi-host coordinator address host:port "
                          "(jax.distributed.initialize)")
    run.add_argument("--num-hosts", type=int, default=1)
    run.add_argument("--host-id", type=int, default=None)

    mrg = sub.add_parser("merge", help="merge per-process files (the MERGE tool)")
    mrg.add_argument("mc_dir",
                     help="angle directory containing mc_proc_*.h5, or the MC "
                          "base directory containing angle dirs (cross-angle "
                          "merge into ALL_DATA/, like the reference MERGE "
                          "binary: mpiexec -np N ./MERGE /dir/to/MC/)")
    mrg.add_argument("--frames", default=None,
                     help="frame range as lo:hi (default: every frame found)")
    mrg.add_argument("--all-data", action="store_true",
                     help="force the cross-angle ALL_DATA merge (otherwise "
                          "auto-detected from the directory layout)")

    st = sub.add_parser(
        "status",
        help="report per-rank progress from checkpoints (replaces the "
             "reference's log-grepping ops script mcrat_msp.sh)",
    )
    st.add_argument("base_dir", help="MC output directory (contains angle dirs)")
    st.add_argument("--last-frame", type=int, required=True)

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stderr)

    if args.command == "status":
        import glob
        import os

        from .io.checkpoint import load_checkpoint, scan_checkpoints

        report = {}
        for adir in sorted(glob.glob(os.path.join(args.base_dir, "*-*"))):
            if not os.path.isdir(adir):
                continue
            ranks = {}
            for path in sorted(glob.glob(os.path.join(adir, "mc_chkpt_*.npz"))):
                rank = int(path.rsplit("_", 1)[1].split(".")[0])
                loaded = load_checkpoint(adir, rank)
                if loaded is None:
                    continue
                state, photons = loaded
                done = state.frame > state.frm2 or (
                    state.restart == "i" and state.frame > state.frm2
                )
                ranks[rank] = dict(
                    inj_frame=state.frame,
                    frm2=state.frm2,
                    scatt_frame=state.scatt_frame,
                    progress=min(
                        1.0,
                        max(state.scatt_frame - 1, 0) / max(args.last_frame, 1),
                    ),
                    done=bool(done),
                    n_photons=(
                        int((photons.weight > 0).sum()) if photons is not None else 0
                    ),
                )
            report[os.path.basename(adir)] = ranks
        print(json.dumps(report, indent=1))
        return 0

    if getattr(args, "dtype", None) == "float64":
        # without this, float64 requests silently downgrade to float32
        import jax

        jax.config.update("jax_enable_x64", True)

    if args.command == "merge":
        import glob
        import os

        from .io.photons_h5 import discover_frames, merge_across_angles, merge_all

        frames = None
        if args.frames:
            lo, hi = (int(x) for x in args.frames.split(":"))
            frames = range(lo, hi + 1)
        local_procs = glob.glob(os.path.join(args.mc_dir, "mc_proc_*.h5"))
        if args.all_data or not local_procs:
            # MC base dir: cross-angle merge into ALL_DATA/ (the reference's
            # standalone MERGE binary, Src/merge.c:23-336)
            counts = merge_across_angles(args.mc_dir, frames)
        else:
            counts = merge_all(
                args.mc_dir, frames if frames is not None else discover_frames(local_procs)
            )
        print(json.dumps({str(k): v for k, v in counts.items()}))
        return 0

    try:
        import h5py  # noqa: F401
    except ModuleNotFoundError:
        parser.error("run writes its output as HDF5 and needs h5py, which is not installed")
    from .runtime import enable_compile_cache

    enable_compile_cache()

    from .config import HydroSim
    from .driver import (
        default_synthetic_factory, merge_rank_outputs, run_elastic, run_rank,
    )
    from .io.hydro import HydroPaths
    from .io.mcpar import read_mcpar

    cfg = _build_config(args)
    par = read_mcpar(args.mcpar)
    paths = HydroPaths(filepath=args.filepath, fileroot=args.fileroot, mc_path=args.mc_path)
    factory = (
        default_synthetic_factory(cfg, par)
        if cfg.sim_switch is HydroSim.SYNTHETIC
        else None
    )
    mesh = None
    write_outputs = True
    if args.mesh:
        from .parallel.mesh import init_distributed, make_mesh

        init_distributed(
            coordinator=args.coordinator, num_processes=args.num_hosts,
            process_id=args.host_id,
        )
        # ONE logical rank's photon axis spans the whole mesh (all hosts'
        # devices) — the mesh replaces the reference's intra-rank OpenMP axis
        # at pod scale.  write_outputs stays True on EVERY process: the
        # persistence fetch is a cross-process COLLECTIVE
        # (parallel.mesh.fetch_global), so all processes must reach it; the
        # driver gates the actual file writes on jax.process_index() == 0.
        mesh = make_mesh(None if args.mesh < 0 else args.mesh)
    kw = dict(
        last_frame_override=args.last_frame, chunk_rounds=args.chunk_rounds,
        synthetic_frame_factory=factory, ph_weight=args.ph_weight,
        mesh=mesh, write_outputs=write_outputs,
    )
    if args.elastic:
        works = run_elastic(
            cfg, par, paths, rank=args.rank, num_ranks=args.num_ranks, **kw
        )
        work = works[-1] if works else None
    else:
        work = run_rank(
            cfg, par, paths, rank=args.rank, num_ranks=args.num_ranks, **kw
        )
    if args.merge and work is not None:
        counts = merge_rank_outputs(work, par, last_frame=args.last_frame)
        print(json.dumps({str(k): v for k, v in counts.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
