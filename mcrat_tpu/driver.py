"""Simulation driver: the orchestration layer.

JAX re-design of the reference main() (Src/mcrat.c:48-1036):

* work decomposition over viewing-angle bins x injection frames — the
  reference's MPI strategies 1 & 2 (MPI_Comm_split at Src/mcrat.c:146; frame
  blocks at :457-479) become a deterministic rank -> (angle bin, frame block)
  mapping with no communicator machinery (photon batches are independent);
* the two-level frame loop: inject at each injection frame, then transport
  through every subsequent hydro frame until the last one, with per-frame
  decimated hydro loads, optional cyclo-synchrotron emission/absorption/
  rebinning, statistics, checkpointing, and per-rank HDF5 dumps;
* restart: continue from the per-rank checkpoint (reference: readCheckpoint),
  including elastic re-adoption of unfinished old ranks when the job size
  changed (reference: Src/mcrat.c:166-448);
* a final merge pass building mcdata_<frame>.h5 files.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Callable, Optional, Sequence

import jax
import numpy as np

from .ops.rng import make_key
from .config import Config, McPar, PhotonType, SimType
from .constants import C_LIGHT
from .grid import HydroFrameHost
from .io.checkpoint import CheckpointState, load_checkpoint, save_checkpoint, scan_checkpoints
from .io.hydro import HydroPaths, build_index, get_hydro_data
from .io.photons_h5 import append_photons, merge_all
from .ops import cyclosynch
from .parallel.mesh import fetch_global
from . import transport

log = logging.getLogger("mcrat_tpu")


@dataclasses.dataclass
class WorkAssignment:
    """One rank's slice of the angle x injection-frame work."""

    angle_id: int
    theta_min: float  # radians
    theta_max: float
    r_inj: float
    framestart: int
    frm2: int
    mc_dir: str


def decompose_work(
    par: McPar, rank: int, num_ranks: int, base_dir: str
) -> WorkAssignment:
    """rank -> (angle bin, injection frame block).

    Mirrors the reference's angle split (procs_per_angle = world/num_bins,
    color = rank / procs_per_angle; Src/mcrat.c:139-162) and the per-angle
    frame blocks (proc_frame_size = ceil((frm2-frm0)/angle_procs),
    Src/mcrat.c:457-479).
    """
    nbins = par.n_theta_bins
    procs_per_angle = max(num_ranks // nbins, 1)
    angle_id = min(rank // procs_per_angle, nbins - 1)
    angle_rank = rank - angle_id * procs_per_angle

    dtheta = (par.theta_max_deg - par.theta_min_deg) / nbins
    t_lo = par.theta_min_deg + angle_id * dtheta
    t_hi = t_lo + dtheta

    frm0, frm2 = par.frm0[angle_id], par.frm2[angle_id]
    nframes = frm2 - frm0 + 1
    block = math.ceil(nframes / procs_per_angle)
    f_start = frm0 + angle_rank * block
    f_end = min(f_start + block - 1, frm2) if angle_rank < procs_per_angle - 1 else frm2
    # per-angle output directory (reference: Src/mcrat.c:155)
    mc_dir = os.path.join(base_dir, f"{t_lo:g}-{t_hi:g}")
    return WorkAssignment(
        angle_id=angle_id,
        theta_min=math.radians(t_lo),
        theta_max=math.radians(t_hi),
        r_inj=par.inj_radius[angle_id],
        framestart=f_start,
        frm2=f_end,
        mc_dir=mc_dir,
    )


@dataclasses.dataclass(frozen=True)
class FrameSchedule:
    """Per-format hydro frame schedule (SURVEY §7 hard-part e).

    The reference scatters the RIKEN 3-D special case — files come every 10
    frames at 1 fps beyond frame 3000 — through both driver loops and the
    checkpoint reader (Src/mcrat.c:551-562,612-624,667-679;
    Src/mcrat_io.c:1044-1053).  Here one object answers every schedule
    question; every other format is uniform at ``base_fps``.
    """

    base_fps: float
    riken3d: bool = False

    _RIKEN_SWITCH_FRAME = 3000
    _RIKEN_INCREMENT = 10

    def step(self, frame: int):
        """(frame increment, fps) in effect at ``frame``."""
        if self.riken3d and frame >= self._RIKEN_SWITCH_FRAME:
            return self._RIKEN_INCREMENT, 1.0
        return 1, self.base_fps

    def next(self, frame: int) -> int:
        return frame + self.step(frame)[0]

    def frames(self, first: int, last: int):
        """Frame numbers from ``first`` through ``last`` inclusive."""
        frame = first
        while frame <= last:
            yield frame
            frame = self.next(frame)

    def inj_time(self, frame: int) -> float:
        """time_now at a fresh injection (reference: mcrat.c:667-679 sets
        time_now = frame / fps with the fps in effect AT that frame)."""
        return frame / self.step(frame)[1]

    def end_time(self, frame: int, inj_frame: int = 0) -> float:
        """Time at the END of scattering frame ``frame``.

        Uniform formats: (frame+1)/fps.  RIKEN 3-D accumulates dt = 1/fps
        per visited frame (1/base below 3000, 1 s per 10-frame step above).
        The reference's clock is PATH-dependent there — time_now is seeded
        as inj_frame/fps(inj_frame) and then advanced per visited frame
        (Src/mcrat.c:667-679) — so an injection at or beyond frame 3000
        anchors at inj_frame seconds, not on the sub-3000 timeline;
        ``inj_frame`` disambiguates (without it, a >=3000 injection would
        make every dt negative and the run a silent no-op).
        """
        if not self.riken3d or frame < self._RIKEN_SWITCH_FRAME:
            return (frame + 1) / self.base_fps
        k = (frame - self._RIKEN_SWITCH_FRAME) // self._RIKEN_INCREMENT
        if inj_frame >= self._RIKEN_SWITCH_FRAME:
            k0 = (inj_frame - self._RIKEN_SWITCH_FRAME) // self._RIKEN_INCREMENT
            return float(inj_frame) + (k - k0 + 1) * 1.0
        return self._RIKEN_SWITCH_FRAME / self.base_fps + (k + 1) * 1.0


def make_frame_schedule(cfg: Config, par: McPar) -> FrameSchedule:
    from .config import Dims, HydroSim

    return FrameSchedule(
        base_fps=par.fps,
        riken3d=(cfg.sim_switch is HydroSim.RIKEN and cfg.dims is Dims.THREE),
    )


_STALE_PATTERNS = (
    "mc_proc_*.h5",
    "mc_chkpt_*.npz",
    "mc_chkpt_*.npz.old",
    "mc_output_*.log",
    "mcdata_*.h5",
)


def _stale_files(mc_dir: str):
    import glob as _glob

    out = []
    for pat in _STALE_PATTERNS:
        out.extend(_glob.glob(os.path.join(mc_dir, pat)))
    return out


_INIT_READY_PREFIX = ".mc_init_ready."
_INIT_DONE_PREFIX = ".mc_init_done."


def _atomic_write(path: str, content: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(content)
    os.replace(tmp, path)


def clean_initialize_dir(
    mc_dir: str, rank: int, cleaner: bool = True, wait_s: float = 30.0,
    expected_ranks=None,
) -> int:
    """Delete stale output before an initialize-mode run.

    The reference deletes EVERY mc_proc_*, mcdata_*, mc_chkpt_* and log file
    in the angle directory when restart=INITALIZE finds a non-empty directory
    (Src/mcrat.c:507-549, guarded by an MPI barrier so rank 0 cleans before
    anyone writes).  Ranks here are independent processes with no MPI, so the
    barrier is a per-rank ready/ack marker handshake (race-free, unlike the
    marker-mtime heuristic it replaces — that one could sweep a fast rank's
    fresh output when the cleaner lagged):

    * every non-cleaner writes ``.mc_init_ready.<rank>`` containing a fresh
      random nonce, then blocks until ``.mc_init_done.<rank>`` echoes THAT
      nonce (a stale ack from a previous job cannot match);
    * the ``cleaner`` (the lowest rank mapped to the directory) waits up to
      ``wait_s`` for every other expected rank's ready marker, sweeps the
      whole stale set — ALL old ranks' files, because a re-initialize with
      fewer ranks than the previous job must not leave other ranks'
      mc_proc_*.h5 for merge_all to double-count — and only THEN acks each
      ready marker.  No rank writes output before its ack, so the sweep can
      never catch fresh files, regardless of launch order or speed.

    Timeout fallbacks keep degraded cases safe-but-slow: a non-cleaner whose
    ack never comes (no cleaner in a deliberately partial re-run, or a nonce
    mismatch against a stale ready marker the cleaner acked) waits ``wait_s``
    then removes only its own files + the shared merged outputs; a cleaner
    missing some ready markers sweeps anyway after ``wait_s`` (matching the
    old behavior when ranks run sequentially).

    Returns the number of stale files removed by THIS rank.
    """
    import glob as _glob
    import time as _time
    import uuid as _uuid

    def _rm(paths):
        n = 0
        for path in paths:
            try:
                os.remove(path)
                n += 1
            except FileNotFoundError:
                pass
        return n

    def _ready_markers():
        out = {}
        for p in _glob.glob(os.path.join(mc_dir, _INIT_READY_PREFIX + "*")):
            try:
                out[int(p.rsplit(".", 1)[-1])] = p
            except ValueError:
                pass
        return out

    if cleaner:
        # marker debris from long-dead jobs (fresh markers must survive: a
        # concurrent rank may have written its ready marker moments ago)
        old = _time.time() - max(4 * wait_s, 120.0)
        for p in _glob.glob(os.path.join(mc_dir, ".mc_init_*")):
            try:
                if os.path.getmtime(p) < old:
                    os.remove(p)
            except OSError:
                pass
        expected = set(expected_ranks or ()) - {rank}
        deadline = _time.monotonic() + wait_s
        while expected - set(_ready_markers()) and _time.monotonic() < deadline:
            _time.sleep(0.05)
        removed = _rm(_stale_files(mc_dir))
        # ack ONLY after the sweep: an acked rank may write immediately
        for r, p in _ready_markers().items():
            try:
                with open(p) as f:
                    nonce = f.read().strip()
            except OSError:
                continue
            _atomic_write(os.path.join(mc_dir, f"{_INIT_DONE_PREFIX}{r}"), nonce)
        return removed

    nonce = _uuid.uuid4().hex
    ready = os.path.join(mc_dir, f"{_INIT_READY_PREFIX}{rank}")
    done = os.path.join(mc_dir, f"{_INIT_DONE_PREFIX}{rank}")
    _rm([done])  # a stale ack for THIS rank id cannot match the nonce, but
    # removing it saves pointless polls
    _atomic_write(ready, nonce)
    deadline = _time.monotonic() + wait_s
    while _time.monotonic() < deadline:
        try:
            with open(done) as f:
                if f.read().strip() == nonce:
                    _rm([ready, done])
                    return 0  # the cleaner swept everything before acking
        except OSError:
            pass
        _time.sleep(0.05)
    # the cleaner never showed: remove this rank's own files + shared merged
    # outputs (idempotent), leaving other live ranks' outputs alone
    _rm([ready])
    own = [
        os.path.join(mc_dir, f"mc_proc_{rank}.h5"),
        os.path.join(mc_dir, f"mc_chkpt_{rank}.npz"),
        os.path.join(mc_dir, f"mc_chkpt_{rank}.npz.old"),
        os.path.join(mc_dir, f"mc_output_{rank}.log"),
    ]
    own = [p for p in own if os.path.exists(p)]
    own.extend(_glob.glob(os.path.join(mc_dir, "mcdata_*.h5")))
    return _rm(own)


def _append_arrays(photons, meta, new_arrays, dtype, n_alive=None,
                   t_rem=None, new_t=None, mesh=None):
    """Append host photon arrays into the fixed-capacity population,
    growing it if necessary (replaces null-slot recycling, Src/photons.c).

    The free-slot search runs ON DEVICE (transport.append_photons_device):
    the old host-side np.flatnonzero over a fetched alive mask cost a
    full-population transfer per append — 2-3 per cyclo-synchrotron frame.
    ``n_alive`` (from the driver's frame_stats tracking) sizes the growth
    decision; None falls back to one device count fetch.  ``t_rem``/``new_t``
    thread the per-photon frame-time array through mid-frame appends.  On a
    multi-process ``mesh`` the new photons are placed replicated (every
    process computes the identical host-side emission).

    Returns (photons, meta, n_new, t_rem).
    """
    import jax.numpy as jnp

    if not new_arrays:
        return photons, meta, 0, t_rem
    n_new = len(new_arrays["weight"])
    if n_alive is None:
        n_alive = int(jax.device_get(jnp.sum(photons.alive.astype(jnp.int32))))
    if photons.capacity - n_alive < n_new:
        # grow capacity (pow-2 steps bound the number of compiles)
        extra = int(2 ** math.ceil(math.log2(photons.capacity + n_new)))
        if t_rem is None:
            photons = transport.grow_photons(photons, extra)
        else:
            photons, t_rem = transport.grow_photons(photons, extra, t_rem=t_rem)
    npad = transport._pow2(n_new)
    new_ph, _ = transport.photons_from_arrays(
        new_arrays, capacity=npad, dtype=dtype, weight_norm=meta.weight_norm
    )
    if mesh is not None and jax.process_count() > 1:
        from .parallel.mesh import put_replicated

        new_ph = put_replicated(jax.device_get(new_ph), mesh)
    if t_rem is None:
        photons = transport.append_photons_device(photons, new_ph)
        return photons, meta, n_new, None
    nt = np.zeros(npad, dtype=np.dtype(t_rem.dtype))
    nt[:n_new] = new_t
    if mesh is not None and jax.process_count() > 1:
        from .parallel.mesh import put_replicated

        new_t_dev = put_replicated(nt, mesh)
    else:
        new_t_dev = jnp.asarray(nt)
    photons, t_rem = transport.append_photons_device(
        photons, new_ph, t_rem=t_rem, new_t=new_t_dev
    )
    return photons, meta, n_new, t_rem


class _PersistWriter:
    """Background checkpoint+dump writer.

    The persistence path costs one device->host transfer of the live photon
    subset plus two disk writes per frame.  A single worker thread keeps writes ordered
    (checkpoint first, then the dump gated on its success — reference:
    Src/mcrat.c:902-915) while the main thread launches the next frame's
    device work; submit_frame() starts the device->host copies asynchronously
    before queueing so the transfer itself also overlaps compute.  Any write
    error surfaces on the next submit_frame()/wait().
    """

    def __init__(self):
        import concurrent.futures

        self._ex = concurrent.futures.ThreadPoolExecutor(1)
        self._fut = None

    def submit_frame(self, cfg, mc_dir, rank, st, sub_ph, meta, scatt_frame):
        self.wait()  # at most one frame in flight; surfaces prior errors
        import jax.numpy as jnp

        # Drop planes the run's config never outputs BEFORE the device->host
        # copy: with COMV off, the comoving momenta are pure transfer weight
        # (the engine recomputes them from the lab p every round; neither the
        # dump nor a resume needs them — the reference's COMV_SWITCH default
        # is OFF, Src/mcrat.h:391-402); likewise the Stokes planes with
        # polarization off.  Together 8 of ~19 planes.
        if not cfg.comv:
            sub_ph = sub_ph.replace(comv_p=jnp.zeros((0, 4), sub_ph.p.dtype))
        if not cfg.stokes:
            sub_ph = sub_ph.replace(s=jnp.zeros((0, 4), sub_ph.p.dtype))
        # the containing-cell index is a pure cache: neither the dump nor a
        # resume needs it persisted (load restores -1 and the first cell
        # search re-resolves every lane — the rectilinear path does that
        # every invocation anyway)
        sub_ph = sub_ph.replace(cell=jnp.zeros((0,), sub_ph.cell.dtype))
        multiproc = jax.process_count() > 1
        if multiproc:
            # the cross-process gather is a COLLECTIVE: it must run on the
            # main thread in deterministic order relative to the next frame's
            # collectives, or two processes can interleave collectives
            # differently and deadlock.  Only the (process-0-only) disk
            # writes go to the background worker.
            from .parallel.mesh import fetch_global

            host_ph = fetch_global(sub_ph)
            if jax.process_index() != 0:
                return
        else:
            host_ph = None
            for leaf in jax.tree_util.tree_leaves(sub_ph):
                try:
                    leaf.copy_to_host_async()
                except Exception:
                    pass  # non-jax leaves / backends without async copy

        def job():
            ph = host_ph if host_ph is not None else jax.device_get(sub_ph)
            save_checkpoint(mc_dir, rank, st, ph)
            append_photons(
                cfg, os.path.join(mc_dir, f"mc_proc_{rank}.h5"),
                scatt_frame, ph, meta,
            )

        self._fut = self._ex.submit(job)

    def wait(self):
        if self._fut is not None:
            fut, self._fut = self._fut, None
            fut.result()

    def close(self):
        try:
            self.wait()
        finally:
            self._ex.shutdown()


def run_rank(
    cfg: Config,
    par: McPar,
    paths: HydroPaths,
    rank: int = 0,
    num_ranks: int = 1,
    base_dir: Optional[str] = None,
    synthetic_frame_factory: Optional[Callable[[int], tuple]] = None,
    key=None,
    chunk_rounds: int = 256,
    last_frame_override: Optional[int] = None,
    xsec_cache: Optional[str] = None,
    progress: bool = True,
    mesh=None,
    ph_weight: float = 1e50,
    work: Optional[WorkAssignment] = None,
    write_outputs: bool = True,
    init_clean_wait_s: float = 30.0,
) -> WorkAssignment:
    """Run one rank's full simulation (inject -> transport -> dump -> merge).

    ``synthetic_frame_factory(frame) -> (HydroFrameHost, edges|None)`` supplies
    frames for SYNTHETIC runs; file-backed formats read from ``paths``.

    With ``mesh`` (a 1-D jax.sharding.Mesh), the photon axis is sharded over
    the mesh devices and each frame window runs as one sharded transport step
    (parallel.sharded_transport_frame): the multi-device analogue of the
    reference's OpenMP intra-rank threading, on top of the angle x frame
    process decomposition.
    """
    base_dir = base_dir or os.path.join(paths.filepath, paths.mc_path)
    cleaner = True  # explicit-work callers (elastic) adopt old ranks alone
    dir_ranks = None
    if work is None:
        work = decompose_work(par, rank, num_ranks, base_dir)
        # lowest rank mapped to this angle dir does the full stale sweep (the
        # reference's per-communicator rank 0, Src/mcrat.c:507-549)
        procs_per_angle = max(num_ranks // par.n_theta_bins, 1)
        cleaner = rank == work.angle_id * procs_per_angle
        # every rank sharing this angle dir (the cleaner's barrier peer set)
        dir_ranks = [
            r for r in range(num_ranks)
            if min(r // procs_per_angle, par.n_theta_bins - 1) == work.angle_id
        ]
    os.makedirs(work.mc_dir, exist_ok=True)
    # on a multi-process mesh only process 0 touches files; the other
    # processes still run the full loop (the persistence fetch is collective)
    files_here = write_outputs and jax.process_index() == 0
    if par.restart == "i" and files_here:
        n_rm = clean_initialize_dir(
            work.mc_dir, rank, cleaner=cleaner, wait_s=init_clean_wait_s,
            expected_ranks=dir_ranks,
        )
        if n_rm:
            log.info("rank %d: initialize mode removed %d stale output files", rank, n_rm)
    # per-rank persistent log file (reference: mc_output_<rank>.log,
    # Src/mcrat.c:567-575; Doc/mcrat_doc.tex:259-263 documents grepping it for
    # progress) — a crashed rank leaves an on-disk trace of what it was doing
    log_handler = None
    if files_here:
        log_handler = logging.FileHandler(
            os.path.join(work.mc_dir, f"mc_output_{rank}.log")
        )
        log_handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        )
        log.addHandler(log_handler)
        if log.level > logging.INFO or log.level == logging.NOTSET:
            log_handler.setLevel(logging.INFO)
            log.setLevel(logging.INFO)
    persist = _PersistWriter()
    try:
        return _run_rank_inner(
            cfg, par, paths, rank, num_ranks, base_dir,
            synthetic_frame_factory, key, chunk_rounds, last_frame_override,
            xsec_cache, progress, mesh, ph_weight, work, write_outputs,
            persist,
        )
    finally:
        persist.close()
        if log_handler is not None:
            log.removeHandler(log_handler)
            log_handler.close()


def _run_rank_inner(
    cfg: Config,
    par: McPar,
    paths: HydroPaths,
    rank: int,
    num_ranks: int,
    base_dir: str,
    synthetic_frame_factory,
    key,
    chunk_rounds: int,
    last_frame_override: Optional[int],
    xsec_cache: Optional[str],
    progress: bool,
    mesh,
    ph_weight: float,
    work: WorkAssignment,
    write_outputs: bool,
    persist: _PersistWriter,
) -> WorkAssignment:
    key = key if key is not None else make_key(1234 + rank)
    rng = np.random.default_rng(9876 + rank)
    dtype = cfg.np_dtype()
    last_frm = last_frame_override or par.last_frame

    xsec_table = None
    if cfg.tau_calculation.value == "table":
        from .ops import hot_xsec

        cache = xsec_cache or os.path.join(base_dir, "hot_x_section.npz")
        xsec_table = hot_xsec.load_or_build(cfg, cache)

    # --- restart handling (reference: Src/mcrat.c:166-455) ---------------------
    state = None
    photons = None
    meta = None
    if par.restart == "c":
        loaded = load_checkpoint(work.mc_dir, rank, dtype=str(dtype))
        if loaded is not None:
            state, photons = loaded
            meta = transport.PhotonsMeta(state.weight_norm, state.n_injected)
            log.info(
                "rank %d: continuing from frame %d scatt %d", rank, state.frame,
                state.scatt_frame,
            )

    sched = make_frame_schedule(cfg, par)

    def load_frame(frame, ph_inj, bounds):
        synth = None
        edges = None
        if synthetic_frame_factory is not None:
            synth, edges = synthetic_frame_factory(frame)
        host = get_hydro_data(
            cfg, paths, frame, sched.step(frame)[1], work.r_inj, ph_inj,
            *(bounds or (0.0, np.inf, 0.0, np.pi)),
            synthetic_frame=synth,
        )
        return host, edges

    frame0 = state.frame if state else work.framestart
    # host-side trackers refreshed from the ONE per-frame stats fetch
    pending_stats = None  # (11,) frame_stats of the previous frame's population
    n_pool_host = 0

    for frame in sched.frames(frame0, work.frm2):
        fresh = state is None or frame != state.frame or state.restart == "i"
        if fresh:
            time_now = sched.inj_time(frame)
            host, edges = load_frame(frame, True, None)
            arrays, w = transport.inject_photons(
                host, work.r_inj, ph_weight, par.min_photons, par.max_photons,
                par.spect, work.theta_min, work.theta_max,
                sched.step(frame)[1], rng,
            )
            pending_stats = None
            n_pool_host = 0
            cap = int(
                2 ** math.ceil(math.log2(len(arrays["weight"]) * cfg.capacity_factor))
            )
            photons, meta = transport.photons_from_arrays(
                arrays, capacity=cap, dtype=dtype
            )
            scatt_start = frame
            log.info(
                "rank %d: injected %d photons at frame %d (w=%.3e)",
                rank, meta.n_injected, frame, meta.weight_norm,
            )
        else:
            time_now = state.time_now
            scatt_start = state.scatt_frame

        for scatt_frame in sched.frames(scatt_start, last_frm):
            dt_frame = sched.end_time(scatt_frame, inj_frame=frame) - time_now
            if dt_frame <= 0:
                continue
            # ONE stats fetch per frame: the decimation bounds were computed at
            # the end of the previous frame together with its scattering stats
            # (each separate float() is a full device->host round-trip).
            if pending_stats is None:
                pending_stats = np.asarray(
                    fetch_global(transport.frame_stats(photons))
                )
                n_pool_host = int(pending_stats[8])
            n_alive = int(pending_stats[9])
            r_min, r_max, t_min, t_max = (float(x) for x in pending_stats[4:8])
            if cfg.cyclosynchrotron and scatt_frame != scatt_start:
                lo, hi = cyclosynch.cs_r_limits(scatt_frame, frame, par.fps, work.r_inj)
                r_min, r_max = min(r_min, lo), max(r_max, hi)
            host, edges = load_frame(scatt_frame, False, (r_min, r_max, t_min, t_max))
            frame_dev = host.to_device(dtype=dtype)
            index = build_index(cfg, host, edges)
            if mesh is not None:
                # replicate ONCE per frame so frame-boundary device work
                # (absorption) shares the mesh placement with transport — on
                # a multi-process mesh, mixing local and global arrays in one
                # jit is an error
                from .parallel.mesh import replicate

                frame_dev = replicate(frame_dev, mesh)
                index = replicate(index, mesh)

            n_emit = 0
            cs_active = cfg.cyclosynchrotron and scatt_frame != scatt_start
            if cs_active:
                cs_arrays, _ = cyclosynch.emit_pool_photons(
                    cfg, host, scatt_frame, frame, par.fps, work.r_inj,
                    meta.weight_norm, par.max_photons,
                    work.theta_min, work.theta_max, rng,
                )
                photons, meta, n_emit, _ = _append_arrays(
                    photons, meta, cs_arrays, dtype, n_alive=n_alive, mesh=mesh
                )
                n_alive += n_emit
                n_pool_before = n_pool_host + n_emit

            def run_transport(ph, sub, t_rem0=None, cs_limit=None):
                if mesh is not None:
                    from .parallel import (
                        pad_capacity, shard_photons, sharded_transport_frame,
                    )
                    from .parallel.mesh import replicate

                    nsh = mesh.devices.size
                    if ph.capacity % nsh:
                        if t_rem0 is None:
                            ph = transport.grow_photons(
                                ph, pad_capacity(ph.capacity, nsh)
                            )
                        else:
                            # t_rem0 must track capacity: transport_frame
                            # masks active = alive & (t_rem > 0) elementwise
                            ph, t_rem0 = transport.grow_photons(
                                ph, pad_capacity(ph.capacity, nsh), t_rem=t_rem0
                            )
                    return sharded_transport_frame(
                        cfg, mesh, shard_photons(ph, mesh),
                        replicate(frame_dev, mesh), replicate(index, mesh),
                        dt_frame, sub, xsec_table=xsec_table,
                        stokes_on=cfg.stokes, chunk_rounds=chunk_rounds,
                        t_rem0=t_rem0, cs_limit=cs_limit,
                    )
                return transport.transport_frame(
                    cfg, ph, frame_dev, index, dt_frame, sub,
                    xsec_table=xsec_table, stokes_on=cfg.stokes,
                    chunk_rounds=chunk_rounds, t_rem0=t_rem0, cs_limit=cs_limit,
                )

            # transport, with the mid-frame rebin trigger armed when
            # cyclo-synchrotron is live: a CS-heavy frame merges its scattered
            # pool photons at chunk boundaries instead of letting the
            # COMPTONIZED population grow unboundedly until the frame ends
            # (reference: every-1000-scatterings check, Src/mcrat.c:819-830)
            cs_limit = par.max_photons if cs_active else None
            n_scatt_frame = 0
            rounds_frame = 0
            t0 = None
            while True:
                key, sub = jax.random.split(key)
                res = run_transport(photons, sub, t_rem0=t0, cs_limit=cs_limit)
                photons = res.photons
                n_scatt_frame += int(res.n_scatt)
                rounds_frame += int(res.n_rounds)
                if not res.rebin_pending:
                    break
                photons, merged, merged_t = cyclosynch.rebin_population(
                    cfg, photons, meta, par.max_photons, n_cs=res.n_cs,
                    t_rem=res.t_rem,
                )
                t0 = res.t_rem
                n_alive -= res.n_cs
                if merged is not None:
                    merged = dict(merged)
                    merged["weight"] = merged["weight"] * meta.weight_norm
                    photons, meta, n_mrg, t0 = _append_arrays(
                        photons, meta, merged, dtype, n_alive=n_alive,
                        t_rem=t0, new_t=merged_t, mesh=mesh,
                    )
                    n_alive += n_mrg
                log.info(
                    "rank %d frame %d scatt %d: mid-frame rebin %d -> %d CS photons",
                    rank, frame, scatt_frame, res.n_cs,
                    0 if merged is None else len(merged["weight"]),
                )
            time_now += dt_frame

            if cs_active:
                # one-for-one pool replenishment for scattered (promoted) pool
                # photons (reference: Src/mcrat.c:791-808), then rebin the
                # scattered-CS population if it exceeds the cap, then absorb
                # below-nu_c photons (reference: Src/mcrat.c:819-830, 853-878).
                # ONE combined stats fetch feeds the pool deficit, the free-
                # slot count, and the rebin trigger.
                stats_mid = np.asarray(
                    fetch_global(transport.frame_stats(photons))
                )
                n_pool_after = int(stats_mid[8])
                n_alive = int(stats_mid[9])
                n_cs_now = int(stats_mid[10])
                deficit = n_pool_before - n_pool_after
                if deficit > 0:
                    repl = cyclosynch.emit_pool_replacements(
                        cfg, host, scatt_frame, frame, par.fps, work.r_inj,
                        meta.weight_norm, deficit,
                        work.theta_min, work.theta_max, rng,
                    )
                    photons, meta, n_rep, _ = _append_arrays(
                        photons, meta, repl, dtype, n_alive=n_alive, mesh=mesh
                    )
                    n_alive += n_rep
                photons, merged, _ = cyclosynch.rebin_population(
                    cfg, photons, meta, par.max_photons, n_cs=n_cs_now
                )
                if merged is not None:
                    n_alive -= n_cs_now
                    merged = dict(merged)
                    merged["weight"] = merged["weight"] * meta.weight_norm
                    photons, meta, n_mrg, _ = _append_arrays(
                        photons, meta, merged, dtype, n_alive=n_alive, mesh=mesh
                    )
                    n_alive += n_mrg
                photons, n_abs, _w_abs = cyclosynch.apply_absorption(
                    cfg, frame_dev, photons
                )

            # end-of-frame combined fetch: scattering stats for logging, the
            # NEXT frame's decimation bounds, the surviving pool count, and
            # the live count that sizes the persistence subset
            pending_stats = np.asarray(
                fetch_global(transport.frame_stats(photons))
            )
            mx, mn, mean, r_avg = (float(x) for x in pending_stats[0:4])
            n_pool_host = int(pending_stats[8])
            if progress:
                log.info(
                    "rank %d frame %d scatt %d: %d scatterings (%d rounds); "
                    "num_scatt max/mean %.0f/%.2f; <r> %.3e; %d live photons",
                    rank, frame, scatt_frame, n_scatt_frame, rounds_frame,
                    mx, mean, r_avg, int(pending_stats[9]),
                )

            if write_outputs:
                # next scatt frame per the schedule (reference: the RIKEN +10
                # resume special case in readCheckpoint, mcrat_io.c:1044-1053)
                st = CheckpointState(
                    frame=frame, frm2=work.frm2,
                    scatt_frame=sched.next(scatt_frame),
                    time_now=time_now, restart="c",
                    weight_norm=meta.weight_norm, n_injected=meta.n_injected,
                )
                # Persistence fetches ONLY the live lanes (dead lanes are pure
                # transfer traffic) and runs on a background writer
                # thread overlapped with the next frame's compute; the fetch
                # starts asynchronously here so the transfer itself also
                # overlaps.  Ordering (checkpoint, then the dump gated on its
                # success — reference: Src/mcrat.c:902-915) is preserved by
                # the single-worker queue.
                n_live_now = int(pending_stats[9])
                sub_ph = transport.compact_live(
                    photons, min(transport._pad64k(n_live_now), photons.capacity)
                )
                persist.submit_frame(
                    cfg, work.mc_dir, rank, st, sub_ph, meta, scatt_frame
                )

        # injection-complete marker (reference: mcrat_io.c:966-1001)
        state = None
        if write_outputs and jax.process_index() == 0:
            persist.wait()
            next_inj = sched.next(frame)
            save_checkpoint(
                work.mc_dir, rank,
                CheckpointState(
                    frame=next_inj, frm2=work.frm2, scatt_frame=next_inj,
                    time_now=time_now, restart="i",
                ),
            )

    return work


def elastic_work_items(par: McPar, base_dir: str, last_frame: int):
    """Scan every angle directory for unfinished old-rank checkpoints.

    The discovery half of the reference's elastic-restart collectives
    (getOrigNumProcesses probes a random chkpt file for the original rank
    count, then every old rank's file is scanned for unfinished work,
    Src/mcrat_io.c:10-112): here there is no original-rank-count riddle — the
    per-rank files are enumerated directly.  Returns a deterministic list of
    (angle_id, mc_dir, WorkItem) sorted by (angle, old rank) so every new rank
    computes the same assignment without any communication.
    """
    items = []
    nbins = par.n_theta_bins
    dtheta = (par.theta_max_deg - par.theta_min_deg) / nbins
    for angle_id in range(nbins):
        t_lo = par.theta_min_deg + angle_id * dtheta
        mc_dir = os.path.join(base_dir, f"{t_lo:g}-{t_lo + dtheta:g}")
        if not os.path.isdir(mc_dir):
            continue
        for wi in scan_checkpoints(mc_dir, last_frame):
            items.append((angle_id, mc_dir, wi))
    return items


def run_elastic(
    cfg: Config,
    par: McPar,
    paths: HydroPaths,
    rank: int = 0,
    num_ranks: int = 1,
    base_dir: Optional[str] = None,
    last_frame_override: Optional[int] = None,
    **run_kw,
) -> Sequence[WorkAssignment]:
    """Re-adopt unfinished old-rank work under a new (any-size) job.

    The reference re-colors a continuing job's MPI ranks so exactly the
    unfinished old ranks are adopted, and aborts when the new rank count
    cannot be mapped (Src/mcrat.c:166-448, abort :402-407).  Here the
    unfinished work list is distributed round-robin over the new job's ranks —
    a rank may adopt several old ranks (smaller job) or none (larger job), so
    no rank-count constraint exists.  Each adopted item resumes under its OLD
    rank id, keeping checkpoint/output file names consistent.
    """
    base_dir = base_dir or os.path.join(paths.filepath, paths.mc_path)
    last_frm = last_frame_override or par.last_frame
    items = elastic_work_items(par, base_dir, last_frm)
    adopted = items[rank::max(num_ranks, 1)]
    log.info(
        "elastic rank %d/%d: adopting %d of %d unfinished work items",
        rank, num_ranks, len(adopted), len(items),
    )
    par_c = dataclasses.replace(par, restart="c")
    dtheta = (par.theta_max_deg - par.theta_min_deg) / par.n_theta_bins
    done = []
    for angle_id, mc_dir, wi in adopted:
        t_lo = par.theta_min_deg + angle_id * dtheta
        work = WorkAssignment(
            angle_id=angle_id,
            theta_min=math.radians(t_lo),
            theta_max=math.radians(t_lo + dtheta),
            r_inj=par.inj_radius[angle_id],
            framestart=wi.state.frame,
            frm2=wi.state.frm2,
            mc_dir=mc_dir,
        )
        done.append(
            run_rank(
                cfg, par_c, paths, rank=wi.old_rank, num_ranks=num_ranks,
                base_dir=base_dir, last_frame_override=last_frame_override,
                work=work, **run_kw,
            )
        )
    return done


def default_synthetic_factory(cfg: Config, par: McPar, nr: int = 384, ntheta: int = 64):
    """Synthetic-grid factory for SYNTHETIC runs driven purely by mc.par.

    Builds one static 2-D spherical grid covering the mc.par domain (analytic
    outflows are time-independent; the per-frame prep re-applies the profile).
    """
    import math as _math

    from .models.analytic import synthetic_spherical_frame

    r_lo = max(par.r0_domain[0], min(par.inj_radius) / 20.0)
    r_hi = par.r0_domain[1]
    theta_hi = min(max(_math.radians(par.theta_max_deg) * 3.0, 0.3), _math.pi)
    host, edges = synthetic_spherical_frame(
        cfg, r_min=r_lo, r_max=r_hi, nr=nr, ntheta=ntheta, theta_max=theta_hi
    )

    def factory(frame):
        return host, edges

    return factory


def merge_rank_outputs(work: WorkAssignment, par: McPar, last_frame=None):
    """Merge per-process files into mcdata_<frame>.h5 for this angle dir
    (the in-run merge, reference: Src/mcrat.c:934-1023)."""
    frames = range(min(par.frm0), (last_frame or par.last_frame) + 1)
    return merge_all(work.mc_dir, frames)
