"""Checkpoint / resume / elastic restart.

JAX re-design of the reference checkpoint subsystem
(saveCheckpoint/readCheckpoint, Src/mcrat_io.c:838-1134, and the elastic
process-remapping collectives at Src/mcrat.c:166-448):

* per-rank checkpoint files ``mc_chkpt_<rank>.npz`` hold the photon SoA plus
  the loop counters (inj frame, frm2, scatt frame, time_now, weight_norm);
* crash safety is write-to-temp + atomic rename, plus the reference's _old
  backup copy of the previous checkpoint (Src/mcrat_io.c:857,969);
* elastic restart: ``scan_checkpoints`` inspects every old rank's file and
  returns exactly the unfinished work items, so a new job of any size can
  re-adopt them (replacing getOrigNumProcesses + the MPI re-coloring,
  Src/mcrat_io.c:10-112, Src/mcrat.c:166-448) — no rank-count match required,
  where the reference aborts on an impossible mapping (Src/mcrat.c:402-407).
"""
from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import List, Optional

import numpy as np

from ..config import Config, PhotonType
from ..transport import Photons, PhotonsMeta, empty_photons


@dataclasses.dataclass
class CheckpointState:
    """Loop counters saved with the photon population
    (reference: Src/mcrat_io.c:872-894)."""

    frame: int  # current injection frame
    frm2: int  # last injection frame for this rank
    scatt_frame: int  # current scattering frame
    time_now: float
    restart: str  # 'c' mid-run | 'i' injection-complete marker
    weight_norm: float = 1.0
    n_injected: int = 0


def checkpoint_path(mc_dir: str, rank: int) -> str:
    return os.path.join(mc_dir, f"mc_chkpt_{rank}.npz")


def save_checkpoint(
    mc_dir: str,
    rank: int,
    state: CheckpointState,
    photons: Optional[Photons] = None,
) -> None:
    """Write a checkpoint; keep the previous file as *_old first.

    Mirrors saveCheckpoint's three cases (reference: Src/mcrat_io.c:838-1009):
    mid-run (photons present, restart='c'), and the injection-complete marker
    (photons None, restart='i').  Scattered cyclo-synchrotron photons are
    relabeled UNABSORBED_CS on save (reference: :896-901).
    """
    path = checkpoint_path(mc_dir, rank)
    payload = dict(
        frame=state.frame,
        frm2=state.frm2,
        scatt_frame=state.scatt_frame,
        time_now=state.time_now,
        restart=state.restart,
        weight_norm=state.weight_norm,
        n_injected=state.n_injected,
    )
    if photons is not None:
        import jax

        # ONE batched device fetch (per-leaf np.asarray is a sequential
        # blocking transfer each — 8 round-trips per checkpoint), stored in
        # the run's native dtype (upcasting f32 state to f64 on disk doubles
        # the write for no information).  comv_p / s may arrive as EMPTY
        # (0, 4) placeholders when the run's config does not need them
        # persisted (driver._PersistWriter drops them from the device fetch:
        # the engine recomputes comoving momenta from the lab p every round,
        # transport.py step 2, so with COMV output off they are pure transfer
        # weight — the reference's COMV_SWITCH default is OFF too,
        # Src/mcrat.h:391-402).
        p, comv_p, pos, s, weight, num_scatt, cell, ptype = jax.device_get([
            photons.p, photons.comv_p, photons.pos, photons.s,
            photons.weight, photons.num_scatt, photons.cell, photons.ptype,
        ])
        ptype = np.array(ptype)
        # COMPTONIZED -> UNABSORBED_CS on save (reference: mcrat_io.c:896-901)
        ptype[ptype == int(PhotonType.COMPTONIZED)] = int(PhotonType.UNABSORBED_CS)
        payload.update(
            p=p, comv_p=comv_p, pos=pos, s=s, weight=weight,
            num_scatt=num_scatt, cell=cell, ptype=ptype,
        )
    tmp = path + ".tmp.npz"
    # uncompressed savez: photon state is high-entropy floats — zlib costs
    # ~2.5 s per 80 MB checkpoint and saves almost nothing
    np.savez(tmp, **payload)
    if os.path.exists(path):
        # previous checkpoint becomes the _old backup (reference cp's it,
        # Src/mcrat_io.c:857,969); rename is atomic and free vs an 80 MB copy
        os.replace(path, path + ".old")
    os.replace(tmp, path)


def load_checkpoint(mc_dir: str, rank: int, dtype="float64"):
    """Restore (state, photons|None).  Missing file -> None (fresh start,
    reference: readCheckpoint missing-file branch, Src/mcrat_io.c:1124-1133)."""
    import jax.numpy as jnp

    path = checkpoint_path(mc_dir, rank)
    if not os.path.exists(path):
        if os.path.exists(path + ".old"):
            path = path + ".old"
        else:
            return None
    with np.load(path, allow_pickle=False) as z:
        state = CheckpointState(
            frame=int(z["frame"]),
            frm2=int(z["frm2"]),
            scatt_frame=int(z["scatt_frame"]),
            time_now=float(z["time_now"]),
            restart=str(z["restart"]),
            weight_norm=float(z["weight_norm"]),
            n_injected=int(z["n_injected"]),
        )
        photons = None
        if "p" in z.files:
            n = len(z["weight"])
            comv_p = z["comv_p"]
            if comv_p.shape[0] != n:
                # dropped from the checkpoint (COMV off): the engine
                # recomputes comoving momenta from the lab p on the first
                # round after resume, and no COMV output is being written
                comv_p = np.zeros((n, 4), comv_p.dtype)
            s = z["s"]
            if s.shape[0] != n:
                # dropped (Stokes off): restore the unpolarized init
                s = np.zeros((n, 4), s.dtype)
                s[:, 0] = 1.0
            cell = z["cell"]
            if cell.shape[0] != n:
                # dropped (pure cache): the first containing-cell search
                # after resume re-resolves every lane
                cell = np.full(n, -1, np.int32)
            photons = Photons(
                p=jnp.asarray(z["p"], dtype=dtype),
                comv_p=jnp.asarray(comv_p, dtype=dtype),
                pos=jnp.asarray(z["pos"], dtype=dtype),
                s=jnp.asarray(s, dtype=dtype),
                weight=jnp.asarray(z["weight"], dtype=dtype),
                num_scatt=jnp.asarray(z["num_scatt"], dtype=dtype),
                cell=jnp.asarray(cell, dtype=jnp.int32),
                ptype=jnp.asarray(z["ptype"], dtype=jnp.int32),
            )
    return state, photons


@dataclasses.dataclass
class WorkItem:
    """One unfinished old-rank work unit discovered at restart."""

    old_rank: int
    state: CheckpointState


def scan_checkpoints(mc_dir: str, last_frame: int) -> List[WorkItem]:
    """Find all old ranks with unfinished work.

    Mirrors the unfinished-work predicate of getOrigNumProcesses (reference:
    Src/mcrat_io.c:80): a rank is unfinished iff its injection loop has frames
    left (frame <= frm2) or its scattering loop has frames left
    (scatt_frame <= last_frame).

    Ranks are discovered through BOTH mc_chkpt_<rank>.npz and its .old backup:
    save_checkpoint's atomic swap has a window where only the .old file exists
    (the previous primary was just renamed away), and a crash inside it must
    not make the rank invisible to an elastic restart — load_checkpoint
    already falls back to .old when the primary is missing.
    """
    items = []
    ranks = set()
    for path in glob.glob(os.path.join(mc_dir, "mc_chkpt_*.npz")) + glob.glob(
        os.path.join(mc_dir, "mc_chkpt_*.npz.old")
    ):
        m = re.search(r"mc_chkpt_(\d+)\.npz(\.old)?$", path)
        if m:
            ranks.add(int(m.group(1)))
    for rank in sorted(ranks):
        loaded = load_checkpoint(mc_dir, rank)
        if loaded is None:
            continue
        state, _ = loaded
        unfinished = (state.frame <= state.frm2) and (
            state.scatt_frame <= last_frame or state.restart == "i"
        )
        if state.restart == "c" and state.scatt_frame <= last_frame:
            unfinished = True
        if unfinished:
            items.append(WorkItem(old_rank=rank, state=state))
    return items
