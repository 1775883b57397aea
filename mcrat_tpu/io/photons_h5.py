"""Photon HDF5 output with the ProcessMCRaT-compatible schema.

JAX re-design of printPhotons / dirFileMerge / the MERGE tool
(reference: Src/mcrat_io.c:114-836, 1239-1772; Src/merge.c): per-process files
``mc_proc_<rank>.h5`` hold one group per scattering frame with 1-D datasets

    P0 P1 P2 P3 [COMV_P0..3] R0 R1 R2 [S0..S3] NS PW [PT]

(dataset list documented at Doc/mcrat_doc.tex:362-384).  Four-momenta are
written in cgs E/c units (the photon arrays in this framework are dimensionless
m_e c units), so downstream ProcessMCRaT tooling reads the files unchanged.

The merge step concatenates all ranks' per-frame groups into
``mcdata_<frame>.h5`` with the reference's corruption check (every dataset
length must divide evenly by the expected total, Src/mcrat_io.c:1450).
"""
from __future__ import annotations

import glob
import os
import re
from typing import Iterable, Optional

import numpy as np

from ..config import Config, PHOTON_TYPE_CHARS, PhotonType
from ..constants import ME_C
from ..transport import Photons, PhotonsMeta

DSETS_ALWAYS = ["P0", "P1", "P2", "P3", "R0", "R1", "R2", "NS", "PW"]


def _chunks(n):
    return (min(max(n, 1), 1 << 16),)


_TYPE_CHAR_LUT = None


def _type_char_lut():
    """(max_type+1,) S1 lookup table — a vectorized PHOTON_TYPE_CHARS map
    (a per-element ``PhotonType(t)`` loop costs ~0.5 s per million photons)."""
    global _TYPE_CHAR_LUT
    if _TYPE_CHAR_LUT is None:
        lut = np.full(max(int(t) for t in PhotonType) + 1, b"?", dtype="S1")
        for t, ch in PHOTON_TYPE_CHARS.items():
            lut[int(t)] = ch.encode()
        _TYPE_CHAR_LUT = lut
    return _TYPE_CHAR_LUT


def append_photons(
    cfg: Config,
    path: str,
    frame: int,
    photons: Photons,
    meta: PhotonsMeta,
    exclude_types: Iterable[int] = (PhotonType.CS_POOL,),
) -> int:
    """Append the live population to the frame group of a per-process file.

    Equivalent of printPhotons (reference: Src/mcrat_io.c:114-836): creates the
    group + chunked-unlimited datasets on first write; extends and appends when
    the group exists (multiple injection batches share frame groups).  Null and
    pool photons are skipped (the reference writes pool photons only via their
    own bookkeeping).  Returns the number of photons written.
    """
    import h5py
    import jax

    # ONE batched device fetch for every leaf the schema needs (sequential
    # per-leaf np.asarray transfers dominated the per-frame dump wall time)
    fetch = [photons.weight, photons.ptype, photons.p, photons.pos,
             photons.num_scatt]
    if cfg.comv:
        fetch.append(photons.comv_p)
    if cfg.stokes:
        fetch.append(photons.s)
    got = jax.device_get(fetch)
    weight, ptype, p_raw, pos_raw, ns_raw = got[:5]
    got = got[5:]

    w = weight.astype(np.float64) * meta.weight_norm
    keep = (w > 0) & (ptype != int(PhotonType.NULL))
    for t in exclude_types:
        keep &= ptype != int(t)
    if not keep.any():
        return 0

    p = p_raw[keep].astype(np.float64) * ME_C
    pos = pos_raw[keep].astype(np.float64)
    ns = ns_raw[keep].astype(np.float64)
    data = {
        "P0": p[:, 0], "P1": p[:, 1], "P2": p[:, 2], "P3": p[:, 3],
        "R0": pos[:, 0], "R1": pos[:, 1], "R2": pos[:, 2],
        "NS": ns, "PW": w[keep],
    }
    if cfg.comv:
        comv = got[0][keep].astype(np.float64) * ME_C
        got = got[1:]
        data.update(
            COMV_P0=comv[:, 0], COMV_P1=comv[:, 1],
            COMV_P2=comv[:, 2], COMV_P3=comv[:, 3],
        )
    if cfg.stokes:
        s = got[0][keep].astype(np.float64)
        data.update(S0=s[:, 0], S1=s[:, 1], S2=s[:, 2], S3=s[:, 3])
    if cfg.save_type:
        data["PT"] = _type_char_lut()[ptype[keep]]

    n = len(data["P0"])
    with h5py.File(path, "a") as f:
        gname = str(frame)
        grp = f.require_group(gname)
        for k, v in data.items():
            if k in grp:
                ds = grp[k]
                old = ds.shape[0]
                ds.resize((old + n,))
                ds[old:] = v
            else:
                grp.create_dataset(
                    k, data=v, maxshape=(None,), chunks=_chunks(n)
                )
    return n


def merge_frame(
    out_dir: str,
    frame: int,
    proc_files: Optional[list] = None,
    out_path: Optional[str] = None,
) -> int:
    """Concatenate all ranks' groups for ``frame`` into mcdata_<frame>.h5.

    Equivalent of dirFileMerge for one frame (reference:
    Src/mcrat_io.c:1239-1772): idempotent/resumable — an existing output whose
    dataset lengths do not match the expected total is rebuilt from scratch
    (the reference's corruption check at :1450).  Returns photon count.
    """
    import h5py

    proc_files = proc_files or sorted(glob.glob(os.path.join(out_dir, "mc_proc_*.h5")))
    out_path = out_path or os.path.join(out_dir, f"mcdata_{frame}.h5")
    gname = str(frame)

    arrays = {}
    total = 0
    for pf in proc_files:
        with h5py.File(pf, "r") as f:
            if gname not in f:
                continue
            grp = f[gname]
            for k in grp.keys():
                arrays.setdefault(k, []).append(np.asarray(grp[k]))
    if not arrays:
        return 0
    cat = {k: np.concatenate(v) for k, v in arrays.items()}
    total = len(next(iter(cat.values())))

    if os.path.exists(out_path):
        try:
            with h5py.File(out_path, "r") as f:
                ok = all(
                    k in f and f[k].shape[0] == total for k in cat.keys()
                )
            if ok:
                return total  # already merged and consistent
        except Exception:
            pass
    tmp = out_path + ".tmp"
    with h5py.File(tmp, "w") as f:
        for k, v in cat.items():
            f.create_dataset(k, data=v)
    os.replace(tmp, out_path)
    return total


def merge_all(out_dir: str, frames: Iterable[int]) -> dict:
    """Merge a list of frames (the MERGE tool's per-group work,
    reference: Src/merge.c:268-340)."""
    return {fr: merge_frame(out_dir, fr) for fr in frames}


ALL_DATA_DIR = "ALL_DATA"


def discover_angle_dirs(base_dir: str) -> list:
    """Angle directories under an MC base dir, skipping ALL_DATA.

    Mirrors the MERGE tool's directory scan (reference: Src/merge.c:80-161):
    every subdirectory except ALL_DATA that contains at least one
    mc_proc_*.h5 file counts as an angle bin's output directory.
    """
    dirs = []
    for name in sorted(os.listdir(base_dir)):
        path = os.path.join(base_dir, name)
        if not os.path.isdir(path) or name == ALL_DATA_DIR:
            continue
        if glob.glob(os.path.join(path, "mc_proc_*.h5")):
            dirs.append(path)
    return dirs


def discover_frames(proc_files: Iterable[str]) -> list:
    """Sorted union of frame-group numbers across per-process files."""
    import h5py

    found = set()
    for path in proc_files:
        with h5py.File(path, "r") as f:
            found |= {int(k) for k in f.keys()}
    return sorted(found)


def merge_across_angles(
    base_dir: str, frames: Optional[Iterable[int]] = None
) -> dict:
    """Cross-angle merge: combine EVERY angle directory's per-process files
    into ``ALL_DATA/mcdata_<frame>.h5``.

    The standalone MERGE binary's job (reference: Src/merge.c:23-336): walk the
    angle dirs (skipping ALL_DATA, :80-161), sum photon counts across all dirs
    per frame (:275-317), and write combined files under ALL_DATA (collective
    create at :331-336).  MPI rank groups + parallel HDF5 are replaced by a
    serial concat per frame — the data volume is per-frame photon lists, not
    hydro grids, so the collective machinery buys nothing here.  Resume-safe
    through merge_frame's corruption check.  Returns {frame: photon_count}.
    """
    angle_dirs = discover_angle_dirs(base_dir)
    if not angle_dirs:
        raise FileNotFoundError(f"no angle directories with mc_proc_*.h5 under {base_dir}")
    proc_files = []
    for adir in angle_dirs:
        proc_files.extend(sorted(glob.glob(os.path.join(adir, "mc_proc_*.h5"))))
    if frames is None:
        frames = discover_frames(proc_files)
    out_dir = os.path.join(base_dir, ALL_DATA_DIR)
    os.makedirs(out_dir, exist_ok=True)
    return {
        fr: merge_frame(
            base_dir, fr, proc_files=proc_files,
            out_path=os.path.join(out_dir, f"mcdata_{fr}.h5"),
        )
        for fr in frames
    }


def read_frame(path: str) -> dict:
    """Load a merged mcdata_<frame>.h5 into a dict of numpy arrays."""
    import h5py

    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f.keys()}
