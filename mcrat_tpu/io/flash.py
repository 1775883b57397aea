"""FLASH 2-D AMR HDF5 frame reader.

JAX re-design of readAndDecimate (reference: Src/mclib_flash.c:60-431):
reads the block datasets, keeps leaf nodes (node type == 1), expands each
block into 8x8 cells with the fixed sub-cell offsets, applies unit scales,
derives (gamma, lab density, temperature), and decimates to the live photon
band — all as vectorized numpy instead of per-cell C loops.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..constants import A_RAD
from ..grid import HydroFrameHost, frame_from_numpy
from .decimate import decimation_mask

# sub-cell center offsets within a block, units of block size
# (reference: Src/mclib_flash.c:69)
X1 = np.array([-7.0, -5.0, -3.0, -1.0, 1.0, 3.0, 5.0, 7.0]) / 16.0
NB = 8  # cells per block side


def flash_frame_name(filepath: str, fileroot: str, frame: int) -> str:
    """FLASH file naming: FILEPATH + FILEROOT + zero-padded 4-digit frame
    (reference: modifyFlashName, Src/mclib_flash.c:15-58)."""
    return f"{filepath}{fileroot}{frame:04d}"


def read_flash(
    cfg: Config,
    path: str,
    fps: float,
    r_inj: float,
    ph_inj_switch: bool,
    min_r: float = 0.0,
    max_r: float = np.inf,
    min_theta: float = 0.0,
    max_theta: float = np.pi,
) -> HydroFrameHost:
    import h5py

    with h5py.File(path, "r") as f:
        coords = np.asarray(f["coordinates"], dtype=np.float64)
        block_sz = np.asarray(f["block size"], dtype=np.float64)
        node_type = np.asarray(f["node type"], dtype=np.int64).reshape(len(coords), -1)[:, 0]
        velx = np.asarray(f["velx"], dtype=np.float64).reshape(len(coords), -1)
        vely = np.asarray(f["vely"], dtype=np.float64).reshape(len(coords), -1)
        dens = np.asarray(f["dens"], dtype=np.float64).reshape(len(coords), -1)
        pres = np.asarray(f["pres"], dtype=np.float64).reshape(len(coords), -1)

    leaf = node_type == 1
    coords = coords[leaf]
    block_sz = block_sz[leaf]
    velx, vely = velx[leaf], vely[leaf]
    dens, pres = dens[leaf], pres[leaf]
    nblk = len(coords)

    # expand each block into NB x NB cells; the flat per-block cell ordering is
    # j-major rows of x offsets (reference: mclib_flash.c:246-266: x index
    # cycles every 8, y index increments each row)
    ox, oy = np.meshgrid(X1, X1, indexing="ij")  # (8, 8): ox varies fastest? see below
    # reference: j % 8 indexes x1[x1_count] (fast), y1_count increments per row
    off_x = np.tile(X1, NB)  # (64,) x offset, cycles fast
    off_y = np.repeat(X1, NB)  # (64,) y offset, increments per row

    cx = (coords[:, 0:1] + block_sz[:, 0:1] * off_x[None, :]) * cfg.hydro_l_scale
    cy = (coords[:, 1:2] + block_sz[:, 1:2] * off_y[None, :]) * cfg.hydro_l_scale
    szx = np.broadcast_to(block_sz[:, 0:1] / NB * cfg.hydro_l_scale, cx.shape)
    szy = np.broadcast_to(block_sz[:, 1:2] / NB * cfg.hydro_l_scale, cy.shape)

    arr = dict(
        r0=cx.ravel(),
        r1=cy.ravel(),
        dr0=szx.ravel(),
        dr1=szy.ravel(),
        v0=velx.ravel(),
        v1=vely.ravel(),
        dens=dens.ravel() * cfg.hydro_d_scale,
        pres=pres.ravel() * cfg.hydro_p_scale,
    )
    keep = decimation_mask(
        cfg,
        arr["r0"], arr["r1"], 0.0, arr["dr0"], arr["dr1"], 0.0,
        fps, r_inj, ph_inj_switch, min_r, max_r, min_theta, max_theta,
        cyclosynchrotron=cfg.cyclosynchrotron,
    )
    arr = {k: v[keep] for k, v in arr.items()}
    return frame_from_numpy(cfg, arr)
