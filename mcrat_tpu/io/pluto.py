"""PLUTO .dbl frame reader (grid.out + dbl.out + data.XXXX.dbl).

JAX re-design of readPluto (reference: Src/mclib_pluto.c:1058-1459):
parses grid.out cell edges into centers/widths (readGridFile, :852-988), the
dbl.out variable name order (readDblOutFile, :990-1056), memory-maps the raw
double binary keyed by rho/vx1/vx2/vx3/prs/bx1/bx2/bx3, applies per-geometry
unit scales, and decimates — vectorized numpy throughout.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import numpy as np

from ..config import Config, Dims, Geometry
from ..grid import HydroFrameHost, frame_from_numpy
from .decimate import decimation_mask


def pluto_frame_name(fileroot: str, frame: int, suffix: str = ".dbl") -> str:
    """PLUTO file naming: prefix + zero-padded 4-digit frame + suffix
    (reference: modifyPlutoName, Src/mclib_pluto.c:803-850)."""
    return f"{fileroot}{frame:04d}{suffix}"


def read_grid_file(path: str, three_d: bool) -> Tuple[np.ndarray, ...]:
    """Parse grid.out cell edges -> (centers, widths) per axis.

    Mirrors readGridFile (reference: Src/mclib_pluto.c:852-988): header lines,
    per-axis point counts, then "<idx> <lo> <hi>" rows.  Implemented robustly:
    axis blocks are located by their single-integer count lines.
    """
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    # skip comment header (lines starting with '#')
    body = [ln for ln in lines if ln and not ln.startswith("#")]
    axes = []
    i = 0
    while i < len(body) and len(axes) < (3 if three_d else 3):
        toks = body[i].split()
        if len(toks) == 1 and toks[0].isdigit():
            n = int(toks[0])
            rows = body[i + 1 : i + 1 + n]
            vals = np.array([[float(x) for x in r.split()[:3]] for r in rows])
            lo, hi = vals[:, 1], vals[:, 2]
            axes.append((0.5 * (lo + hi), hi - lo))
            i += 1 + n
        else:
            i += 1
    while len(axes) < 3:
        axes.append((np.array([0.0]), np.array([1.0])))
    (x1, dx1), (x2, dx2), (x3, dx3) = axes[:3]
    return x1, dx1, x2, dx2, x3, dx3


def read_dbl_out(path: str) -> List[str]:
    """Variable-name order from dbl.out's first line
    (reference: readDblOutFile, Src/mclib_pluto.c:990-1056)."""
    with open(path) as f:
        first = f.readline().split()
    # layout: nout t dt nstep file_type endianness var1 var2 ...
    return first[6:]


def read_pluto(
    cfg: Config,
    data_path: str,
    fps: float,
    r_inj: float,
    ph_inj_switch: bool,
    min_r: float = 0.0,
    max_r: float = np.inf,
    min_theta: float = 0.0,
    max_theta: float = np.pi,
    grid_path: str = None,
    dblout_path: str = None,
) -> HydroFrameHost:
    base = os.path.dirname(data_path)
    grid_path = grid_path or os.path.join(base, "grid.out")
    dblout_path = dblout_path or os.path.join(base, "dbl.out")
    three_d = cfg.dims is Dims.THREE

    x1, dx1, x2, dx2, x3, dx3 = read_grid_file(grid_path, three_d)
    var_names = read_dbl_out(dblout_path)
    n1, n2, n3 = len(x1), len(x2), (len(x3) if three_d else 1)
    grid_size = n1 * n2 * n3

    if data_path.endswith(".h5") or cfg.pluto_filetype.value.endswith("h5"):
        import h5py

        with h5py.File(data_path, "r") as f:
            # PLUTO .dbl.h5 layout: /Timestep_N/vars/<name>
            ts = [k for k in f.keys() if k.startswith("Timestep")]
            grp = f[ts[0]]["vars"]
            data = {k: np.asarray(grp[k], dtype=np.float64).ravel() for k in grp.keys()}
    else:
        from .. import native

        raw = native.read_dbl(data_path, len(var_names) * grid_size)
        data = {
            name: raw[i * grid_size : (i + 1) * grid_size]
            for i, name in enumerate(var_names)
        }

    # data layout: x1 fastest, then x2, then x3 (reference: mclib_pluto.c:1163-1172)
    # -> index (j3, j2, j1) C-order; build matching coordinate arrays
    X1 = np.tile(x1, n2 * n3)
    DX1 = np.tile(dx1, n2 * n3)
    X2 = np.tile(np.repeat(x2, n1), n3)
    DX2 = np.tile(np.repeat(dx2, n1), n3)
    X3 = np.repeat(x3, n1 * n2) if three_d else np.zeros(grid_size)
    DX3 = np.repeat(dx3, n1 * n2) if three_d else np.zeros(grid_size)

    l = cfg.hydro_l_scale
    X1, DX1 = X1 * l, DX1 * l
    # x2 is a length only for cartesian/cylindrical (reference: :1193-1199)
    if cfg.geometry in (Geometry.CARTESIAN, Geometry.CYLINDRICAL):
        X2, DX2 = X2 * l, DX2 * l
    if three_d and cfg.geometry in (Geometry.CARTESIAN, Geometry.POLAR):
        X3, DX3 = X3 * l, DX3 * l

    zero = np.zeros(grid_size)
    arr = dict(
        r0=X1,
        r1=X2,
        r2=X3,
        dr0=DX1,
        dr1=DX2,
        dr2=DX3,
        v0=data.get("vx1", zero),
        v1=data.get("vx2", zero),
        v2=data.get("vx3", zero) if cfg.dims is not Dims.TWO else zero,
        dens=data["rho"] * cfg.hydro_d_scale,
        pres=data["prs"] * cfg.hydro_p_scale,
    )
    if cfg.b_field_calc.value == "simulation":
        b_scale = cfg.hydro_b_scale
        for out, keys in (("B0", ("bx1", "Bx1")), ("B1", ("bx2", "Bx2")), ("B2", ("bx3", "Bx3"))):
            for k in keys:
                if k in data:
                    arr[out] = data[k] * b_scale
                    break

    keep = decimation_mask(
        cfg,
        arr["r0"], arr["r1"], arr["r2"], arr["dr0"], arr["dr1"], arr["dr2"],
        fps, r_inj, ph_inj_switch, min_r, max_r, min_theta, max_theta,
        cyclosynchrotron=cfg.cyclosynchrotron,
    )
    arr = {k: v[keep] for k, v in arr.items()}
    return frame_from_numpy(cfg, arr)
