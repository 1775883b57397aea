"""ctypes bindings for the native host-runtime library (native/mcrat_native.cpp).

Builds ``native/libmcrat_native.so`` on first use (``make -C native``) and
rebuilds it when it is older than its source.  Every entry point has a numpy
fallback, so a checkout without a C++ compiler stays fully functional.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)


def _build() -> None:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, text=True, timeout=120)
    except subprocess.CalledProcessError as e:
        log.warning("native build failed (numpy fallback in use): %s", e.stderr.strip())
    except (OSError, subprocess.TimeoutExpired) as e:
        log.warning("native build failed (numpy fallback in use): %s", e)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(_NATIVE_DIR, "libmcrat_native.so")
    src = os.path.join(_NATIVE_DIR, "mcrat_native.cpp")
    if os.path.exists(src) and (
        not os.path.exists(path) or os.path.getmtime(path) < os.path.getmtime(src)
    ):
        _build()
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        log.warning("native library unavailable (numpy fallback in use): %s", e)
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.build_binned_index.restype = ctypes.c_int
    lib.build_binned_index.argtypes = [dp, dp, dp, ctypes.c_int64, dp, dp, i64p, i32p, i32p, i32p]
    lib.read_dbl.restype = ctypes.c_int64
    lib.read_dbl.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, dp]
    lib.gather_rows.restype = None
    lib.gather_rows.argtypes = [dp, ctypes.c_int64, i64p, ctypes.c_int64, dp]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def build_binned_index(r0, r1, r2, lo, inv_bin, dims):
    """Counting-sort cells into uniform bins.

    Returns (cell_ids, bin_start, bin_count) as int32 arrays; falls back to
    numpy argsort when the native library is absent.
    """
    n = len(r0)
    nbins = int(dims[0] * dims[1] * dims[2])
    lib = _load()
    if lib is not None:
        r0 = np.ascontiguousarray(r0, dtype=np.float64)
        r1 = np.ascontiguousarray(r1, dtype=np.float64)
        r2 = np.ascontiguousarray(r2, dtype=np.float64)
        lo = np.ascontiguousarray(lo, dtype=np.float64)
        inv = np.ascontiguousarray(inv_bin, dtype=np.float64)
        dims_a = np.ascontiguousarray(dims, dtype=np.int64)
        cell_ids = np.empty(n, np.int32)
        bin_start = np.empty(nbins, np.int32)
        bin_count = np.empty(nbins, np.int32)
        rc = lib.build_binned_index(
            _dptr(r0), _dptr(r1), _dptr(r2), n, _dptr(lo), _dptr(inv),
            dims_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cell_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            bin_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            bin_count.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc == 0:
            return cell_ids, bin_start, bin_count
    # numpy fallback (same algorithm, vectorized)
    i = np.clip(((r0 - lo[0]) * inv_bin[0]).astype(np.int64), 0, dims[0] - 1)
    j = np.clip(((r1 - lo[1]) * inv_bin[1]).astype(np.int64), 0, dims[1] - 1)
    if dims[2] > 1:
        k = np.clip(((r2 - lo[2]) * inv_bin[2]).astype(np.int64), 0, dims[2] - 1)
    else:
        k = np.zeros(n, dtype=np.int64)
    flat = (k * dims[1] + j) * dims[0] + i
    order = np.argsort(flat, kind="stable").astype(np.int32)
    counts = np.bincount(flat, minlength=nbins).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    return order, starts, counts


def read_dbl(path: str, count: int, swap: bool = False) -> np.ndarray:
    """Bulk-read ``count`` float64 values from a raw binary file."""
    lib = _load()
    if lib is not None:
        out = np.empty(count, np.float64)
        got = lib.read_dbl(path.encode(), count, int(swap), _dptr(out))
        if got != count:
            raise IOError(f"read_dbl: expected {count} doubles, got {got} from {path}")
        return out
    data = np.fromfile(path, dtype=np.float64, count=count)
    if swap:
        data = data.byteswap()
    if len(data) != count:
        raise IOError(f"read_dbl: expected {count} doubles, got {len(data)} from {path}")
    return data


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Row gather src[idx] for 2-D float64 arrays."""
    lib = _load()
    if lib is not None and src.ndim == 2 and src.dtype == np.float64:
        src = np.ascontiguousarray(src)
        idx64 = np.ascontiguousarray(idx, dtype=np.int64)
        out = np.empty((len(idx64), src.shape[1]), np.float64)
        lib.gather_rows(
            _dptr(src), src.shape[1],
            idx64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx64), _dptr(out),
        )
        return out
    return src[idx]
