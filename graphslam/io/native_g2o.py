"""ctypes bridge to the native C++ g2o parser (native/g2o_parser.cc).

The shared library is built from the committed source at first use
(`make -C native`, into the gitignored native/libg2o_parser.so). Where it
cannot be built, `_lib` raises OSError saying why; `g2o.load_g2o` catches
that and re-routes to the pure-Python parser.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict

import numpy as np

_LIB = None
NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)


def build() -> str:
    """Build the library if it is missing or older than its source; returns
    its path. Raises OSError when make or the compiler is unavailable."""
    try:
        proc = subprocess.run(
            ["make", "-s", "-C", NATIVE_DIR], capture_output=True, text=True
        )
    except FileNotFoundError as e:
        raise OSError(f"native g2o parser not built: {e.filename} not found") from e
    if proc.returncode != 0:
        raise OSError(
            f"native g2o parser not built: make -C {NATIVE_DIR} failed:\n"
            + (proc.stderr or proc.stdout).strip()
        )
    return os.path.join(NATIVE_DIR, "libg2o_parser.so")


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        lib.g2o_parse.restype = ctypes.c_void_p
        lib.g2o_parse.argtypes = [ctypes.c_char_p]
        lib.g2o_free.argtypes = [ctypes.c_void_p]
        lib.g2o_sizes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        iptr = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        for fn in (lib.g2o_copy_se2, lib.g2o_copy_se3):
            fn.argtypes = [ctypes.c_void_p, iptr, dptr, iptr, dptr, dptr]
        _LIB = lib
    return _LIB


def parse(path: str) -> Dict[str, np.ndarray]:
    """Parse a g2o file natively; returns the same intermediate dict as
    g2o._python_parse (see io/g2o.py)."""
    lib = _lib()
    h = lib.g2o_parse(path.encode())
    if not h:
        raise IOError(f"native parser failed to open {path}")
    try:
        sizes = (ctypes.c_int64 * 4)()
        lib.g2o_sizes(h, sizes)
        n_v2, n_e2, n_v3, n_e3 = (int(s) for s in sizes)
        if n_v2 > 0:
            ids = np.empty(n_v2, np.int64)
            poses = np.empty((n_v2, 3), np.float64)
            edges = np.empty((n_e2, 2), np.int64)
            meas = np.empty((n_e2, 3), np.float64)
            info = np.empty((n_e2, 6), np.float64)
            lib.g2o_copy_se2(h, ids, poses, edges, meas, info)
            return {
                "dim": 2,
                "ids": ids,
                "poses_raw": poses,
                "edges": edges,
                "meas_raw": meas,
                "info_raw": info,
            }
        if n_v3 > 0:
            ids = np.empty(n_v3, np.int64)
            poses = np.empty((n_v3, 7), np.float64)
            edges = np.empty((n_e3, 2), np.int64)
            meas = np.empty((n_e3, 7), np.float64)
            info = np.empty((n_e3, 21), np.float64)
            lib.g2o_copy_se3(h, ids, poses, edges, meas, info)
            return {
                "dim": 3,
                "ids": ids,
                "poses_t": poses[:, :3],
                "poses_q": poses[:, 3:7],
                "edges": edges,
                "meas_t": meas[:, :3],
                "meas_q": meas[:, 3:7],
                "info_raw": info,
            }
        raise ValueError(f"no vertices found in {path}")
    finally:
        lib.g2o_free(h)
