"""The float64 weighted LM pose refiner in C++ (`lm_solver.cpp`).

Counterpart of `sgtapose_tpu/native/`: `lm_solver.cpp` is a byte copy of
that package's source (same C ABI and objective as the reference's
libtestso_final.so, `LM(value_init[7], x2d[N*2], x3d[N*3],
weights[(N+1)*2], camera[9], ans[7], N)`), compiled here at first use with
`g++ -O2 -shared -fPIC` into `build/liblm_solver.so` beside the source (a
directory `.gitignore` lists, and no package, so walking the package's
modules does not take the library for one) and loaded with ctypes. A source newer than the library
rebuilds it. A failed build or load raises; nothing falls back.

It is the host-side float64 reference of the on-card refiner
(`core/pnp.register_gn`), not on any path that runs on the card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "lm_solver.cpp")
_SO = os.path.join(_HERE, "build", "liblm_solver.so")

# the fixed Jacobian scratch bound in lm_solver.cpp (kMaxN)
MAX_N = 512

_lib: Optional[ctypes.CDLL] = None


def build(force: bool = False) -> str:
    """Compile the solver if it is missing or older than its source (or
    `force`); returns the library's path. The library is written under a
    temporary name and renamed, so concurrent builds never load a partial
    file."""
    if force or not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_SO))
        os.close(fd)
        try:
            subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC], check=True, capture_output=True)
            os.replace(tmp, _SO)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return _SO


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        dp = ctypes.POINTER(ctypes.c_double)
        lib.LM.argtypes = [dp, dp, dp, dp, dp, dp, ctypes.c_int]
        lib.LM.restype = None
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def lm_refine(x2d, x3d, quat_init, trans_init, weights, camera_K) -> Tuple[np.ndarray, np.ndarray]:
    """Float64 weighted Gauss-Newton refinement (the reference's
    register_GN_C). x2d (N, 2), x3d (N, 3), quat_init (4,) wxyz, trans_init
    (3,), weights (N, 2), camera_K (3, 3), numpy arrays or CPU tensors.
    Returns (quat (4,), trans (3,)) float64. N <= MAX_N."""
    lib = _load()
    x2d = np.asarray(x2d, np.float64)
    n = int(x2d.shape[0])
    if n > MAX_N:
        raise ValueError(f"lm_refine supports at most {MAX_N} correspondences, got {n}; solve larger stacks "
                         "with core/pnp.register_gn")
    value = np.ascontiguousarray(np.concatenate([np.asarray(quat_init, np.float64).ravel(),
                                                 np.asarray(trans_init, np.float64).ravel()]))
    x2d_c = np.ascontiguousarray(x2d)
    x3d_c = np.ascontiguousarray(np.asarray(x3d, np.float64))
    # the trailing constraint-weight pair of the reference's layout
    w_c = np.ascontiguousarray(np.concatenate([np.asarray(weights, np.float64).reshape(n, 2),
                                               np.full((1, 2), 1e8)]))
    cam_c = np.ascontiguousarray(np.asarray(camera_K, np.float64))
    ans = np.zeros(7, np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.LM(*(a.ctypes.data_as(dp) for a in (value, x2d_c, x3d_c, w_c, cam_c, ans)), n)
    return ans[:4], ans[4:]
