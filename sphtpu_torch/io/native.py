"""ctypes loader for the native CSV hot loops (fastcsv.c).

Compiles the shared object on demand (cc -O2 -shared -fPIC, cached under
the repository's git-ignored build/ directory, keyed by source hash) and exposes numpy-friendly wrappers.
Returns None from load_native() when no toolchain is available — callers
keep the pure-pandas fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "fastcsv.c")
_lib = None
_tried = False


def load_native():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
        tag = hashlib.sha256(src).hexdigest()[:16]
        cache = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(_SRC))),
            "build", "sphtpu_torch_native",
        )
        os.makedirs(cache, exist_ok=True)
        so_path = os.path.join(cache, f"fastcsv_{tag}.so")
        if not os.path.exists(so_path):
            for cc in ("cc", "gcc", "clang"):
                try:
                    subprocess.run(
                        [cc, "-O2", "-shared", "-fPIC", "-o", so_path, _SRC],
                        check=True,
                        capture_output=True,
                    )
                    break
                except (OSError, subprocess.CalledProcessError):
                    continue
            else:
                return None
        lib = ctypes.CDLL(so_path)
        lib.sph_format_particles.restype = ctypes.c_long
        lib.sph_format_particles.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.c_long,
        ]
        lib.sph_parse_particles.restype = ctypes.c_long
        lib.sph_parse_particles.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def format_particles(data: np.ndarray) -> bytes | None:
    """data: (n, 6|7) float64 C-contiguous -> CSV body bytes, or None."""
    lib = load_native()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.float64)
    n, ncols = data.shape
    cap = int(n) * 512 + 1024
    buf = ctypes.create_string_buffer(cap)
    written = lib.sph_format_particles(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        ncols,
        buf,
        cap,
    )
    if written < 0:
        return None
    return buf.raw[:written]


def parse_particles(body: bytes, n_rows: int, ncols: int):
    """body: CSV bytes starting at the first particle row -> (n_rows,
    ncols) float64 (empty K cells -> NaN), or None."""
    lib = load_native()
    if lib is None:
        return None
    out = np.empty((n_rows, ncols), dtype=np.float64)
    got = lib.sph_parse_particles(
        body,
        len(body),
        ncols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_rows,
    )
    if got != n_rows:
        return None
    return out
