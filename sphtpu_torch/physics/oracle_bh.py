"""ctypes loader for the reference-faithful Barnes-Hut oracle (oracle_bh.c).

Port of sphtpu/physics/oracle_bh.py with its C source beside it. Used by
tests to measure the reference's own force error (theta = 0.576 monopole
walk, gravOctree_Single.jl:239-278) against the exact softened direct sum:
the bar the P3M far field must match or beat. Not part of any production
path. The shared object is compiled at first use (cc -O2 -shared -fPIC)
into the repository's git-ignored build/ directory, keyed by source hash,
as io/native.py compiles fastcsv.c.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "oracle_bh.c")
_lib = None
_tried = False


def _load():
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
        so_path = os.path.join(cache, f"oracle_bh_{tag}.so")
        if not os.path.exists(so_path):
            for cc in ("cc", "gcc", "clang"):
                try:
                    subprocess.run(
                        [cc, "-O2", "-shared", "-fPIC", "-o", so_path, _SRC,
                         "-lm"],
                        check=True,
                        capture_output=True,
                    )
                    break
                except (OSError, subprocess.CalledProcessError):
                    continue
            else:
                return None
        lib = ctypes.CDLL(so_path)
        pd = ctypes.POINTER(ctypes.c_double)
        lib.bh_gravity.restype = None
        lib.bh_gravity.argtypes = [
            pd, pd, ctypes.c_double, ctypes.c_long, ctypes.c_double,
            ctypes.c_double, pd, pd,
        ]
        lib.exact_gravity.restype = None
        lib.exact_gravity.argtypes = [
            pd, pd, ctypes.c_double, ctypes.c_long, pd, pd,
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def _prep(pos, h):
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    h = np.ascontiguousarray(h, dtype=np.float64)
    n = pos.shape[0]
    g = np.empty((n, 3), dtype=np.float64)
    phi = np.empty(n, dtype=np.float64)
    pd = ctypes.POINTER(ctypes.c_double)
    return pos, h, n, g, phi, pd


def bh_gravity(pos, h, m: float, theta: float = 0.576, l_domain=None):
    """(g, phi) from the reference's octree walk, f64. Returns None when no
    C toolchain is available. l_domain defaults to max|pos| (the reference
    passes maximum(abs.(pos)), polytrope_sim.jl:34)."""
    lib = _load()
    if lib is None:
        return None
    pos, h, n, g, phi, pd = _prep(pos, h)
    if l_domain is None:
        l_domain = float(np.abs(pos).max())
    lib.bh_gravity(
        pos.ctypes.data_as(pd), h.ctypes.data_as(pd), float(m), n,
        float(l_domain), float(theta),
        g.ctypes.data_as(pd), phi.ctypes.data_as(pd),
    )
    return g, phi


def exact_gravity(pos, h, m: float):
    """(g, phi) exact softened direct sum, f64 (the theta -> 0 ground
    truth). Returns None when no C toolchain is available."""
    lib = _load()
    if lib is None:
        return None
    pos, h, n, g, phi, pd = _prep(pos, h)
    lib.exact_gravity(
        pos.ctypes.data_as(pd), h.ctypes.data_as(pd), float(m), n,
        g.ctypes.data_as(pd), phi.ctypes.data_as(pd),
    )
    return g, phi
