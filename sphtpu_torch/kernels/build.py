"""Builds and loads the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by ``nvcc`` for sm_90a into a shared library with
a plain C interface and loaded with ctypes: no PyTorch header is included,
so a source builds in seconds. All sources are compiled at the first use of
any kernel, one ``nvcc`` process each, started together. The libraries go
to ``<repo>/build/sphtpu_torch_kernels`` (git-ignored), keyed by a hash of
the sources, so a later process reuses them.

The wrappers' argument helpers (`check_tensor`, `scalar_tensor`,
`pointer_array`, `device_limits`) and the plain versions'
`occupied_columns` live here too.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``. A build or load failure raises — there is no
fallback to the plain versions for tensors on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("phase_a_cells", "phase_b_tiles", "newton_sweep", "p3m_tail", "phase_b_grouped")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(CSRC)), "..", "build", "sphtpu_torch_kernels"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs = None
_lock = threading.Lock()
build_log = {}  # source name -> what nvcc printed (registers, shared memory)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of sphtpu_torch are built at "
        "first use and need the CUDA toolkit (PATH or CUDA_HOME)"
    )


def _source_tag() -> str:
    hasher = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            hasher.update(name.encode() + f.read())
    return hasher.hexdigest()[:16]


def _declare(libs) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    pp = ctypes.POINTER(ctypes.c_void_p)
    entries = (
        ("phase_a_cells", "sph_phase_a_cells", [pp, ci, ci, ci, ci, ci, ci, ci, ci, vp]),
        ("phase_a_cells", "sph_phase_a_tile", [pp, ci, ci, ci, ci, ci, ci, ci, vp]),
        ("phase_b_tiles", "sph_phase_b_tiles",
         [pp, pp, vp, pp, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]),
        ("newton_sweep", "sph_newton_sweep", [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]),
        ("newton_sweep", "sph_newton_rows_cols",
         [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]),
        ("p3m_tail", "sph_p3m_tail",
         [pp, vp, pp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]),
        ("phase_b_grouped", "sph_phase_b_grouped",
         [pp, vp, vp, vp, vp, pp, vp, vp, ci, ci, ci, ci, ci, vp]),
        ("phase_b_grouped", "sph_phase_b_blocks",
         [pp, pp, vp, pp, pp, vp, ci, ci, ci, ci, ci, vp]),
        ("phase_b_grouped", "sph_phase_b_blocks_units", [ci]),
    )
    for lib, entry, argtypes in entries:
        fnc = getattr(libs[lib], entry)
        fnc.argtypes = argtypes
        fnc.restype = ci
    for lib in libs.values():
        lib.sph_error_string.argtypes = [ci]
        lib.sph_error_string.restype = ctypes.c_char_p
        lib.sph_device_limits.argtypes = [ctypes.POINTER(ci)]
        lib.sph_device_limits.restype = ci


def load_kernels():
    """dict source name -> ctypes library, building what is missing."""
    global _libs
    with _lock:
        if _libs is not None:
            return _libs
        build_dir = os.path.abspath(BUILD_DIR)
        os.makedirs(build_dir, exist_ok=True)
        tag = _source_tag()
        paths = {s: os.path.join(build_dir, f"{s}_{tag}.so") for s in SOURCES}
        procs = {}
        for name, so in paths.items():
            if os.path.exists(so):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
            procs[name] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
                tmp,
            )
        failed = []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n{out}")
            else:
                os.replace(tmp, paths[name])
        if failed:
            raise RuntimeError("\n".join(failed))
        libs = {name: ctypes.CDLL(so) for name, so in paths.items()}
        _declare(libs)
        _libs = libs
        return _libs


_limits = {}


def device_limits(device) -> tuple[int, int]:
    """(streaming multiprocessors, shared memory a block may opt into in
    bytes) of a CUDA device, read once per device through the kernels'
    library."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _limits:
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(index):
            check("phase_a_cells", load_kernels()["phase_a_cells"].sph_device_limits(out))
        _limits[index] = (out[0], out[1])
    return _limits[index]


def check(lib_name: str, code: int) -> None:
    """Raise on a non-zero code returned by a kernel's entry point
    (ERR_BUDGET: F2's guard refused a kernel that does not fit one CTA)."""
    if code != 0:
        msg = load_kernels()[lib_name].sph_error_string(code)
        raise RuntimeError(
            f"CUDA launch of {lib_name} failed: {msg.decode() if msg else code}"
        )


def pointer_array(tensors):
    """ctypes array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def check_tensor(name, t, shape, dtype, device) -> None:
    """Raise unless t is a contiguous tensor of that shape, dtype, device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device or t.dtype != dtype:
        raise ValueError(
            f"{name}: expected {dtype} on {device}, got {t.dtype} on {t.device}"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def scalar_tensor(values, dtype, device):
    """Device tensor of scalars (python numbers or 0-d tensors) built
    without a host synchronisation."""
    return torch.stack(
        [torch.as_tensor(v, dtype=dtype, device=device).reshape(()) for v in values]
    )


def occupied_columns(mask_rows: torch.Tensor) -> torch.Tensor:
    """Indices of the columns of a (rows, width) mask chunk that hold at
    least one occupied slot (mask > 0), never empty: a chunk with none
    keeps column 0. The plain versions sweep only these, as the kernels
    sweep only compacted occupied slots; the others add nothing to any
    sum, count or max. Reads the mask on the host."""
    cols = torch.nonzero((mask_rows > 0).any(0)).flatten()
    return cols if cols.numel() else cols.new_zeros(1)
