"""Reference-compatible CSV snapshot codec.

File grammar (reference: fastv1_kd&single_oc/SnapshotRW.jl:22-159):

    header: type,x,y,z,vx,vy,vz,K,rlin,rho_radial,constants
    N rows  type="particle" with x..vz (and K for polytropic runs)
    0/1 row type="rlin"        rlin column  = ";"-joined float vector
    0/1 row type="rho_radial"  rho_radial   = ";"-joined float vector
    0/1 row type="constants"   constants    = "k=v;k=v;..." row

Missing cells are empty strings. Constants values are sniffed back as Int
unless they contain ``[eE.]`` (SnapshotRW.jl:147) — the writer therefore
keeps integers dot-free and floats with a '.' or exponent so both this codec
and the Julia reader agree on types. Paths follow the reference scheme
``<root>/snapshots/<ic_type>/bin/<ID>snap.csv`` (SnapshotRW.jl:99); unlike
the reference (README.md:41-53 asks the user to pre-create folders) the
directories are created on demand.

Everything here is host-side float64 CGS, matching the on-disk contract of
the reference.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np

_FLOAT_RE = re.compile(r"[eE.]")

COLUMNS = (
    "type",
    "x",
    "y",
    "z",
    "vx",
    "vy",
    "vz",
    "K",
    "rlin",
    "rho_radial",
    "constants",
)


def _fmt_num(v) -> str:
    """Format a number the way Julia's string() does, close enough to
    round-trip through both this codec and Julia's CSV.read.

    Integers print without a decimal point (so the reference's int-vs-float
    sniffing keeps them Int); floats keep a '.' or exponent. Exponents drop
    the '+' and leading zeros ("1.5e+16" -> "1.5e16") like Julia.
    """
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    x = float(v)
    if x != x:
        return "NaN"
    if x in (float("inf"), float("-inf")):
        return "Inf" if x > 0 else "-Inf"
    # repr already matches Julia string() for integral floats ("5.0",
    # "100000.0") and non-integral values alike; only the exponent form
    # below needs adjusting.
    r = repr(x)
    if "e" in r:
        mant, exp = r.split("e")
        if "." not in mant:
            mant += ".0"
        return f"{mant}e{int(exp)}"
    return r


def snapshot_path(root: str, ic_type: str, snap_id: str) -> str:
    return os.path.join(root, "snapshots", ic_type, "bin", f"{snap_id}snap.csv")


def write_snapshot(
    snap_id: str,
    ic_type: str,
    pos: np.ndarray,
    vel: np.ndarray,
    *,
    K: Optional[np.ndarray] = None,
    constants: Optional[Dict] = None,
    rlin: Optional[np.ndarray] = None,
    rho_radial: Optional[np.ndarray] = None,
    root: str = ".",
) -> str:
    """Write a snapshot CSV; returns the path written.

    Mirrors SnapshotRW.write_snapshot (SnapshotRW.jl:22-109). PNG figure
    saving lives in sphtpu_torch.viz instead of here.
    """
    pos = np.asarray(pos, dtype=np.float64)
    vel = np.asarray(vel, dtype=np.float64)
    n = pos.shape[0]
    path = snapshot_path(root, ic_type, str(snap_id))
    os.makedirs(os.path.dirname(path), exist_ok=True)

    kcol = None
    if K is not None:
        kcol = np.asarray(K, dtype=np.float64)
        if kcol.shape != (n,):
            raise ValueError(f"K must have shape ({n},), got {kcol.shape}")

    # Bulk particle rows go through the native codec (fastcsv.c via
    # ctypes): snprintf("%.17g") per value gives exact float64 round-trip
    # and avoids Python/pandas per-value formatting. Fallback:
    # pandas' C writer with the same format string. The constants row below
    # keeps Julia-style formatting that the Int-vs-Float sniffing needs.
    from .native import format_particles

    block = np.hstack([pos, vel] + ([kcol[:, None]] if kcol is not None else []))
    body_bytes = format_particles(block)
    if body_bytes is not None:
        body = body_bytes.decode("ascii")
    else:
        import pandas as pd

        df = pd.DataFrame(
            {
                "type": np.full(n, "particle"),
                "x": pos[:, 0],
                "y": pos[:, 1],
                "z": pos[:, 2],
                "vx": vel[:, 0],
                "vy": vel[:, 1],
                "vz": vel[:, 2],
                "K": kcol if kcol is not None else np.full(n, "", dtype=object),
                "rlin": np.full(n, ""),
                "rho_radial": np.full(n, ""),
                "constants": np.full(n, ""),
            }
        )
        body = df.to_csv(index=False, header=False, float_format="%.17g")
    lines = [",".join(COLUMNS), body.rstrip("\n")]

    if rlin is not None and len(rlin) > 0:
        ser = ";".join(_fmt_num(v) for v in np.asarray(rlin, dtype=np.float64))
        lines.append(f"rlin,,,,,,,,{ser},,")
    if rho_radial is not None and len(rho_radial) > 0:
        ser = ";".join(_fmt_num(v) for v in np.asarray(rho_radial, dtype=np.float64))
        lines.append(f"rho_radial,,,,,,,,,{ser},")
    if constants:
        ser = ";".join(f"{k}={_fmt_num(v)}" for k, v in constants.items())
        lines.append(f"constants,,,,,,,,,,{ser}")

    with open(path, "w") as f:
        f.write("\n".join(lines))
        f.write("\n")
    return path


def _parse_const(v: str):
    """Int-vs-float sniffing identical to SnapshotRW.jl:147."""
    return float(v) if _FLOAT_RE.search(v) else int(v)


def read_snapshot(path: str) -> Dict:
    """Read a snapshot CSV (ours or a reference-generated one).

    Returns dict with keys pos (N,3), vel (N,3), K ((N,) or None), rlin,
    rho_radial (float64 arrays, possibly empty), constants (dict).
    Mirrors SnapshotRW.read_snapshot (SnapshotRW.jl:123-159).
    """
    with open(path, "rb") as f:
        raw = f.read()

    header_end = raw.find(b"\n")
    header = raw[:header_end].decode().split(",")
    has_k = "K" in header
    ncols = 7 if has_k else 6

    # particle block: contiguous rows right after the header; the handful
    # of special rows (rlin/rho_radial/constants) follow it
    first = raw.find(b"particle,", header_end)
    if first >= 0:
        last = raw.rfind(b"\nparticle,")
        last = first if last < 0 else last + 1
        block_end = raw.find(b"\n", last)
        block_end = len(raw) if block_end < 0 else block_end + 1
        body = raw[first:block_end]
        n_rows = body.count(b"particle,")
        tail = raw[block_end:]
    else:
        body, n_rows, tail = b"", 0, raw[header_end + 1 :]

    from .native import parse_particles

    block = parse_particles(body, n_rows, ncols) if n_rows else np.empty((0, ncols))
    if block is None:  # no native toolchain: exact-parse fallback
        import io as _io

        import pandas as pd

        block = pd.read_csv(
            _io.BytesIO(body),
            header=None,
            usecols=range(1, 1 + ncols),
            float_precision="round_trip",
        ).to_numpy(dtype=np.float64)

    pos = block[:, 0:3]
    vel = block[:, 3:6]
    if has_k and n_rows:
        karr = block[:, 6]
        K = None if np.isnan(karr).all() else karr
    else:
        K = None

    rlin = np.empty(0)
    rho_radial = np.empty(0)
    constants: Dict = {}
    idx = {name: i for i, name in enumerate(header)}
    for line in tail.decode().splitlines():
        if not line:
            continue
        cells = line.split(",")
        row_type = cells[idx["type"]]
        if row_type == "rlin":
            rlin = np.fromstring(cells[idx["rlin"]], sep=";", dtype=np.float64)
        elif row_type == "rho_radial":
            rho_radial = np.fromstring(
                cells[idx["rho_radial"]], sep=";", dtype=np.float64
            )
        elif row_type == "constants":
            for pair in cells[idx["constants"]].split(";"):
                k, v = pair.split("=", 1)
                constants[k] = _parse_const(v)
    return {
        "pos": pos,
        "vel": vel,
        "K": K,
        "rlin": rlin,
        "rho_radial": rho_radial,
        "constants": constants,
    }
