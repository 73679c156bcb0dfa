"""The multi-process layer: one mesh across processes over torch.distributed.

Port of sphtpu/shard/multihost.py. The reference joins jax.distributed and
builds one mesh over every process's devices; here each process (a rank)
runs its own shards' generator bodies and `shard/dist.py` exchanges each
collective between the ranks, so the engines' bodies are the one-process
ones.

*   `initialize` wraps `torch.distributed.init_process_group` with an
    explicit backend and timeout: a rank that never arrives fails the
    others in bounded time.
    -   "gloo" runs on the CPU, and on one card shared by several ranks; a
        CUDA payload is staged through host memory (shard/dist.py).
    -   "nccl" needs one card a rank: two ranks on one card are refused
        before the process group forms.
*   `global_mesh` is rank-major: rank r runs global shards r*s .. r*s+s-1,
    every rank the same s (the reference's process-major mesh).
*   State stays replicated across ranks for the work-sharded engines: every
    rank feeds the same host values to `replicate` and runs the same
    deterministic host planning, so plans agree without communication.
*   I/O is the primary rank's (`is_primary`): only rank 0 writes snapshots,
    stats and figures.

Spawn CUDA ranks with the "spawn" start method (or separate launches,
`torchrun`), never "fork".
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .collectives import local_devices
from .dist import ProcessMesh, process_allgather, world

BACKENDS = ("gloo", "nccl")
TIMEOUT_S = 300.0  # default limit of the rendezvous and of every collective


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str = "gloo",
    timeout_s: float = TIMEOUT_S,
    init_method: str | None = None,
):
    """Join (or form) the process group. `coordinator_address` is rank 0's
    "host:port" (init_method "tcp://host:port"); `init_method` may name
    another rendezvous ("file:///path", "env://"). Idempotent: a second
    call is a no-op. Under "nccl" the rank's card is cuda:<local rank mod
    visible cards>, and more ranks on this host than visible cards raise
    ValueError."""
    if dist.is_initialized():
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if init_method is None:
        if coordinator_address is None:
            raise ValueError("initialize needs coordinator_address or init_method")
        init_method = f"tcp://{coordinator_address}"
    if num_processes is None or process_id is None:
        raise ValueError("initialize needs num_processes and process_id")
    if backend == "nccl":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        on_host = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        if on_host > visible:
            raise ValueError(
                f"backend 'nccl' needs one card a rank: {on_host} ranks on this host, "
                f"{visible} visible cards (NCCL refuses two ranks on one device); "
                "use backend='gloo' to share a card"
            )
        torch.cuda.set_device(local_rank(process_id) % visible)
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def local_rank(process_id: int | None = None) -> int:
    """The rank's index on its host: LOCAL_RANK (torchrun) or the rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return world()[0] if process_id is None else process_id


def maybe_initialize_from_env(backend: str = "gloo", timeout_s: float = TIMEOUT_S) -> bool:
    """initialize() from the variables `torchrun` exports (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK) when all four are set; returns whether it
    did."""
    keys = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
    if not all(os.environ.get(k) for k in keys):
        return False
    initialize(
        num_processes=int(os.environ["WORLD_SIZE"]), process_id=int(os.environ["RANK"]),
        backend=backend, timeout_s=timeout_s, init_method="env://",
    )
    return True


def shutdown():
    """Leave the process group, if one was formed."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return world()[1]


def is_primary() -> bool:
    """True on the rank that owns snapshot, stats and figure I/O (rank 0)."""
    return world()[0] == 0


def shard_devices(shards: int, device=None) -> list:
    """The rank's shard devices: `shards` CPU shards when device is "cpu",
    else `shards` shards of cuda:<local rank mod visible cards> (an error
    with no card: a CUDA rank never falls back to the CPU)."""
    if device is not None and torch.device(device).type == "cpu":
        return ["cpu"] * shards
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a multi-process run puts its shards on a CUDA device by default and "
            "none is available; pass device='cpu' (CLI: --device cpu)"
        )
    return [f"cuda:{local_rank() % torch.cuda.device_count()}"] * shards


def global_mesh(devices) -> ProcessMesh:
    """The mesh over every rank's shards, rank-major. `devices` are this
    rank's shards' devices; every rank must give the same number."""
    rank, n = world()
    mine = [str(torch.device(d)) for d in devices]
    if n == 1:
        return ProcessMesh(mine, 0, len(mine))
    every = [None] * n
    dist.all_gather_object(every, mine)
    if len({len(e) for e in every}) != 1:
        raise ValueError(f"every rank must run the same number of shards: {every}")
    return ProcessMesh([d for e in every for d in e], rank, len(mine))


def replicate(tree, mesh):
    """One copy of identical host values (a tensor, numpy array, or a tuple
    or NamedTuple of them) on each of this rank's shards' devices."""

    def place(x, d):
        if isinstance(x, tuple):
            items = [place(v, d) for v in x]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        return torch.as_tensor(x).to(d)

    return [place(tree, d) for d in local_devices(mesh)]


def host_local(x) -> np.ndarray:
    """Host numpy copy of a tensor, or of the first of a list of per-shard
    replicated values."""
    if isinstance(x, list):
        x = x[0]
    return x.detach().cpu().numpy()


def agree_min(value: int) -> int:
    """The smallest of the ranks' values: a host decision made from a
    rank-local measurement (a wall time) must agree before it branches."""
    return int(process_allgather(np.asarray([value], np.int64)).min())
