"""The mesh across processes and its runner, over torch.distributed.

`run_spmd` (shard/collectives.py) steps every shard's generator body in one
process. Here each process (a rank) runs only its own shards' bodies, and
each collective a body yields becomes an exchange between the ranks:

*   A `ProcessMesh` is the global mesh, rank-major: rank r runs global
    shards r*s .. r*s+s-1, every rank the same s. It is a tuple of every
    shard's device (as its rank named it), and a rank touches only its own
    shards' devices (`.local`).
*   `run_dist` steps the rank's bodies in lock step, as `run_spmd` does. At
    each request the rank all-gathers its shards' values, rebuilds the
    global, shard-ordered list, runs the same list function from `OPS` over
    it and keeps its own shards' results. Every collective, the reductions
    included, is therefore folded in global shard order exactly as in one
    process: a run over ranks equals `run_spmd` over the same shards bit
    for bit, given the same arithmetic on each shard.
*   Each request is two all-gathers: a header (the op, a checksum of its
    arguments and of the values' shapes and dtypes, the payload's bytes),
    then the payload. Ranks that reach different requests, or a rank that
    has left its bodies while another waits in one, raise instead of
    hanging.
*   With the "gloo" backend the payload is staged through host memory (one
    device-to-host and one host-to-device copy a request); with "nccl" it
    stays on the rank's card.

Every rank must reach the same requests in the same order: a host branch on
data that only one rank holds must be reduced over the ranks before it
branches (`process_allgather`).
"""

from __future__ import annotations

import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

from .collectives import OPS, _to

_DONE = 0
_OPCODE = {op: i + 1 for i, op in enumerate(OPS)}
_ALIGN = 8  # byte alignment of each leaf in a payload

# what this process's requests cost (tools read and reset them): requests
# exchanged, payload bytes sent (a rank's shards' values), and the wall
# seconds from packing the payload to the rebuilt global list on the device
exchanges = 0
exchange_bytes = 0
exchange_s = 0.0


class ProcessMesh(tuple):
    """The global mesh of a run across processes: every shard's device,
    rank-major, with this process's shards in `local` (a range of global
    shard indices)."""

    def __new__(cls, devices, rank: int, per_rank: int):
        self = super().__new__(cls, (torch.device(d) for d in devices))
        if len(self) % per_rank or not 0 <= rank < len(self) // per_rank:
            raise ValueError(f"rank {rank} with {per_rank} shards a rank on a mesh of {len(self)}")
        self.rank = rank
        self.local = range(rank * per_rank, (rank + 1) * per_rank)
        return self


def world() -> tuple:
    """(rank, number of ranks) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def staging_device() -> torch.device:
    """Where exchanged tensors live: the rank's card under NCCL, else host
    memory (gloo's CUDA support is partial, so CUDA payloads are staged
    through the host explicitly)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_allgather(arr) -> np.ndarray:
    """Stack of every rank's numpy array (same shape and dtype on every rank),
    in rank order: (n_ranks, *shape). Without a process group: arr[None]."""
    arr = np.ascontiguousarray(arr)
    rank, n = world()
    if n == 1:
        return arr[None]
    t = torch.from_numpy(arr).to(staging_device())
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def _leaves(x) -> list:
    if isinstance(x, (tuple, list)):
        return [leaf for item in x for leaf in _leaves(item)]
    return [x]


def _rebuild(like, leaves):
    """`like`'s tuple structure over the next tensors of the `leaves` iterator."""
    if isinstance(like, (tuple, list)):
        return tuple(_rebuild(item, leaves) for item in like)
    return next(leaves)


def _layout(leaves):
    """[(offset, nbytes, shape, dtype)] of the leaves in one shard's payload
    slice, and the slice's length (each leaf aligned to _ALIGN bytes)."""
    out, off = [], 0
    for t in leaves:
        nb = t.numel() * t.element_size()
        out.append((off, nb, tuple(t.shape), t.dtype))
        off += -(-nb // _ALIGN) * _ALIGN
    return out, off


def _payload(values, layout) -> torch.Tensor:
    """The rank's shards' values as one uint8 tensor on the staging device:
    each shard's leaves joined on its own device, then one copy a shard."""
    dev = staging_device()
    chunks = []
    for v in values:
        parts = []
        for t, (_, nb, _, _) in zip(_leaves(v), layout):
            parts.append(t.detach().contiguous().reshape(-1).view(torch.uint8))
            if nb % _ALIGN:
                parts.append(torch.zeros(-nb % _ALIGN, dtype=torch.uint8, device=t.device))
        chunks.append(torch.cat(parts).to(dev))
    return torch.cat(chunks)


def _exchange_header(header, n: int):
    h = torch.tensor(header, dtype=torch.int64, device=staging_device())
    out = [torch.empty_like(h) for _ in range(n)]
    dist.all_gather(out, h)
    got = [tuple(int(x) for x in o.cpu()) for o in out]
    if any(g != got[0] for g in got):
        names = {code: op for op, code in _OPCODE.items()}
        names[_DONE] = "(left the body)"
        raise RuntimeError(
            "ranks disagree on the collective: "
            + ", ".join(f"rank {r}: {names.get(g[0], g[0])} (sum {g[1]:#x}, {g[2]} bytes)"
                        for r, g in enumerate(got))
        )


def run_dist(bodies, mesh: ProcessMesh):
    """Run the rank's shards' generator bodies (one per shard of
    `mesh.local`, in order) in lock step with the other ranks' bodies: at
    each request the global list of values is exchanged and `OPS[op]` runs
    over it in global shard order. Returns the rank's bodies' return values,
    in local shard order."""
    global exchanges, exchange_bytes, exchange_s
    gens = list(bodies)
    if len(gens) != len(mesh.local):
        raise ValueError(f"{len(gens)} bodies for {len(mesh.local)} local shards")
    _, n_ranks = world()
    sends = [None] * len(gens)
    results = [None] * len(gens)
    while True:
        reqs = []
        done = 0
        for i, g in enumerate(gens):
            try:
                reqs.append(g.send(sends[i]))
            except StopIteration as stop:
                results[i] = stop.value
                reqs.append(None)
                done += 1
        if done == len(gens):
            _exchange_header([_DONE, 0, 0], n_ranks)
            return results
        if done:
            raise RuntimeError("shards left the body at different collectives")
        op, kw = reqs[0].op, reqs[0].kw
        if any(r.op != op or r.kw != kw for r in reqs):
            raise RuntimeError(
                f"shards disagree on the collective: {[(r.op, r.kw) for r in reqs]}"
            )
        values = [r.value for r in reqs]
        sig = [(tuple(t.shape), str(t.dtype)) for t in _leaves(values[0])]
        if any([(tuple(t.shape), str(t.dtype)) for t in _leaves(v)] != sig for v in values):
            raise RuntimeError(f"{op}: the shards' values differ in shape or dtype")
        t0 = time.perf_counter()
        layout, size = _layout(_leaves(values[0]))
        check = zlib.crc32(repr((op, sorted(kw.items()), sig)).encode())
        _exchange_header([_OPCODE[op], check, size], n_ranks)
        mine = _payload(values, layout)
        gathered = [torch.empty_like(mine) for _ in range(n_ranks)]
        dist.all_gather(gathered, mine)
        devs = [mesh[k] for k in mesh.local]
        buf = torch.cat(gathered).to(devs[0])
        exchanges += 1
        exchange_bytes += mine.numel()
        exchange_s += time.perf_counter() - t0
        glob = []
        for k in range(len(mesh)):
            base = k * size
            leaves = iter([
                buf[base + off : base + off + nb].view(dtype).reshape(shape)
                for off, nb, shape, dtype in layout
            ])
            glob.append(_rebuild(values[0], leaves))
        out = OPS[op](glob, **kw)
        sends = [_to(out[k], d) for k, d in zip(mesh.local, devs)]
