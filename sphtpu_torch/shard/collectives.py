"""The mesh and its collectives, in one process over a tuple of devices.

The reference is one controller over a 1-D mesh of devices ("dp"): its
sharded engines are `shard_map` bodies that call XLA collectives. Here the
mesh is a tuple of `torch.device`s (`particle_mesh`), repeats allowed: four
shards of `cuda:0` run the whole exchange on one card, `cuda:0..3` on four,
four `cpu`s in the tests. A shard's data lives on its device.

Two layers:

*   Collectives are plain functions over per-shard lists (`all_gather`,
    `psum`, `psum_scatter`, `pmin`, `pmax`, `ppermute`): element i of the
    argument is shard i's value, element i of the result lands on shard
    i's device. A value is a tensor or a tuple of tensors. Data moves
    between shards only here, as tensor copies (`.to(device,
    non_blocking=True)`, a no-op between shards of one device); nothing is
    read back to the host.
*   A `shard_map` body becomes a generator function, one generator a
    shard: at each collective it yields `request(op, value, **kw)` and
    receives its share of the result. `run_spmd` steps all shards' bodies
    in lock step, phase by phase, and performs each collective between the
    phases. With one shard every collective is the identity, so the
    single-device engines run the same bodies through `run_local`.

The interface is the list functions and the request names. Across
processes (shard/dist.py) the mesh is a `ProcessMesh`: each rank runs its
own shards' bodies (`local_shards`) and `run_mesh` hands them to
`dist.run_dist`, which exchanges each request's values between the ranks
and runs the same list function; the bodies are unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


def particle_mesh(devices) -> tuple:
    """The 1-D mesh: a tuple of torch.device, one a shard (repeats allowed)."""
    return tuple(torch.device(d) for d in devices)


def _tree_map(fn, *trees):
    """fn over tensors, or elementwise over tuples/lists of tensors."""
    if isinstance(trees[0], (tuple, list)):
        return tuple(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _to(x, device):
    return _tree_map(lambda t: t.to(device, non_blocking=True), x)


def _reduce(xs, fn):
    """fn-fold of the shards' values in shard order, on shard 0's device,
    then one copy to each shard."""
    if len(xs) == 1:
        return [xs[0]]
    dev0 = _devices_of(xs)[0]

    def fold(*leaves):
        acc = leaves[0]
        for t in leaves[1:]:
            acc = fn(acc, t.to(dev0, non_blocking=True))
        return acc

    total = _tree_map(fold, *xs)
    return [_to(total, d) for d in _devices_of(xs)]


def _devices_of(xs):
    def first(x):
        return first(x[0]) if isinstance(x, (tuple, list)) else x.device

    return [first(x) for x in xs]


def psum(xs: Sequence):
    """Sum over shards (shard order), replicated."""
    return _reduce(xs, torch.add)


def pmax(xs: Sequence):
    return _reduce(xs, torch.maximum)


def pmin(xs: Sequence):
    return _reduce(xs, torch.minimum)


def all_gather(xs: Sequence, dim: int = 0):
    """Concatenation of the shards' values along dim (tiled), replicated."""
    if len(xs) == 1:
        return [xs[0]]
    devs = _devices_of(xs)
    cat = _tree_map(
        lambda *leaves: torch.cat([t.to(devs[0], non_blocking=True) for t in leaves], dim),
        *xs,
    )
    return [_to(cat, d) for d in devs]


def psum_scatter(xs: Sequence, dim: int = 0):
    """Sum over shards, then shard i keeps block i of the sum along dim
    (tiled: the dim's length must divide by the shard count)."""
    n = len(xs)
    if n == 1:
        return [xs[0]]
    total = psum(xs)[0]
    devs = _devices_of(xs)

    def block(t, i):
        k = t.shape[dim] // n
        return t.narrow(dim, i * k, k).to(devs[i], non_blocking=True)

    return [_tree_map(lambda t, i=i: block(t, i), total) for i in range(n)]


def ppermute(xs: Sequence, perm):
    """out[dst] = xs[src] for each (src, dst) pair of perm; zeros where a
    shard receives from no one (XLA's ppermute)."""
    devs = _devices_of(xs)
    out = [_tree_map(torch.zeros_like, x) for x in xs]
    for src, dst in perm:
        out[dst] = _to(xs[src], devs[dst])
    return out


OPS = {
    "psum": psum,
    "pmax": pmax,
    "pmin": pmin,
    "all_gather": all_gather,
    "psum_scatter": psum_scatter,
    "ppermute": ppermute,
}


class Request(NamedTuple):
    """A collective a shard's body waits on: OPS[op](values, **kw)."""

    op: str
    value: object
    kw: dict


def request(op: str, value, **kw) -> Request:
    if op not in OPS:
        raise ValueError(f"unknown collective {op!r}")
    return Request(op, value, kw)


def run_spmd(bodies: Sequence):
    """Run one generator a shard in lock step: every body must yield the
    same collective (op and arguments) at the same point; the collective
    runs over the yielded values and each body resumes with its share.
    Returns the bodies' return values, in shard order."""
    gens = list(bodies)
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
            return results
        if done:
            raise RuntimeError("shards left the body at different collectives")
        op, kw = reqs[0].op, reqs[0].kw
        if any(r.op != op or r.kw != kw for r in reqs):
            raise RuntimeError(
                f"shards disagree on the collective: {[(r.op, r.kw) for r in reqs]}"
            )
        sends = OPS[op]([r.value for r in reqs], **kw)


def local_shards(mesh) -> range:
    """The global indices of the shards this process runs: all of them, or
    a rank's slice of a mesh across processes."""
    return getattr(mesh, "local", range(len(mesh)))


def local_devices(mesh) -> list:
    """The devices of this process's shards, in shard order."""
    return [mesh[k] for k in local_shards(mesh)]


def run_mesh(mesh, bodies):
    """Run this process's shards' bodies (one per `local_shards(mesh)`, in
    order) over the mesh: `run_spmd` in one process, `dist.run_dist` across
    processes. Returns the bodies' return values in the same order."""
    if hasattr(mesh, "local"):
        from .dist import run_dist

        return run_dist(bodies, mesh)
    return run_spmd(bodies)


def run_local(body):
    """A body on one device: every collective is the identity."""
    return run_spmd([body])[0]
