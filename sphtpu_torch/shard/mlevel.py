"""Work-sharded multi-level engine: replicated state, sharded work lists.

Port of sphtpu/shard/mlevel.py over a mesh of shards in one process
(shard/collectives.py). Under collapse the z-slab engine (shard/tiles.py)
cannot certify or balance; this layer keeps the particle state replicated
on every shard, splits every active strip list and the residual budget
evenly across the shards (physics/mlevel.mlevel_forces_body with its
shard arguments; phase A on kernel K1, a shard's slice a launch) and
psum-combines the per-row outputs. shard/blocks.py runs the block-compact
engine through the same chunk runner.

Far field: "exact" shards the pure-Newtonian sweep by query rows (1/P of
the rows against all N, kernel K3's rows x columns entry, then a psum);
"p3m" solves the small mesh on every shard (no collective).

Certification follows the slab engine's freeze protocol: the host reads
the collective certificate once per evaluation; a failure freezes the
chunk (the state stops, the step reports cert_fail) and the host re-plans.
"""

from __future__ import annotations

import functools

import torch

from ..engine.config import EngineConfig, Params, State
from ..engine.step import kdk_body
from ..kernels.cuda_gravity_rc import newton_rows_cols
from ..physics.mesh_gravity import greens_hat, p3m_mesh_force
from ..physics.mlevel import mlevel_args_to_device, mlevel_forces_body
from ..profiling import stage
from .collectives import local_devices, local_shards, request, run_mesh
from .step import replicate


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _newton_rows_sharded(pos, m, shard: int, n_shards: int):
    """Row-sharded pure-Newtonian all-pairs sweep (a generator body): shard
    `shard` sweeps its 1/n_shards of the rows against all N columns (K3's
    rows x columns entry), and the psum of the zero-padded (N,) results
    gives every shard the full arrays."""
    n = pos.shape[0]
    rows_per = _ceil_to(n, 8 * n_shards) // n_shards
    r0, r1 = min(shard * rows_per, n), min((shard + 1) * rows_per, n)
    g = torch.zeros_like(pos)
    phi = torch.zeros_like(pos[:, 0])
    with stage("gravity"):
        if r1 > r0:
            g[r0:r1], phi[r0:r1] = newton_rows_cols(pos[r0:r1], pos, None, m)
    return (yield request("psum", (g, phi)))


def make_ml_chunk_runner(cfg: EngineConfig, mesh, joint_gravity: bool = False):
    """chunk(state, p, h0, mlargs, n_steps) -> (state, stats (S, 10), valid
    (S,), cert_fail (S,), h_last, rho_last) running the multi-level engine
    work-sharded over `mesh` (plan it with plan_mlevel(shards=len(mesh))).
    joint_gravity: mlevel_forces_body's (ROADMAP D21)."""
    assert cfg.mlevel is not None
    n_shards = len(mesh)

    def engine_force(p: Params, pos, vel, K, h_hint, mlargs, aux, shard):
        return (yield from mlevel_forces_body(
            pos, vel, p.m, K, h_hint, mlargs,
            eos=cfg.eos, gamma=p.gamma, cs0=p.cs0, alpha=p.alpha, beta=p.beta,
            kh=cfg.kh, spec=cfg.mlevel, mesh_factor=cfg.mesh_factor,
            sigma_cells=cfg.sigma_cells, joint_gravity=joint_gravity, shard=shard,
            n_shards=n_shards,
        ))

    def to_device(mlargs, dtype, device):
        return mlevel_args_to_device(mlargs, device)

    return _make_workshard_chunk_runner(cfg, mesh, engine_force, to_device)


def _make_workshard_chunk_runner(cfg: EngineConfig, mesh, engine_force, to_device,
                                 make_aux=None):
    """Generic work-sharded chunk runner: replicated state, the engine's
    work lists split across the mesh by `engine_force` (a generator body
    that psum-combines its per-row outputs), far field row-sharded (exact)
    or replicated (p3m mesh). to_device(args, dtype, device) places the
    plan's arguments on a shard's device; make_aux(args, shard), when
    given, builds a shard's per-chunk tables once a chunk (the block
    engine's candidate tables)."""
    n_shards = len(mesh)
    p3m = cfg.gravity == "p3m"
    # this process's shards: all of them, or a rank's slice (shard/dist.py)
    shards, devs = local_shards(mesh), local_devices(mesh)
    ghats = [
        greens_hat(cfg.mesh_pad, cfg.sigma_cells, cfg.torch_dtype, d) if p3m else None
        for d in devs
    ]

    def force(p: Params, mlargs, ghat, aux, shard, pos, vel, K, h_hint):
        """engine/step.kdk_body's force: None when the collective
        certificate failed (the chunk freezes; no fallback)."""
        tf, gcorr, ok = yield from engine_force(p, pos, vel, K, h_hint, mlargs, aux, shard)
        if not bool(ok):  # the host read of this evaluation's certificate
            return None
        if p3m:
            with stage("gravity"):
                gfar, phifar = p3m_mesh_force(pos, p.m, ghat, gm=cfg.mesh_gm, pad=cfg.mesh_pad)
        else:
            gfar, phifar = yield from _newton_rows_sharded(pos, p.m, shard, n_shards)
        g = gfar + torch.stack(gcorr[:3], dim=1)
        return tf.acc - g, tf, phifar + gcorr[3], False

    def chunk(state: State, p: Params, h0, mlargs, n_steps: int):
        dtype = state.pos.dtype
        states = replicate(state, devs)
        ps = replicate(p, devs)
        hs = [h0.to(d) for d in devs]
        args = [to_device(mlargs, dtype, d) for d in devs]
        aux = [make_aux(a, k) if make_aux is not None else None for k, a in zip(shards, args)]
        dev = devs[0]
        stats = torch.zeros((n_steps, 10), dtype=dtype, device=dev)
        valid = torch.zeros((n_steps,), dtype=torch.bool, device=dev)
        cert = torch.zeros((n_steps,), dtype=torch.bool, device=dev)
        h, rho = hs[0], torch.zeros_like(hs[0])
        for i in range(n_steps):
            if not bool(states[0].t < ps[0].t_end):
                break
            out = run_mesh(mesh, [
                kdk_body(cfg, ps[i], states[i], hs[i],
                         functools.partial(force, ps[i], args[i], ghats[i], aux[i], k))
                for i, k in enumerate(shards)
            ])
            if out[0] is None:
                cert[i] = True  # frozen: the state stays, the host re-plans
                break
            states = [o[0] for o in out]
            hs = [o[2] for o in out]
            stats[i] = out[0][1]
            valid[i] = True
            h, rho = out[0][2], out[0][3]
        return states[0], stats, valid, cert, h, rho

    return chunk
