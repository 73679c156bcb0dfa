"""Work-sharded block-compact engine: replicated state, sharded blocks.

Port of sphtpu/shard/blocks.py. Each of P shards sweeps a contiguous 1/P
slice of every bucket's block list (the planner pads bucket lengths to a
multiple of lcm(BLK_GRAN, P), so the slices are exact): phase A on kernel
K1 and phase B on kernel K5 over its blocks only
(physics/blocks.block_forces_body with its shard arguments), then the
per-row outputs are psum-combined. Work balance is exact at any density
contrast because blocks are work units, not space units. The chunk
runner, the far field and the freeze protocol are shard/mlevel.py's.
"""

from __future__ import annotations

from ..engine.config import EngineConfig, Params
from ..physics.blocks import block_args_to_device, block_forces_body, build_cand_tables
from .mlevel import _make_workshard_chunk_runner


def make_blocks_chunk_runner(cfg: EngineConfig, mesh):
    """chunk(state, params, h0, bargs, n_steps) -> (state, stats (S, 10),
    valid (S,), cert_fail (S,), h_last, rho_last) running the block-compact
    engine work-sharded over `mesh`. The spec must have been planned with
    shards = len(mesh) (bucket granularity)."""
    assert cfg.blocks is not None
    n_shards = len(mesh)
    for _, nb in cfg.blocks[0]:
        assert nb % n_shards == 0, "spec not planned for this mesh size"

    def engine_force(p: Params, pos, vel, K, h_hint, bargs, aux, shard):
        return (yield from block_forces_body(
            pos, vel, p.m, K, h_hint, bargs,
            eos=cfg.eos, gamma=p.gamma, cs0=p.cs0, alpha=p.alpha, beta=p.beta,
            kh=cfg.kh, spec=cfg.blocks, gravity=cfg.gravity,
            mesh_factor=cfg.mesh_factor, sigma_cells=cfg.sigma_cells,
            idx_tables=aux, shard=shard, n_shards=n_shards,
        ))

    def make_aux(bargs, shard):
        # this shard's slice of the candidate index tables, once a chunk
        return build_cand_tables(bargs, cfg.blocks, cfg.n, shard=shard, n_shards=n_shards)

    return _make_workshard_chunk_runner(
        cfg, mesh, engine_force, block_args_to_device, make_aux
    )
