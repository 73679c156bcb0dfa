"""The multi-device layer: engines sharded over a mesh of shards in one
process (shard/collectives.py). The exports are the reference's
(sphtpu/shard/__init__.py), loaded on first use: the single-device engines
import shard.collectives, and the sharded engines import them."""

_EXPORTS = {
    "make_sharded_chunk_runner": "step",
    "make_sharded_step": "step",
    "shard_state": "step",
    "particle_mesh": "collectives",
    "SlabPlan": "tiles",
    "SlabState": "tiles",
    "make_slab_chunk_runner": "tiles",
    "pack_state": "tiles",
    "plan_slabs": "tiles",
    "unpack_rows": "tiles",
}


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)


__all__ = sorted(_EXPORTS)
