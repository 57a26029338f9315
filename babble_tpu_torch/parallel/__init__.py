"""Multi-device parallelism on ``torch.distributed``: the ("ev", "p")
mesh, the sharding layout, the sharded consensus step and fork step,
and the multi-host bootstrap (the port's twin of the JAX package's
``parallel/``).

The JAX package shards ONE consensus computation over a device mesh
and lets XLA insert the collectives.  The port runs one process per
rank, each on bit-identical inputs, with the decomposition written out
(``sharded.py``): event rows over "ev", participant (or branch) columns
over "p", every strongly-see compare-count a partial count over the
rank's columns and an all-reduce SUM over "p" (``collectives.py``).

Launch a program over several ranks with torchrun (``bootstrap`` reads
its variables) or rehearse the certifications with ``python -m
babble_tpu_torch.parallel.dryrun --ranks R --backend nccl|gloo --device
cuda|cpu``.  Names resolve on first use (PEP 562), so importing the
package imports no torch.
"""

_EXPORTS = {
    "bootstrap": "multihost", "broadcast_batch": "multihost",
    "global_mesh": "multihost", "make_multihost_step": "multihost",
    "make_mesh": "mesh",
    "state_specs": "sharded", "state_shardings": "sharded",
    "batch_shardings": "sharded", "place_state": "sharded",
    "consensus_step_impl": "sharded", "make_sharded_step": "sharded",
    "pad_cfg_for_mesh": "sharded", "sharded_init_state": "sharded",
}


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = [
    "bootstrap", "broadcast_batch", "global_mesh", "make_multihost_step",
    "make_mesh",
    "state_specs",
    "state_shardings",
    "batch_shardings",
    "place_state",
    "consensus_step_impl",
    "make_sharded_step",
    "pad_cfg_for_mesh",
]
