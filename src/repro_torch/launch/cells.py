"""Placement of whole training and serving states on a slot mesh.

The first part of the reference's ``repro.launch.cells``: the placements
its cells attach to a ``TrainState`` and to the KV/SSM caches, here over
the port's slot mesh.  A state is the reference's tree
(``train_step.state_tree``: ``params``, ``opt/{step, mu, nu}``, ``step``;
caches as ``transformer.stack_caches`` lays them out), of tensors or of
anything with a ``.shape``.  The cell builder (``CellSpec``,
``build_cell``, ``MODEL_FLOPS``) is ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

from repro_torch.launch.mesh import DeviceMesh
from repro_torch.sharding import rules
from repro_torch.sharding.placement import NamedPlacement, P

__all__ = ["_replicated", "_state_shardings", "_cache_shardings"]


def _replicated(mesh: DeviceMesh) -> NamedPlacement:
    return NamedPlacement(mesh, P())


def _state_shardings(mesh: DeviceMesh, state_sds: dict) -> dict:
    """Placements beside a ``state_tree``-shaped train state: parameters
    and both AdamW moments by the parameter rules, the counters
    replicated."""
    opt = state_sds["opt"]
    return {"params": rules.param_shardings(mesh, state_sds["params"]),
            "opt": {"step": _replicated(mesh),
                    "mu": rules.param_shardings(mesh, opt["mu"]),
                    "nu": rules.param_shardings(mesh, opt["nu"])},
            "step": _replicated(mesh)}


def _cache_shardings(mesh: DeviceMesh, caches_sds, seq_shard: bool):
    return rules.cache_shardings(mesh, caches_sds, seq_axis_shard=seq_shard)
