"""Logical-axis sharding rules (MaxText-style) with divisibility fallbacks.

The reference's ``repro.sharding.rules`` over the port's slot mesh
(``launch.mesh.DeviceMesh``).  Logical axes:
    fsdp   -- parameter sharding over the batch-ish axes ("pod","data")
    tp     -- tensor parallel over "model"
    dp     -- batch sharding over ("pod","data")
    seq    -- sequence sharding over "data" (long-context serving)
    expert -- expert parallel over "model"

``maybe_spec`` drops any mesh axis that does not divide the corresponding
dimension (e.g. gemma-2b's 8 heads on a 16-way model axis fall back to
replication; granite's 40 experts fall back to expert-dim TP), which is
what makes one rule set serve all ten architectures.  A spec is the
port's :class:`~repro_torch.sharding.placement.P`; ``named`` turns it into
a :class:`~repro_torch.sharding.placement.NamedPlacement` whose
``place`` puts a tensor on the mesh's slots.

Activation constraints go through the module-level context (``activate``
/ ``shard``): models call ``shard(x, "dp", None, "tp")`` unconditionally,
and outside a mesh context it is a no-op.  Under ``activate`` it resolves
the spec — so a constraint of the wrong rank fails as in the reference —
and counts the constraint by call site (:data:`constraint_counts`).  It
returns ``x`` itself.

Tensor parallelism is the sites that split their ``tp`` dimension
themselves (the MLP's ``d_ff``, the attention heads, the vocabulary of
the cross-entropy): under ``activate(mesh, group=g)`` with a ``model``
extent ``tp > 1``, :func:`tp_slots` gives each of group ``g``'s ``model``
slots its device and its ``1/tp`` range of the dimension, or ``None``
where the rules drop ``model`` for it (the site then runs whole on the
group's device).  Slot ``m`` computes its range on its own device from
that range of the weights and sends its partial result back to the
group's device, where the partials are combined in f32.
:data:`tp_counts` is the census of those splits.
"""
from __future__ import annotations

import contextlib
import re
import sys
from typing import Optional, Sequence

import numpy as np

from repro_torch.launch.mesh import DeviceMesh
from repro_torch.sharding.placement import NamedPlacement, P

__all__ = ["LOGICAL", "resolve_axis", "maybe_spec", "activate", "shard",
           "param_shardings", "batch_shardings", "cache_shardings",
           "tree_shardings", "named", "current_mesh", "axis_size",
           "axis_size_of", "group_slots", "model_devices",
           "tree_map", "tree_items", "constraint_counts",
           "reset_constraint_counts", "tp_slots", "tp_counts",
           "reset_tp_counts"]

# logical axis -> tuple of mesh axis names (in priority order)
LOGICAL = {
    "fsdp": ("pod", "data"),
    "dp": ("pod", "data"),
    "tp": ("model",),
    "seq": ("data",),
    "expert": ("model",),
    None: (),
}

_ACTIVE: dict = {"mesh": None, "group": 0}

#: ``shard`` constraints resolved under an active mesh, by call site
#: (``"module.py:line"``); zero it with :func:`reset_constraint_counts`
constraint_counts: dict = {}


def reset_constraint_counts() -> None:
    constraint_counts.clear()


#: The tensor-parallel census by site (``"mlp"``, ``"attention"``,
#: ``"cross_entropy"``), summed over calls (zero it with
#: :func:`reset_tp_counts`): ``splits``, calls split over the ``model``
#: slots; ``whole``, calls whose dimension does not divide ``model`` and
#: so run whole; ``sent_bytes``, the activations handed to the slots
#: after the first (the group's own device), and ``returned_bytes``, the
#: partial results those slots send back — what crosses between cards
#: when each slot is a card of its own.  A call recomputed under
#: ``torch.utils.checkpoint`` counts again.
tp_counts: dict = {}


def reset_tp_counts() -> None:
    tp_counts.clear()


def current_mesh() -> Optional[DeviceMesh]:
    return _ACTIVE["mesh"]


@contextlib.contextmanager
def activate(mesh: DeviceMesh, group: int = 0):
    """Enable activation sharding constraints (and MoE's expert-parallel
    branch) for model code computing data-parallel group ``group``'s
    activations (see :func:`group_slots`)."""
    prev = dict(_ACTIVE)
    _ACTIVE.update(mesh=mesh, group=group)
    try:
        yield
    finally:
        _ACTIVE.update(prev)


def group_slots(mesh: DeviceMesh, group: int) -> list:
    """The devices of data-parallel group ``group``'s slots along
    ``model``, in ``model`` order (one device on a mesh without a
    ``model`` axis).  Groups count the ``("pod", "data")`` coordinate, pod
    major, as ``batch_shardings`` splits a batch; any other axis is taken
    at 0."""
    sizes = mesh.axis_sizes()
    coord, rest = {}, group
    for a in reversed([a for a in LOGICAL["dp"] if a in sizes]):
        rest, coord[a] = divmod(rest, sizes[a])
    if rest or group < 0:
        raise ValueError(f"no data-parallel group {group} on {mesh!r}")
    idx = tuple(coord.get(a, slice(None) if a == "model" else 0)
                for a in mesh.axis_names)
    slots = mesh.devices[idx]
    return list(slots.flat) if isinstance(slots, np.ndarray) else [slots]


def model_devices() -> list:
    """The active group's ``model`` slot devices (:func:`group_slots`)."""
    return group_slots(_ACTIVE["mesh"], _ACTIVE["group"])


def resolve_axis(logical: Optional[str], mesh: DeviceMesh, dim: int):
    """Mesh axes for one logical axis, dropping what doesn't divide ``dim``."""
    if logical is None:
        return None
    sizes = mesh.axis_sizes()
    keep = []
    remaining = dim
    for a in LOGICAL[logical]:
        if a in sizes and remaining % sizes[a] == 0:
            keep.append(a)
            remaining //= sizes[a]
    if not keep:
        return None
    return tuple(keep) if len(keep) > 1 else keep[0]


def maybe_spec(mesh: DeviceMesh, shape: Sequence[int],
               logical: Sequence[Optional[str]]) -> P:
    """Resolve logical axes; drop non-dividing mesh axes AND axes already
    used by an earlier dimension (a spec may use each mesh axis once —
    e.g. MoE buffers ask for both 'expert' and 'tp', which collide on
    'model' only when the expert count actually divides)."""
    if len(shape) != len(logical):
        raise ValueError(f"logical spec {tuple(logical)} for a tensor of "
                         f"shape {tuple(shape)}")
    sizes = mesh.axis_sizes()
    used: set = set()
    out = []
    for l, d in zip(logical, shape):
        if l is None:
            out.append(None)
            continue
        keep = []
        remaining = d
        for a in LOGICAL[l]:
            if a in sizes and a not in used and remaining % sizes[a] == 0:
                keep.append(a)
                remaining //= sizes[a]
        used.update(keep)
        out.append(tuple(keep) if len(keep) > 1 else
                   (keep[0] if keep else None))
    return P(*out)


def named(mesh: DeviceMesh, shape, logical) -> NamedPlacement:
    return NamedPlacement(mesh, maybe_spec(mesh, shape, logical))


def shard(x, *logical):
    """Activation sharding constraint; no-op without an active mesh."""
    mesh = _ACTIVE["mesh"]
    if mesh is None:
        return x
    maybe_spec(mesh, x.shape, logical)
    caller = sys._getframe(1)
    site = (f"{caller.f_code.co_filename.rsplit('/', 1)[-1]}:"
            f"{caller.f_lineno}")
    constraint_counts[site] = constraint_counts.get(site, 0) + 1
    return x


def tp_slots(site: str, dim: Optional[int], sent: int = 0,
             returned: int = 0) -> Optional[list]:
    """Split a dimension of size ``dim`` over the active group's ``model``
    slots: ``[(device, lo, hi)]``, slot ``m``'s device
    (:func:`model_devices`) and its range ``[lo, hi)``, in ``model``
    order; ``None`` where the site runs whole.  Without an active mesh or
    with a ``model`` extent of 1 it returns ``None`` and counts nothing;
    otherwise it counts the call in :data:`tp_counts` under ``site``:
    split, or whole where the rules drop ``model`` for ``dim`` (``dim``
    ``None``: the site has no dimension to split), with ``sent`` and
    ``returned`` bytes a slot for each slot after the first."""
    mesh = _ACTIVE["mesh"]
    if mesh is None or axis_size_of(mesh, "tp") == 1:
        return None
    c = tp_counts.setdefault(site, dict.fromkeys(
        ("splits", "whole", "sent_bytes", "returned_bytes"), 0))
    if dim is None or resolve_axis("tp", mesh, dim) is None:
        c["whole"] += 1
        return None
    slots = model_devices()
    n = dim // len(slots)
    c["splits"] += 1
    c["sent_bytes"] += sent * (len(slots) - 1)
    c["returned_bytes"] += returned * (len(slots) - 1)
    return [(d, m * n, (m + 1) * n) for m, d in enumerate(slots)]


def axis_size(logical: str) -> int:
    """Active-mesh size of a logical axis (1 without a mesh)."""
    mesh = _ACTIVE["mesh"]
    return 1 if mesh is None else axis_size_of(mesh, logical)


# ---------------------------------------------------------------------------
# Trees (dicts, lists, tuples and NamedTuples, as ``jax.tree`` walks them)
# ---------------------------------------------------------------------------

def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts (keys sorted), lists,
    tuples and NamedTuples, and the matching leaves of ``rest`` (trees of
    the same structure); ``None`` holds no leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        vals = (tree_map(fn, v, *(r[j] for r in rest))
                for j, v in enumerate(tree))
        return type(tree)(*vals) if _is_namedtuple(tree) else \
            type(tree)(vals)
    return fn(tree, *rest)


def tree_items(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``(path, leaf)`` pairs in ``jax.tree_util`` order, the path joined
    with ``/`` as the reference's checkpointer and rules join it (dict
    keys, sequence indices, NamedTuple field names)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        keys = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        keys = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        keys = [(str(j), v) for j, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in keys:
        out += tree_items(v, f"{prefix}/{k}" if prefix else k)
    return out


# ---------------------------------------------------------------------------
# Parameter rules (by leaf path)
# ---------------------------------------------------------------------------

# (regex on 'a/b/c' path) -> logical spec *for the trailing dims*; any extra
# leading dims (layer-stacking 'cycles') stay unsharded.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$", ("tp", "fsdp")),                 # (V, D) / (K, V, D)
    (r"lm_head$", ("fsdp", "tp")),               # (D, V) / (K, D, V)
    (r"mm_proj/w\d$", ("fsdp", "tp")),
    (r"cond_proj$", ("fsdp", "tp")),
    (r"(wq|wk|wv|wg|wr)$", ("fsdp", "tp")),      # (D, H*Dh)-family
    (r"wo$", ("tp", "fsdp")),                    # (H*Dh, D)
    (r"(wi_gate|wi_up|cm_wk)$", ("fsdp", "tp")),  # (D, F)
    (r"(cm_wv)$", ("tp", "fsdp")),               # (F, D)
    (r"cm_wr$", ("fsdp", "tp")),
    (r"moe/router$", ("fsdp", None)),
    (r"moe/wi_(gate|up)$", ("expert", "fsdp", "tp")),   # (E, D, F)
    (r"moe/wo$", ("expert", "tp", "fsdp")),             # (E, F, D)
    (r"ssm/in_proj$", ("fsdp", "tp")),
    (r"ssm/out_proj$", ("tp", "fsdp")),
    (r"ssm/x_proj$", ("tp", None)),
    (r"ssm/dt_proj$", (None, "tp")),
    (r"ssm/(a_log|d_skip|dt_bias)$", ("tp",)),
    (r"ssm/conv_band$", (None, "tp")),
    (r"(lora_a|w_lora_a)$", ("fsdp", None)),
    (r"lora_b$", (None, None, "fsdp")),
    (r"w_lora_b$", (None, "fsdp")),
]


def _param_logical(path: str, ndim: int) -> tuple:
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            spec = tuple(spec)
            if len(spec) < ndim:           # leading stacked/cycle dims
                spec = (None,) * (ndim - len(spec)) + spec
            elif len(spec) > ndim:
                spec = spec[-ndim:]
            return spec
    return (None,) * ndim


def param_shardings(mesh: DeviceMesh, params_sds):
    """A tree of :class:`NamedPlacement` beside a parameter (or
    optimizer-moment) tree in the reference's layout — stacked by cycle,
    as ``train_step.state_tree`` builds it — of tensors or anything with
    a ``.shape``."""
    items = iter(tree_items(params_sds))

    def one(leaf):
        path, _ = next(items)
        return named(mesh, leaf.shape,
                     _param_logical(path, len(leaf.shape)))
    return tree_map(one, params_sds)


# ---------------------------------------------------------------------------
# Batch / cache rules
# ---------------------------------------------------------------------------

def batch_shardings(mesh: DeviceMesh, specs: dict, *,
                    seq_shard: bool = False) -> dict:
    """Input batch: batch axis over dp; optionally the sequence axis over
    'data' (long-context serving with batch 1)."""
    out = {}
    for k, s in specs.items():
        logical: list = [None] * len(s.shape)
        logical[0] = "dp"
        if seq_shard and len(s.shape) >= 2 and k in ("tokens", "labels"):
            logical[-1] = "seq"
        out[k] = named(mesh, s.shape, logical)
    return out


def cache_shardings(mesh: DeviceMesh, cache_sds, *, seq_axis_shard: bool):
    """KV caches: (cycles, B, S, KVH, Dh) — batch over dp; S over 'data'
    when serving batch=1; head axis over tp when divisible.  SSM/RWKV
    states (cycles, B, ...): batch over dp, feature axes over tp.  The
    tree is the reference's cache layout (``transformer.stack_caches``)."""
    tp_size = axis_size_of(mesh, "tp")

    def one(leaf):
        shp = tuple(leaf.shape)
        logical: list = [None] * len(shp)
        if len(shp) >= 2:
            logical[1] = "dp"
        if len(shp) == 5:  # (cycles, B, S, KVH, Dh)
            if seq_axis_shard:
                logical[2] = "seq"
            logical[3] = "tp"
            # KVH rarely divides the model axis (GQA): shard head_dim
            # instead, so decode attention keeps KV stationary
            if shp[3] % tp_size != 0 and shp[4] % tp_size == 0:
                logical[3] = None
                logical[4] = "tp"
        elif len(shp) == 4:  # rwkv state (cycles, B, H/C, ...) or ssm h
            logical[2] = "tp"
        elif len(shp) == 3:  # (cycles, B, D) shift states
            logical[2] = "tp"
        return named(mesh, shp, logical)

    return tree_map(one, cache_sds)


def axis_size_of(mesh: DeviceMesh, logical: str) -> int:
    """``mesh``'s size of a logical axis."""
    sizes = mesh.axis_sizes()
    n = 1
    for a in LOGICAL[logical]:
        n *= sizes.get(a, 1)
    return n


def tree_shardings(mesh: DeviceMesh, tree_sds, leaf_fn):
    return tree_map(leaf_fn, tree_sds)
