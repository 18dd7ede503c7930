"""Gradient compression for data-parallel sync, with error feedback.

The reference's ``repro.optim.compression`` over trees of tensors: the
standard error-feedback loop (``g_hat = C(g + e); e' = (g + e) - g_hat``)
so compression error accumulates into later steps instead of being lost:

  * ``bf16``  — cast-only (2x wire reduction, no state)
  * ``int8``  — per-tensor absmax int8 (4x), error feedback required

``train_step``'s data-parallel step on a slot mesh calls them on each
group's gradient before the reduction (``make_train_step(...,
compression=)``, ``TrainerConfig.compression``; off by default, as in
the reference).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.adamw import tree_map

__all__ = ["CompressionState", "make_compressor"]


class CompressionState(NamedTuple):
    error: dict  # error-feedback residual per parameter (fp32)


def _zeros_like_tree(tree):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def make_compressor(kind: str):
    """Returns (init_fn, compress_fn, decompress_fn).

    compress_fn(grads, state) -> (wire_tree, new_state); the wire tree is
    what crosses the interconnect (all-reduce it), decompress_fn maps it
    back to fp32 grads.  An ``int8`` wire leaf is ``(codes, scale)``.
    """
    if kind == "none":
        return (lambda g: CompressionState(error={}),
                lambda g, s: (g, s),
                lambda w: w)

    if kind == "bf16":
        def compress(g, s):
            return tree_map(lambda x: x.to(torch.bfloat16), g), s
        return (lambda g: CompressionState(error={}),
                compress,
                lambda w: tree_map(lambda x: x.to(torch.float32), w))

    if kind == "int8":
        def init(g):
            return CompressionState(error=_zeros_like_tree(g))

        def compress(g, s: CompressionState):
            def one(x, e):
                x = x.to(torch.float32) + e
                scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
                q = torch.clamp(torch.round(x / scale), -127, 127).to(
                    torch.int8)
                deq = q.to(torch.float32) * scale
                return (q, scale), x - deq

            pairs = tree_map(one, g, s.error)
            wire = tree_map(lambda _, p: p[0], g, pairs)
            new_err = tree_map(lambda _, p: p[1], g, pairs)
            return wire, CompressionState(error=new_err)

        def decompress(wire):
            return _map_pairs(lambda q, scale: q.to(torch.float32) * scale,
                              wire)
        return init, compress, decompress

    raise ValueError(f"unknown compressor {kind!r}")


def _map_pairs(fn, wire):
    """``fn(codes, scale)`` over the ``(codes, scale)`` leaves of a wire
    tree."""
    if isinstance(wire, dict):
        return {k: _map_pairs(fn, wire[k]) for k in sorted(wire)}
    if isinstance(wire, tuple) and len(wire) == 2 and \
            isinstance(wire[0], torch.Tensor):
        return fn(*wire)
    if isinstance(wire, (list, tuple)):
        return type(wire)(_map_pairs(fn, v) for v in wire)
    raise TypeError(f"not an int8 wire tree: {type(wire).__name__}")
