"""KV caches: full-length and ring (sliding-window) variants.

Ring caches hold only ``window`` slots — absolute position ``p`` lives at
slot ``p % window`` — so a long decode with windowed layers costs
O(window) memory per layer.  Keys are RoPE-rotated at write time, so
overwrites stay consistent.

Unlike the reference's immutable arrays, the writes update the cache's
tensors in place (a decode step would otherwise copy every layer's cache
per token); the returned cache shares them with the one passed in.
``length`` is a host integer.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["FullKVCache", "RingKVCache", "init_kv_cache", "prefill_write",
           "decode_write", "cache_view"]


class FullKVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max, KVH, Dh)
    v: torch.Tensor
    length: int


class RingKVCache(NamedTuple):
    k: torch.Tensor       # (B, W, KVH, Dh)
    v: torch.Tensor
    length: int


def init_kv_cache(batch: int, max_len: int, kvh: int, dh: int,
                  window: Optional[int] = None, dtype=torch.bfloat16, *,
                  device):
    """A ring cache when the window is shorter than ``max_len``, else a
    full one."""
    if window is not None and window < max_len:
        shape, cls = (batch, window, kvh, dh), RingKVCache
    else:
        shape, cls = (batch, max_len, kvh, dh), FullKVCache
    return cls(k=torch.zeros(shape, dtype=dtype, device=device),
               v=torch.zeros(shape, dtype=dtype, device=device), length=0)


def prefill_write(cache, k: torch.Tensor, v: torch.Tensor):
    """Write a full prefix (positions 0..S-1). k/v: (B, S, KVH, Dh)."""
    s = k.shape[1]
    if isinstance(cache, RingKVCache):
        w = cache.k.shape[1]
        if s >= w:
            # the last w positions, position p at slot p % w
            k_last, v_last = k[:, s - w:], v[:, s - w:]
            slots = torch.arange(s - w, s, device=k.device) % w
        else:
            k_last, v_last = k, v
            slots = torch.arange(s, device=k.device)
        cache.k[:, slots] = k_last.to(cache.k.dtype)
        cache.v[:, slots] = v_last.to(cache.v.dtype)
        return RingKVCache(k=cache.k, v=cache.v, length=s)
    cache.k[:, :s] = k.to(cache.k.dtype)
    cache.v[:, :s] = v.to(cache.v.dtype)
    return FullKVCache(k=cache.k, v=cache.v, length=s)


def decode_write(cache, k: torch.Tensor, v: torch.Tensor):
    """Append one token. k/v: (B, 1, KVH, Dh)."""
    if isinstance(cache, RingKVCache):
        slot = cache.length % cache.k.shape[1]
    else:
        slot = cache.length
        if slot >= cache.k.shape[1]:
            raise ValueError(f"full cache of {cache.k.shape[1]} positions "
                             f"is full")
    cache.k[:, slot:slot + 1] = k.to(cache.k.dtype)
    cache.v[:, slot:slot + 1] = v.to(cache.v.dtype)
    return type(cache)(k=cache.k, v=cache.v, length=cache.length + 1)


def cache_view(cache):
    """(k, v, k_positions, kv_mask) for attention over the cache contents.

    Positions are absolute; invalid (unwritten) slots are masked out.
    """
    device = cache.k.device
    if isinstance(cache, RingKVCache):
        w = cache.k.shape[1]
        j = torch.arange(w, device=device)
        last = cache.length - 1
        pos = last - torch.remainder(last - j, w)   # latest position in slot j
        # the reference's final mask (kv_cache.py:85)
        mask = (pos >= 0) & (pos < cache.length) if cache.length > 0 \
            else torch.zeros(w, dtype=torch.bool, device=device)
        return cache.k, cache.v, pos, mask
    pos = torch.arange(cache.k.shape[1], device=device)
    return cache.k, cache.v, pos, pos < cache.length
