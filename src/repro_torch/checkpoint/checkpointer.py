"""Atomic, async, digest-checked checkpointing in the JAX package's format.

Layout (one directory per step), byte-compatible with the JAX package's
``checkpoint/checkpointer.py``:
    step_000100.tmp/              -- written first
        manifest.msgpack          -- leaf keys, shapes, dtypes, shard index
        shard_<name>.npz          -- the arrays
    step_000100/                  -- atomic rename on completion

The manifest records a content digest PER SHARD FILE, so a torn
single-shard write is detected at restore time — the digest mismatch
raises and a resume ladder falls back to the newest intact checkpoint,
exactly like a torn manifest.  A checkpoint that the JAX package writes
on one device restores here, and the reverse.

The manifest is msgpack.  This module carries its own encoder and
decoder (:func:`packb`, :func:`unpackb`) for the subset the manifest
uses — maps, arrays, str, bytes, int, float, bool and nil — producing
the bytes ``msgpack.packb`` produces, so it needs no ``msgpack`` package.

Tensors are copied to the host (``.cpu().numpy()``) before a save leaves
the caller's thread; a bfloat16 tensor is stored as its exact float32
upcast with ``"bfloat16"`` in the manifest.  Restore builds tensors on
the caller's device.

A placed leaf — a :class:`repro_torch.sharding.placement.Placed` tensor
of a train state on a mesh, or a stencil path's
:class:`repro_torch.core.distributed.ShardedState` — is written as the
JAX package writes a mesh-sharded array: one ``shard_<slot>.npz`` file
per slot holding that slot's block, each block's global index in the
leaf's manifest entry (replicas written once), plus the mesh shape, axis
names and the leaf's spec (a stencil state's grid axes) under the
entry's ``"mesh"`` key (the JAX package's restore ignores it).  Restore
reassembles the global array from the indices — whichever package wrote
it — and ``shardings=`` re-shards it onto the CURRENT mesh, which may
have another shape than the one that wrote it (elastic re-mesh after a
failure).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import shutil
import struct
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.runtime import chaos

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "retained_steps", "CheckpointManager", "packb", "unpackb"]



# ---------------------------------------------------------------------------
# The manifest's msgpack subset
# ---------------------------------------------------------------------------

def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_head(len(b), 0xa0, 31, (0xd9, 0xda, 0xdb)) + b)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_head(len(obj), None, -1, (0xc4, 0xc5, 0xc6)) + bytes(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 15, (None, 0xdc, 0xdd)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 15, (None, 0xde, 0xdf)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _head(n: int, fix: int | None, fix_max: int, codes) -> bytes:
    """Length header: the fixed form up to ``fix_max``, then the 8/16/32-bit
    forms (``None`` where the type has no such form)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xff, 0xffff, 0xffffffff)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} too large for msgpack")


def _pack_int(x: int) -> bytes:
    if 0 <= x < 0x80 or -0x20 <= x < 0:
        return struct.pack(">b", x) if x < 0 else bytes([x])
    forms = ((0xcc, ">B", 0, 0xff), (0xd0, ">b", -0x80, -1),
             (0xcd, ">H", 0, 0xffff), (0xd1, ">h", -0x8000, -1),
             (0xce, ">I", 0, 0xffffffff), (0xd2, ">i", -0x80000000, -1),
             (0xcf, ">Q", 0, 0xffffffffffffffff),
             (0xd3, ">q", -0x8000000000000000, -1))
    for code, fmt, lo, hi in forms:
        if lo <= x <= hi:
            return bytes([code]) + struct.pack(fmt, x)
    raise OverflowError("int too big to pack")


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for the manifest's types (dict keys in
    insertion order; tuples pack as arrays)."""
    out: list[bytes] = []
    _pack(obj, out)
    return b"".join(out)


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LENGTH = {0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
           0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
           0xdc: (">H", "array"), 0xdd: (">I", "array"),
           0xde: (">H", "map"), 0xdf: (">I", "map")}


def _unpack(buf: bytes, i: int):
    if i >= len(buf):
        raise ValueError("truncated msgpack data")
    c = buf[i]
    i += 1
    if c <= 0x7f:
        return c, i
    if c >= 0xe0:
        return c - 0x100, i
    if c == 0xc0:
        return None, i
    if c in (0xc2, 0xc3):
        return c == 0xc3, i
    if c in _FIXED:
        fmt = _FIXED[c]
        n = struct.calcsize(fmt)
        if i + n > len(buf):
            raise ValueError("truncated msgpack data")
        return struct.unpack_from(fmt, buf, i)[0], i + n
    if 0xa0 <= c <= 0xbf:
        kind, n = "str", c & 0x1f
    elif 0x90 <= c <= 0x9f:
        kind, n = "array", c & 0x0f
    elif 0x80 <= c <= 0x8f:
        kind, n = "map", c & 0x0f
    elif c in _LENGTH:
        fmt, kind = _LENGTH[c]
        w = struct.calcsize(fmt)
        if i + w > len(buf):
            raise ValueError("truncated msgpack data")
        n = struct.unpack_from(fmt, buf, i)[0]
        i += w
    else:
        raise ValueError(f"msgpack type byte 0x{c:02x} is outside the "
                         f"manifest's subset")
    if kind in ("str", "bin"):
        if i + n > len(buf):
            raise ValueError("truncated msgpack data")
        raw = buf[i:i + n]
        return (raw.decode("utf-8") if kind == "str" else bytes(raw)), i + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            items.append(v)
        return items, i
    d = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"map key of type {type(k).__name__} is not "
                             f"str or bytes")
        d[k], i = _unpack(buf, i)
    return d, i


def unpackb(data: bytes):
    """``msgpack.unpackb(data)`` for the manifest's types (arrays as lists,
    str decoded as UTF-8); raises ``ValueError`` on truncated or extra
    bytes."""
    obj, end = _unpack(bytes(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} extra bytes after the msgpack "
                         f"object")
    return obj


# ---------------------------------------------------------------------------
# Trees of arrays
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _HostSharded:
    """A sharded leaf copied to the host: ``(file, global index, data)``
    per unique block, the dtype name, the global shape and the mesh
    record."""
    shards: tuple
    dtype: str
    shape: tuple
    mesh: dict


@dataclasses.dataclass(frozen=True)
class _HostLeaf:
    """A leaf already copied to the host, with the dtype name the manifest
    records (``"bfloat16"`` for a bf16 tensor stored as float32)."""
    data: np.ndarray
    dtype: str


def _tree_paths(tree) -> tuple[list[str], list, Callable]:
    """(keys, leaves, rebuild) of a tree of dicts, lists and tuples, with
    the keys and leaf order of ``jax.tree_util.tree_flatten_with_path``
    (dict keys sorted, sequence entries by index, ``None`` holds no
    leaf); ``rebuild(new_leaves)`` puts leaves back into the structure."""
    keys, leaves = [], []

    def walk(node, path):
        if node is None:
            return lambda it: None
        if isinstance(node, dict):
            subs = [(k, walk(node[k], path + [str(k)])) for k in sorted(node)]
            return lambda it: {k: f(it) for k, f in subs}
        if isinstance(node, (list, tuple)):
            subs = [walk(v, path + [str(j)]) for j, v in enumerate(node)]
            kind = type(node)
            return lambda it: kind(f(it) for f in subs)
        keys.append("/".join(path))
        leaves.append(node)
        return lambda it: next(it)

    build = walk(tree, [])
    return keys, leaves, lambda new: build(iter(new))


def _sharded_to_host(state, copy: bool) -> _HostSharded:
    shards = []
    for c, idx, block in state.unique_blocks():
        host = _to_host(block, copy)
        index = [[0 if sl.start is None else int(sl.start),
                  int(n) if sl.stop is None else int(sl.stop)]
                 for sl, n in zip(idx, state.shape)]
        shards.append((f"shard_{int(state.mesh.slots[c])}", index,
                       host.data))
    name = str(state.dtype).removeprefix("torch.")
    layout = {"grid_axes": list(state.grid_axes)} if \
        hasattr(state, "grid_axes") else \
        {"spec": [e if e is None or isinstance(e, str) else list(e)
                  for e in state.spec]}
    return _HostSharded(
        tuple(shards), name, tuple(int(n) for n in state.shape),
        {"shape": list(state.mesh.shape),
         "axes": list(state.mesh.axis_names), **layout})


def _to_host(leaf, copy: bool = False):
    """The leaf as host data; ``copy`` snapshots it even where the host
    array would share the caller's memory (CPU tensors, numpy arrays)."""
    from repro_torch.core.distributed import ShardedState
    from repro_torch.sharding.placement import Placed
    if isinstance(leaf, (_HostLeaf, _HostSharded)):
        return leaf
    if isinstance(leaf, (ShardedState, Placed)):
        return _sharded_to_host(leaf, copy)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.float()
        shares = t.device.type == "cpu"
        t = t.cpu()
        if copy and shares:
            t = t.clone()
        return _HostLeaf(t.numpy(), name)
    arr = np.array(leaf) if copy else np.asarray(leaf)
    return _HostLeaf(arr, str(arr.dtype))


def _file_digest(path: str) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _truncate(path: str) -> None:
    with open(path, "rb") as f:
        half = f.read()[: max(1, os.path.getsize(path) // 2)]
    with open(path, "wb") as f:
        f.write(half)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: dict | None = None) -> str:
    """Write one checkpoint synchronously. Returns the final path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    keys, leaves, _ = _tree_paths(tree)

    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    blobs: dict[str, dict[str, np.ndarray]] = {}
    for key, leaf in zip(keys, leaves):
        host = _to_host(leaf)
        name = key.replace("/", "__")
        if isinstance(host, _HostSharded):
            entry = {"key": key, "dtype": host.dtype,
                     "shape": list(host.shape), "shards": [],
                     "mesh": host.mesh}
            for fname, index, data in host.shards:
                blobs.setdefault(fname, {})[name] = data
                entry["shards"].append({"file": fname, "index": index})
        else:
            entry = {"key": key, "dtype": host.dtype,
                     "shape": [int(n) for n in host.data.shape],
                     "shards": [{"file": "shard_full", "index": None}]}
            blobs.setdefault("shard_full", {})[name] = host.data
        manifest["leaves"].append(entry)
    if not blobs:
        blobs["shard_full"] = {}
    for fname, blob in blobs.items():
        np.savez(os.path.join(tmp, fname + ".npz"), **blob)
    # per-shard-file content digests: restore verifies each blob against
    # these before trusting it, so a torn SINGLE-shard write is as
    # detectable as a torn manifest
    manifest["shard_digests"] = {
        fname: _file_digest(os.path.join(tmp, fname + ".npz"))
        for fname in blobs}
    mpath = os.path.join(tmp, "manifest.msgpack")
    with open(mpath, "wb") as f:
        f.write(packb(manifest))
    # fault site: "raise" models a crash mid-write (the .tmp is left
    # behind — invisible to latest_step/GC); "corrupt" models a TORN
    # write that still completed the rename: with slot shards the
    # highest-named shard file is truncated (one slot's write torn
    # mid-flight, caught by its manifest digest); otherwise the manifest
    # itself is truncated.  Either way the resume fallback must skip to
    # an older checkpoint.
    if chaos.fire("checkpoint.write", step=int(step)) == "corrupt":
        sharded = sorted(f for f in blobs if f != "shard_full")
        _truncate(os.path.join(tmp, sharded[-1] + ".npz") if sharded
                  else mpath)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def retained_steps(directory: str) -> list[int]:
    """Every COMPLETED checkpoint step in ``directory``, ascending
    (in-flight ``.tmp`` directories are invisible here, as everywhere)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(directory)
                  if (m := re.fullmatch(r"step_(\d+)", d)))


def latest_step(directory: str) -> Optional[int]:
    steps = retained_steps(directory)
    return steps[-1] if steps else None


def read_manifest(directory: str, step: int) -> dict:
    """The decoded ``manifest.msgpack`` of one checkpoint."""
    path = os.path.join(directory, f"step_{step:08d}", "manifest.msgpack")
    with open(path, "rb") as f:
        return unpackb(f.read())


def _np_dtype(name: str) -> np.dtype:
    # numpy has no bfloat16: such leaves are stored as their f32 upcast
    return np.dtype(np.float32 if name == "bfloat16" else name)


def _torch_dtype(leaf, fallback: str) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    name = str(leaf.dtype) if hasattr(leaf, "dtype") else fallback
    return getattr(torch, name)


def _sharding_leaves(shardings, template, n: int) -> list:
    """One sharding (or None) per leaf of ``template``: a single
    ``MeshSharding`` applies to every leaf; a tree follows the template's
    structure, a ``None`` node standing for every leaf below it."""
    if shardings is None:
        return [None] * n
    if hasattr(shardings, "place"):
        return [shardings] * n
    out = []

    def walk(node, tmpl):
        if tmpl is None:
            return
        if isinstance(tmpl, dict):
            for k in sorted(tmpl):
                walk(None if node is None else node.get(k), tmpl[k])
        elif isinstance(tmpl, (list, tuple)):
            for j, v in enumerate(tmpl):
                walk(None if node is None else node[j], v)
        else:
            out.append(node)

    walk(shardings, template)
    return out


def restore_checkpoint(directory: str, step: int, target_tree: Any,
                       shardings: Any = None, *,
                       device=None) -> tuple[Any, dict]:
    """Rebuild the tree saved at ``step`` in the structure of
    ``target_tree``.  Each leaf comes back as a tensor of the target
    leaf's dtype, on ``device`` — by default the target leaf's device
    when it is a tensor, else the CPU.  ``shardings`` (a placement for
    every leaf — a :class:`repro_torch.sharding.placement.NamedPlacement`
    or a stencil state's :class:`repro_torch.core.distributed
    .MeshSharding` — or a tree of them and ``None`` like ``target_tree``,
    such as ``launch.cells._state_shardings`` builds) re-places a leaf
    onto its mesh instead, whatever mesh wrote it.  Returns ``(tree,
    extra)``."""
    path = os.path.join(directory, f"step_{step:08d}")
    chaos.fire("checkpoint.read", step=int(step))
    manifest = read_manifest(directory, step)
    digests = manifest.get("shard_digests", {})
    blobs: dict[str, Any] = {}

    def load_blob(fname):
        if fname not in blobs:
            fpath = os.path.join(path, fname + ".npz")
            want = digests.get(fname)
            if want is not None and _file_digest(fpath) != want:
                raise ValueError(
                    f"checkpoint shard {fname!r} at step {step} fails its "
                    f"manifest digest (torn write)")
            blobs[fname] = np.load(fpath)
        return blobs[fname]

    by_key = {}
    for entry in manifest["leaves"]:
        key = entry["key"]
        full = np.zeros(entry["shape"], dtype=_np_dtype(entry["dtype"]))
        for sh in entry["shards"]:
            data = load_blob(sh["file"])[key.replace("/", "__")]
            if sh["index"] is None:
                full = data
            else:
                # a mesh-sharded checkpoint of the JAX package: reassemble
                full[tuple(slice(a, b) for a, b in sh["index"])] = data
        by_key[key] = (full, entry["dtype"])

    keys, leaves, rebuild = _tree_paths(target_tree)
    shards = _sharding_leaves(shardings, target_tree, len(leaves))
    new_leaves = []
    for key, leaf, shd in zip(keys, leaves, shards):
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr, name = by_key[key]
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(
            dtype=_torch_dtype(leaf, name))
        if shd is not None:
            new_leaves.append(shd.place(t))
            continue
        dev = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        new_leaves.append(t.to(device=dev))
    return rebuild(new_leaves), manifest["extra"]


class CheckpointManager:
    """Async checkpointing with retention and a wait/flush barrier.

    Retention: ``keep_last=N`` keeps the N newest completed ``step_*``
    directories and garbage-collects the rest after every successful
    save; ``keep=None`` retains everything.  (``keep`` is the historical
    alias for the same knob; ``keep_last`` wins when both are given, and
    ``keep_last=None`` just defers to ``keep``.)  GC only ever sees
    COMPLETED checkpoints — an in-flight ``step_*.tmp`` directory matches
    neither the retention scan nor ``latest_step``, so a crash mid-write
    can neither be restored from nor disturb what is kept.

    ``save`` copies every tensor to the host on the caller's thread
    (which waits for the device work that produced it), then writes on a
    background thread when ``async_save`` is on.
    """

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True,
                 keep_last: Optional[int] = None):
        self.directory = directory
        self.keep = keep if keep_last is None else keep_last
        if self.keep is not None and self.keep < 1:
            raise ValueError("keep_last >= 1 (or None to retain all)")
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any, extra: dict | None = None):
        self.wait()
        keys, leaves, rebuild = _tree_paths(tree)
        host_tree = rebuild([_to_host(leaf, copy=True) for leaf in leaves])

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_if_failed()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint failed") from err

    def _gc(self):
        if self.keep is None:
            return
        for s in retained_steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest(self) -> Optional[int]:
        return latest_step(self.directory)

    def steps(self) -> list[int]:
        """All retained completed checkpoint steps, ascending — the
        fallback ladder a digest-guarded resume walks newest-first when
        the latest checkpoint turns out torn/corrupt."""
        return retained_steps(self.directory)
