"""The port's checkpointer against the JAX package's: the same on-disk
format (``step_XXXXXXXX.tmp`` then an atomic rename, ``shard_*.npz``, a
per-shard-file digest, ``manifest.msgpack``), so checkpoints cross
between the packages both ways bit-identically; the port's own msgpack
encoder/decoder against ``msgpack`` itself; retention, atomicity and
torn-write detection inside the port."""
import os

import msgpack
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.checkpoint import checkpointer as ref_ck

from repro_torch.checkpoint import checkpointer as ck
from repro_torch.core.distributed import MeshSharding, unshard
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime import chaos

torch.set_num_threads(2)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"state": rng.standard_normal((2, 12, 10)).astype(np.float32),
            "emits": {"00000003": rng.standard_normal((12, 10))
                      .astype(np.float32),
                      "00000009": rng.standard_normal((12, 10))
                      .astype(np.float32)},
            "count": np.arange(5, dtype=np.int32)}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _assert_tree_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))


# ---------------------------------------------------------------------------
# The manifest's msgpack subset
# ---------------------------------------------------------------------------

_OBJECTS = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 0.0, -0.0, 1.5, 1e300, float("inf"), "", "a" * 31,
    "a" * 32, "é" * 200, "b" * 256, "c" * 70000, b"", b"\x00" * 255,
    b"\x01" * 256, b"\x02" * 70000, [], list(range(15)), list(range(16)),
    list(range(70000)), (1, "two", None), {}, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)}, {str(i): [i] for i in range(70000)},
    {"step": 3, "extra": {"program": "0123456789abcdef", "segment": 2},
     "leaves": [{"key": "emits/00000003", "dtype": "float32",
                 "shape": [8192, 8192],
                 "shards": [{"file": "shard_full", "index": None}]},
                {"key": "state", "dtype": "float32", "shape": [2, 64],
                 "shards": [{"file": "shard_0", "index": [[0, 1], [0, 64]]}]}],
     "shard_digests": {"shard_full": "ab" * 20}},
]


@pytest.mark.parametrize("obj", _OBJECTS, ids=range(len(_OBJECTS)))
def test_packb_matches_msgpack_both_ways(obj):
    want = msgpack.packb(obj)
    assert ck.packb(obj) == want
    assert ck.unpackb(want) == msgpack.unpackb(want)
    assert msgpack.unpackb(ck.packb(obj)) == ck.unpackb(want)


def test_codec_rejects_what_the_manifest_never_holds():
    with pytest.raises(TypeError):
        ck.packb({"x": np.float32(1.0)})
    with pytest.raises(ValueError, match="truncated"):
        ck.unpackb(msgpack.packb({"leaves": [1, 2, 3]})[:-1])
    with pytest.raises(ValueError, match="extra bytes"):
        ck.unpackb(msgpack.packb(1) + b"\x01")
    with pytest.raises(ValueError, match="subset"):
        ck.unpackb(b"\xc7\x01\x05\x00")          # ext type


def test_port_manifest_bytes_are_msgpacks(tmp_path):
    d = str(tmp_path)
    ck.save_checkpoint(d, 7, _as_torch(_tree()),
                       extra={"program": "abc", "segment": 2, "step": 7})
    raw = open(os.path.join(d, "step_00000007", "manifest.msgpack"),
               "rb").read()
    manifest = msgpack.unpackb(raw)
    assert msgpack.packb(manifest) == raw
    assert ck.unpackb(raw) == manifest
    assert manifest["extra"] == {"program": "abc", "segment": 2, "step": 7}
    assert sorted(manifest["shard_digests"]) == ["shard_full"]


# ---------------------------------------------------------------------------
# Checkpoints cross between the packages
# ---------------------------------------------------------------------------

def test_reference_checkpoint_restores_bit_identically(tmp_path):
    d = str(tmp_path)
    tree = _tree(1)
    ref_ck.save_checkpoint(d, 5, {k: (jnp.asarray(v) if not isinstance(v, dict)
                                      else {e: jnp.asarray(a)
                                            for e, a in v.items()})
                                  for k, v in tree.items()},
                           extra={"program": "p", "segment": 1})
    ref_bytes = open(os.path.join(d, "step_00000005", "manifest.msgpack"),
                     "rb").read()
    assert ck.packb(msgpack.unpackb(ref_bytes)) == ref_bytes
    target = _as_torch({k: (np.zeros_like(v) if not isinstance(v, dict)
                            else {e: np.zeros_like(a) for e, a in v.items()})
                        for k, v in tree.items()})
    got, extra = ck.restore_checkpoint(d, 5, target)
    assert extra == {"program": "p", "segment": 1}
    assert got["count"].dtype == torch.int32
    _assert_tree_equal({k: (v.numpy() if not isinstance(v, dict) else
                            {e: a.numpy() for e, a in v.items()})
                        for k, v in got.items()}, tree)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    d = str(tmp_path)
    tree = _tree(2)
    mgr = ck.CheckpointManager(d, keep_last=2, async_save=True)
    mgr.save(4, _as_torch(tree), extra={"program": "q", "segment": 3})
    mgr.wait()
    assert ref_ck.latest_step(d) == 4
    target = {k: (np.zeros_like(v) if not isinstance(v, dict)
                  else {e: np.zeros_like(a) for e, a in v.items()})
              for k, v in tree.items()}
    got, extra = ref_ck.restore_checkpoint(d, 4, target)
    assert extra == {"program": "q", "segment": 3}
    _assert_tree_equal(got, tree)


def test_mesh_sharded_reference_manifest_reassembles(tmp_path):
    """A manifest with per-device shard files (what the JAX package
    writes under a mesh) restores on one device, each shard checked
    against its digest."""
    d = str(tmp_path)
    path = os.path.join(d, "step_00000001")
    os.makedirs(path)
    full = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    np.savez(os.path.join(path, "shard_0.npz"), state=full[:4])
    np.savez(os.path.join(path, "shard_1.npz"), state=full[4:])
    manifest = {"step": 1, "extra": {}, "leaves": [
        {"key": "state", "dtype": "float32", "shape": [8, 6],
         "shards": [{"file": "shard_0", "index": [[0, 4], [0, 6]]},
                    {"file": "shard_1", "index": [[4, 8], [0, 6]]}]}]}
    manifest["shard_digests"] = {
        f: ck._file_digest(os.path.join(path, f + ".npz"))
        for f in ("shard_0", "shard_1")}
    with open(os.path.join(path, "manifest.msgpack"), "wb") as f:
        f.write(msgpack.packb(manifest))
    got, _ = ck.restore_checkpoint(d, 1, {"state": torch.zeros(())})
    np.testing.assert_array_equal(got["state"].numpy(), full)
    with open(os.path.join(path, "shard_1.npz"), "r+b") as f:
        f.truncate(16)
    with pytest.raises(ValueError, match="digest"):
        ck.restore_checkpoint(d, 1, {"state": torch.zeros(())})
    # restored onto a mesh of another shape (the ported shardings=)
    os.remove(os.path.join(path, "shard_1.npz"))
    np.savez(os.path.join(path, "shard_1.npz"), state=full[4:])
    mesh = make_mesh((4,), ("x",), devices="cpu")
    got, _ = ck.restore_checkpoint(
        d, 1, {"state": torch.zeros(())},
        shardings={"state": MeshSharding(mesh, ("x", ""))})
    st = got["state"]
    assert st.mesh is mesh and st.local_shape == (2, 6)
    np.testing.assert_array_equal(unshard(st).numpy(), full)


def test_bfloat16_leaves_round_trip_exactly(tmp_path):
    d = str(tmp_path)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((5, 7))
                         .astype(np.float32)).to(torch.bfloat16)
    ck.save_checkpoint(d, 1, {"x": x})
    got, _ = ck.restore_checkpoint(d, 1, {"x": torch.zeros((), dtype=torch
                                                           .bfloat16)})
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"], x)


# ---------------------------------------------------------------------------
# Inside the port: retention, atomicity, torn writes
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_gc(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.int32)},
            "pair": [torch.zeros(2), torch.ones(3)]}
    mgr = ck.CheckpointManager(d, keep=2, async_save=False)
    for step in (1, 2, 3, 4):
        mgr.save(step, {"a": tree["a"] * step, "nested": tree["nested"],
                        "pair": tree["pair"]})
    assert mgr.latest() == 4 and mgr.steps() == [3, 4]
    restored, _ = ck.restore_checkpoint(d, 4, tree)
    assert torch.equal(restored["a"], tree["a"] * 4)
    assert restored["nested"]["b"].dtype == torch.int32
    assert isinstance(restored["pair"], list)
    assert torch.equal(restored["pair"][1], torch.ones(3))


def test_checkpoint_keep_last_retention_and_stale_tmp(tmp_path):
    d = str(tmp_path)
    mgr = ck.CheckpointManager(d, keep_last=2, async_save=False)
    tree = {"w": torch.ones((4,))}
    for step in (1, 2, 3, 4):
        mgr.save(step, tree)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    stale = os.path.join(d, "step_00000005.tmp")
    os.makedirs(stale)
    with open(os.path.join(stale, "garbage"), "w") as f:
        f.write("partial write")
    assert mgr.latest() == 4
    mgr.save(5, tree)                    # clobbers the stale tmp
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]
    mgr_all = ck.CheckpointManager(d, keep=None, async_save=False)
    for step in (6, 7, 8, 9):
        mgr_all.save(step, tree)
    assert len(os.listdir(d)) == 6
    with pytest.raises(ValueError, match="keep_last"):
        ck.CheckpointManager(d, keep_last=0)


def test_async_save_snapshots_before_returning(tmp_path):
    """The save thread gets host copies: changing the tensor after save()
    returns does not change what is written."""
    d = str(tmp_path)
    mgr = ck.CheckpointManager(d, async_save=True)
    w = torch.ones((64, 64))
    mgr.save(1, {"w": w})
    w.fill_(7.0)
    mgr.wait()
    got, _ = ck.restore_checkpoint(d, 1, {"w": torch.zeros(())})
    assert torch.equal(got["w"], torch.ones((64, 64)))
    assert not any(p.endswith(".tmp") for p in os.listdir(d))


def test_chaos_torn_write_and_crash(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.ones((4,))}
    # a rule counts only the calls that reach it: the first call stops at
    # the corrupt rule, so the raise rule sees the second as its call 0
    plan = (chaos.FaultPlan(seed=0)
            .rule("checkpoint.write", at=(0,), action="corrupt")
            .rule("checkpoint.write", at=(0,)))
    with plan:
        ck.save_checkpoint(d, 1, tree)                # torn: renamed
        with pytest.raises(chaos.FaultError):
            ck.save_checkpoint(d, 2, tree)            # crash: .tmp stays
    assert ck.retained_steps(d) == [1]
    assert os.path.isdir(os.path.join(d, "step_00000002.tmp"))
    with pytest.raises(ValueError):
        ck.restore_checkpoint(d, 1, tree)
    with chaos.FaultPlan(seed=0).rule("checkpoint.read", at=(0,)):
        ck.save_checkpoint(d, 3, tree)
        with pytest.raises(chaos.FaultError):
            ck.restore_checkpoint(d, 3, tree)


def test_async_failure_surfaces_on_wait(tmp_path):
    d = str(tmp_path)
    mgr = ck.CheckpointManager(d, async_save=True)
    with chaos.FaultPlan(seed=0).rule("checkpoint.write", at=(0,)):
        mgr.save(1, {"w": torch.ones(2)})
        with pytest.raises(RuntimeError, match="async checkpoint failed"):
            mgr.wait()
    mgr.wait()                                        # error consumed


def test_restore_places_leaves_on_the_callers_device(tmp_path):
    d = str(tmp_path)
    ck.save_checkpoint(d, 1, {"w": torch.ones(3, dtype=torch.float64)})
    got, _ = ck.restore_checkpoint(d, 1, {"w": np.zeros((), np.float32)},
                                   device="cpu")
    assert got["w"].device.type == "cpu" and got["w"].dtype == torch.float32
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore_checkpoint(d, 1, {"v": torch.zeros(())})
