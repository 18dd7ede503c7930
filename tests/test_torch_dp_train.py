"""The data-parallel train step on a slot mesh (``train/train_step.py``'s
``MeshTrainState``) on slots of the CPU, against the port's one-device
step and the JAX package's step: the reference's
``tests/test_multidevice.py`` bars, at tinyllama and Hymba SMOKE with the
JAX weights carried across (``params_from_numpy``).

* a 4x2 ``("data", "model")`` step's loss within 1e-4 of one device and
  of the JAX package's jitted step (its parameters and moments after the
  step within 0.05 x lr of one device's);
* its checkpoint, written one shard file a slot, restored onto a 2x2x2
  ``("pod", "data", "model")`` mesh and stepped again within 1e-4 of one
  device's second step;
* that checkpoint restored by the JAX package without a mesh, stepped
  there, saved and restored by the port onto 2x2x2, leaves equal;
* the reference's compression toy (8 ``data`` slots, bf16 and int8 before
  the wire) within 0.02 relative of the unsharded gradient;
* the sync census of a step.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as ref_ckpt
from repro.configs import base as ref_base
from repro.data import pipeline as ref_pipe
from repro.optim import adamw as ref_adamw
from repro.train import train_step as ref_ts

from repro_torch.checkpoint import checkpointer
from repro_torch.configs import base
from repro_torch.data import pipeline
from repro_torch.launch.cells import _state_shardings
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.sharding.placement import Placed
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

LR, SEQ, BATCH, CE_CHUNK = 1e-3, 16, 4, 8
ARCHS = ("tinyllama_1_1b", "hymba_1_5b")


def _mesh(shape):
    names = ("data", "model") if len(shape) == 2 else \
        ("pod", "data", "model")
    return make_mesh(shape, names, devices="cpu")


def _flat(tree, device="cpu") -> dict:
    """``{path: numpy}`` copies of a ``state_tree`` (placed leaves
    gathered)."""
    return {k: (v.unshard(device) if isinstance(v, Placed)
                else torch.as_tensor(v)).numpy().copy()
            for k, v in rules.tree_items(tree)}


@pytest.fixture(scope="module", params=ARCHS)
def run(request, tmp_path_factory):
    """Two steps each: the JAX package's, the port's on one device, and
    the port's on 4x2 then (restored from the 4x2 checkpoint) on 2x2x2."""
    arch = request.param
    cfg = base.get_smoke_config(arch)
    ref_cfg = ref_base.get_smoke_config(arch)
    kw = dict(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
              seed=1)
    ref_batches = [ref_pipe.SyntheticLM(ref_pipe.DataConfig(**kw))
                   .batch_at(i) for i in range(2)]
    batches = [pipeline.SyntheticLM(pipeline.DataConfig(**kw)).batch_at(i)
               for i in range(2)]
    ref_opt = ref_adamw.adamw(lr=LR)
    opt = adamw.adamw(lr=LR)

    jstate = ref_ts.init_train_state(jax.random.PRNGKey(0), ref_cfg, ref_opt)
    p_np = jax.tree.map(np.asarray, jstate.params)
    jstep = jax.jit(ref_ts.make_train_step(ref_cfg, ref_opt,
                                           ce_chunk=CE_CHUNK))
    jst1, jm1 = jstep(jstate, ref_batches[0])

    model = tf.params_from_numpy(p_np, cfg, "cpu", trainable=True)
    one = ts.TrainState(params=model,
                        opt=opt.init(dict(model.named_parameters())),
                        step=torch.zeros((), dtype=torch.int32))
    step1 = ts.make_train_step(cfg, opt, ce_chunk=CE_CHUNK)
    one, m1 = step1(one, batches[0])
    one_tree = _flat(ts.state_tree(one))
    one, m1b = step1(one, batches[1])

    mesh_a = _mesh((4, 2))
    st_a = ts.place_train_state(
        tf.params_from_numpy(p_np, cfg, "cpu", trainable=True), mesh_a)
    ts.reset_sync_counts()
    st_a, ma = ts.make_train_step(cfg, opt, ce_chunk=CE_CHUNK,
                                  mesh=mesh_a)(st_a, batches[0])
    census = dict(ts.sync_counts)
    d = str(tmp_path_factory.mktemp(arch))
    checkpointer.save_checkpoint(d, 1, ts.state_tree(st_a))

    mesh_b = _mesh((2, 2, 2))
    target = ts.state_tree(st_a, device="meta")
    restored, _ = checkpointer.restore_checkpoint(
        d, 1, target, shardings=_state_shardings(mesh_b, target))
    st_b = ts.load_state_tree(ts.place_train_state(
        tf.params_from_numpy(p_np, cfg, "cpu", trainable=True), mesh_b),
        restored)
    st_b, mb = ts.make_train_step(cfg, opt, ce_chunk=CE_CHUNK,
                                  mesh=mesh_b)(st_b, batches[1])
    return dict(cfg=cfg, ref_cfg=ref_cfg, ref_opt=ref_opt, jstate=jstate,
                jm1=jm1, m1=m1, m1b=m1b, ma=ma, mb=mb, st_a=st_a, st_b=st_b,
                one=one, one_tree=one_tree, census=census, ckpt=d,
                mesh_b=mesh_b, ref_batches=ref_batches, p_np=p_np)


def test_dp_step_matches_one_device_and_reference(run):
    la, l1, lj = (float(run["ma"]["loss"]), float(run["m1"]["loss"]),
                  float(run["jm1"]["loss"]))
    assert abs(la - l1) < 1e-4, (la, l1)
    assert abs(la - lj) < 1e-4, (la, lj)
    assert abs(float(run["ma"]["grad_norm"]) - float(run["m1"]["grad_norm"])) \
        <= 1e-4 * float(run["m1"]["grad_norm"])
    # Adam moves an entry whose gradient is near zero by up to lr, so the
    # groups' summation order shows in the parameters at a fraction of lr
    got = _flat(ts.state_tree(run["st_a"]))
    for k, v in run["one_tree"].items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=0.05 * LR,
                                   err_msg=k)


def test_elastic_restore_onto_2x2x2(run):
    """Restored onto another mesh shape, the next step stays within 1e-4
    of one device's second step; the blocks are the 2x2x2 rules'."""
    lb, l1b = float(run["mb"]["loss"]), float(run["m1b"]["loss"])
    assert abs(lb - l1b) < 1e-4, (lb, l1b)
    assert int(run["st_b"].step) == 2 and int(run["st_b"].opt.step) == 2
    wq = dict(rules.tree_items(run["st_b"].params))["layers/0/attn/wq"]
    assert wq.mesh is run["mesh_b"]
    assert tuple(wq.spec) == tuple(rules.maybe_spec(
        run["mesh_b"], wq.shape, (None, "fsdp", "tp")))


def test_mesh_checkpoint_one_shard_file_a_slot(run):
    """Each slot's blocks in ``shard_<slot>.npz``, each block's global
    index in the manifest, replicas written once."""
    d = run["ckpt"]
    files = sorted(f for f in os.listdir(os.path.join(d, "step_00000001"))
                   if f.endswith(".npz"))
    assert files == sorted([f"shard_{i}.npz" for i in range(8)]
                           + ["shard_full.npz"])
    entries = {e["key"]: e for e in checkpointer.read_manifest(d, 1)["leaves"]}
    assert entries["params/final_norm"]["shards"] == [
        {"file": "shard_0", "index": [[0, run["cfg"].d_model]]}]
    assert entries["params/final_norm"]["mesh"]["spec"] == [None]
    wq = entries["params/layers/0/attn/wq"]
    assert len(wq["shards"]) == 8 and wq["mesh"]["axes"] == ["data", "model"]
    assert entries["step"]["shards"] == [{"file": "shard_full",
                                          "index": None}]


def test_checkpoint_crosses_to_jax_and_back(run, tmp_path):
    """The port's 4x2 checkpoint restores in the JAX package without a
    mesh; the JAX package's step on it saves a checkpoint the port
    restores onto 2x2x2."""
    target = ref_ts.init_train_state(jax.random.PRNGKey(1), run["ref_cfg"],
                                     run["ref_opt"])
    jst, _ = ref_ckpt.restore_checkpoint(run["ckpt"], 1, target)
    want = _flat(ts.state_tree(run["st_a"]))
    flat = jax.tree_util.tree_flatten_with_path(jst)[0]
    got = {"/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", k)))) for k in p): np.asarray(v) for p, v in flat}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jstep = jax.jit(ref_ts.make_train_step(run["ref_cfg"], run["ref_opt"],
                                           ce_chunk=CE_CHUNK))
    jst2, _ = jstep(jst, run["ref_batches"][1])
    ref_ckpt.save_checkpoint(str(tmp_path), 2, jst2)
    tmpl = ts.state_tree(run["st_a"], device="meta")
    back, _ = checkpointer.restore_checkpoint(
        str(tmp_path), 2, tmpl, shardings=_state_shardings(run["mesh_b"],
                                                           tmpl))
    assert isinstance(dict(rules.tree_items(back))["params/embed"], Placed)
    flat2 = {"/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", k)))) for k in p): np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(jst2)[0]}
    for k, v in _flat(back).items():
        np.testing.assert_array_equal(v, flat2[k], err_msg=k)


def test_sync_census(run):
    """One gather, reduction and scatter a leaf; bytes of the whole state
    in and out, every group's f32 gradient over the wire."""
    c, st = run["census"], run["st_a"]
    leaves = rules.tree_items(st.params)
    nbytes = sum(int(np.prod(p.shape)) * 4 for _, p in leaves)
    assert c == {"gathers": len(leaves), "gather_bytes": nbytes,
                 "reductions": len(leaves), "reduction_bytes": 4 * nbytes,
                 "scatters": len(leaves), "scatter_bytes": nbytes,
                 "broadcasts": 0}
    assert ts.dp_groups(_mesh((4, 2))) == [torch.device("cpu")] * 4
    assert len(ts.dp_groups(_mesh((2, 2, 2)))) == 4


def test_compressed_step_halves_the_wire(run):
    """A bf16 sync moves half the bytes and changes the step's loss by
    nothing (the loss is taken before the sync)."""
    cfg = run["cfg"]
    batch = pipeline.SyntheticLM(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=1)).batch_at(0)
    mesh = _mesh((4, 2))
    st = ts.place_train_state(tf.params_from_numpy(
        run["p_np"], cfg, "cpu", trainable=True), mesh)
    ts.reset_sync_counts()
    st, m = ts.make_train_step(cfg, adamw.adamw(lr=LR), ce_chunk=CE_CHUNK,
                               mesh=mesh, compression="bf16")(st, batch)
    assert ts.sync_counts["reduction_bytes"] * 2 == \
        run["census"]["reduction_bytes"]
    assert float(m["loss"]) == float(run["ma"]["loss"])
    with pytest.raises(ValueError, match="mesh"):
        ts.make_train_step(cfg, adamw.adamw(lr=LR), compression="bf16")


@pytest.mark.parametrize("kind", [None, "bf16", "int8"])
def test_dp_sync_compression_toy(kind):
    """The reference's toy: a least-squares gradient on 8 ``data`` slots,
    each slot's gradient compressed before the wire, the mean within 0.02
    (relative) of the unsharded gradient."""
    groups = ts.dp_groups(make_mesh((8,), ("data",), devices="cpu"))
    w = torch.as_tensor(np.random.default_rng(0).normal(size=(16, 4)),
                        dtype=torch.float32)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(32, 16)),
                        dtype=torch.float32)
    y = torch.as_tensor(np.random.default_rng(2).normal(size=(32, 4)),
                        dtype=torch.float32)

    def grad(xs, ys):
        wr = w.clone().requires_grad_(True)
        torch.mean((xs @ wr - ys) ** 2).backward()
        return wr.grad

    n = 32 // len(groups)
    parts = ({"w": grad(x[g * n:(g + 1) * n], y[g * n:(g + 1) * n])}
             for g in range(len(groups)))
    residuals: dict = {}
    g_dp = ts.sync_mean(parts, "cpu", kind, residuals)["w"]
    g_ref = grad(x, y)
    err = float((g_dp - g_ref).abs().max()) / (float(g_ref.abs().max())
                                               + 1e-9)
    assert err < (1e-6 if kind is None else 0.02), err
    assert len(residuals) == 8
    if kind == "int8":      # error feedback: the residual is what was lost
        assert all(float(r.error["w"].abs().max()) > 0
                   for r in residuals.values())
