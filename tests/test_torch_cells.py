"""The port's cell builder (``launch/cells.py``) and mesh serve steps
against the JAX package's ``repro.launch.cells``.

``MODEL_FLOPS`` equals the reference's for every architecture and cell;
every leaf of ``build_cell(...).args`` has the reference's shape and
dtype, and every placement spec the reference's, for all ten
architectures at full size on the production meshes 16x16 and 2x16x16.
The JAX side needs no devices: ``jax.sharding.AbstractMesh`` gives its
shardings and ``jax.eval_shape`` its argument shapes; the port's
arguments are ``meta`` tensors.  Then the mesh prefill and decode steps
(``train/serve_step.py`` with ``mesh=``) on a 4x2 mesh of CPU slots
against one device, and against the JAX package's prefill and decode
steps jitted with the same shardings on 8 fake CPU devices (the JAX
weights carried across); and the one-device steps unchanged.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import get_smoke_config as jax_get_smoke_config
from repro.configs.base import SHAPE_CELLS as JAX_SHAPE_CELLS
from repro.launch import cells as jax_cells
from repro.models import transformer as jax_tf
from repro_torch.configs.base import (ARCH_IDS, SHAPE_CELLS, cells_for,
                                      get_config, get_smoke_config)
from repro_torch.launch import cells, input_specs, serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.sharding import rules
from repro_torch.train import serve_step as ss
from repro_torch.train import train_step as ts
from test_multidevice import run_with_devices

torch.set_num_threads(2)

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for cell in cells_for(arch):
        assert cells.MODEL_FLOPS(cfg, SHAPE_CELLS[cell]) == \
            jax_cells.MODEL_FLOPS(jcfg, JAX_SHAPE_CELLS[cell]), cell


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx",
                                                  getattr(k, "name", k))))
                    for k in path)


def _jax_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_key(p): (tuple(v.shape), str(v.dtype)) for p, v in flat}


def _jax_specs(tree):
    if tree is None:
        return None
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding) or x is None)[0]
    return {_key(p): None if s is None else tuple(s.spec) for p, s in flat}


def _port_leaves(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in rules.tree_items(tree)}


def _port_specs(tree):
    if tree is None:
        return None
    out = {k: tuple(s.spec) for k, s in rules.tree_items(tree)}
    # an output left to the step: (state placement, None)
    out.update({str(i): None for i, s in enumerate(tree) if s is None})
    return out


@pytest.mark.parametrize("shape", list(MESHES),
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_cell_matches_reference_full_size(arch, shape):
    names = MESHES[shape]
    jmesh = AbstractMesh(shape, names)
    mesh = make_mesh(shape, names, devices="meta")
    for cell in cells_for(arch):
        want = jax_cells.build_cell(arch, cell, jmesh)
        got = cells.build_cell(arch, cell, mesh)
        assert got.meta == want.meta and got.donate == want.donate
        assert _port_leaves(got.args) == _jax_leaves(want.args), cell
        for mine, theirs in ((got.in_shardings, want.in_shardings),
                             (got.out_shardings, want.out_shardings)):
            assert _port_specs(mine) == _jax_specs(theirs), cell
        assert all(v.device.type == "meta"
                   for _, v in rules.tree_items(got.args)
                   if v.ndim > 1), cell


# ---------------------------------------------------------------------------
# The mesh serve steps at SMOKE
# ---------------------------------------------------------------------------

MESH_ARCHS = ["tinyllama_1_1b", "qwen3_moe_30b_a3b", "rwkv6_1_6b"]


@functools.lru_cache(maxsize=None)
def _f32_model(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    return cfg, tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                               trainable=True)


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_prefill_and_decode_equal_one_device(arch):
    """Four dp groups, each its MLP (and MoE experts) split over two
    model slots, against one device: within 1e-5 of max|logits|."""
    cfg, model = _f32_model(arch)
    mesh = make_mesh((4, 2), ("data", "model"), devices="cpu")
    batch = input_specs.sample_from_specs(
        input_specs.prefill_specs(cfg, 8, 16), cfg, seed=1)
    params = ss.place_params(model, mesh)
    one = (ss.make_prefill(cfg, 24), ss.make_decode_step(cfg))
    many = (ss.make_prefill(cfg, 24, mesh=mesh),
            ss.make_decode_step(cfg, mesh=mesh))
    ts.reset_sync_counts()
    rules.reset_tp_counts()
    with torch.no_grad():
        a, sa = one[0](model, batch["tokens"])
        b, sb = many[0](params, batch["tokens"])
        outs = [(a, b)]
        for _ in range(4):
            tok = ss.pick(cfg, a)
            a, sa = one[1](model, sa, tok)
            b, sb = many[1](params, sb, tok)
            outs.append((a, b))
    for a, b in outs:
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
    assert len(sb.caches) == 4 and sb.length == sa.length == 20
    # one gather of every leaf a call; the dense MLP split over model in
    # every group, layer and call
    leaves = len(rules.tree_items(params))
    assert ts.sync_counts["gathers"] == 5 * leaves
    if arch == "tinyllama_1_1b":
        assert rules.tp_counts["mlp"]["splits"] == 5 * 4 * cfg.num_layers


def test_mesh_prefill_and_decode_equal_reference_gspmd(tmp_path):
    """The mesh prefill of 8 x 16 tokens and 4 greedy decode steps on 4x2
    CPU slots against the JAX package's steps jitted with the rules'
    shardings (parameters, batch, caches) on a 4x2 mesh of 8 fake CPU
    devices, the JAX weights carried across, f32: logits within 1e-5 of
    max|logits|, the same greedy tokens."""
    tokens = np.random.default_rng(5).integers(0, 256, size=(8, 16))
    np.save(tmp_path / "tokens.npy", tokens)
    out = run_with_devices(f"""
        import dataclasses
        import jax
        import jax.numpy as jnp
        import numpy as np
        from repro.configs.base import get_smoke_config
        from repro.launch.cells import _cache_shardings, _replicated
        from repro.launch.mesh import make_mesh
        from repro.models import transformer as tf
        from repro.sharding import rules
        from repro.train.serve_step import (ServeState, make_decode_step,
                                            make_prefill)
        mesh = make_mesh((4, 2), ("data", "model"))
        res = {{}}
        for arch in {MESH_ARCHS!r}:
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      compute_dtype="float32")
            tokens = jnp.asarray(np.load({str(tmp_path / "tokens.npy")!r})
                                 % cfg.vocab_size, jnp.int32)
            params = tf.init_params(jax.random.PRNGKey(0), cfg)
            psh = rules.param_shardings(mesh, jax.eval_shape(lambda: params))
            tsh = rules.batch_shardings(mesh, {{"token": jax.ShapeDtypeStruct(
                (8, 1), jnp.int32)}})["token"]
            ssh = ServeState(
                caches=_cache_shardings(mesh, jax.eval_shape(
                    lambda: tf.init_caches(cfg, 8, 24)), False),
                length=_replicated(mesh))
            with rules.activate(mesh):
                prefill = jax.jit(make_prefill(cfg, 24), in_shardings=(
                    psh, rules.batch_shardings(mesh, {{"tokens": jax.eval_shape(
                        lambda: tokens)}})["tokens"]))
                decode = jax.jit(make_decode_step(cfg),
                                 in_shardings=(psh, ssh, tsh))
                params = jax.device_put(params, psh)
                last, state = prefill(params, tokens)
                logits, picks = [np.asarray(last)], []
                for _ in range(4):
                    tok = jnp.argmax(last, axis=-1)[:, None].astype(
                        jnp.int32)
                    picks.append(np.asarray(tok))
                    last, state = decode(params, jax.device_put(state, ssh),
                                         jax.device_put(tok, tsh))
                    logits.append(np.asarray(last))
            np.savez({str(tmp_path)!r} + "/" + arch + ".npz",
                     logits=np.stack(logits), picks=np.stack(picks))
        print("DONE")
    """, n=8, timeout=300)
    assert "DONE" in out
    mesh = make_mesh((4, 2), ("data", "model"), devices="cpu")
    for arch in MESH_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32")
        jcfg = dataclasses.replace(jax_get_smoke_config(arch),
                                   compute_dtype="float32")
        model = tf.params_from_numpy(jax.tree.map(
            np.asarray, jax_tf.init_params(jax.random.PRNGKey(0), jcfg)),
            cfg, "cpu")
        want = np.load(tmp_path / f"{arch}.npz")
        prompt = torch.as_tensor(tokens % cfg.vocab_size)
        params = ss.place_params(model, mesh)
        prefill = ss.make_prefill(cfg, 24, mesh=mesh)
        decode = ss.make_decode_step(cfg, mesh=mesh)
        with torch.no_grad():
            last, state = prefill(params, prompt)
            got = [last]
            for i in range(4):
                tok = ss.pick(cfg, last)
                np.testing.assert_array_equal(tok.numpy(), want["picks"][i],
                                              err_msg=arch)
                last, state = decode(params, state, tok)
                got.append(last)
        for i, (a, b) in enumerate(zip(want["logits"], got)):
            assert a.shape == tuple(b.shape), (arch, i)
            err = float(np.abs(b.numpy() - a).max())
            assert err <= 1e-5 * float(np.abs(a).max()), (arch, i, err)


def test_mesh_step_replicates_a_batch_that_does_not_split():
    cfg, model = _f32_model("tinyllama_1_1b")
    mesh = make_mesh((4, 1), ("data", "model"), devices="cpu")
    tokens = input_specs.sample_from_specs(
        input_specs.prefill_specs(cfg, 2, 8), cfg, seed=3)["tokens"]
    with torch.no_grad():
        a, _ = ss.make_prefill(cfg, 12)(model, tokens)
        b, sb = ss.make_prefill(cfg, 12, mesh=mesh)(
            ss.place_params(model, mesh), tokens)
    assert ss.serving_groups(mesh, 2) == 1 and len(sb.caches) == 1
    assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "qwen3_moe_30b_a3b"])
def test_one_device_steps_unchanged(arch):
    """Without ``mesh=`` the steps are the one-device ones: bit-identical
    to the serving launcher's run of the same model and prompt."""
    cfg = get_smoke_config(arch)
    model = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = input_specs.sample_from_specs(
        input_specs.prefill_specs(cfg, 2, 12), cfg, seed=2)["tokens"]
    ref = serve.serve(model, tokens, 3)
    with torch.no_grad():
        last, state = ss.make_prefill(cfg, 16, mesh=None)(model, tokens)
        got = [last]
        for _ in range(3):
            last, state = ss.make_decode_step(cfg, mesh=None)(
                model, state, ss.pick(cfg, last))
            got.append(last)
    for a, b in zip(got, ref["logits"]):
        assert torch.equal(a, b)


def test_moe_counts_equal_bincount_and_run_on_meta():
    """The routing's expert counts are ``torch.bincount``'s integers; on
    ``meta`` the dispatch sizes its buffers by the static capacity."""
    cfg = get_smoke_config("qwen3_moe_30b_a3b")
    gen = torch.Generator().manual_seed(4)
    p = moe.init_moe(gen, cfg.d_model, cfg.moe, "cpu")
    x = torch.randn(37, cfg.d_model, generator=gen)
    for dropless in (False, True):
        r = moe.route(x, p["router"], cfg.moe, dropless)
        assert torch.equal(r.counts, torch.bincount(
            r.experts.reshape(-1), minlength=cfg.moe.num_experts))
    meta = {k: v.to("meta") for k, v in p.items()}
    y = moe.moe_ffn(meta, x.to("meta").reshape(1, 37, -1), cfg.moe)
    assert y.y.shape == (1, 37, cfg.d_model) and y.y.device.type == "meta"
