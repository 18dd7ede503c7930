"""The port's sharding rules (``sharding/rules.py``) and placement against
the JAX package's ``repro.sharding.rules``.

The reference's divisibility cases
(``tests/test_multidevice.py::test_sharding_rules_divisibility``) on a
4x2 mesh of CPU slots; then, for all ten architectures at their full
configs, every leaf's spec from ``param_shardings``, ``cache_shardings``
and ``batch_shardings`` equal to the JAX package's on the meshes (4, 2),
(2, 2, 2), (16, 16) and (2, 16, 16).  The JAX side needs no devices:
``jax.sharding.AbstractMesh`` and ``jax.eval_shape`` give its specs; the
port's trees are built on the ``meta`` device.  Specs compare as tuples
(``PartitionSpec`` is one), so ``P("data", None) != P("data")`` on both
sides.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import get_config as jax_get_config
from repro.launch import input_specs as jax_specs
from repro.models import transformer as jax_tf
from repro.sharding import rules as jax_rules
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.launch import input_specs
from repro_torch.launch.cells import _cache_shardings, _state_shardings
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as tf
from repro_torch.sharding import placement, rules
from repro_torch.sharding.placement import P
from repro_torch.train import train_step as ts

MESHES = {(4, 2): ("data", "model"), (2, 2, 2): ("pod", "data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


def test_sharding_rules_divisibility():
    mesh = make_mesh((4, 2), ("data", "model"), devices="cpu")
    # divisible: sharded; non-divisible: dropped
    assert rules.resolve_axis("tp", mesh, 8) == "model"
    assert rules.resolve_axis("tp", mesh, 7) is None
    assert rules.resolve_axis("dp", mesh, 8) == "data"
    assert rules.resolve_axis("dp", mesh, 2) is None
    assert rules.maybe_spec(mesh, (16, 6), ("fsdp", "tp")) == \
        P("data", "model")
    assert rules.maybe_spec(mesh, (3, 6), ("fsdp", "tp")) == P(None, "model")
    # each mesh axis once: expert and tp collide on "model"
    assert rules.maybe_spec(mesh, (8, 4, 6), ("expert", "fsdp", "tp")) == \
        P("model", "data", None)
    mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"), devices="cpu")
    assert rules.maybe_spec(mesh3, (8, 6), ("fsdp", "tp")) == \
        P(("pod", "data"), "model")
    assert rules.maybe_spec(mesh3, (6, 6), ("fsdp", "tp")) == \
        P("pod", "model")
    with pytest.raises(ValueError, match="logical spec"):
        rules.maybe_spec(mesh, (3, 6), ("fsdp",))


def test_shard_constraint_counts_and_axis_size():
    x = torch.zeros(4, 6)
    mesh = make_mesh((4, 2), ("data", "model"), devices="cpu")
    rules.reset_constraint_counts()
    assert rules.shard(x, "dp", "tp") is x          # no mesh: a no-op
    assert rules.constraint_counts == {} and rules.axis_size("tp") == 1
    with rules.activate(mesh):
        assert rules.current_mesh() is mesh and rules.axis_size("dp") == 4
        assert rules.shard(x, "dp", "tp") is x
        with pytest.raises(ValueError):
            rules.shard(x, "dp")                     # the wrong rank
    assert rules.current_mesh() is None
    (site, n), = rules.constraint_counts.items()
    assert site.startswith("test_torch_sharding_rules.py:") and n == 1


def test_placement_round_trip_and_replicas():
    """Blocks of a spec that names several axes a dimension, replicas on
    one device shared, unshard and reshard back to the tensor."""
    x = torch.arange(8 * 6 * 5, dtype=torch.float32).reshape(8, 6, 5)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices="cpu")
    p = placement.place(x, mesh, P(("pod", "data"), "model"))
    assert p.shape == (8, 6, 5) and p.local_shape == (2, 3, 5)
    assert p.blocks[1, 0, 1] is not p.blocks[0, 1, 1]
    assert torch.equal(p.blocks[1, 0, 1], x[4:6, 3:6])
    rep = placement.place(x, mesh, P(None, "model"))    # pod, data replicate
    assert rep.blocks[0, 0, 1] is rep.blocks[1, 1, 1]
    assert len(list(rep.unique_blocks())) == 2
    assert torch.equal(placement.unshard(p), x)
    other = make_mesh((4, 2), ("data", "model"), devices="cpu")
    q = placement.NamedPlacement(other, P(None, "model")).place(p)
    assert q.local_shape == (8, 3, 5) and torch.equal(q.unshard(), x)
    assert q.spec == P(None, "model", None)
    with pytest.raises(ValueError, match="not divisible"):
        placement.place(x, mesh, P("model", ("pod", "data")))
    z = placement.zeros((8, 6), mesh, P("data"))
    assert z.local_shape == (4, 6) and not z.unshard().any()


# ---------------------------------------------------------------------------
# Every leaf of the ten architectures, full size, against the JAX package
# ---------------------------------------------------------------------------

def _jax_key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx",
                                                  getattr(k, "name", k))))
                    for k in path)


def _jax_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {_jax_key(p): tuple(s.spec) for p, s in flat}


def _port_specs(tree) -> dict:
    return {k: tuple(s.spec) for k, s in rules.tree_items(tree)}


@functools.lru_cache(maxsize=None)
def _jax_trees(arch):
    cfg = jax_get_config(arch)
    params = jax.eval_shape(lambda: jax_tf.init_params(
        jax.random.PRNGKey(0), cfg))
    caches = [jax.eval_shape(lambda b=b, s=s: jax_tf.init_caches(cfg, b, s))
              for b, s in ((8, 1024), (1, 4096))]
    batches = (jax_specs.train_batch_specs(cfg, 16, 1024),
               jax_specs.prefill_specs(cfg, 1, 4096))
    return params, caches, batches


@functools.lru_cache(maxsize=None)
def _port_trees(arch):
    cfg = get_config(arch)
    model = tf.init_params(cfg, torch.Generator(), "meta", trainable=True)
    state = ts.state_tree(ts.TrainState(
        params=model, opt=ts.AdamWState(
            step=torch.zeros((), dtype=torch.int32, device="meta"),
            mu=dict(model.named_parameters()),
            nu=dict(model.named_parameters())),
        step=torch.zeros((), dtype=torch.int32, device="meta")))
    caches = [tf.stack_caches(cfg, tf.init_caches(cfg, b, s, "meta"))
              for b, s in ((8, 1024), (1, 4096))]
    batches = (input_specs.train_batch_specs(cfg, 16, 1024),
               input_specs.prefill_specs(cfg, 1, 4096))
    return state, caches, batches


@pytest.mark.parametrize("shape", list(MESHES),
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_match_reference_full_size(arch, shape):
    shape = tuple(shape)
    names = MESHES[shape]
    jmesh = AbstractMesh(shape, names)
    mesh = make_mesh(shape, names, devices="cpu")
    jparams, jcaches, jbatches = _jax_trees(arch)
    state, caches, batches = _port_trees(arch)

    want = _jax_specs(jax_rules.param_shardings(jmesh, jparams))
    sh = _state_shardings(mesh, state)
    assert _port_specs(sh["params"]) == want
    assert _port_specs(sh["opt"]["mu"]) == want
    assert sh["step"].spec == P() and sh["opt"]["step"].spec == P()

    for jc, pc, seq in zip(jcaches, caches, (False, True)):
        want = _jax_specs(jax_rules.cache_shardings(jmesh, jc,
                                                    seq_axis_shard=seq))
        got = _port_specs(_cache_shardings(mesh, pc, seq))
        assert got == want, seq
        shapes = {k: tuple(v.shape) for k, v in rules.tree_items(pc)}
        assert shapes == {_jax_key(p): tuple(v.shape) for p, v in
                          jax.tree_util.tree_flatten_with_path(jc)[0]}

    for jb, pb, seq in zip(jbatches, batches, (False, True)):
        want = {k: tuple(v.spec) for k, v in jax_rules.batch_shardings(
            jmesh, jb, seq_shard=seq).items()}
        got = {k: tuple(v.spec) for k, v in rules.batch_shardings(
            mesh, pb, seq_shard=seq).items()}
        assert got == want


def test_port_param_tree_paths_match_reference():
    """The port's state tree names every leaf as the reference's does
    (the rules key on these paths)."""
    for arch in ARCH_IDS:
        jparams, _, _ = _jax_trees(arch)
        state, _, _ = _port_trees(arch)
        want = {_jax_key(p): tuple(v.shape) for p, v in
                jax.tree_util.tree_flatten_with_path(jparams)[0]}
        got = {k: tuple(v.shape) for k, v in
               rules.tree_items(state["params"])}
        assert got == want, arch
