"""Tensor parallelism along ``model`` on slots of the CPU: the MLP's
``d_ff`` (``models/layers.py::mlp``), the attention heads
(``models/transformer.py::_self_attention`` through
``attention_chunked.head_slots``) and the cross-entropy's vocabulary
(``train/loss.py::_chunk_nll``), each split over the active group's
``model`` slots by ``sharding.rules.tp_slots``.

At SMOKE with the JAX package's weights carried across
(``params_from_numpy``):

* tinyllama on ``(4, 2)`` (the KV heads split) and ``(1, 8)`` (K/V
  repeated to one head a query head, then the heads split); Hymba (the
  SSM whole, attention and MLP split); gemma_2b (a tied ``(V, D)`` head,
  MQA through the repeat); and a Hymba SMOKE whose 5 heads, 1 KV head and
  257-token vocabulary do not divide ``model`` 2, as Hymba-1.5B's 25
  heads and 32001 tokens do not: its attention and cross-entropy run
  whole and count whole;
* each site under ``activate`` against the same call without a mesh at
  1e-5 (values and gradients);
* a whole train step's loss and gradient norm within 1e-4 relative of
  one device's, and of the JAX package's step sharded over 4x2 fake
  devices (a subprocess, as ``tests/test_multidevice.py`` runs it);
* ``rules.tp_counts`` exact for the step;
* a ``("cpu", "meta")`` ``model`` axis: slot 1's products run on
  ``meta`` and its partial cannot come back (a meta tensor holds no
  data), so the work leaves the group's device.

AdamW on a state whose blocks lie on two devices mixes no devices in one
operation (a ``TorchFunctionMode`` spy; CUDA refuses such an operation
across cards, 0-d tensors included), and stays bit-identical to the
plain sequential arithmetic on one device.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree

from repro.configs import base as ref_base
from repro.optim import adamw as ref_adamw
from repro.train import train_step as ref_ts

from repro_torch.configs import base
from repro_torch.data import pipeline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.layers import mlp
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.train import loss as loss_mod
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

SEQ, BATCH, CE_CHUNK, LR = 16, 4, 8, 1e-3
#: (config, mesh shape): the cases every check runs
CASES = (("tinyllama_1_1b", (4, 2)), ("tinyllama_1_1b", (1, 8)),
         ("hymba_1_5b", (4, 2)), ("gemma_2b", (4, 2)), ("fallback", (4, 2)))
#: Hymba SMOKE with heads and vocabulary that do not divide 2
FALLBACK = dict(num_heads=5, num_kv_heads=1, vocab_size=257)
_SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _configs(name):
    """(port config, reference config) of a case's config name."""
    if name == "fallback":
        return tuple(dataclasses.replace(b.get_smoke_config("hymba_1_5b"),
                                         **FALLBACK)
                     for b in (base, ref_base))
    return base.get_smoke_config(name), ref_base.get_smoke_config(name)


def _mesh(shape, devices="cpu"):
    return make_mesh(shape, ("data", "model"), devices=devices)


@pytest.fixture(scope="module")
def weights():
    """Each config's JAX SMOKE parameters (PRNGKey(0)) as numpy."""
    out = {}
    for name in dict(CASES):
        _, ref_cfg = _configs(name)
        state = ref_ts.init_train_state(jax.random.PRNGKey(0), ref_cfg,
                                        ref_adamw.adamw(lr=LR))
        out[name] = jax.tree.map(np.asarray, state.params)
    return out


def _model(weights, name):
    cfg, _ = _configs(name)
    return cfg, tf.params_from_numpy(weights[name], cfg, "cpu",
                                     trainable=True)


def _normal(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape),
                           dtype=torch.float32)


def _splits(cfg, tp) -> dict:
    """Whether each site splits over ``tp`` slots: the rules' decision,
    restated."""
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    return {"mlp": cfg.d_ff % tp == 0,
            "attention": kvh % tp == 0 or (h % tp == 0 and h // kvh <= 4),
            "cross_entropy": cfg.vocab_size % tp == 0}


def test_tp_slots_ranges_fallback_and_census():
    x = torch.zeros(())
    rules.reset_tp_counts()
    assert rules.tp_slots("s", 8) is None                 # no mesh
    with rules.activate(_mesh((8, 1))):                   # model extent 1
        assert rules.tp_slots("s", 8) is None
    assert rules.tp_counts == {}
    with rules.activate(_mesh((4, 2))):
        assert rules.tp_slots("s", 8, 10, 3) == [(x.device, 0, 4),
                                                 (x.device, 4, 8)]
        assert rules.tp_slots("s", 7, 10, 3) is None
        assert rules.tp_slots("s", None) is None
    assert rules.tp_counts == {"s": {"splits": 1, "whole": 2,
                                     "sent_bytes": 10, "returned_bytes": 3}}
    mesh = make_mesh((2, 2), ("data", "model"),
                     devices=["cpu", "meta", "cpu", "meta"])
    with rules.activate(mesh, group=1):
        assert [(d.type, lo, hi) for d, lo, hi in rules.tp_slots("s", 6)] \
            == [("cpu", 0, 3), ("meta", 3, 6)]
    rules.reset_tp_counts()


# ---------------------------------------------------------------------------
# Each site under activate against the same call without a mesh
# ---------------------------------------------------------------------------

def _site_call(site, cfg, model, seed):
    """``fn()`` runs the site on fresh leaf inputs and returns its output
    and the gradients of a random projection of it with respect to the
    inputs and the weights it reads."""
    if site == "mlp":
        layer = next(l for l in model.layers if hasattr(l, "ffn"))
        weights = list(layer.ffn.values())
        x = _normal((2, 24, cfg.d_model), seed)

        def run(x):
            return mlp(layer.ffn, x, cfg.mlp_act)
    elif site == "attention":
        # past q_chunk (128), through _dense_chunks or _banded_window
        layers = [l for l in model.layers if hasattr(l, "attn")]
        weights = [w for l in layers for w in l.attn.values()]
        x = _normal((2, 136, cfg.d_model), seed)
        pos = torch.arange(136)

        def run(x):
            return torch.stack([tf._self_attention(
                l.attn, x, cfg, pos, None, l.window, "train")[0]
                for l in layers])
    else:
        head = model.embed if cfg.tie_embeddings else model.lm_head
        weights = [head]
        x = _normal((2, 12, cfg.d_model), seed)
        lbl = torch.as_tensor(np.random.default_rng(seed + 1).integers(
            0, cfg.vocab_size, size=(2, 12)))
        m = torch.as_tensor(np.random.default_rng(seed + 2).integers(
            0, 2, size=(2, 12)), dtype=torch.float32)

        def run(x):
            nll, count = loss_mod._chunk_nll(x, head, lbl, m,
                                             cfg.tie_embeddings)
            return torch.stack([nll, count])

    def fn():
        xl = x.clone().requires_grad_(True)
        y = run(xl)
        r = _normal(y.shape, seed + 3)
        return y.detach(), torch.autograd.grad((y * r).sum(),
                                               [xl] + weights)
    return fn


@pytest.mark.parametrize("site", ["mlp", "attention", "cross_entropy"])
@pytest.mark.parametrize("name,shape", CASES)
def test_site_matches_the_call_without_a_mesh(weights, name, shape, site):
    cfg, model = _model(weights, name)
    fn = _site_call(site, cfg, model, seed=5)
    want, want_g = fn()
    rules.reset_tp_counts()
    with rules.activate(_mesh(shape)):
        got, got_g = fn()
    split = _splits(cfg, shape[1])[site]
    c = rules.tp_counts[site]
    assert (c["splits"] > 0, c["whole"] > 0) == (split, not split)
    assert float((got - want).abs().max()) <= 1e-5 * max(
        1.0, float(want.abs().max()))
    for a, b in zip(got_g, want_g):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))
    rules.reset_tp_counts()


def test_model_extent_1_changes_nothing(weights):
    """A mesh without a ``model`` split runs every site as without a mesh,
    bit for bit, and counts no split."""
    cfg, model = _model(weights, "tinyllama_1_1b")
    for site in ("mlp", "attention", "cross_entropy"):
        fn = _site_call(site, cfg, model, seed=7)
        want, want_g = fn()
        rules.reset_tp_counts()
        with rules.activate(_mesh((8, 1))):
            got, got_g = fn()
        assert rules.tp_counts == {}
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))


# ---------------------------------------------------------------------------
# The whole step: one device, the census, the JAX package's sharded step
# ---------------------------------------------------------------------------

def _batch(cfg, i=0):
    return pipeline.SyntheticLM(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=1)).batch_at(i)


@pytest.fixture(scope="module")
def steps(weights):
    """Each case's first step on one device and on its mesh, with the
    mesh step's ``tp_counts``."""
    out = {}
    opt = adamw.adamw(lr=LR)
    for name, shape in CASES:
        cfg, model = _model(weights, name)
        one = ts.TrainState(params=model,
                            opt=opt.init(dict(model.named_parameters())),
                            step=torch.zeros((), dtype=torch.int32))
        _, m1 = ts.make_train_step(cfg, opt, ce_chunk=CE_CHUNK)(
            one, _batch(cfg))
        mesh = _mesh(shape)
        st = ts.place_train_state(_model(weights, name)[1], mesh)
        rules.reset_tp_counts()
        _, mt = ts.make_train_step(cfg, opt, ce_chunk=CE_CHUNK, mesh=mesh)(
            st, _batch(cfg))
        out[(name, shape)] = (m1, mt, dict(rules.tp_counts))
    rules.reset_tp_counts()
    return out


@pytest.mark.parametrize("name,shape", CASES)
def test_step_matches_one_device(steps, name, shape):
    m1, mt, _ = steps[(name, shape)]
    l1, lt = float(m1["loss"]), float(mt["loss"])
    assert abs(lt - l1) <= 1e-4 * abs(l1), (lt, l1)
    n1, nt = float(m1["grad_norm"]), float(mt["grad_norm"])
    assert abs(nt - n1) <= 1e-4 * n1, (nt, n1)


@pytest.mark.parametrize("name,shape", CASES)
def test_step_census(steps, name, shape):
    """Every site once a layer (or CE chunk), group and pass — the
    forward and the remat recompute — split or whole as the rules
    decide; a split counts each slot after the first its activations in
    and its partial back."""
    cfg, _ = _configs(name)
    groups, tp = shape
    rows = (BATCH // groups) * SEQ              # a group's tokens
    chunks = -(-SEQ // CE_CHUNK)
    act = rows * cfg.d_model * 4                # f32 SMOKE compute
    per_call = {"mlp": (act, act), "attention": (act, act),
                "cross_entropy": ((rows // SEQ) * CE_CHUNK * (
                    cfg.d_model * 4 + 8), 2 * (rows // SEQ) * CE_CHUNK * 4)}
    calls = {"mlp": cfg.num_layers, "attention": cfg.num_layers,
             "cross_entropy": chunks}
    want = {}
    for site, split in _splits(cfg, tp).items():
        n = calls[site] * groups * 2
        sent, back = per_call[site] if split else (0, 0)
        want[site] = {"splits": n * split, "whole": n * (not split),
                      "sent_bytes": n * sent * (tp - 1),
                      "returned_bytes": n * back * (tp - 1)}
    assert steps[(name, shape)][2] == want
    if name == "fallback":
        assert want["mlp"]["splits"] and want["attention"]["whole"] and \
            want["cross_entropy"]["whole"]
    else:
        assert all(c["whole"] == 0 for c in want.values())


def test_step_matches_the_reference_sharded_step(steps):
    """The JAX package's step, jitted on a 4x2 mesh of 8 fake CPU devices
    under ``rules.activate`` (GSPMD's tensor parallelism), against the
    port's 4x2 step: loss and gradient norm within 1e-4 relative."""
    names = [n for n, s in CASES if s == (4, 2)]
    body = f"""
        import dataclasses, json
        import jax
        from repro.configs.base import get_smoke_config
        from repro.data.pipeline import DataConfig, SyntheticLM
        from repro.launch.cells import _state_shardings
        from repro.launch.mesh import make_mesh
        from repro.optim.adamw import adamw
        from repro.sharding import rules
        from repro.train.train_step import init_train_state, make_train_step

        mesh = make_mesh((4, 2), ("data", "model"))
        opt = adamw(lr={LR})
        out = {{}}
        for name in {names!r}:
            if name == "fallback":
                cfg = dataclasses.replace(get_smoke_config("hymba_1_5b"),
                                          **{FALLBACK!r})
            else:
                cfg = get_smoke_config(name)
            batch = SyntheticLM(DataConfig(
                vocab_size=cfg.vocab_size, seq_len={SEQ},
                global_batch={BATCH}, seed=1)).batch_at(0)
            state = init_train_state(jax.random.PRNGKey(0), cfg, opt)
            sh = _state_shardings(mesh, jax.eval_shape(lambda: state))
            bsh = rules.batch_shardings(mesh, jax.eval_shape(lambda: batch))
            with rules.activate(mesh):
                _, m = jax.jit(make_train_step(cfg, opt, ce_chunk={CE_CHUNK}),
                               in_shardings=(sh, bsh),
                               out_shardings=(sh, None))(
                    jax.device_put(state, sh), batch)
            out[name] = (float(m["loss"]), float(m["grad_norm"]))
        print("RESULT", json.dumps(out))
    """
    env = dict(os.environ, PYTHONPATH=_SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads(proc.stdout.split("RESULT", 1)[1])
    for name in names:
        _, mt, _ = steps[(name, (4, 2))]
        (lj, nj), lt, nt = ref[name], float(mt["loss"]), \
            float(mt["grad_norm"])
        assert abs(lt - lj) <= 1e-4 * abs(lj), (name, lt, lj)
        assert abs(nt - nj) <= 1e-4 * nj, (name, nt, nj)


# ---------------------------------------------------------------------------
# Slot 1's work leaves the group's device
# ---------------------------------------------------------------------------

class _ProductDevices(TorchFunctionMode):
    """Records the device of every matrix product."""

    def __init__(self):
        super().__init__()
        self.devices = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) in ("matmul", "einsum"):
            t = next(a for a in _pytree.tree_leaves(args)
                     if isinstance(a, torch.Tensor))
            self.devices.append(t.device.type)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("site", ["mlp", "attention", "cross_entropy"])
def test_each_model_slot_runs_on_its_own_device(weights, site):
    """A (1, 2) mesh whose second slot is the ``meta`` device: slot 0's
    products run on the CPU, slot 1's on ``meta``, and bringing slot 1's
    partial back fails there."""
    cfg, model = _model(weights, "tinyllama_1_1b")
    fn = _site_call(site, cfg, model, seed=9)
    spy = _ProductDevices()
    with rules.activate(_mesh((1, 2), ["cpu", "meta"])), spy, \
            pytest.raises(NotImplementedError, match="meta"):
        fn()
    assert spy.devices[0] == "cpu" and "meta" in spy.devices
    assert spy.devices[-1] == "meta"


# ---------------------------------------------------------------------------
# AdamW with blocks on two devices
# ---------------------------------------------------------------------------

class _OneDevicePerOp(TorchFunctionMode):
    """Fails an operation whose tensor arguments lie on more than one
    device.  A copy out of ``meta`` (no data there) gives zeros on the
    target, standing in for the transfer."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = [a for a in _pytree.tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor)]
        devices = {t.device for t in tensors}
        if len(devices) > 1:
            raise AssertionError(f"{func} mixes devices {devices}")
        if func is torch.Tensor.to and args[0].is_meta:
            rest = list(args[1:]) + list(kwargs.values())
            to = [torch.device(a) for a in rest
                  if isinstance(a, (str, torch.device))]
            if to and to[0].type != "meta":
                dtype = next((a for a in rest if isinstance(a, torch.dtype)),
                             args[0].dtype)
                return torch.zeros(args[0].shape, dtype=dtype, device=to[0])
        return func(*args, **kwargs)


def _blocks(devices):
    shapes = [(6, 4), (4,), (3, 5), (5,)]
    return {f"b{i}": _normal(s, i).to(d)
            for i, (s, d) in enumerate(zip(shapes, devices))}


@pytest.mark.parametrize("lr", [LR, adamw.cosine_schedule(LR, 1, 4)])
def test_adamw_mixes_no_devices(lr):
    """Blocks on the CPU and on ``meta`` (a second device): the update
    runs, no operation mixes the two, and the CPU blocks move."""
    devices = ["cpu", "meta", "cpu", "meta"]
    params = _blocks(devices)
    grads = {k: _normal(v.shape, 10 + i).to(v.device)
             for i, (k, v) in enumerate(params.items())}
    opt = adamw.adamw(lr=lr, clip_norm=1.0)
    state = opt.init(params)
    before = {k: v.clone() for k, v in params.items() if not v.is_meta}
    with _OneDevicePerOp():
        _, new, metrics = opt.update(grads, state, params)
    assert int(new.step) == 1 and metrics["grad_norm"].device.type == "cpu"
    for k, v in before.items():
        assert not torch.equal(params[k], v)
        assert params[k].device.type == "cpu"


def test_adamw_one_device_is_the_plain_arithmetic():
    """On one device the update equals, bit for bit, the reference's
    arithmetic written out leaf by leaf."""
    params = _blocks(["cpu"] * 4)
    grads = {k: _normal(v.shape, 20 + i) * 10
             for i, (k, v) in enumerate(params.items())}
    want = {k: v.clone() for k, v in params.items()}
    opt = adamw.adamw(lr=adamw.cosine_schedule(LR, 1, 4), clip_norm=1.0)
    state = opt.init(params)
    _, _, metrics = opt.update(grads, state, params)

    total = torch.zeros(())
    for k in sorted(grads):
        total = total + torch.sum(torch.square(grads[k]))
    norm = torch.sqrt(total)
    scale = torch.clamp(1.0 / (norm + 1e-9), max=1.0)
    step = torch.ones((), dtype=torch.int32)
    lr = opt.lr(step)
    stepf = step.to(torch.float32)
    bias1, bias2 = 1 - opt.b1 ** stepf, 1 - opt.b2 ** stepf
    for k in sorted(grads):
        g = grads[k] * scale
        m = (1 - opt.b1) * g
        v = (1 - opt.b2) * g * g
        delta = (m / bias1) / (torch.sqrt(v / bias2) + opt.eps)
        if want[k].ndim >= 2:
            delta = delta + opt.weight_decay * want[k]
        want[k] = want[k] - lr * delta
    assert torch.equal(metrics["grad_norm"], norm)
    for k in params:
        assert torch.equal(params[k], want[k]), k
