"""MoE's expert-parallel branch (``models/moe.py``) on slots of the CPU.

Under ``sharding.rules.activate`` on a ``(1, model)`` mesh whose ``model``
extent divides the expert count, the tokens are routed once, model slot
``m`` runs its ``num_experts / model`` experts on its own device — its
own range of the weights, its buffer sized by its own experts' largest
count — and the partial outputs are summed in f32 (the reference's
``shard_map`` branch, ``src/repro/models/moe.py``).  Held against the
dense path (itself held against the JAX package by
``tests/test_torch_moe.py``) at Qwen3 and Granite SMOKE with ``model`` in
{2, 4}: y within 1e-5, the aux loss equal, the gradients within 1e-5,
and a whole train step's loss within 1e-5.  A mesh whose second slot is
the ``meta`` device shows each slot's work going to its own device.
Granite SMOKE's 4 experts on ``model = 8`` take the dense path.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.data import pipeline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.optim.adamw import adamw
from repro_torch.sharding import rules
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

ARCHS = ("qwen3_moe_30b_a3b", "granite_moe_3b_a800m")


def _mesh(tp):
    return make_mesh((1, tp), ("data", "model"), devices="cpu")


@pytest.fixture
def expert_calls(monkeypatch):
    """Each ``_experts`` call: its first expert, expert count, buffer rows,
    the device of its tokens and of its weights, and its weights' first
    element's address."""
    calls = []
    real = moe._experts

    def spy(xt, r, w, lo, keep, rows, act):
        calls.append(dict(lo=lo, n=w["wo"].shape[0], rows=rows,
                          device=xt.device, w_device=w["wo"].device,
                          w_ptr=w["wo"].data_ptr()))
        return real(xt, r, w, lo, keep, rows, act)
    monkeypatch.setattr(moe, "_experts", spy)
    return calls


def _layer(arch, seed=0):
    cfg = get_smoke_config(arch)
    p = moe.init_moe(torch.Generator().manual_seed(seed), cfg.d_model,
                     cfg.moe, "cpu")
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    x = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(2, 24, cfg.d_model)), dtype=torch.float32).requires_grad_(True)
    return cfg, p, x


def _run(cfg, p, x, dropless):
    out = moe.moe_ffn(p, x, cfg.moe, cfg.mlp_act, dropless=dropless)
    r = torch.as_tensor(np.random.default_rng(9).normal(size=x.shape),
                        dtype=torch.float32)
    grads = torch.autograd.grad((out.y * r).sum() + out.aux_loss,
                                [x] + list(p.values()))
    return out, grads


def _slot_rows(cfg, p, x, dropless, tp):
    """Each slot's buffer depth from the routing: its own experts' largest
    count, at most the capacity."""
    xt = x.detach().reshape(-1, x.shape[-1])
    r = moe.route(xt, p["router"].detach(), cfg.moe, dropless)
    n = cfg.moe.num_experts // tp
    return [min(r.cap, int(r.counts[m * n:(m + 1) * n].max()))
            for m in range(tp)]


@pytest.mark.parametrize("dropless", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_matches_dense(arch, tp, dropless, expert_calls):
    cfg, p, x = _layer(arch)
    dense, dgrads = _run(cfg, p, x, dropless)
    assert [(c["lo"], c["n"]) for c in expert_calls] == \
        [(0, cfg.moe.num_experts)]
    expert_calls.clear()
    with rules.activate(_mesh(tp)):
        ep, egrads = _run(cfg, p, x, dropless)
    e_loc = cfg.moe.num_experts // tp
    assert [(c["lo"], c["n"]) for c in expert_calls] == \
        [(m * e_loc, e_loc) for m in range(tp)]
    assert [c["rows"] for c in expert_calls] == \
        _slot_rows(cfg, p, x, dropless, tp)
    # slot m's weights are its own experts' range of the parameters
    assert [c["w_ptr"] for c in expert_calls] == \
        [p["wo"][m * e_loc].data_ptr() for m in range(tp)]
    assert float((ep.y - dense.y).detach().abs().max()) < 1e-5
    assert torch.equal(ep.aux_loss, dense.aux_loss)
    for a, b in zip(egrads, dgrads):
        assert float((a - b).abs().max()) < 1e-5


def test_each_model_slot_runs_on_its_own_device(expert_calls):
    """A (1, 2) mesh whose second slot is the ``meta`` device: slot 0's
    experts run on the CPU beside the tokens, slot 1's tokens and weights
    go to ``meta``, and bringing its partial output back fails there (a
    meta tensor holds no data)."""
    cfg, p, x = _layer("qwen3_moe_30b_a3b")
    mesh = make_mesh((1, 2), ("data", "model"), devices=["cpu", "meta"])
    with rules.activate(mesh), pytest.raises(NotImplementedError,
                                             match="meta"):
        moe.moe_ffn(p, x, cfg.moe, cfg.mlp_act)
    assert [(c["device"].type, c["w_device"].type) for c in expert_calls] \
        == [("cpu", "cpu"), ("meta", "meta")]


def test_model_devices_follow_the_active_group():
    """``activate(mesh, group=g)`` selects dp group ``g``'s ``model``
    slots (the train step sets it per group)."""
    mesh = make_mesh((2, 2), ("data", "model"),
                     devices=[f"cpu:{i}" for i in range(4)])
    for g in range(2):
        with rules.activate(mesh, group=g):
            assert [d.index for d in rules.model_devices()] == \
                [2 * g, 2 * g + 1]
    assert [d.index for d in ts.dp_groups(mesh)] == [0, 2]


def test_granite_smoke_on_model_8_takes_the_dense_path(expert_calls):
    cfg, p, x = _layer("granite_moe_3b_a800m")
    dense = moe.moe_ffn(p, x, cfg.moe, cfg.mlp_act)
    with rules.activate(_mesh(8)):
        out = moe.moe_ffn(p, x, cfg.moe, cfg.mlp_act)
    assert [(c["lo"], c["n"]) for c in expert_calls] == [(0, 4), (0, 4)]
    assert torch.equal(out.y, dense.y)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_train_step_matches_one_device(arch, expert_calls):
    """One train step on a (1, 4) mesh — expert parallel in every MoE
    layer — against the dense path on one device, same weights."""
    cfg = get_smoke_config(arch)
    batch = pipeline.SyntheticLM(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
        seed=4)).batch_at(0)
    opt = adamw(lr=1e-3)
    one = ts.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                              device="cpu")
    _, m1 = ts.make_train_step(cfg, opt, ce_chunk=8)(one, batch)
    assert {c["n"] for c in expert_calls} == {cfg.moe.num_experts}
    expert_calls.clear()
    mesh = _mesh(4)
    st = ts.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                             mesh=mesh)
    _, m4 = ts.make_train_step(cfg, opt, ce_chunk=8, mesh=mesh)(st, batch)
    assert {c["n"] for c in expert_calls} == {cfg.moe.num_experts // 4}
    assert abs(float(m4["loss"]) - float(m1["loss"])) < 1e-5
    assert abs(float(m4["aux_loss"]) - float(m1["aux_loss"])) < 1e-6
    assert abs(float(m4["grad_norm"]) - float(m1["grad_norm"])) < \
        1e-5 * float(m1["grad_norm"])
