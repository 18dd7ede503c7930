"""The language-model cell on the CPU at the port's Hymba SMOKE sizes: the
plain reference against the port's prefill, whole runs of the cell past
the look for a card (a sound run is correct; the control and each fault
planted in the timed path are not), the work ``prefill_mfu`` counts, and
the reference's imports."""
import ast
import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

from portbench import harness, lm_work
from portbench.drivers import prefill as prefill_driver
from portbench.reference import hymba

HERE = Path(__file__).resolve().parents[1]
CELL = "hymba_1_5b.prefill"

def full_config() -> dict:
    return json.loads((HERE / "configs" / "hymba_1_5b.json").read_text())


#: the configuration's numbers at ``configs/hymba_1_5b.SMOKE``'s sizes
SMOKE = {"hidden_size": 64, "num_hidden_layers": 2,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "intermediate_size": 128, "vocab_size": 256, "attn_window_size": 16,
         "global_attn_idx": [1], "mamba_d_state": 4, "mamba_dt_rank": 4,
         "compute_dtype": "float32",
         "port": dict(full_config()["port"],
                      values={"local_global_period": 2})}
#: two lengths, past the 16-token window, one past the attention's
#: 128-query chunk; 3 and 5 prompts a call
MIX = {"classes": [{"name": "long", "prompt_len": 160},
                   {"name": "short", "prompt_len": 96}],
       "call_tokens": 480, "bank": 2}


def smoke_config() -> dict:
    return dict(full_config(), **SMOKE)


def test_port_config_is_the_ports_hymba_at_both_sizes():
    """The configuration's numbers, mapped onto the port's ModelConfig,
    give the port's own Hymba-1.5B (its dt rank 0 means ceil(1600 / 16) =
    100) and, at SMOKE's numbers, its SMOKE."""
    from repro_torch.configs import hymba_1_5b
    cfg = prefill_driver.port_config(full_config())
    want = hymba_1_5b.CONFIG
    assert cfg == dataclasses.replace(
        want, ssm=dataclasses.replace(want.ssm, dt_rank=100))
    small = prefill_driver.port_config(smoke_config())
    want = hymba_1_5b.SMOKE
    assert small == dataclasses.replace(
        want, name=cfg.name, ssm=dataclasses.replace(want.ssm, dt_rank=4))


def test_reference_matches_the_ports_prefill_at_smoke():
    """Last logits of the port's prefill (``serve_step.make_prefill``, the
    SMOKE model in float32) against the reference on the same seeded
    weights: within 1e-4 of the largest logit.  Both compute in float32;
    they differ only in the order of sums (the port's blocked window
    attention and chunked scan, the conv as a kernel's plain version
    against shifted adds), a few units in the last place a layer."""
    from repro_torch.configs import hymba_1_5b
    from repro_torch.models import transformer as tf
    from repro_torch.train.serve_step import make_prefill
    config = smoke_config()
    g = torch.Generator().manual_seed(11)
    w = hymba.init_weights(config, g, "cpu")
    model = tf.Transformer(hymba_1_5b.SMOKE, w["embed"].clone(),
                           ({k: ({kk: vv.clone() for kk, vv in v.items()}
                                 if isinstance(v, dict) else v.clone())
                             for k, v in layer.items()}
                            for layer in w["layers"]),
                           w["final_norm"].clone(), w["lm_head"].clone(),
                           device="cpu")
    tokens = torch.randint(0, 256, (3, 160), generator=g)
    with torch.no_grad():
        last, _ = make_prefill(hymba_1_5b.SMOKE, 160)(model, tokens)
    want = hymba.forward_last(config, w, tokens)
    err = ((last - want).abs().amax(-1) / want.abs().amax(-1)).max()
    assert err < 1e-4
    # the weights matter: other weights give other logits
    assert (want - hymba.forward_last(
        config, hymba.init_weights(config, torch.Generator().manual_seed(12),
                                   "cpu"), tokens)).abs().max() > 0.1


def test_reference_layers_follow_the_configured_pattern():
    config = full_config()
    globals_ = [i for i in range(32) if hymba.layer_is_global(config, i)]
    assert globals_ == [7, 15, 23, 31]
    assert prefill_driver.global_layers(
        prefill_driver.port_config(config)) == globals_
    assert config["published"]["global_attn_idx"] == [0, 15, 31]
    assert set(config["reduced"]) == set(config["published"]) == \
        set(config["departures"])


def test_driver_refuses_global_layers_the_port_does_not_run():
    cell = harness.load_cell(CELL, overrides={
        "config": dict(SMOKE, global_attn_idx=[0]), "mix": MIX})
    with pytest.raises(ValueError, match="global layers"):
        prefill_driver.System(cell, torch.device("cpu"))


def test_weights_drawn_again_from_the_seed_are_the_same():
    """What ``checks`` relies on: a second draw from the same seed gives
    the weights the program was built from, in the compute dtype."""
    def draw(config):
        g = torch.Generator().manual_seed(2 ** 40 + 3)
        return hymba.init_weights(config, g, "cpu")
    config = dict(smoke_config(), compute_dtype="bfloat16")
    a, b = draw(config), draw(config)
    assert a["embed"].dtype == a["layers"][1]["ssm"]["a_log"].dtype == \
        torch.bfloat16
    for x, y in zip(a["layers"], b["layers"]):
        for k in ("attn", "ssm", "ffn"):
            for kk in x[k]:
                assert torch.equal(x[k][kk], y[k][kk]), (k, kk)
    assert torch.equal(a["lm_head"], b["lm_head"])


def test_reference_scan_is_the_recurrence_step_by_step():
    g = torch.Generator().manual_seed(3)
    b, t, di, n = 2, 150, 5, 3
    dt = torch.rand((b, t, di), generator=g)
    u = torch.randn((b, t, di), generator=g)
    bm, cm = torch.randn((2, b, t, n), generator=g)
    a = -torch.rand((di, n), generator=g)
    h = torch.zeros((b, di, n))
    ys = []
    for i in range(t):
        h = torch.exp(dt[:, i, :, None] * a) * h \
            + u[:, i, :, None] * bm[:, i, None, :]
        ys.append((h * cm[:, i, None, :]).sum(-1))
    torch.testing.assert_close(hymba._scan(dt, u, bm, cm, a),
                               torch.stack(ys, 1), rtol=1e-5, atol=1e-5)


def test_fp8_round_keeps_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.1, -3.3, 448.0, 0.0])
    y = hymba.fp8_round(x)
    assert y[0] == 1.0 and y[4] == 448.0 and y[5] == 0.0
    assert y[1] in (1.0, 1.125) and y[2] == 1.125 and y[3] == -3.25


# -- whole runs of the cell past the look for a card --

def run(*, control=None, trace=False, seed=2 ** 40 + 7, seconds=0.4):
    cell = harness.load_cell(CELL, overrides={"config": SMOKE, "mix": MIX})
    return harness.run_cell(cell, seed, seconds, trace,
                            device=torch.device("cpu"),
                            t0=time.perf_counter(), control=control)


def test_sound_run_is_correct():
    r = run()
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    info = r["info"]
    # the calls alternate 3 x 160 and 5 x 96; 3 kept calls checked
    assert info["tokens"] == 480 * info["calls"]
    assert r["attempted"] == 3 * (info["calls"] - info["calls"] // 2) \
        + 5 * (info["calls"] // 2)
    # every prompt of each kept call: 3 in the even calls, 5 in the odd
    kept = json.loads(info["checked_calls"])
    assert 0 in kept and info["calls"] - 1 in kept
    assert info["prompts_checked"] == sum(5 if i % 2 else 3 for i in kept)
    m = r["metrics"]
    assert set(m) == {"lm_tokens_per_s", "setup_s"}
    assert m["lm_tokens_per_s"]["unit"] == "tokens/s"
    assert list(r)[-1] == "checks"
    json.loads(json.dumps(r))


def test_traced_run_reports_no_end_to_end_metric():
    # long enough for calls before, in and after the profiled sub-window
    r = run(trace=True, seconds=1.5)
    assert r["correct"] is True
    assert not {"lm_tokens_per_s", "setup_s"} & set(r["metrics"])
    # off the card no device op is traced and no peak is known: each
    # per-layer reader finds nothing and leaves its metric out
    assert r["metrics"] == {}
    assert r["device"]["window_s"] > 0
    # the sub-window's calls are not among those outside it
    info = r["info"]
    assert 0 < info["unprofiled_flops"] < info["flops"]
    assert info["unprofiled_s"] > 0


def test_control_in_fp8_is_not_correct():
    r = run(control="fp8")
    assert r["correct"] is False
    assert r["checks"]["max_rel_logit_err"]["value"] > \
        r["checks"]["max_rel_logit_err"]["limit"]


def _plant(monkeypatch, fault):
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.train import serve_step
    if fault == "no_ssm_heads":
        def no_ssm(p, x, cfg, state=None):
            return torch.zeros_like(x), state
        monkeypatch.setattr(ssm_mod, "ssm_forward", no_ssm)
        return
    real = serve_step.make_prefill

    def broken(cfg, max_len, mesh=None):
        step = real(cfg, max_len, mesh)

        def fn(model, tokens, **kw):
            if fault == "half_batch":     # the first half, repeated
                half = tokens.shape[0] // 2 or 1
                last, state = step(model, tokens[:half], **kw)
                return last.repeat(-(-tokens.shape[0] // half), 1)[
                    :tokens.shape[0]], state
            last, state = step(model, tokens, **kw)
            last = last.clone()
            last[-1, 7] += last.abs().max()
            return last, state
        return fn
    monkeypatch.setattr(serve_step, "make_prefill", broken)


@pytest.mark.parametrize("fault", ["no_ssm_heads", "half_batch", "altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _plant(monkeypatch, fault)
    r = run()
    assert r["correct"] is False, r["checks"]


# -- the work prefill_mfu counts --

def test_prefill_flops_by_hand_at_smoke():
    """3 prompts of 160 tokens at SMOKE (D 64, 4 heads and 2 KV heads of
    16, FF 128, DI 128, N 4, W 4, R 4, V 256; layer 0 windowed at 16,
    layer 1 global).  A token's products in one layer: attention 2*64*128
    + 2*64*64 = 24,576; the SSM's projections 2*64*256 + 2*128*12 +
    2*4*128 + 2*128*64 = 53,248, its conv and recurrence 2*4*128 +
    6*128*4 = 4,096; the MLP 6*64*128 = 49,152: 131,072 in all, over 2
    layers and 480 tokens 125,829,120.  Attention pairs a head: 16*17/2 +
    144*16 = 2,440 windowed, 160*161/2 = 12,880 global, each 4*16 flops,
    3 prompts, 4 heads: 11,765,760.  The head at the last positions:
    2*3*64*256 = 98,304."""
    assert lm_work.prefill_flops(smoke_config(), 3, 160) == \
        125_829_120 + 11_765_760 + 98_304


@pytest.mark.parametrize("seq, window", [(1, None), (7, None), (7, 3),
                                         (20, 20), (20, 25), (33, 8)])
def test_keys_attended_counts_the_mask(seq, window):
    pos = torch.arange(seq)
    keep = pos[None, :] <= pos[:, None]
    if window is not None:
        keep &= pos[None, :] > pos[:, None] - window
    assert lm_work.keys_attended(seq, window) == int(keep.sum())


@pytest.mark.parametrize("batch, seq", [(36, 1020), (24, 1500)])
def test_full_size_prefill_is_about_three_gflop_a_token(batch, seq):
    per_token = lm_work.prefill_flops(full_config(), batch, seq) \
        / (batch * seq)
    assert 3.1e9 < per_token < 3.4e9


def test_classes_take_turns_in_every_seed():
    cell = harness.load_cell(CELL, overrides={"config": SMOKE, "mix": MIX})
    orders = []
    for seed in (1, 2 ** 40 + 7, 2 ** 31 + 5):
        system = prefill_driver.System(cell, torch.device("cpu"))
        system.inputs(seed)
        lens = [system.bank[i].shape[1] for i in system.order]
        assert lens == [160, 96] * MIX["bank"]
        orders.append(system.order)
    assert sorted(orders[0]) == list(range(2 * MIX["bank"]))


def test_mix_calls_hold_the_token_budget():
    mix = json.loads((HERE / "traffic" / "prefill.json").read_text())
    shapes = [(mix["call_tokens"] // c["prompt_len"], c["prompt_len"])
              for c in mix["classes"]]
    assert shapes == [(36, 1020), (24, 1500)]
    for b, n in shapes:
        assert mix["call_tokens"] - n < b * n <= mix["call_tokens"]
        assert b >= mix["check"]["prompts"]


def test_lm_readers():
    cell = harness.load_cell(CELL)
    record = harness.RunRecord(cell=cell, calls=10, window_s=2.0,
                               setup_s=9.0)
    record.tokens = 10 * 12288.0
    assert harness.read_metrics(record, cell.end_to_end) == {
        "lm_tokens_per_s": {"value": 61440.0, "unit": "tokens/s"},
        "setup_s": {"value": 9.0, "unit": "s"}}
    assert harness.read_metrics(record, cell.per_layer) == {}
    # the share reads the flops and seconds outside the sub-window, and
    # only where the card's peak is known
    record.unprofiled_flops, record.unprofiled_s = 4e14, 1.6
    assert harness.read_metrics(record, cell.per_layer) == {}
    record.flops_peak = 1e15
    assert set(harness.read_metrics(record, cell.per_layer)) == \
        {"prefill_mfu"}
    from portbench import timeline
    record.trace = timeline.DeviceTrace(
        window_s=1.0, busy_s=0.75, device_s=0.8, kernel_s=0.0, h2d_s=0.0,
        ops=[], gaps=[], n_device_ops=30720)
    record.sub = {"calls": 1, "tokens": 12288}
    got = harness.read_metrics(record, cell.per_layer)
    assert got == {
        "prefill_mfu": {"value": pytest.approx(25.0), "unit": "%"},
        "kernels_per_token": {"value": 2.5, "unit": "count"}}


# -- imports --

def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_the_reference_imports_nothing_of_the_program():
    names = _imported(HERE / "reference" / "hymba.py")
    assert names == {"__future__", "math", "torch", "torch.nn.functional"}
