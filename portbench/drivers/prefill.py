"""Closed loop of prefill calls on the port's serving path: the function
``train/serve_step.make_prefill`` returns, which ``launch/serve.py``'s
``serve`` times, ``gen_len`` tokens out (0: the prefill alone).

The mix's ``classes`` each give a prompt length; the queue is grouped by
length, so a call holds prompts of one class, ``call_tokens //
prompt_len`` of them.  Set-up draws the model's weights from the seed on
the card in the type the serving build holds them in (the configuration's
reference's ``init_weights``), builds the port's model from them
(``models.transformer.Transformer``, its serving build) and lets the
drawn tensors go: the reference draws them again from the seed once the
program's state is freed.  It then draws a bank of ``bank`` batches of
each class, token ids uniform over the vocabulary, resident on the card.
The calls walk the bank round and round, the classes taking turns in the
mix's order and each class's batches in an order drawn from the seed, so
every seed runs the same shapes in the same sequence.  The port's
``ModelConfig`` is its architecture's (``configs/<arch>.py``) with each
field the configuration's ``port`` map names set from the configuration's
own numbers, and the fields ``port.values`` gives, so the program and the
reference read the same sizes.

The window issues calls until ``seconds`` have passed on the host clock,
then synchronises; every call that synchronise covers counts, with its
prompt tokens.  At most ``in_flight`` calls are queued on the card ahead
of the host.  It keeps the tokens and a copy of the last logits of the
window's first and last call and of ``check.sampled`` more, drawn from
the seed by reservoir sampling; once the window has closed,
``check.prompts`` prompts of each kept call, drawn from the seed, are the
answers the reference checks.

A traced run also records the model flops and the seconds of the window
outside its profiled sub-window (``unprofiled_flops``,
``unprofiled_s``): the profiler's cost on each of the tens of thousands
of launches a call slows the host inside the sub-window, so a rate of
the whole traced window would read the profiler.  Each of the two parts
ends on a synchronise, so its calls are done within its seconds.
"""
from __future__ import annotations

import dataclasses
import importlib
import random
import time
from collections import deque

import torch
from torch.profiler import record_function

from portbench import lm_work
from portbench.drivers import common


def port_config(config: dict):
    """The port's ``ModelConfig`` of the configuration: its ``arch``'s,
    with each field of ``port.fields`` (``field`` or ``group.field`` -> a
    key of the configuration) set to that key's value and each of
    ``port.values`` to its own."""
    from repro_torch.configs.base import get_config
    port = config["port"]
    cfg = get_config(port["arch"])
    values = {f: config[k] for f, k in port["fields"].items()}
    values.update(port.get("values", {}))
    top, nested = {}, {}
    for field, value in values.items():
        group, _, name = field.rpartition(".")
        (nested.setdefault(group, {}) if group else top)[name] = value
    for group, fields in nested.items():
        top[group] = dataclasses.replace(getattr(cfg, group), **fields)
    return dataclasses.replace(cfg, **top)


def global_layers(cfg) -> list[int]:
    """The layers of the port's model that attend without a window."""
    from repro_torch.models.transformer import build_pattern
    pattern = build_pattern(cfg)
    return [i for i in range(cfg.num_layers)
            if pattern[i % len(pattern)][1] is None]


class System:
    def __init__(self, cell, device):
        from repro_torch.train.serve_step import make_prefill
        self.cell, self.device = cell, device
        mix, config = cell.mix, cell.config
        self.cfg = port_config(config)
        if global_layers(self.cfg) != list(config["global_attn_idx"]):
            raise ValueError(
                f"the port's global layers {global_layers(self.cfg)} are "
                f"not the configuration's {config['global_attn_idx']}")
        gen_len = int(mix["gen_len"])
        #: (prompts, prompt_len) of each class, one call's batch
        self.shapes = [(int(mix["call_tokens"]) // int(c["prompt_len"]),
                        int(c["prompt_len"])) for c in mix["classes"]]
        self.prefills = {n: make_prefill(self.cfg, n + gen_len)
                         for _, n in self.shapes}
        self.flops = {(b, n): lm_work.prefill_flops(config, b, n)
                      for b, n in self.shapes}
        self.reference = importlib.import_module(
            f"portbench.reference.{config['reference']}")
        self.kept: dict[int, tuple] = {}

    def describe(self) -> list[str]:
        c = self.cfg
        return [f"model: {c.name}, {c.num_layers} layers, d_model "
                f"{c.d_model}, compute {c.compute_dtype}, params "
                f"{c.param_dtype}; prefill calls of "
                + ", ".join(f"{b} x {n}" for b, n in self.shapes)
                + f"; {len(self.order)} bank batches a round"]

    def inputs(self, seed: int) -> None:
        from repro_torch.models import transformer as tf
        self.seed = seed
        g = torch.Generator(device=self.device)
        g.manual_seed(common.torch_seed(seed))
        w = self.reference.init_weights(self.cell.config, g, self.device)
        self.model = tf.Transformer(
            self.cfg, w["embed"], w["layers"], w["final_norm"], w["lm_head"],
            device=self.device)
        del w
        vocab = int(self.cell.config["vocab_size"])
        bank = int(self.cell.mix["bank"])
        self.bank = [torch.randint(0, vocab, (b, n), generator=g,
                                   device=self.device)
                     for b, n in self.shapes for _ in range(bank)]
        # the classes take turns; each walks its batches in a seeded order
        rng = random.Random(common.torch_seed(seed))
        turns = [rng.sample(range(k * bank, (k + 1) * bank), bank)
                 for k in range(len(self.shapes))]
        self.order = [i for round_ in zip(*turns) for i in round_]

    def _call(self, tokens):
        with torch.no_grad():
            last, _state = self.prefills[tokens.shape[1]](self.model, tokens)
        return last

    def warm(self) -> None:
        """One call of each shape, in the order the window takes them."""
        seen = set()
        for i in self.order:
            shape = tuple(self.bank[i].shape)
            if shape not in seen:
                seen.add(shape)
                self._call(self.bank[i])
        common.sync(self.device)

    def window(self, record, seconds: float, trace: bool, seed: int,
               t0: float) -> None:
        check = self.cell.mix["check"]
        rng = random.Random(common.torch_seed(seed))
        sampled: list[tuple] = []
        profiled = common.SubWindow(self.device, seconds) if trace else None
        calls, tokens_done, flops_done = 0, 0, 0.0
        kept_first = last = None
        in_flight = int(self.cell.mix["in_flight"])
        queued: deque = deque()
        cuda = self.device.type == "cuda"
        resumed = None          # seconds into the window, sub-window closed
        common.sync(self.device)
        if cuda:
            # the peak the harness reads is the serving window's: set-up's
            # drawn weights, which the serving build copies, are gone
            torch.cuda.reset_peak_memory_stats(self.device)
        t_start = time.perf_counter()
        while True:
            now = time.perf_counter() - t_start
            if profiled is not None and profiled.due(now):
                profiled.open(self._counts(calls, tokens_done, flops_done),
                              now)
            tokens = self.bank[self.order[calls % len(self.order)]]
            with record_function("portbench.call"):
                logits = self._call(tokens)
            # a copy: the call's last logits are a view of all its logits
            item = (calls, tokens, logits.clone())
            if cuda:
                queued.append(torch.cuda.Event())
                queued[-1].record()
                if len(queued) > in_flight:
                    queued.popleft().synchronize()
            if calls == 0:
                kept_first = item
            elif len(sampled) < check["sampled"]:
                sampled.append(item)
            else:
                j = rng.randrange(calls)
                if j < check["sampled"]:
                    sampled[j] = item
            last = item
            calls += 1
            tokens_done += tokens.numel()
            flops_done += self.flops[tuple(tokens.shape)]
            now = time.perf_counter() - t_start
            if profiled is not None and profiled.over(now):
                common.sync(self.device)
                profiled.close(self._counts(calls, tokens_done, flops_done))
                resumed = time.perf_counter() - t_start
            if now >= seconds and not (profiled and profiled.is_open):
                break
        common.sync(self.device)
        t_end = time.perf_counter()
        if profiled is not None:
            profiled.close(self._counts(calls, tokens_done, flops_done))
        kept = ([kept_first] if check["first"] else []) + sampled + (
            [last] if check["last"] else [])
        self.kept = {i: (t, lg) for i, t, lg in kept}
        del logits, item, sampled, kept_first, last, kept
        record.setup_s = t_start - t0
        record.window_s = t_end - t_start
        record.calls = calls
        record.tokens = float(tokens_done)
        record.unprofiled_flops = flops_done
        record.unprofiled_s = record.window_s
        if resumed is not None:
            c0, c1 = profiled.counts0, profiled.counts1
            record.unprofiled_flops = flops_done - (c1["flops"] - c0["flops"])
            record.unprofiled_s = profiled.opened_at + (
                record.window_s - resumed)
        record.attempted = sum(int(self.bank[self.order[i % len(self.order)]]
                                   .shape[0]) for i in range(calls))
        record.failed = 0
        peaks = common.peaks(self.device)
        record.flops_peak = (None if peaks is None
                             else peaks["bf16_dense_flops_per_s"])
        record.info.update(calls=calls, prompts=record.attempted,
                           tokens=record.tokens, flops=flops_done,
                           unprofiled_flops=record.unprofiled_flops,
                           unprofiled_s=record.unprofiled_s,
                           checked_calls=sorted(self.kept))
        if profiled is not None:
            record.trace, record.sub = profiled.result(
                self.cell.kernels["symbols"])

    @staticmethod
    def _counts(calls: int, tokens: int, flops: float) -> dict:
        return {"calls": calls, "tokens": tokens, "flops": flops}

    def answers(self) -> list[tuple]:
        """``(label, tokens, last logits in float32, seed)`` of
        ``check.prompts`` prompts of each kept call (all, where the call
        holds fewer), drawn from the seed; the seed the weights were
        drawn from."""
        rng = random.Random(common.torch_seed(self.seed) + 1)
        out = []
        for i, (t, lg) in sorted(self.kept.items()):
            n = min(int(self.cell.mix["check"]["prompts"]), t.shape[0])
            rows = torch.tensor(sorted(rng.sample(range(t.shape[0]), n)),
                                device=t.device)
            out.append((f"call {i} prompts {rows.tolist()} of "
                        f"{t.shape[1]} tokens", t[rows], lg[rows].float(),
                        self.seed))
        return out

    def release(self) -> None:
        self.kept = {}
        self.model = self.bank = self.prefills = None
