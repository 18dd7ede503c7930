"""Serving launcher: batched prefill + greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1_5b \\
        [--smoke] [--batch 4 --prompt-len 1536 --gen-len 32] [--device cuda]

The model is built on the device from a ``torch.Generator`` seeded with
0, as the reference launcher seeds its key (no weight file); the prompts
are ``sample_from_specs(..., seed=1)``, the reference launcher's.  It
runs on the card unless ``--device cpu`` is given, and raises when asked
for the card without one.  Times are on the host clock, the device
synchronised before each reading.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.launch.input_specs import sample_from_specs, train_batch_specs
from repro_torch.models import transformer as tf
from repro_torch.train.serve_step import make_decode_step, make_prefill

__all__ = ["serve", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(model: tf.Transformer, prompt: torch.Tensor, gen_len: int,
          max_len: int | None = None) -> dict:
    """Prefill ``prompt`` (B, S), then ``gen_len`` greedy decode steps.

    Returns ``prefill_ms`` and ``decode_ms`` (host clock, each ending in a
    device synchronise), ``ids`` (B, gen_len) — the argmax fed to each
    decode step — and ``logits``: the prefill's last logits followed by
    every decode step's."""
    cfg = model.cfg
    device = model.embed.device
    if max_len is None:
        max_len = prompt.shape[1] + gen_len + 1
    prefill = make_prefill(cfg, max_len)
    decode = make_decode_step(cfg)
    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        last, state = prefill(model, prompt)
        _sync(device)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        logits, ids = [last], []
        t0 = time.perf_counter()
        for _ in range(gen_len):
            tok = torch.argmax(last, dim=-1)[:, None]
            last, state = decode(model, state, tok)
            ids.append(tok[:, 0])
            logits.append(last)
        _sync(device)
        decode_ms = (time.perf_counter() - t0) * 1e3
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "ids": torch.stack(ids, dim=-1) if ids else None,
            "logits": logits, "state": state}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    model = tf.init_params(cfg, gen, device)
    batch = sample_from_specs(
        train_batch_specs(cfg, args.batch, args.prompt_len), cfg, seed=1)
    out = serve(model, batch["tokens"].to(device), args.gen_len)
    print(f"prefill {args.batch}x{args.prompt_len}: {out['prefill_ms']:.1f} ms")
    n = max(args.gen_len, 1)
    print(f"decode {args.gen_len} tokens: {out['decode_ms']:.1f} ms "
          f"({out['decode_ms'] / n:.2f} ms/tok)")
    return out


if __name__ == "__main__":
    main()
