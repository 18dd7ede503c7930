"""Serving launcher: batched prefill + greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1_5b \\
        [--smoke] [--batch 4 --prompt-len 1536 --gen-len 32] [--device cuda]

Any ``--arch`` of ``configs.base.ARCH_IDS``.  The model is built on the
device from a ``torch.Generator`` seeded with 0, as the reference
launcher seeds its key (no weight file); the prompts, and a config's
stubbed modality inputs (LLaVA's patch embeddings, MusicGen's
conditioning), are ``sample_from_specs(prefill_specs(...), seed=1)``.  It
runs on the card unless ``--device cpu`` is given, and raises when asked
for the card without one.  Times are on the host clock, the device
synchronised before each reading.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.launch.input_specs import prefill_specs, sample_from_specs
from repro_torch.models import transformer as tf
from repro_torch.train.serve_step import make_decode_step, make_prefill, pick

__all__ = ["serve", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(model: tf.Transformer, prompt: torch.Tensor, gen_len: int,
          max_len: int | None = None, patch_embeds=None, cond=None) -> dict:
    """Prefill ``prompt`` (B, S), or (B, K, S) with codebooks, then
    ``gen_len`` greedy decode steps (``cond`` passed to each).

    Returns ``prefill_ms`` and ``decode_ms`` (host clock, each ending in a
    device synchronise), ``ids`` (B, gen_len), or (B, K, gen_len) — the
    argmax fed to each decode step — and ``logits``: the prefill's last
    logits followed by every decode step's."""
    cfg = model.cfg
    device = model.embed.device
    if max_len is None:
        max_len = prompt.shape[-1] + cfg.num_image_tokens + gen_len + 1
    prefill = make_prefill(cfg, max_len)
    decode = make_decode_step(cfg)
    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        last, state = prefill(model, prompt, patch_embeds=patch_embeds,
                              cond=cond)
        _sync(device)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        logits, ids = [last], []
        t0 = time.perf_counter()
        for _ in range(gen_len):
            tok = pick(cfg, last)
            last, state = decode(model, state, tok, cond=cond)
            ids.append(tok[..., 0])
            logits.append(last)
        _sync(device)
        decode_ms = (time.perf_counter() - t0) * 1e3
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "ids": torch.stack(ids, dim=-1) if ids else None,
            "logits": logits, "state": state}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help=f"one of {', '.join(ARCH_IDS)}")
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
    batch = {k: v.to(device) for k, v in sample_from_specs(
        prefill_specs(cfg, args.batch, args.prompt_len), cfg, seed=1).items()}
    out = serve(model, batch["tokens"], args.gen_len,
                patch_embeds=batch.get("patch_embeds"), cond=batch.get("cond"))
    print(f"prefill {args.batch}x{args.prompt_len}: {out['prefill_ms']:.1f} ms")
    n = max(args.gen_len, 1)
    print(f"decode {args.gen_len} tokens: {out['decode_ms']:.1f} ms "
          f"({out['decode_ms'] / n:.2f} ms/tok)")
    return out


if __name__ == "__main__":
    main()
