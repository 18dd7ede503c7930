"""Batched serving example: prefill a batch of prompts, stream greedy
tokens with the KV cache, report per-phase timings.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch tinyllama_1_1b \\
        [--device cpu]

It uses the reduced smoke config of the chosen architecture.  It runs on
the card unless ``--device cpu`` is given; there ``--arch hymba_1_5b``
runs its SSM's short convolution through the banded-mixer kernel.
Times are on the host clock, the device synchronised before each
reading.
"""
import argparse
import time

import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.launch.input_specs import sample_from_specs, train_batch_specs
from repro_torch.models import transformer as tf
from repro_torch.train.serve_step import make_decode_step, make_prefill, pick


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    model = tf.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    batch = {k: v.to(device) for k, v in sample_from_specs(
        train_batch_specs(cfg, args.batch, args.prompt_len), cfg,
        seed=1).items()}
    kw = {k: batch[k] for k in ("patch_embeds", "cond") if k in batch}

    max_len = args.prompt_len + args.gen_len + (cfg.num_image_tokens or 0) + 1
    prefill = make_prefill(cfg, max_len=max_len)
    decode = make_decode_step(cfg)

    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        last, state = prefill(model, batch["tokens"], **kw)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        print(f"prefill: batch={args.batch} len={args.prompt_len} "
              f"in {t_prefill*1e3:.1f} ms (incl. first call)")

        toks = []
        tok = pick(cfg, last)
        t0 = time.perf_counter()
        for _ in range(args.gen_len):
            last, state = decode(model, state, tok, cond=batch.get("cond"))
            tok = pick(cfg, last)
            toks.append(tok)
        _sync(device)
        t_dec = time.perf_counter() - t0
    print(f"decode: {args.gen_len} tokens in {t_dec*1e3:.1f} ms "
          f"({t_dec/args.gen_len*1e3:.2f} ms/tok incl. first call)")
    seq = torch.cat(toks, dim=-1)
    ids = [int(t) for t in (seq[0, 0] if cfg.num_codebooks else seq[0])][:16]
    print("first sequence token ids:", ids)
    finite = bool(torch.isfinite(last).all())
    assert finite
    return {"cfg": cfg, "ids": seq, "last": last, "finite": finite,
            "prefill_ms": t_prefill * 1e3, "decode_ms": t_dec * 1e3}


if __name__ == "__main__":
    main()
