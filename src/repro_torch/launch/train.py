"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba_1_5b \\
        --steps 4 --batch 4 --seq 1024 [--smoke] [--device cuda]

The reference launcher's options, plus ``--device``: it trains on the
card unless ``--device cpu`` is given, and raises when asked for the card
without one.  The model is drawn from a ``torch.Generator`` seeded with
0 (no weight file); the data is ``SyntheticLM`` (seed 0) unless
``--data-path`` names a flat uint16 token file.  ``--mesh`` belongs to
the LM half of the distributed slice (ROADMAP Queue 1 item 4) and
raises.  Any
``--arch`` of ``configs.base.ARCH_IDS``: ``--seq`` counts text tokens (a
VLM's image tokens come on top), and a VLM's patch embeddings and a
cross-attention model's conditioning are the pipeline's stubs.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import adamw, cosine_schedule
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["main"]


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help=f"one of {', '.join(ARCH_IDS)}")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--mesh", default=None,
                    help="e.g. 4x2 => (data, model); not ported yet")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: <tempdir>/repro_torch_launch_train/<arch> "
                         "(per-arch so restores never cross architectures)")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--data-path", default=None,
                    help="flat uint16 token file (default: synthetic)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh:
        raise NotImplementedError(
            "--mesh: mesh training belongs to the LM half of the port's "
            "distributed slice (ROADMAP Queue 1 item 4), which is not "
            "ported yet")
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.ckpt_dir is None:
        args.ckpt_dir = os.path.join(tempfile.gettempdir(),
                                     "repro_torch_launch_train", cfg.name)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"device={device}")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=0, path=args.data_path,
                      num_codebooks=cfg.num_codebooks,
                      num_image_tokens=cfg.num_image_tokens,
                      vision_dim=cfg.vision_dim,
                      cond_len=cfg.cond_len if cfg.cross_attn else 0,
                      cond_dim=cfg.cond_dim)
    opt = adamw(lr=cosine_schedule(args.lr,
                                   warmup=min(20, args.steps // 5 + 1),
                                   total=args.steps))
    tcfg = TrainerConfig(total_steps=args.steps,
                         checkpoint_every=args.ckpt_every,
                         checkpoint_dir=args.ckpt_dir, log_every=10)
    tr = Trainer(cfg, dcfg, tcfg, optimizer=opt, device=device)
    tr.run()
    for m in tr.metrics_log:
        print(f"step={m['step']} loss={m['loss']:.4f} "
              f"gnorm={m['grad_norm']:.3f} {m['sec_per_step']:.3f}s")
    return tr


if __name__ == "__main__":
    main()
