"""End-to-end driver: train a ~100M-parameter dense LM for a few hundred
steps on the synthetic pipeline, with checkpointing + fault tolerance on.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 \\
        [--device cpu]

It trains on the card unless ``--device cpu`` is given.  A checkpoint
directory that already holds a checkpoint is resumed from.
"""
import argparse
import os
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import adamw, cosine_schedule
from repro_torch.train.trainer import Trainer, TrainerConfig

# ~100M params: 12L x 512d x 8H, vocab 8k
CFG_100M = ModelConfig(
    name="demo-100m", family="dense", num_layers=12, d_model=512,
    num_heads=8, num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=8192,
    compute_dtype="float32", source="examples/train_lm.py")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = CFG_100M
    print(f"model: {cfg.name}  params={cfg.param_count()/1e6:.1f}M")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=0)
    opt = adamw(lr=cosine_schedule(3e-4, warmup=20, total=args.steps))
    tr = Trainer(cfg, dcfg,
                 TrainerConfig(total_steps=args.steps, checkpoint_every=100,
                               checkpoint_dir=args.ckpt_dir, log_every=10),
                 optimizer=opt, device=device)
    state = tr.run()
    print("step,loss,grad_norm,sec_per_step")
    for m in tr.metrics_log:
        print(f"{m['step']},{m['loss']:.4f},{m['grad_norm']:.3f},"
              f"{m['sec_per_step']:.3f}")
    head, tail = tr.metrics_log[:3], tr.metrics_log[-3:]
    first = sum(m["loss"] for m in head) / len(head)
    last = sum(m["loss"] for m in tail) / len(tail)
    print(f"loss: {first:.3f} -> {last:.3f}")
    if tr.monitor.stragglers:
        print(f"stragglers flagged: {tr.monitor.stragglers}")
    return {"first": first, "last": last, "log": tr.metrics_log,
            "step": int(state.step), "trainer": tr}


if __name__ == "__main__":
    main()
