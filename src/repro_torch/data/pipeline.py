"""Token data pipeline: synthetic + file-backed, sharded, resumable.

The reference's ``repro.data.pipeline``, batch for batch: batch ``i`` of
shard ``s`` is a pure function of ``(seed, i, s)`` (synthetic, numpy's
``SeedSequence([seed, i, s])``) or a deterministic offset into the token
file (file-backed), so a restart at step N regenerates exactly the stream
a failed worker would have seen — no iterator state in checkpoints beyond
the step counter.  Batches are numpy int32 arrays, equal to the
reference's; the train step moves them to its device.

A config with image tokens or cross-attention also gets its stubbed
frontend's output, as serving does: f32 ``patch_embeds`` (B, N,
vision_dim) or ``cond`` (B, L, cond_dim), standard normal, drawn from a
stream of their own (``SeedSequence([seed, i, s, 1])``), so the token
stream stays the reference's.  The reference's pipeline has no such
inputs (its trainer runs MusicGen without its conditioning).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "FileBackedLM", "make_pipeline",
           "Prefetcher"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_shards: int = 1
    shard_id: int = 0
    seed: int = 0
    path: Optional[str] = None       # file-backed when set
    num_codebooks: int = 0
    num_image_tokens: int = 0        # patch_embeds (B, N, vision_dim)
    vision_dim: int = 0
    cond_len: int = 0                # cond (B, cond_len, cond_dim)
    cond_dim: int = 0

    @property
    def shard_batch(self) -> int:
        if self.global_batch % self.num_shards:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of num_shards {self.num_shards}")
        return self.global_batch // self.num_shards


def _with_stubs(cfg: DataConfig, step: int, batch: dict) -> dict:
    """``batch`` with the stubbed frontends' inputs the config asks for."""
    if not (cfg.num_image_tokens or cfg.cond_len):
        return batch
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.shard_id, 1]))
    b = cfg.shard_batch
    if cfg.num_image_tokens:
        batch["patch_embeds"] = rng.normal(size=(
            b, cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32)
    if cfg.cond_len:
        batch["cond"] = rng.normal(
            size=(b, cfg.cond_len, cfg.cond_dim)).astype(np.float32)
    return batch


class SyntheticLM:
    """Deterministic synthetic LM batches: a noisy structured sequence so a
    small model visibly learns (copy/periodic structure + noise)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.shard_id]))
        shape = (cfg.shard_batch, cfg.seq_len + 1)
        if cfg.num_codebooks:
            shape = (cfg.shard_batch, cfg.num_codebooks, cfg.seq_len + 1)
        period = 3 + (step % 5)
        # motifs from a small sub-vocabulary: the stream has low unigram
        # entropy plus periodic structure, so even short smoke runs show a
        # visible loss drop (full-vocab noise keeps the task non-trivial)
        sub = max(8, min(64, cfg.vocab_size // 4))
        base = rng.integers(0, sub, size=shape[:-1] + (period,))
        reps = -(-(cfg.seq_len + 1) // period)
        seq = np.tile(base, (1,) * (len(shape) - 1) + (reps,))[
            ..., : cfg.seq_len + 1]
        noise = rng.random(shape) < 0.1
        seq = np.where(noise, rng.integers(0, cfg.vocab_size, size=shape),
                       seq)
        return _with_stubs(cfg, step,
                           {"tokens": seq[..., :-1].astype(np.int32),
                            "labels": seq[..., 1:].astype(np.int32)})

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class FileBackedLM:
    """Memory-mapped flat token file (uint16/uint32), strided per shard."""

    def __init__(self, cfg: DataConfig, dtype=np.uint16):
        self.cfg = cfg
        self.tokens = np.memmap(cfg.path, dtype=dtype, mode="r")
        self.tokens_per_batch = cfg.shard_batch * (cfg.seq_len + 1)
        usable = len(self.tokens) - self.tokens_per_batch * cfg.num_shards
        if usable <= 0:
            raise ValueError("token file too small for one batch per shard")

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        stride = self.tokens_per_batch * cfg.num_shards
        start = (step * stride + cfg.shard_id * self.tokens_per_batch) % \
            (len(self.tokens) - self.tokens_per_batch)
        flat = np.asarray(self.tokens[start: start + self.tokens_per_batch])
        seq = flat.reshape(cfg.shard_batch, cfg.seq_len + 1).astype(np.int32)
        seq = np.clip(seq, 0, cfg.vocab_size - 1)
        return _with_stubs(cfg, step,
                           {"tokens": np.ascontiguousarray(seq[:, :-1]),
                            "labels": np.ascontiguousarray(seq[:, 1:])})

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch with bounded queue; survives consumer
    restarts (call .close())."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)


def make_pipeline(cfg: DataConfig):
    if cfg.path:
        return FileBackedLM(cfg)
    return SyntheticLM(cfg)
