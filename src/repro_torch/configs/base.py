"""Config system of the port's LM stack: architecture + shape cells.

A copy of the reference's config dataclasses (``repro.configs.base``), so
the port runs where JAX is not installed.  Every architecture of
``ARCH_IDS`` is a module ``repro_torch.configs.<id>`` exporting ``CONFIG``
(full published dims) and ``SMOKE`` (reduced same-family config for CPU
tests).

``kernel_impl`` names the path of the SSM's short causal conv: ``"cuda"``
runs the banded-mixer kernel (``kernels.ops.banded_mix``; its plain
version for CPU tensors), ``"ref"`` the shifted adds written out in
``models/ssm.py``.  The reference's ``"pallas"`` maps to ``"cuda"``, as
the planner maps its backends.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

__all__ = [
    "MoEConfig", "SSMConfig", "ModelConfig", "ShapeCell", "SHAPE_CELLS",
    "KERNEL_IMPLS", "ARCH_IDS", "LONG_CONTEXT_ARCHS", "cells_for",
    "get_config", "get_smoke_config",
]

KERNEL_IMPLS = ("cuda", "ref")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    groups: int = 1          # dispatch groups (cells set = data shards)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: int = 0          # 0 -> ceil(d_model/16)
    conv_shared: bool = False  # True: one (W,) band shared by all channels


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention variants
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None
    local_global_period: int = 0    # 0: all global; k: every k-th layer global
    attn_softcap: Optional[float] = None
    qk_norm: bool = False
    # mlp
    mlp_act: str = "silu"           # silu (swiglu) | gelu (geglu)
    # families
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    num_codebooks: int = 0          # audio
    cross_attn: bool = False        # audio conditioning
    cond_len: int = 0
    cond_dim: int = 0
    num_image_tokens: int = 0       # vlm
    vision_dim: int = 0
    # rwkv
    rwkv_mode: bool = False
    # numerics / structure
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scan_layers: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"             # none | full | dots
    kernel_impl: str = "cuda"       # cuda (banded-mixer kernel) | ref
    source: str = ""

    def __post_init__(self):
        if self.kernel_impl not in KERNEL_IMPLS:
            raise ValueError(f"kernel_impl must be one of {KERNEL_IMPLS}, "
                             f"got {self.kernel_impl!r}")

    @property
    def attn_out_dim(self) -> int:
        return self.num_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer + head)."""
        d, dh = self.d_model, self.head_dim
        emb = self.vocab_size * d * (max(self.num_codebooks, 1))
        head = 0 if self.tie_embeddings else self.vocab_size * d * max(self.num_codebooks, 1)
        per_layer = 0
        if self.rwkv_mode:
            per_layer += 5 * d * 32 * 2 + d * d * 4 + 2 * d * self.d_ff + d * self.d_ff
        else:
            q = d * self.num_heads * dh
            kv = 2 * d * self.num_kv_heads * dh
            o = self.num_heads * dh * d
            per_layer += q + kv + o
            if self.cross_attn:
                per_layer += q + o + 2 * self.cond_dim * self.num_kv_heads * dh
        if self.moe is not None:
            per_layer += d * self.moe.num_experts  # router
            per_layer += self.moe.num_experts * 3 * d * self.moe.d_ff_expert
        elif not self.rwkv_mode:
            per_layer += 3 * d * self.d_ff
        if self.ssm is not None:
            di = self.ssm.expand * d
            per_layer += 2 * d * di + di * d + di * (self.ssm.conv_width +
                         2 * self.ssm.state_dim + 2) + di
        return emb + head + self.num_layers * per_layer


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


ARCH_IDS = [
    "yi_6b", "gemma_2b", "tinyllama_1_1b", "gemma3_12b", "musicgen_large",
    "rwkv6_1_6b", "llava_next_34b", "qwen3_moe_30b_a3b",
    "granite_moe_3b_a800m", "hymba_1_5b",
]

# long_500k requires sub-quadratic attention (DESIGN.md §4).
LONG_CONTEXT_ARCHS = {"rwkv6_1_6b", "hymba_1_5b", "gemma3_12b"}


def cells_for(arch: str) -> list[str]:
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        cells.append("long_500k")
    return cells


def _load(arch: str):
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; one of "
                         f"{', '.join(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _load(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _load(arch).SMOKE
