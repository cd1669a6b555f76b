"""Config schema: architectures × input-shape cells (a copy of
`repro.configs.base`: plain dataclasses, no jax).

`ArchConfig` is the single description every layer of the framework reads:
model building (`models.api.build_model`), sharding (`dist.sharding`),
the dry-run (`launch.dryrun`) and the roofline report all consume it.

The paper's technique is the `spe_bits` / `spe_sparse` knobs: setting them
swaps dense projections for `core.spe` sparse-quantized operators (QAT in
training, compressed storage in serving). The dry-run baseline keeps them
off (dense bf16 = paper-faithful baseline for the LM substrate); §Perf
turns them on as the beyond-paper memory-roofline optimization.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert_ff: int = 0  # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # Block pattern, repeated every len(pattern) layers; a tail of
    # n_layers % len(pattern) layers is unrolled after the scan.
    # Kinds: global | local | chunked | rglru | rwkv
    pattern: tuple[str, ...] = ("global",)
    window: int = 0  # local window / chunk size (elements)

    act: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    qk_norm: bool = False
    qkv_bias: bool = False  # qwen1.5-style attention biases
    sandwich_norm: bool = False  # gemma2 pre+post block norms
    scale_embed: bool = False  # gemma-family sqrt(d) embedding scale
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w)
    tie_embeddings: bool = False
    moe: Optional[MoESpec] = None

    # ssm / hybrid details
    rwkv_head_dim: int = 64
    lru_width: int = 0  # rglru recurrence width (0 -> d_model)
    conv_width: int = 4

    # encoder-decoder (whisper): decoder uses the main fields
    enc_layers: int = 0
    enc_seq: int = 0  # stub-frontend frame count

    # shape-cell applicability
    supports_decode: bool = True
    supports_long: bool = False  # sub-quadratic decode at 500k

    # --- the paper's technique, as a first-class knob -------------------
    spe_bits: Optional[int] = None  # 8/4/2/1 weight bits (None = bf16)
    spe_sparse: bool = False  # 50% balanced (16:8) pruning
    spe_group: int = 16
    spe_keep: int = 8

    # parallelism profile (consumed by dist.sharding)
    use_tp: bool = True  # False -> pure DP over all mesh axes
    fsdp: bool = True
    train_microbatches: int = 1  # gradient-accumulation chunks per step

    # --- beyond-paper optimization knobs (§Perf hillclimb) --------------
    kv_quant_bits: Optional[int] = None  # int8 KV cache (decode memory)
    moe_shard: str = "tp_fsdp"  # tp_fsdp | tp_only (experts replicated
    #                             over data: kills the D-contraction
    #                             all-reduce for small-expert models)
    loss_chunk: int = 0  # chunked CE over S (0 = off): bounds live
    #                      logits to (B, chunk, V)
    attn_block: int = 512  # blockwise-attention q/kv tile size
    kv_mode: str = "pad"  # pad | replicate (kv heads vs TP degree)
    remat: str = "block"  # none | block
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.period

    @property
    def tail(self) -> tuple[str, ...]:
        return self.pattern[: self.n_layers % self.period]

    @property
    def is_enc_dec(self) -> bool:
        return self.enc_layers > 0

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def lru_dim(self) -> int:
        return self.lru_width or self.d_model

    def layer_kinds(self) -> list[str]:
        return [
            self.pattern[i % self.period] for i in range(self.n_layers)
        ]

    def validate(self) -> None:
        assert self.family in (
            "dense", "moe", "ssm", "hybrid", "audio", "vlm",
        ), self.family
        if self.family == "moe":
            assert self.moe is not None
        for k in self.pattern:
            assert k in ("global", "local", "chunked", "rglru", "rwkv"), k
        if any(k in ("local", "chunked") for k in self.pattern):
            assert self.window > 0
        if self.head_dim == 0:
            assert self.d_model % self.n_heads == 0


# ---------------------------------------------------------------------------
# Input-shape cells (assigned)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def applicable_shapes(cfg: ArchConfig) -> list[ShapeCell]:
    """The assignment's skip rules (documented in DESIGN.md §4)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"]]
    if cfg.supports_decode:
        out.append(SHAPES["decode_32k"])
        if cfg.supports_long:
            out.append(SHAPES["long_500k"])
    return out


def pad_up(x: int, m: int) -> int:
    return -(-x // m) * m
