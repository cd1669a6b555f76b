"""SPE — sparse-quantized linear operators (port of `repro.core.spe`).

The software twins of the chip's Sparse Processing Elements: a linear /
1-D conv operator whose weights are balanced-group pruned
(`core.sparsity`) and quantized (`core.quant`).

Three interchangeable compute paths of `spe_matmul`:
  * ``dense``     — dequantized dense matmul
  * ``reference`` — gather oracle (`sparsity.sparse_matmul_ref`)
  * ``kernel``    — `kernels.ops.nm_spmm`: the hand-written CUDA kernel
                    for a CUDA tensor, its plain version for a CPU one

Layouts follow the reference at every public function: activations NWC
`(B, T, C)`, conv weights `(ks, c_in, c_out)`; `F.conv1d`'s NCW layout is
used only inside functions.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import quant as Q
from repro_torch.core import sparsity as S

ComputePath = Literal["dense", "reference", "kernel"]


@dataclasses.dataclass(frozen=True)
class SPEConfig:
    """Joint sparsity × quantization operating point of one layer."""

    bits: int = 8
    group_size: int = 16
    keep: int = 8
    sparse: bool = True
    quantized: bool = True

    @property
    def sparsity_cfg(self) -> S.SparsityConfig:
        return S.SparsityConfig(self.group_size, self.keep)

    @property
    def quant_cfg(self) -> Q.QuantConfig:
        return Q.QuantConfig(bits=self.bits)


def spe_train_weight(w: torch.Tensor, cfg: SPEConfig) -> torch.Tensor:
    """QAT/co-design view of a weight: prune-STE then fake-quant (both
    straight-through), so training sees the inference constraints."""
    if cfg.sparse:
        w = S.prune_ste(w, cfg.group_size, cfg.keep)
    if cfg.quantized:
        w = Q.fake_quant(w, cfg.bits, True)
    return w


@dataclasses.dataclass
class CompiledLayer:
    """Frozen inference format of one SPE layer (what the chip stores)."""

    values_q: torch.Tensor  # (K_kept, N) int8 — compressed, quantized
    select: torch.Tensor  # (K_kept, N) uint8 — in-group select signals
    scale: torch.Tensor  # (1, N) f32 per-channel scale
    packed_planes: torch.Tensor  # (K_kept*bits/8, N) uint8 — storage
    bits: int
    group_size: int
    keep: int
    k_dense: int
    sparse: bool = True

    def hbm_bytes(self) -> int:
        sel_bits = max(1, (self.group_size - 1).bit_length())
        return (
            self.packed_planes.numel()
            + (self.select.numel() * sel_bits + 7) // 8
            + self.scale.numel() * 4
        )

    def to(self, device: torch.device) -> "CompiledLayer":
        return dataclasses.replace(
            self,
            values_q=self.values_q.to(device),
            select=self.select.to(device),
            scale=self.scale.to(device),
            packed_planes=self.packed_planes.to(device),
        )


def compile_layer(w: torch.Tensor, cfg: SPEConfig) -> CompiledLayer:
    """Dense trained (K, N) weight -> compressed/quantized inference format."""
    k, n = w.shape
    scfg = cfg.sparsity_cfg
    if cfg.sparse:
        values, select = S.compress(S.apply_prune(w, scfg), scfg)
    else:
        values = w
        select = torch.zeros((k, n), dtype=torch.uint8, device=w.device)
    q, scale = Q.quantize(values, cfg.quant_cfg)
    return CompiledLayer(
        values_q=q,
        select=select,
        scale=scale.reshape(1, -1),
        packed_planes=Q.pack_planes(q, cfg.bits),
        bits=cfg.bits,
        group_size=cfg.group_size,
        keep=cfg.keep,
        k_dense=k,
        sparse=cfg.sparse,
    )


def spe_matmul(
    x: torch.Tensor, layer: CompiledLayer, *, path: ComputePath = "reference"
) -> torch.Tensor:
    """y = x @ W_sparse_quant — inference execution of one SPE layer."""
    scfg = S.SparsityConfig(layer.group_size, layer.keep)
    xf = x.to(torch.float32)
    if not layer.sparse:
        # dense storage (the 1x1 head): plain dequant matmul on every
        # path. torch.matmul in float32 runs at full precision (the
        # default matmul precision is "highest", no TF32).
        y = xf @ layer.values_q.to(torch.float32)
        return (y * layer.scale).to(x.dtype)
    if path == "dense":
        dense_q = S.decompress(
            layer.values_q.to(torch.float32), layer.select, scfg,
            layer.k_dense,
        )
        return (xf @ dense_q * layer.scale).to(x.dtype)
    if path == "reference":
        values = layer.values_q.to(torch.float32)
        y = S.sparse_matmul_ref(xf, values, layer.select, scfg)
        return (y * layer.scale).to(x.dtype)
    if path == "kernel":
        from repro_torch.kernels import ops as kops

        # the kernel reads the int8 codes, not packed_planes — as the
        # reference's kernel path does, whatever the layer's bit width
        return kops.nm_spmm(
            x, layer.values_q, layer.select, layer.scale,
            group_size=layer.group_size, keep=layer.keep,
        ).to(x.dtype)
    raise ValueError(f"unknown path {path!r}")


# ---------------------------------------------------------------------------
# 1-D convolution with XLA SAME padding, in the NWC layout
# ---------------------------------------------------------------------------


def same_padding(t: int, ksize: int, stride: int) -> tuple[int, int, int]:
    """XLA SAME semantics: (t_out, pad_left, pad_right) with
    t_out = ceil(t / stride) and the odd pad on the right."""
    t_out = (t - 1) // stride + 1
    pad_total = max((t_out - 1) * stride + ksize - t, 0)
    pad_l = pad_total // 2
    return t_out, pad_l, pad_total - pad_l


def im2col(x: torch.Tensor, ksize: int, stride: int) -> torch.Tensor:
    """SAME-padded windows of (B, T, C) flattened (tap, channel) ->
    (B, T_out, ksize*C): the chip's SPad streaming order, and the row
    order of every compiled weight.

    `Tensor.unfold` puts the window last, (B, T_out, C, ks); it is
    permuted to (B, T_out, ks, C) before flattening.
    """
    b, t, c = x.shape
    t_out, pad_l, pad_r = same_padding(t, ksize, stride)
    xp = F.pad(x, (0, 0, pad_l, pad_r))
    win = xp.unfold(1, ksize, stride)[:, :t_out]  # (B, T_out, C, ks)
    return win.permute(0, 1, 3, 2).reshape(b, t_out, ksize * c)


def conv1d_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, T, C_in) * (ks, C_in, C_out) -> (B, T_out, C_out), SAME padding,
    full float32: cuDNN would run a float32 convolution in TF32 by
    default, so TF32 is switched off for this call only."""
    ks = w.shape[0]
    _, pad_l, pad_r = same_padding(x.shape[1], ks, stride)
    xc = F.pad(x.transpose(1, 2), (pad_l, pad_r))  # (B, C_in, T + pad)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv1d(xc, w.permute(2, 1, 0), stride=stride)
    return y.transpose(1, 2)


def conv1d_init(
    generator: torch.Generator,
    c_in: int,
    c_out: int,
    ksize: int,
    device: torch.device,
) -> dict:
    """He-normal (ks, c_in, c_out) weight drawn on the generator's device,
    zero bias, both placed on `device`."""
    fan = c_in * ksize
    w = torch.randn(
        (ksize, c_in, c_out), generator=generator, device=generator.device
    ) * (2.0 / fan) ** 0.5
    return {
        "w": w.to(device),
        "b": torch.zeros((c_out,), dtype=torch.float32, device=device),
    }


def conv1d_apply(
    params: dict,
    x: torch.Tensor,
    cfg: Optional[SPEConfig],
    *,
    stride: int = 1,
) -> torch.Tensor:
    """1-D convolution (B, T, C_in) -> (B, T', C_out), SAME padding.

    Prune/quant apply to the flattened (ksize*c_in, c_out) weight, the
    contraction the chip streams.
    """
    w, b = params["w"], params["b"]
    ks, c_in, c_out = w.shape
    if cfg is not None:
        w = spe_train_weight(w.reshape(ks * c_in, c_out), cfg).reshape(
            ks, c_in, c_out
        )
    return conv1d_same(x, w, stride) + b


def conv1d_as_matmul(
    params: dict, x: torch.Tensor, *, stride: int = 1
) -> torch.Tensor:
    """im2col view of conv1d — the form the chip (and the kernel)
    executes. SAME padding; equal to `conv1d_apply` in float32."""
    w, b = params["w"], params["b"]
    ks, c_in, c_out = w.shape
    return im2col(x, ks, stride) @ w.reshape(ks * c_in, c_out) + b
