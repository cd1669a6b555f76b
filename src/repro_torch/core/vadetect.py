"""The paper's workload: an 8-layer 1-D fully-convolutional VA detector.

Port of `repro.core.vadetect`. Input: one IEGM recording — 512 samples
@ 250 Hz, band-pass filtered 15–55 Hz (`data/iegm.py`), single lead.
Output: VA (VT/VF) vs non-VA logits. A diagnosis aggregates 6 recordings
by majority vote, ties toward VA.

Parameters are a plain dict `{"conv{i}": {"w": (ks, c_in, c_out),
"b": (c_out,)}}` of tensors — the reference's pytree, so weights carry
across (`repro_torch.convert`) and tests compare like with like.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import _device
from repro_torch.core.spe import SPEConfig, conv1d_apply, conv1d_init

# (c_out, ksize, stride) of the 8 conv layers; the last is the 1x1 head.
VA_LAYERS: tuple[tuple[int, int, int], ...] = (
    (16, 7, 2),  # 512 -> 256
    (24, 5, 2),  # 256 -> 128
    (32, 5, 1),  # 128 -> 128
    (48, 3, 2),  # 128 -> 64
    (64, 3, 1),  # 64  -> 64
    (64, 3, 2),  # 64  -> 32
    (96, 3, 2),  # 32  -> 16
    (2, 1, 1),   # 1x1 head -> logits per position
)

N_INPUT_PAD = 4  # paper: input channel count padded to N=4
RECORD_LEN = 512
VOTE_SEGMENTS = 6


@dataclasses.dataclass(frozen=True)
class VAConfig:
    layers: tuple[tuple[int, int, int], ...] = VA_LAYERS
    spe: Optional[SPEConfig] = SPEConfig(
        bits=8, group_size=16, keep=8, sparse=True, quantized=True
    )
    # Mixed-precision point: per-layer bit widths (None -> spe.bits).
    layer_bits: Optional[tuple[int, ...]] = None

    def layer_spe(self, i: int) -> Optional[SPEConfig]:
        if self.spe is None:
            return None
        bits = self.spe.bits
        if self.layer_bits is not None:
            bits = self.layer_bits[i]
        # the 1x1 head contracts few channels; it stays dense 8-bit
        if i == len(self.layers) - 1:
            return SPEConfig(bits=8, sparse=False, quantized=True)
        return SPEConfig(
            bits=bits,
            group_size=self.spe.group_size,
            keep=self.spe.keep,
            sparse=self.spe.sparse,
            quantized=self.spe.quantized,
        )


def pad_input(x: torch.Tensor) -> torch.Tensor:
    """(B, T) or (B, T, C) -> (B, T, N_INPUT_PAD): zero-pad the input
    channels to N=4, as the paper does."""
    if x.ndim == 2:
        x = x[..., None]
    c = x.shape[-1]
    if c < N_INPUT_PAD:
        x = F.pad(x, (0, N_INPUT_PAD - c))
    return x


def init(
    generator: torch.Generator,
    cfg: VAConfig = VAConfig(),
    *,
    device: _device.DeviceLike = None,
) -> dict:
    """Random He-normal parameters drawn in layer order from `generator`
    (on its own device, so a CPU generator gives the same weights on any
    `device`)."""
    dev = _device.resolve(device)
    params = {}
    c_in = N_INPUT_PAD
    for i, (c_out, ks, _) in enumerate(cfg.layers):
        params[f"conv{i}"] = conv1d_init(generator, c_in, c_out, ks, dev)
        c_in = c_out
    return params


def apply(
    params: dict,
    x: torch.Tensor,
    cfg: VAConfig = VAConfig(),
    *,
    train: bool = True,
) -> torch.Tensor:
    """(B, 512) or (B, 512, 1) IEGM -> (B, 2) logits.

    The SPE constraints (prune + fake-quant) apply in training and in
    eval alike, so eval matches the compiled program; `train` is kept for
    the reference's signature.
    """
    h = pad_input(x)
    n_layers = len(cfg.layers)
    for i, (_, _, stride) in enumerate(cfg.layers):
        h = conv1d_apply(params[f"conv{i}"], h, cfg.layer_spe(i), stride=stride)
        if i < n_layers - 1:
            h = torch.relu(h)
    # fully-convolutional head: average logits over remaining positions
    return h.mean(dim=1)


def loss_fn(
    params: dict, batch: dict, cfg: VAConfig = VAConfig()
) -> tuple[torch.Tensor, dict]:
    """Mean negative log-likelihood of `batch["label"]` under the logits of
    `batch["signal"]`; returns (loss, {"loss", "accuracy"})."""
    logits = apply(params, batch["signal"], cfg)
    labels = batch["label"].to(torch.int64)
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return nll, {"loss": nll, "accuracy": acc}


def predict(params: dict, x: torch.Tensor, cfg: VAConfig = VAConfig()) -> torch.Tensor:
    """Per-segment class predictions (B,)."""
    return torch.argmax(apply(params, x, cfg, train=False), dim=-1)


def vote(segment_preds: torch.Tensor) -> torch.Tensor:
    """Majority vote over the last axis of 0/1 segment predictions.

    Ties break toward VA (a missed VA is fatal; a false positive is a
    recoverable shock). Returns int32 (...,).
    """
    votes = segment_preds.sum(dim=-1)
    return (votes * 2 >= segment_preds.shape[-1]).to(torch.int32)


def diagnose(
    params: dict, recordings: torch.Tensor, cfg: VAConfig = VAConfig()
) -> torch.Tensor:
    """(B, VOTE_SEGMENTS, 512) -> (B,) diagnosis via 6-segment voting."""
    b, s, t = recordings.shape
    preds = predict(params, recordings.reshape(b * s, t), cfg)
    return vote(preds.reshape(b, s))


def param_count(params: dict) -> int:
    return sum(int(p.numel()) for layer in params.values() for p in layer.values())


def layer_shapes(cfg: VAConfig = VAConfig()) -> list[dict]:
    """Static per-layer workload description (for the compiler/perf model)."""
    out = []
    t = RECORD_LEN
    c_in = N_INPUT_PAD
    for i, (c_out, ks, stride) in enumerate(cfg.layers):
        t_out = (t - 1) // stride + 1
        spe = cfg.layer_spe(i)
        out.append(
            dict(
                name=f"conv{i}",
                c_in=c_in,
                c_out=c_out,
                ksize=ks,
                stride=stride,
                t_in=t,
                t_out=t_out,
                macs=t_out * c_out * ks * c_in,
                bits=spe.bits if spe else 32,
                sparse=bool(spe and spe.sparse),
                keep_frac=(spe.keep / spe.group_size)
                if (spe and spe.sparse)
                else 1.0,
            )
        )
        t, c_in = t_out, c_out
    return out
