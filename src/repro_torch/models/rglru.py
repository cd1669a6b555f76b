"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Port of `repro.models.rglru`:

    r_t = sigmoid(x_t @ W_a + b_a)              (recurrence gate)
    i_t = sigmoid(x_t @ W_i + b_i)              (input gate)
    log a_t = -c * softplus(Lambda) * r_t       (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block wraps the LRU with a gated residual branch and a width-4 causal
depthwise temporal conv. The reference evaluates the linear recurrence
with `jax.lax.associative_scan`; the port runs it as a float32 loop over
S (`_lru_scan`), which sums in another order: the two agree to float32
rounding. Decode is the same function at S = 1 on the carried
{"h", "conv"} state.

`w_x`, `w_gate` and `w_out` go through `layers.linear_apply` (packed at
serve time, so they reach `quant_matmul`); `w_a` and `w_i` are read as
float32 `{"w"}` weights and never packed.

Tensor parallelism (sharded serving): `w_x`, `w_gate`, `w_a` and `w_i`
are column-parallel and `w_out` row-parallel. The recurrence is
elementwise in the hidden dimension, so a rank runs its block of the R
channels with its slice of the replicated per-channel leaves (`b_a`,
`b_i`, `lam`) and of the cache's `h`; the gates' (R, R) matmuls read
every channel, so `w_x`'s local output is gathered over `model` first
(the depthwise conv then runs on all channels, as the cache's `conv`
holds them), and the new `h` is gathered back whole, as the cache keeps
it (`cache_specs` replicates recurrent state over `model`).

In training the whole `u` enters `model` (`dist.sharding.enter_model`)
on its way into the gates' local columns only: its other use, this
rank's channels (`model_block`), makes its own gradient whole.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.spe import SPEConfig
from repro_torch.dist import sharding as shd
from repro_torch.models.layers import (
    _randn,
    col_inputs,
    col_local,
    gelu,
    linear_apply,
    linear_init,
    sigmoid,
)

LRU_C = 8.0


def rglru_init(gen: torch.Generator, d: int, r: int, conv_width: int = 4,
               lead: tuple = ()) -> dict:
    dev = gen.device
    # Lambda so that a ranges over ~(0.9, 0.999) at r_t = 1 (Griffin init):
    # softplus(Lambda) = -log(a)/c  =>  Lambda = log(expm1(-log(a)/c))
    lam_min, lam_max = 0.9, 0.999
    u = torch.rand((*lead, r), generator=gen, device=dev)
    a_init = lam_min + u * (lam_max - lam_min)
    lam = torch.log(torch.expm1(-torch.log(a_init) / LRU_C))
    return {
        "w_x": linear_init(gen, d, r, lead=lead),  # input projection
        "w_gate": linear_init(gen, d, r, lead=lead),  # gelu gate branch
        "conv_w": _randn(gen, (*lead, conv_width, r)).mul_(
            1.0 / conv_width ** 0.5),
        "conv_b": torch.zeros((*lead, r), device=dev),
        "w_a": linear_init(gen, r, r, lead=lead),  # recurrence gate
        "w_i": linear_init(gen, r, r, lead=lead),  # input gate
        "b_a": torch.zeros((*lead, r), device=dev),
        "b_i": torch.zeros((*lead, r), device=dev),
        "lam": lam,
        "w_out": linear_init(gen, r, d, lead=lead),
    }


def _causal_conv(
    u: torch.Tensor,  # (B, S, R)
    w: torch.Tensor,  # (W, R) depthwise taps
    b: torch.Tensor,
    prev: Optional[torch.Tensor] = None,  # (B, W-1, R) carry-in
) -> tuple[torch.Tensor, torch.Tensor]:
    width = w.shape[0]
    if prev is None:
        prev = torch.zeros((u.shape[0], width - 1, u.shape[-1]),
                           dtype=u.dtype, device=u.device)
    up = torch.cat([prev, u], dim=1)
    y = sum(up[:, i: i + u.shape[1]] * w[i].to(u.dtype) for i in range(width))
    return y + b.to(u.dtype), up[:, -(width - 1):]


def _lru_scan(a: torch.Tensor, b: torch.Tensor,
              h0: Optional[torch.Tensor]) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over S, in float32. a/b (B,S,R)."""
    h = torch.zeros_like(b[:, 0]) if h0 is None else h0
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def rglru_apply(
    p: dict,
    x: torch.Tensor,  # (B, S, D) — post-norm block input
    *,
    cache: Optional[dict] = None,  # {"h": (B,R), "conv": (B,W-1,R)}
    spe: Optional[SPEConfig] = None,
    dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, dict]:
    """Returns (y (B,S,D), {"h": (B,R) float32, "conv": (B,W-1,R)}), the
    new state as new tensors (the caller writes it into its cache)."""
    xg, xx = col_inputs(x, p["w_gate"], p["w_x"])
    gate = gelu(linear_apply(p["w_gate"], xg, spe=spe, dtype=dtype,
                             entered=True))
    u = linear_apply(p["w_x"], xx, spe=spe, dtype=dtype, entered=True)
    if col_local(p["w_x"]):  # the conv and the gates read every channel
        u = shd.gather_model(u)
    conv_prev = cache["conv"] if cache is not None else None
    u, conv_new = _causal_conv(u, p["conv_w"], p["conv_b"], conv_prev)

    local = col_local(p["w_a"])  # this rank's block of the R channels

    def mine(t):
        return shd.model_block(t) if local else t

    if col_local(p["w_gate"]) != local:
        gate = mine(gate) if local else shd.gather_model(gate)
    uf = u.to(torch.float32)
    ue = shd.enter_model(uf) if local else uf  # into the gates' columns
    r = sigmoid(ue @ p["w_a"]["w"] + mine(p["b_a"]))
    i = sigmoid(ue @ p["w_i"]["w"] + mine(p["b_i"]))
    log_a = -LRU_C * F.softplus(mine(p["lam"])) * r  # (B,S,R) f32
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (
        i * mine(uf))
    h = _lru_scan(a, b, mine(cache["h"]) if cache is not None else None)
    y = h.to(dtype) * gate
    y = linear_apply(p["w_out"], y, spe=spe, dtype=dtype, x_local=local)
    h_last = shd.gather_model(h[:, -1]) if local else h[:, -1]
    return y, {"h": h_last, "conv": conv_new}
