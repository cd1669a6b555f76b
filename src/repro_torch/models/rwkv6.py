"""RWKV-6 ("Finch") block: data-dependent-decay linear attention.

Port of `repro.models.rwkv6`. Time-mix with per-channel data-dependent
decay w_t and bonus u:

    out_t = r_t · (diag(u) k_t v_tᵀ + S_{t-1})
    S_t   = diag(w_t) S_{t-1} + k_t v_tᵀ            (per head, hd×hd state)

`wkv_chunked` is the reference's chunked evaluation with CHUNK = 16:
within a chunk the contributions are einsums over decay ratios
exp(cum_t - cum_s), and a loop over chunks carries the state. A sequence
longer than one chunk must be a whole number of chunks; any other length
(17-31 tokens, and so on) raises, as the reference's assertion does. The
decay exponents are clamped to WW_CLAMP so that every in-chunk ratio stays
finite in float32. Decode is the same block at S = 1 (one chunk of one
token) on the carried {tm_shift, cm_shift, state}.

The projections (r/k/v/g/o and the channel mix) go through
`layers.linear_apply`, so they are packed at serve time and reach
`quant_matmul`; the LoRA adapters, mixes and decay stay float32.

Tensor parallelism (sharded serving, `serve.sharded`), by the
reference's rules: `w_r/w_k/w_v/w_g/cm_k/cm_r` column-parallel,
`w_o/cm_v` row-parallel. The time mix runs this rank's heads: the token
shift, the ddlerp and the decay LoRA are computed whole (replicated),
then `log_w`, `u`, `ln_x` and the carried state are cut to the local
heads (`model_block`), the WKV runs on them, and `w_o` sums the local
heads' partial products. The state cache stays replicated over `model`
(`cache_specs` does not split it, as in the reference), so the new
state's head blocks are all-gathered back whole: one all-gather a block
a step. Where `model` splits the columns mid-head (a head count it does
not divide), r/k/v/g are gathered and every head runs whole. The
channel mix's `cm_k` -> `cm_v` is column -> row; `cm_r`'s local block
of the receptance is gathered before it gates the whole `cm_v` output.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.spe import SPEConfig
from repro_torch.dist import sharding as shd
from repro_torch.models.layers import (
    _randn,
    col_local,
    layernorm_apply,
    layernorm_init,
    linear_apply,
    sigmoid,
    silu,
)

MIX_NAMES = ("w", "k", "v", "r", "g")
LORA_MIX = 32
LORA_DECAY = 64
CHUNK = 16
WW_CLAMP = (-8.0, 1.386)  # exp(ww) <= 4 -> |log w| <= 4


def rwkv_init(gen: torch.Generator, d: int, d_ff: int, head_dim: int,
              lead: tuple = ()) -> dict:
    h = d // head_dim
    dev = gen.device
    s = 1.0 / (d ** 0.5)

    def lin(di, do):
        return {"w": _randn(gen, (*lead, di, do)).div_(di ** 0.5)}

    def zeros(*shape):
        return torch.zeros((*lead, *shape), device=dev)

    nm = len(MIX_NAMES)
    return {
        "ln1": layernorm_init(d, lead=lead, device=dev),
        "ln2": layernorm_init(d, lead=lead, device=dev),
        "mu_x": zeros(d),
        "mu": zeros(nm, d),
        "lora_a": _randn(gen, (*lead, d, nm, LORA_MIX)).mul_(s * 0.1),
        "lora_b": zeros(nm, LORA_MIX, d),
        "w_r": lin(d, d),
        "w_k": lin(d, d),
        "w_v": lin(d, d),
        "w_g": lin(d, d),
        "w_o": lin(d, d),
        "w0": torch.full((*lead, d), -0.6, device=dev),  # exp(-exp(-0.6))≈0.58
        "w_lora_a": _randn(gen, (*lead, d, LORA_DECAY)).mul_(s * 0.1),
        "w_lora_b": zeros(LORA_DECAY, d),
        "u": zeros(h, head_dim),
        "ln_x": layernorm_init(d, lead=lead, device=dev),  # per-head groupnorm
        "cm_mu_k": zeros(d),
        "cm_mu_r": zeros(d),
        "cm_k": lin(d, d_ff),
        "cm_v": lin(d_ff, d),
        "cm_r": lin(d, d),
    }


def _ddlerp(p, x, x_prev, dtype):
    """Data-dependent token-shift mixes -> [x_w, x_k, x_v, x_r, x_g]."""
    xx = (x_prev - x).to(dtype)
    base = x + xx * p["mu_x"].to(dtype)
    lora = torch.tanh(
        torch.einsum("bsd,dfm->bsfm", base, p["lora_a"].to(dtype)))
    delta = torch.einsum("bsfm,fmd->bsfd", lora, p["lora_b"].to(dtype))
    mixes = p["mu"].to(dtype)[None, None] + delta  # (B,S,5,D)
    return [x + xx * mixes[:, :, i] for i in range(len(MIX_NAMES))]


def _decay_log_w(p, x_w, dtype):
    """log w_t in [-4, 0): data-dependent per-channel decay, float32."""
    ww = p["w0"].to(dtype) + torch.tanh(
        x_w @ p["w_lora_a"].to(dtype)) @ p["w_lora_b"].to(dtype)
    ww = torch.clamp(ww.to(torch.float32), *WW_CLAMP)
    return -torch.exp(ww)  # (B,S,D) f32


def _heads(x, h, hd):
    return x.reshape(*x.shape[:-1], h, hd)


def wkv_chunked(r, k, v, log_w, u, state):
    """Chunked WKV. r/k/v/log_w (B,S,H,hd) float32; u (H,hd); state
    (B,H,hd,hd). Returns (out (B,S,H,hd), state')."""
    b, s, h, hd = r.shape
    c = min(CHUNK, s)
    if s % c:
        raise ValueError(
            f"wkv_chunked: a sequence of {s} tokens is not a whole number "
            f"of {CHUNK}-token chunks (the reference asserts the same)")
    tri = torch.tril(torch.ones((c, c), dtype=torch.float32,
                                device=r.device), -1)
    carry, outs = state, []
    for j in range(0, s, c):
        rc, kc, vc, lwc = (x[:, j: j + c] for x in (r, k, v, log_w))
        cum = torch.cumsum(lwc, dim=1)  # inclusive (B,C,H,hd)
        cumprev = cum - lwc
        r_t = rc * torch.exp(cumprev)
        k_t = kc * torch.exp(-cum)
        # intra-chunk: A[t,s] for s < t, plus the u-bonus diagonal
        a = torch.einsum("bthk,bshk->bhts", r_t, k_t)
        a = a * tri[None, None]
        diag = torch.einsum("bthk,bthk->bth", rc * u[None, None], kc)
        intra = torch.einsum("bhts,bshv->bthv", a, vc)
        intra = intra + diag[..., None] * vc
        inter = torch.einsum("bthk,bhkv->bthv", r_t, carry)
        outs.append(inter + intra)
        # carry update
        decay_all = torch.exp(cum[:, -1])  # (B,H,hd)
        k_scaled = kc * torch.exp(cum[:, -1:] - cum)
        carry = carry * decay_all[..., None] + torch.einsum(
            "bshk,bshv->bhkv", k_scaled, vc)
    return torch.cat(outs, dim=1), carry


def wkv_step(r, k, v, log_w, u, state):
    """Exact single-token recurrence. r/k/v/log_w (B,H,hd); state
    (B,H,hd,hd)."""
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    out = torch.einsum("bhk,bhkv->bhv", r, state + u[None, :, :, None] * kv)
    state = torch.exp(log_w)[..., None] * state + kv
    return out, state


def _group_norm_heads(ln, x, h, hd, mine=lambda t: t):
    """Per-head layernorm (RWKV's GroupNorm(h)) with the ln_x params
    `ln`, cut by `mine` to x's channels."""
    b, s, d = x.shape
    xh = x.reshape(b, s, h, hd).to(torch.float32)
    mu = torch.mean(xh, dim=-1, keepdim=True)
    var = torch.var(xh, dim=-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + 1e-5)
    return xh.reshape(b, s, d) * mine(ln["scale"]) + mine(ln["bias"])


def _shift(x, x_prev):
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, :1])
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def time_mix(
    p: dict,
    x: torch.Tensor,  # (B,S,D) — post-ln1
    head_dim: int,
    *,
    x_prev: Optional[torch.Tensor] = None,  # (B,1,D) carry-in shift state
    state: Optional[torch.Tensor] = None,  # (B,H,hd,hd)
    spe: Optional[SPEConfig] = None,
    dtype: torch.dtype = torch.bfloat16,
):
    b, s, d = x.shape
    xw, xk, xv, xr, xg = _ddlerp(p, x, _shift(x, x_prev), dtype)
    r, k, v, g = (linear_apply(p[n], xi, spe=spe, dtype=dtype)
                  for n, xi in (("w_r", xr), ("w_k", xk), ("w_v", xv),
                                ("w_g", xg)))
    local = col_local(p["w_r"])  # this rank's columns of r/k/v/g
    if local and (d // head_dim) % shd.tp_size():  # split mid-head
        r, k, v, g = (shd.gather_model(t) for t in (r, k, v, g))
        local = False

    def mine(t, dim=-1):  # a replicated tensor's block of the local heads
        return shd.model_block(t, dim) if local else t

    h = r.shape[-1] // head_dim  # the heads this rank runs
    log_w = _heads(mine(_decay_log_w(p, xw, dtype)), h, head_dim)
    if state is None:
        state = torch.zeros((b, h, head_dim, head_dim), dtype=torch.float32,
                            device=x.device)
    else:
        state = mine(state, 1)
    out, state = wkv_chunked(
        *(_heads(t.to(torch.float32), h, head_dim) for t in (r, k, v)),
        log_w, mine(p["u"], 0), state,
    )
    y = _group_norm_heads(p["ln_x"], out.reshape(b, s, h * head_dim), h,
                          head_dim, mine)
    y = y.to(dtype) * silu(g)
    y = linear_apply(p["w_o"], y, spe=spe, dtype=dtype, x_local=local)
    if local:  # the cache keeps every head's state
        state = shd.gather_model(state, 1)
    return y, (x[:, -1:], state)


def channel_mix(
    p: dict,
    x: torch.Tensor,  # (B,S,D) — post-ln2
    *,
    x_prev: Optional[torch.Tensor] = None,
    spe: Optional[SPEConfig] = None,
    dtype: torch.dtype = torch.bfloat16,
):
    xx = (_shift(x, x_prev) - x).to(dtype)
    xk = x + xx * p["cm_mu_k"].to(dtype)
    xr = x + xx * p["cm_mu_r"].to(dtype)
    kk = torch.square(
        torch.relu(linear_apply(p["cm_k"], xk, spe=spe, dtype=dtype)))
    vv = linear_apply(p["cm_v"], kk, spe=spe, dtype=dtype,
                      x_local=col_local(p["cm_k"]))
    rr = sigmoid(linear_apply(p["cm_r"], xr, spe=spe, dtype=dtype))
    if col_local(p["cm_r"]):  # vv is whole after cm_v's all-reduce
        rr = shd.gather_model(rr)
    return rr * vv, x[:, -1:]


def block_apply(
    p: dict,
    h: torch.Tensor,
    head_dim: int,
    *,
    cache: Optional[dict] = None,
    spe: Optional[SPEConfig] = None,
    dtype: torch.dtype = torch.bfloat16,
):
    """One full RWKV-6 residual block. `cache` carries {tm_shift (B,1,D),
    cm_shift (B,1,D), state (B,H,hd,hd)}; the new ones are returned as new
    tensors (the caller writes them into its cache)."""
    c = cache or {}
    a_in = layernorm_apply(p["ln1"], h)
    att, (tm_new, state_new) = time_mix(
        p, a_in, head_dim, x_prev=c.get("tm_shift"), state=c.get("state"),
        spe=spe, dtype=dtype,
    )
    h = h + att
    c_in = layernorm_apply(p["ln2"], h)
    ffn, cm_new = channel_mix(p, c_in, x_prev=c.get("cm_shift"), spe=spe,
                              dtype=dtype)
    h = h + ffn
    return h, {"tm_shift": tm_new, "cm_shift": cm_new, "state": state_new}
