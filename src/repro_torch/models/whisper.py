"""Whisper-style encoder-decoder backbone (audio family).

Port of `repro.models.whisper`. The conv/mel frontend is a stub, as in
the reference: the encoder takes precomputed frame embeddings (B,
enc_seq, D), adds sinusoidal positions and runs a bidirectional
transformer stack; the decoder is a causal LM with learned positional
embeddings (sized to the model's `max_seq`) that cross-attends to the
encoder output.

Serving: `prefill(params, tokens, frames)` encodes the frames, runs the
prompt and builds the decode cache — per decoder layer the self-attention
ring cache and the cross-attention K/V of the encoder output (`cross_k`,
`cross_v`), stacked under "dec" with the layer axis first. `decode_step`
writes the new token's K/V into that cache **in place** and returns it,
as `models.transformer.decode_step` does. The decoder-only serving entry
points (`serve.engine.Engine`, `generate`) refuse this family with
`serve.engine.EncDecUnsupportedError`, as the reference's do. Training
(`loss_fn`) is `encode` -> `decode_train` -> the next-token
cross-entropy; both stacks take their stacked layer leaves apart once
(`transformer._unbind`), so a layer's gradient is not a full-size
zero-padded scatter.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models.layers import (
    _randn,
    embed_init,
    ffn_apply,
    ffn_init,
    layernorm_apply,
    layernorm_init,
    linear_apply,
    linear_init,
)
from repro_torch.models.transformer import (
    Dims,
    _group,
    _stack,
    _unbind,
    attn_cache_from_prefill,
    attn_cache_init,
    compute_dtype,
)


def _sinusoid(length: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(length, device=device)[:, None].to(torch.float32)
    dim = torch.arange(d // 2, device=device)[None, :].to(torch.float32)
    inv = torch.exp(-math.log(10000.0) * dim / (d // 2))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _mha_init(gen, d, heads, hd, lead):
    return {
        "wq": linear_init(gen, d, heads * hd, bias=True, lead=lead),
        "wk": linear_init(gen, d, heads * hd, bias=False, lead=lead),
        "wv": linear_init(gen, d, heads * hd, bias=True, lead=lead),
        "wo": linear_init(gen, heads * hd, d, bias=True, lead=lead),
    }


def _enc_block_init(gen, cfg: ArchConfig, dims: Dims, lead: tuple):
    d, dev = cfg.d_model, gen.device
    return {
        "ln1": layernorm_init(d, lead=lead, device=dev),
        "attn": _mha_init(gen, d, dims.n_heads, cfg.hd, lead),
        "ln2": layernorm_init(d, lead=lead, device=dev),
        "ffn": ffn_init(gen, d, dims.d_ff, act="gelu", bias=True, lead=lead),
    }


def _dec_block_init(gen, cfg: ArchConfig, dims: Dims, lead: tuple):
    d, dev = cfg.d_model, gen.device
    return {
        "ln1": layernorm_init(d, lead=lead, device=dev),
        "self_attn": _mha_init(gen, d, dims.n_heads, cfg.hd, lead),
        "ln_x": layernorm_init(d, lead=lead, device=dev),
        "cross_attn": _mha_init(gen, d, dims.n_heads, cfg.hd, lead),
        "ln2": layernorm_init(d, lead=lead, device=dev),
        "ffn": ffn_init(gen, d, dims.d_ff, act="gelu", bias=True, lead=lead),
    }


def whisper_init(gen: torch.Generator, cfg: ArchConfig, dims: Dims,
                 max_dec_seq: int) -> dict:
    """Random params drawn from `gen` on its device; the encoder's and the
    decoder's blocks stacked along a leading layer axis."""
    dev = gen.device
    return {
        "embed": embed_init(gen, dims.vocab, cfg.d_model),
        "pos_emb": _randn(gen, (max_dec_seq, cfg.d_model)).mul_(0.01),
        "enc_blocks": _enc_block_init(gen, cfg, dims, (cfg.enc_layers,)),
        "enc_ln": layernorm_init(cfg.d_model, device=dev),
        "dec_blocks": _dec_block_init(gen, cfg, dims, (cfg.n_layers,)),
        "dec_ln": layernorm_init(cfg.d_model, device=dev),
    }


def _mha(p, xq, xkv, *, heads, hd, causal, dtype, block=512):
    b, sq = xq.shape[:2]
    sk = xkv.shape[1]
    q = linear_apply(p["wq"], xq, dtype=dtype).reshape(b, sq, heads, hd)
    k = linear_apply(p["wk"], xkv, dtype=dtype).reshape(b, sk, heads, hd)
    v = linear_apply(p["wv"], xkv, dtype=dtype).reshape(b, sk, heads, hd)
    out = A.attention(q, k, v, causal=causal, block_q=block, block_k=block)
    return linear_apply(
        p["wo"], out.reshape(b, sq, heads * hd), dtype=dtype
    ), k, v


def _ffn(bp, h, dtype):
    return ffn_apply(bp["ffn"], layernorm_apply(bp["ln2"], h), act="gelu",
                     dtype=dtype)


def encode(params, frames: torch.Tensor, cfg: ArchConfig, dims: Dims):
    """frames (B, T_enc, D) — stub-frontend embeddings."""
    dtype = compute_dtype(cfg)
    h = frames.to(dtype) + _sinusoid(
        frames.shape[1], cfg.d_model, frames.device).to(dtype)
    for bp in _unbind(params["enc_blocks"], cfg.enc_layers):
        x_in = layernorm_apply(bp["ln1"], h)
        att, _, _ = _mha(bp["attn"], x_in, x_in, heads=dims.n_heads,
                         hd=cfg.hd, causal=False, dtype=dtype,
                         block=cfg.attn_block)
        h = h + att
        h = h + _ffn(bp, h, dtype)
    return layernorm_apply(params["enc_ln"], h)


def _embed(params, tokens, pos_rows, dtype):
    h = params["embed"]["w"][tokens].to(dtype)
    return h + pos_rows.to(dtype)


def _logits(params, h, dtype):
    h = layernorm_apply(params["dec_ln"], h)
    return (h @ params["embed"]["w"].to(dtype).T).to(torch.float32)  # tied


def decode_train(params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ArchConfig, dims: Dims) -> torch.Tensor:
    """Teacher-forced decoder: (B,S) tokens -> (B,S,V) float32 logits."""
    dtype = compute_dtype(cfg)
    s = tokens.shape[1]
    h = _embed(params, tokens, params["pos_emb"][:s], dtype)
    for bp in _unbind(params["dec_blocks"], cfg.n_layers):
        x_in = layernorm_apply(bp["ln1"], h)
        sa, _, _ = _mha(bp["self_attn"], x_in, x_in, heads=dims.n_heads,
                        hd=cfg.hd, causal=True, dtype=dtype,
                        block=cfg.attn_block)
        h = h + sa
        ca, _, _ = _mha(bp["cross_attn"], layernorm_apply(bp["ln_x"], h),
                        enc_out, heads=dims.n_heads, hd=cfg.hd, causal=False,
                        dtype=dtype)
        h = h + ca
        h = h + _ffn(bp, h, dtype)
    return _logits(params, h, dtype)


def loss_fn(params, batch, cfg: ArchConfig, dims: Dims):
    """Teacher-forced next-token CE of the decoder over the encoded
    `batch["frames"]`. Returns (nll, {"loss", "nll"})."""
    enc_out = encode(params, batch["frames"], cfg, dims)
    logits = decode_train(params, batch["tokens"], enc_out, cfg, dims)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["targets"].long()[..., None]).mean()
    return nll, {"loss": nll, "nll": nll}


# --- serving ---------------------------------------------------------------


def _self_dims(dims: Dims) -> Dims:
    # whisper decoder: kv heads == heads
    return Dims(dims.tp, dims.n_heads, dims.n_heads, dims.vocab, dims.d_ff)


def init_cache(cfg: ArchConfig, dims: Dims, batch: int, max_seq: int,
               device=None) -> dict:
    dtype = compute_dtype(cfg)
    lead = (cfg.n_layers,)
    cross = (*lead, batch, cfg.enc_seq, dims.n_heads, cfg.hd)
    return {"dec": {
        "self": attn_cache_init(cfg, _self_dims(dims), "global", batch,
                                max_seq, dtype, lead=lead, device=device),
        "cross_k": torch.zeros(cross, dtype=dtype, device=device),
        "cross_v": torch.zeros(cross, dtype=dtype, device=device),
    }}


def prefill(params, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ArchConfig, dims: Dims, *, max_seq: int):
    """Encode the frames and teacher-force the prompt; returns (last-token
    logits (B, V) float32, cache)."""
    dtype = compute_dtype(cfg)
    enc_out = encode(params, frames, cfg, dims)
    b, s = tokens.shape
    heads, hd = dims.n_heads, cfg.hd
    h = _embed(params, tokens, params["pos_emb"][:s], dtype)
    layers = []
    for layer in range(cfg.n_layers):
        bp = _group(params["dec_blocks"], layer)
        x_in = layernorm_apply(bp["ln1"], h)
        sa, k, v = _mha(bp["self_attn"], x_in, x_in, heads=heads, hd=hd,
                        causal=True, dtype=dtype, block=cfg.attn_block)
        h = h + sa
        cx = layernorm_apply(bp["ln_x"], h)
        xa = bp["cross_attn"]
        ck = linear_apply(xa["wk"], enc_out, dtype=dtype).reshape(
            b, -1, heads, hd)
        cv = linear_apply(xa["wv"], enc_out, dtype=dtype).reshape(
            b, -1, heads, hd)
        q = linear_apply(xa["wq"], cx, dtype=dtype).reshape(b, s, heads, hd)
        ca = A.attention(q, ck, cv, causal=False)
        h = h + linear_apply(xa["wo"], ca.reshape(b, s, -1), dtype=dtype)
        h = h + _ffn(bp, h, dtype)
        layers.append({
            "self": attn_cache_from_prefill(k, v, cfg, "global", max_seq),
            "cross_k": ck,
            "cross_v": cv,
        })
    return _logits(params, h[:, -1:], dtype)[:, 0], {"dec": _stack(layers)}


def decode_step(params, cache, token: torch.Tensor, pos: torch.Tensor,
                cfg: ArchConfig, dims: Dims):
    """One-token step: returns (logits (B, V) float32, cache), the cache
    updated in place."""
    dtype = compute_dtype(cfg)
    b = token.shape[0]
    heads, hd = dims.n_heads, cfg.hd
    h = _embed(params, token[:, None], params["pos_emb"][pos][:, None], dtype)
    bidx = torch.arange(b, device=token.device)
    for layer in range(cfg.n_layers):
        bp = _group(params["dec_blocks"], layer)
        c = _group(cache["dec"], layer)
        sa_p, xa = bp["self_attn"], bp["cross_attn"]
        x_in = layernorm_apply(bp["ln1"], h)
        q, k, v = (linear_apply(sa_p[name], x_in, dtype=dtype).reshape(
            b, heads, hd) for name in ("wq", "wk", "wv"))
        sc = c["self"]
        slot = (pos % sc["k"].shape[1]).long()
        sc["k"][bidx, slot] = k.to(sc["k"].dtype)
        sc["v"][bidx, slot] = v.to(sc["v"].dtype)
        sc["slot_pos"][bidx, slot] = pos.to(torch.int32)
        sa = A.attention_decode(q, sc["k"], sc["v"], sc["slot_pos"], pos)
        h = h + linear_apply(sa_p["wo"], sa.reshape(b, 1, -1), dtype=dtype)
        cx = layernorm_apply(bp["ln_x"], h)
        qx = linear_apply(xa["wq"], cx, dtype=dtype).reshape(b, heads, hd)
        enc_s = c["cross_k"].shape[1]
        enc_pos = torch.arange(enc_s, dtype=torch.int32,
                               device=token.device).expand(b, enc_s)
        ca = A.attention_decode(
            qx, c["cross_k"], c["cross_v"], enc_pos,
            torch.full((b,), enc_s, dtype=torch.int32, device=token.device),
        )
        h = h + linear_apply(xa["wo"], ca.reshape(b, 1, -1), dtype=dtype)
        h = h + _ffn(bp, h, dtype)
    return _logits(params, h, dtype)[:, 0], cache
