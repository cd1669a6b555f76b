"""Decoder-only LM stack: pattern-period groups of heterogeneous blocks.

Port of `repro.models.transformer`. One orchestrator serves the dense
attention families (global / local / chunked attention, GQA, qk-norm, qkv
bias, softcaps, sandwich norms, M-RoPE), MoE FFNs (`models.moe`), and the
recurrent blocks `rglru` (`models.rglru`) and `rwkv` (`models.rwkv6`):

  * layers are grouped by the config's block `pattern`; each pattern
    position's params are stacked along a leading `n_groups` axis, as in
    the reference. Where it runs a `lax.scan` over the groups, the port
    loops in Python and slices group `[g]` (a packed weight's bit width
    still comes from its `[g]` slice's shape);
  * a tail of n_layers % period layers is run after the groups with its
    own params;
  * decode threads a cache through the same structure — ring buffers for
    local/chunked attention (capacity = window), full buffers for global
    attention, O(1) states for rwkv/rglru blocks (`h` and `state` in
    float32, the rest in the compute dtype), leaf for leaf the
    reference's layout.

The decode cache is updated **in place**: `decode_step` writes the new
token's K/V (and `slot_pos`), and every recurrent block's new state, into
the cache it is given and returns that same cache, where the reference
returns a new one. A recurrent state advances on every row, idle rows
included, as in the reference (seating overwrites a row when it is
reused). A caller that needs the old cache clones it first. `prefill`
builds a fresh cache.

The paged cache (`init_cache_paged`, `decode_step(page_tbl=, page=)`)
keeps every attention block's K/V in a shared `(n_pages, page, ...)` pool
behind a slot->page table the engine passes in per step; `slot_pos` and
recurrent state stay dense per slot. A paged step gathers the slot's
pages into the dense ring view, writes the new K/V into that view and
into its physical page, and attends over the view: bit for bit the dense
step (masked scores weigh exactly 0).

Training: `loss_fn` is the next-token cross-entropy (plus the MoE
auxiliary loss), optionally chunked over S (`cfg.loss_chunk`). Under
`cfg.remat == "block"` (every config's default) each pattern group of
`forward_train` runs under non-reentrant `torch.utils.checkpoint`, as the
reference wraps its scan body in `jax.checkpoint`; the tail runs outside
it. `forward_train` takes each stacked `(n_groups, ...)` leaf apart once
with `torch.unbind`, whose backward is one stack, where slicing `[g]` in
every group would add a full-size zero-padded gradient per group. The
reference's `constrain` layout hints do nothing on one device and are
dropped (`dist.sharding` ports the rules; `constrain` and
`activation_context` are ROADMAP.md queue 1 item 8b).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, pad_up
from repro_torch.core.spe import SPEConfig
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RWKV
from repro_torch.models.layers import (
    apply_rope,
    embed_apply,
    embed_init,
    ffn_apply,
    ffn_init,
    linear_apply,
    linear_init,
    norm_apply,
    norm_init,
    softcap,
)

# ---------------------------------------------------------------------------
# Mesh-divisibility padding
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Dims:
    """Physical (padded) dimensions for a given TP degree."""

    tp: int
    n_heads: int
    n_kv: int
    vocab: int
    d_ff: int

    @staticmethod
    def create(cfg: ArchConfig, tp: int = 1) -> "Dims":
        if not cfg.use_tp:
            tp = 1
        n_heads = pad_up(cfg.n_heads, tp)
        if cfg.kv_mode == "pad" and tp > 1:
            n_kv = pad_up(cfg.n_kv_heads, min(tp, pad_up(cfg.n_heads, tp)))
        else:
            n_kv = cfg.n_kv_heads
        # keep GQA grouping consistent: heads must divide evenly over kv
        while n_heads % n_kv:
            n_kv += 1 if cfg.kv_mode == "pad" else -1
        return Dims(
            tp=tp,
            n_heads=n_heads,
            n_kv=n_kv,
            vocab=pad_up(cfg.vocab, max(tp, 128)),
            d_ff=pad_up(cfg.d_ff, tp),
        )


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def spe_config(cfg: ArchConfig) -> Optional[SPEConfig]:
    if cfg.spe_bits is None and not cfg.spe_sparse:
        return None
    return SPEConfig(
        bits=cfg.spe_bits or 8,
        group_size=cfg.spe_group,
        keep=cfg.spe_keep,
        sparse=cfg.spe_sparse,
        quantized=cfg.spe_bits is not None,
    )


def _group(tree: Any, g: int) -> Any:
    """Group `g` of a stacked subtree: every tensor leaf sliced on its
    leading axis (a view, so writes reach the stacked tensor)."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g] if isinstance(tree, torch.Tensor) else tree


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------


def attn_init(gen: torch.Generator, cfg: ArchConfig, dims: Dims,
              lead: tuple = ()) -> dict:
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": linear_init(gen, d, dims.n_heads * hd, bias=cfg.qkv_bias,
                          lead=lead),
        "wk": linear_init(gen, d, dims.n_kv * hd, bias=cfg.qkv_bias,
                          lead=lead),
        "wv": linear_init(gen, d, dims.n_kv * hd, bias=cfg.qkv_bias,
                          lead=lead),
        "wo": linear_init(gen, dims.n_heads * hd, d, lead=lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init("rmsnorm", hd, lead=lead, device=gen.device)
        p["k_norm"] = norm_init("rmsnorm", hd, lead=lead, device=gen.device)
    return p


def _qkv(p, x, pos, cfg, dims, spe, dtype):
    b, s = x.shape[:2]
    hd = cfg.hd
    q = linear_apply(p["wq"], x, spe=spe, dtype=dtype).reshape(
        b, s, dims.n_heads, hd
    )
    k = linear_apply(p["wk"], x, spe=spe, dtype=dtype).reshape(
        b, s, dims.n_kv, hd
    )
    v = linear_apply(p["wv"], x, spe=spe, dtype=dtype).reshape(
        b, s, dims.n_kv, hd
    )
    if cfg.qk_norm:
        q = norm_apply("rmsnorm", p["q_norm"], q)
        k = norm_apply("rmsnorm", p["k_norm"], k)
    q = apply_rope(q, pos, theta=cfg.rope_theta, sections=cfg.mrope_sections)
    k = apply_rope(k, pos, theta=cfg.rope_theta, sections=cfg.mrope_sections)
    return q, k, v


def attn_apply_train(
    p: dict, x: torch.Tensor, pos: torch.Tensor, cfg: ArchConfig,
    dims: Dims, kind: str, *, spe, dtype,
) -> torch.Tensor:
    q, k, v = _qkv(p, x, pos, cfg, dims, spe, dtype)
    out = A.attention(
        q, k, v, kind=kind, window=cfg.window, cap=cfg.attn_softcap,
        causal=True, block_q=cfg.attn_block, block_k=cfg.attn_block,
    )
    b, s = x.shape[:2]
    return linear_apply(
        p["wo"], out.reshape(b, s, dims.n_heads * cfg.hd), spe=spe,
        dtype=dtype,
    )


def cache_capacity(cfg: ArchConfig, kind: str, max_seq: int) -> int:
    if kind in ("local", "chunked") and cfg.window:
        return min(cfg.window, max_seq)
    return max_seq


def attn_cache_init(
    cfg: ArchConfig, dims: Dims, kind: str, batch: int, max_seq: int,
    dtype, *, lead: tuple = (), device=None,
) -> dict:
    cap = cache_capacity(cfg, kind, max_seq)
    shape = (*lead, batch, cap, dims.n_kv, cfg.hd)
    sp = torch.full((*lead, batch, cap), -1, dtype=torch.int32, device=device)
    if cfg.kv_quant_bits == 8:
        # int8 KV (per-slot-per-head symmetric scales)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], device=device),
            "v_scale": torch.zeros(shape[:-1], device=device),
            "slot_pos": sp,
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": sp,
    }


def attn_capacities(cfg: ArchConfig, max_seq: int) -> tuple[int, ...]:
    """Cache capacities of every attention block position (pattern+tail)."""
    kinds = tuple(cfg.pattern) + tuple(cfg.tail or ())
    return tuple(
        cache_capacity(cfg, k, max_seq)
        for k in kinds
        if k not in ("rglru", "rwkv")
    )


def _check_page(kind: str, cap: int, page: int) -> None:
    if cap % page != 0:
        raise ValueError(
            f"page={page} does not divide {kind} cache capacity {cap}"
        )


def attn_cache_init_paged(
    cfg: ArchConfig, dims: Dims, kind: str, batch: int, n_pages: int,
    page: int, max_seq: int, dtype, *, lead: tuple = (), device=None,
) -> dict:
    """Paged twin of `attn_cache_init`: K/V (and int8 scales) become
    `(n_pages, page, ...)` physical pages; which pages belong to which
    slot is the engine's table, passed into `decode_step` each step and
    never stored in the cache. `slot_pos` stays a dense per-slot
    `(batch, cap)`: it is the validity mask that keeps garbage in unmapped
    and scratch pages unread, so it is always slot-addressed."""
    cap = cache_capacity(cfg, kind, max_seq)
    _check_page(kind, cap, page)
    shape = (*lead, n_pages, page, dims.n_kv, cfg.hd)
    sp = torch.full((*lead, batch, cap), -1, dtype=torch.int32, device=device)
    if cfg.kv_quant_bits == 8:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], device=device),
            "v_scale": torch.zeros(shape[:-1], device=device),
            "slot_pos": sp,
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": sp,
    }


def paged_layouts(cfg: ArchConfig, page: int, max_seq: int) -> dict:
    """attn cache path prefix -> (logical pages per slot, page size).

    Keys are the '/'-joined tree paths of the paged K/V leaves' parents
    (e.g. "blocks/pos0/attn"); `serve.seating` uses them to tell page-pool
    leaves from dense per-slot leaves, and the engine to size a block's
    view of the table."""
    out: dict[str, tuple[int, int]] = {}
    for top, kinds in (("blocks", cfg.pattern), ("tail", cfg.tail or ())):
        for i, kind in enumerate(kinds):
            if kind in ("rglru", "rwkv"):
                continue
            cap = cache_capacity(cfg, kind, max_seq)
            _check_page(kind, cap, page)
            out[f"{top}/pos{i}/attn"] = (cap // page, page)
    return out


def _kv_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, Kv, hd) -> (int8 values, (B, S, Kv) f32 scales)."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(amax, min=1e-20) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def attn_apply_decode(
    p: dict, x: torch.Tensor, pos: torch.Tensor, cache: dict,
    cfg: ArchConfig, dims: Dims, kind: str, *, spe, dtype, page_tbl=None,
    page: int = 0,
) -> tuple[torch.Tensor, dict]:
    """x (B,1,D); pos (B,) absolute positions. Writes the token's K/V into
    its ring slot (`pos % cap`) of `cache` in place, then attends over the
    cache. Returns (y, cache).

    With `page_tbl` (B, span) set, K/V live in a `(n_pages, page, ...)`
    pool. In the reference's order: the slot's pages are gathered into the
    dense (B, cap) ring view, the new token is written into that view at
    its slot and, separately, into its physical page, and attention runs
    on the view. (Writing the pool first and gathering after would not be
    the reference's step: every idle row's table points at the shared
    scratch page, so an idle row would read another row's K/V at its own
    position. Idle rows' logits are discarded either way.)
    Unmapped logical pages point at scratch, whose garbage never survives
    the `slot_pos` mask (masked scores weigh exp(-1e30 - ...) == 0.0
    exactly), so paged and dense decode are bitwise identical. Idle rows
    all write the scratch page, in an unspecified order on the card;
    scratch is never read unmasked."""
    b = x.shape[0]
    rope_pos = pos[:, None]  # (B,1)
    if cfg.mrope_sections:
        rope_pos = pos[:, None, None].expand(b, len(cfg.mrope_sections), 1)
    q, k, v = _qkv(p, x, rope_pos, cfg, dims, spe, dtype)
    cap = cache["slot_pos"].shape[1]
    slot = (pos % cap).long()  # (B,)
    bidx = torch.arange(b, device=x.device)
    cache["slot_pos"][bidx, slot] = pos.to(torch.int32)
    new = {"k": k[:, 0], "v": v[:, 0]}
    if cfg.kv_quant_bits == 8:
        (new["k"], new["k_scale"]), (new["v"], new["v_scale"]) = (
            _kv_quant(k[:, 0]), _kv_quant(v[:, 0]))
    if page_tbl is None:
        view = cache
        for name, val in new.items():
            cache[name][bidx, slot] = val.to(cache[name].dtype)
    else:
        tblb = page_tbl[:, : cap // page].long()  # (B, maxp) this block's
        phys = tblb[bidx, slot // page]
        off = slot % page
        view = {}
        for name, val in new.items():
            pool = cache[name]
            # gather first: the dense ring view (B, cap, ...)
            view[name] = pool[tblb].reshape(b, cap, *pool.shape[2:])
            view[name][bidx, slot] = val.to(pool.dtype)
            pool[phys, off] = val.to(pool.dtype)
    out = A.attention_decode(
        q[:, 0], view["k"], view["v"], cache["slot_pos"], pos,
        kind=kind, window=cfg.window, cap=cfg.attn_softcap,
        k_scale=view.get("k_scale"), v_scale=view.get("v_scale"),
    )
    y = linear_apply(
        p["wo"], out.reshape(b, 1, dims.n_heads * cfg.hd), spe=spe,
        dtype=dtype,
    )
    return y, cache


def attn_cache_from_prefill(
    k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig, kind: str,
    max_seq: int,
) -> dict:
    """Build the ring cache state equivalent to having decoded 0..S-1."""
    b, s = k.shape[:2]
    dev = k.device
    cap = cache_capacity(cfg, kind, max_seq)
    sp = torch.full((b, cap), -1, dtype=torch.int32, device=dev)
    n = min(s, cap)
    tail = torch.arange(s - n, s, device=dev)
    slots = tail % cap
    sp[:, slots] = tail.to(torch.int32).expand(b, n)
    if cfg.kv_quant_bits == 8:
        kq, ks = _kv_quant(k)
        vq, vs = _kv_quant(v)
        out = {
            "k": torch.zeros((b, cap, *k.shape[2:]), dtype=torch.int8, device=dev),
            "v": torch.zeros((b, cap, *k.shape[2:]), dtype=torch.int8, device=dev),
            "k_scale": torch.zeros((b, cap, k.shape[2]), device=dev),
            "v_scale": torch.zeros((b, cap, k.shape[2]), device=dev),
            "slot_pos": sp,
        }
        for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            out[name][:, slots] = val[:, tail]
        return out
    kc = torch.zeros((b, cap, *k.shape[2:]), dtype=k.dtype, device=dev)
    vc = torch.zeros_like(kc)
    kc[:, slots] = k[:, tail]
    vc[:, slots] = v[:, tail]
    return {"k": kc, "v": vc, "slot_pos": sp}


# ---------------------------------------------------------------------------
# Block = (norms + mixer + ffn/moe), dispatched on kind
# ---------------------------------------------------------------------------


def block_init(gen: torch.Generator, cfg: ArchConfig, dims: Dims, kind: str,
               lead: tuple = ()) -> dict:
    d, dev = cfg.d_model, gen.device
    if kind == "rwkv":
        return {"rwkv": RWKV.rwkv_init(gen, d, dims.d_ff, cfg.rwkv_head_dim,
                                       lead)}
    p = {"ln1": norm_init(cfg.norm, d, lead=lead, device=dev),
         "ln2": norm_init(cfg.norm, d, lead=lead, device=dev)}
    if cfg.sandwich_norm:
        p["post_ln1"] = norm_init(cfg.norm, d, lead=lead, device=dev)
        p["post_ln2"] = norm_init(cfg.norm, d, lead=lead, device=dev)
    if kind == "rglru":
        p["mix"] = RG.rglru_init(gen, d, cfg.lru_dim, cfg.conv_width, lead)
    else:
        p["mix"] = attn_init(gen, cfg, dims, lead)
    if cfg.moe is not None:
        p["moe"] = MOE.moe_init(gen, d, cfg.moe, lead)
    else:
        p["ffn"] = ffn_init(gen, d, dims.d_ff, act=cfg.act, lead=lead)
    return p


def _write(cache: dict, new: dict) -> None:
    """A recurrent block's new state into its cache, in place."""
    for k, v in new.items():
        cache[k].copy_(v)


def _ffn_half(p: dict, h: torch.Tensor, mixed: torch.Tensor,
              cfg: ArchConfig, *, spe, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The mixer's residual add, then the FFN (or MoE) half of a block.
    Returns (h, moe_aux)."""
    if cfg.sandwich_norm:
        mixed = norm_apply(cfg.norm, p["post_ln1"], mixed)
    h = h + mixed
    f_in = norm_apply(cfg.norm, p["ln2"], h)
    if cfg.moe is not None:
        f_out, aux = MOE.moe_apply(p["moe"], f_in, cfg.moe, dtype=dtype)
    else:
        f_out = ffn_apply(p["ffn"], f_in, act=cfg.act, spe=spe, dtype=dtype)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.sandwich_norm:
        f_out = norm_apply(cfg.norm, p["post_ln2"], f_out)
    return h + f_out, aux


def block_apply(
    p: dict,
    h: torch.Tensor,
    pos: torch.Tensor,
    cfg: ArchConfig,
    dims: Dims,
    kind: str,
    *,
    cache: Optional[dict] = None,
    spe=None,
    dtype=torch.bfloat16,
    page_tbl=None,
    page: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """Returns (h, moe_aux, cache) — the cache updated in place."""
    if kind == "rwkv":
        rc = cache["rwkv"] if cache is not None else None
        h, nc = RWKV.block_apply(p["rwkv"], h, cfg.rwkv_head_dim, cache=rc,
                                 spe=spe, dtype=dtype)
        if rc is not None:
            _write(rc, nc)
        return h, torch.zeros((), dtype=torch.float32, device=h.device), cache
    a_in = norm_apply(cfg.norm, p["ln1"], h)
    if kind == "rglru":
        rc = cache["rglru"] if cache is not None else None
        mixed, nc = RG.rglru_apply(p["mix"], a_in, cache=rc, spe=spe,
                                   dtype=dtype)
        if rc is not None:
            _write(rc, nc)
    elif cache is not None:
        mixed, _ = attn_apply_decode(
            p["mix"], a_in, pos, cache["attn"], cfg, dims, kind,
            spe=spe, dtype=dtype, page_tbl=page_tbl, page=page,
        )
    else:
        mixed = attn_apply_train(
            p["mix"], a_in, pos, cfg, dims, kind, spe=spe, dtype=dtype
        )
    h, aux = _ffn_half(p, h, mixed, cfg, spe=spe, dtype=dtype)
    return h, aux, cache


def block_cache_init(
    cfg: ArchConfig, dims: Dims, kind: str, batch: int, max_seq: int, dtype,
    *, lead: tuple = (), device=None,
) -> dict:
    def zeros(shape, dt):
        return torch.zeros((*lead, *shape), dtype=dt, device=device)

    d = cfg.d_model
    if kind == "rwkv":
        h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
        return {"rwkv": {
            "tm_shift": zeros((batch, 1, d), dtype),
            "cm_shift": zeros((batch, 1, d), dtype),
            "state": zeros((batch, h, hd, hd), torch.float32),
        }}
    if kind == "rglru":
        return {"rglru": {
            "h": zeros((batch, cfg.lru_dim), torch.float32),
            "conv": zeros((batch, cfg.conv_width - 1, cfg.lru_dim), dtype),
        }}
    return {"attn": attn_cache_init(cfg, dims, kind, batch, max_seq, dtype,
                                    lead=lead, device=device)}


def block_cache_init_paged(
    cfg: ArchConfig, dims: Dims, kind: str, batch: int, n_pages: int,
    page: int, max_seq: int, dtype, *, lead: tuple = (), device=None,
) -> dict:
    if kind in ("rwkv", "rglru"):
        # recurrent state is O(1) per slot: nothing to page
        return block_cache_init(cfg, dims, kind, batch, max_seq, dtype,
                                lead=lead, device=device)
    return {"attn": attn_cache_init_paged(
        cfg, dims, kind, batch, n_pages, page, max_seq, dtype, lead=lead,
        device=device)}


# ---------------------------------------------------------------------------
# Full stack
# ---------------------------------------------------------------------------


def stack_init(gen: torch.Generator, cfg: ArchConfig, dims: Dims) -> dict:
    """Random params drawn from `gen` on its device, in a fixed order."""
    params: dict[str, Any] = {
        "embed": embed_init(gen, dims.vocab, cfg.d_model),
        "final_norm": norm_init(cfg.norm, cfg.d_model, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(gen, cfg.d_model, dims.vocab)
    params["blocks"] = {
        f"pos{p_idx}": block_init(gen, cfg, dims, kind, (cfg.n_groups,))
        for p_idx, kind in enumerate(cfg.pattern)
    }
    if cfg.tail:
        params["tail"] = {
            f"pos{i}": block_init(gen, cfg, dims, kind)
            for i, kind in enumerate(cfg.tail)
        }
    return params


def _positions(cfg: ArchConfig, batch: int, seq: int, device) -> torch.Tensor:
    pos = torch.arange(seq, device=device).expand(batch, seq)
    if cfg.mrope_sections:
        # text-stub M-RoPE: all three rows equal (== standard RoPE)
        pos = pos[:, None, :].expand(batch, len(cfg.mrope_sections), seq)
    return pos


def _groups(params: dict, cfg: ArchConfig):
    """(group params, pattern index, kind) in layer order: the stacked
    groups, then the tail."""
    for g in range(cfg.n_groups):
        for p_idx, kind in enumerate(cfg.pattern):
            yield ("blocks", f"pos{p_idx}", g), kind
    for i, kind in enumerate(cfg.tail):
        yield ("tail", f"pos{i}", None), kind


def _at(tree: dict, where: tuple) -> Any:
    top, key, g = where
    sub = tree[top][key]
    return sub if g is None else _group(sub, g)


def _logits(params: dict, h: torch.Tensor, cfg: ArchConfig, dtype) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = h @ params["embed"]["w"].to(dtype).T
    else:
        logits = linear_apply(params["lm_head"], h, dtype=dtype)
    return softcap(logits.to(torch.float32), cfg.final_softcap)


def _unbind(tree: Any, n: int) -> list:
    """The `n` groups of a stacked subtree, each leaf taken apart once on
    its leading axis (`torch.unbind`: its backward stacks the groups'
    gradients, where `n` slices would each scatter into a full-size
    zero tensor)."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[g] for k, v in parts.items()} for g in range(n)]
    if isinstance(tree, torch.Tensor):
        return list(torch.unbind(tree))
    return [tree] * n


def forward_train(
    params: dict,
    tokens: torch.Tensor,  # (B, S)
    cfg: ArchConfig,
    dims: Dims,
    *,
    positions: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B,S,V_padded) f32, moe_aux) — or the post-norm
    hidden states (B,S,D) when return_hidden (the chunked-CE path)."""
    dtype = compute_dtype(cfg)
    spe = spe_config(cfg)
    b, s = tokens.shape
    pos = positions if positions is not None else _positions(
        cfg, b, s, tokens.device)
    h = embed_apply(params["embed"], tokens, dtype=dtype,
                    scale=cfg.scale_embed)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    def group_body(h, aux, gp):
        for p_idx, kind in enumerate(cfg.pattern):
            h, a, _ = block_apply(gp[f"pos{p_idx}"], h, pos, cfg, dims, kind,
                                  spe=spe, dtype=dtype)
            aux = aux + a
        return h, aux

    remat = cfg.remat == "block" and torch.is_grad_enabled()
    for gp in _unbind(params["blocks"], cfg.n_groups):
        if remat:
            h, aux = checkpoint(group_body, h, aux, gp, use_reentrant=False)
        else:
            h, aux = group_body(h, aux, gp)
    for i, kind in enumerate(cfg.tail):
        h, a, _ = block_apply(params["tail"][f"pos{i}"], h, pos, cfg, dims,
                              kind, spe=spe, dtype=dtype)
        aux = aux + a
    h = norm_apply(cfg.norm, params["final_norm"], h)
    if return_hidden:
        return h, aux
    return _logits(params, h, cfg, dtype), aux


def _chunk_nll_sum(params: dict, hc: torch.Tensor, tc: torch.Tensor,
                   mc: torch.Tensor, cfg: ArchConfig, dtype) -> torch.Tensor:
    """sum(log p(target) * mask) over one (B, c) chunk of the sequence."""
    lp = F.log_softmax(_logits(params, hc, cfg, dtype), dim=-1)
    pick = torch.gather(lp, -1, tc[..., None])[..., 0]
    return torch.sum(pick * mc)


def loss_fn(
    params: dict, batch: dict, cfg: ArchConfig, dims: Dims
) -> tuple[torch.Tensor, dict]:
    """Next-token CE (+ MoE aux). Targets beyond cfg.vocab never occur.

    With cfg.loss_chunk > 0 the CE is evaluated in S-chunks, each under
    non-reentrant checkpoint: the lm_head matmul and the log-softmax run
    per chunk and are recomputed in the backward, so live logits are
    (B, chunk, V) instead of (B, S, V), as in the reference's scan —
    without the checkpoint autograd would keep every chunk's log-probs.
    """
    tgt = batch["targets"].long()
    if not cfg.loss_chunk:
        logits, aux = forward_train(
            params, batch["tokens"], cfg, dims,
            positions=batch.get("positions"),
        )
        logp = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, tgt[..., None]).mean()
    else:
        h, aux = forward_train(
            params, batch["tokens"], cfg, dims,
            positions=batch.get("positions"), return_hidden=True,
        )
        dtype = compute_dtype(cfg)
        b, s, _ = h.shape
        c = min(cfg.loss_chunk, s)
        pad = (-s) % c
        hp = F.pad(h, (0, 0, 0, pad))
        tp_ = F.pad(tgt, (0, pad))
        mask = F.pad(torch.ones((b, s), dtype=torch.float32, device=h.device),
                     (0, pad))
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, s + pad, c):
            total = total - checkpoint(
                _chunk_nll_sum, params, hp[:, i:i + c], tp_[:, i:i + c],
                mask[:, i:i + c], cfg, dtype, use_reentrant=False,
            )
        nll = total / (b * s)
    loss = nll
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_coef * aux
    return loss, {"loss": loss, "nll": nll, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ArchConfig, dims: Dims, batch: int, max_seq: int, device=None
) -> dict:
    dtype = compute_dtype(cfg)
    cache: dict[str, Any] = {"blocks": {
        f"pos{p_idx}": block_cache_init(cfg, dims, kind, batch, max_seq,
                                        dtype, lead=(cfg.n_groups,),
                                        device=device)
        for p_idx, kind in enumerate(cfg.pattern)
    }}
    if cfg.tail:
        cache["tail"] = {
            f"pos{i}": block_cache_init(cfg, dims, kind, batch, max_seq,
                                        dtype, device=device)
            for i, kind in enumerate(cfg.tail)
        }
    return cache


def init_cache_paged(
    cfg: ArchConfig, dims: Dims, batch: int, n_pages: int, page: int,
    max_seq: int, device=None,
) -> dict:
    """Paged twin of `init_cache`: every attention block position gets its
    own `(n_pages, page, ...)` K/V pool; recurrent and `slot_pos` state
    stays dense per slot. With no attention blocks this is exactly
    `init_cache` (paging degenerates to the dense pool)."""
    dtype = compute_dtype(cfg)
    cache: dict[str, Any] = {"blocks": {
        f"pos{p_idx}": block_cache_init_paged(
            cfg, dims, kind, batch, n_pages, page, max_seq, dtype,
            lead=(cfg.n_groups,), device=device)
        for p_idx, kind in enumerate(cfg.pattern)
    }}
    if cfg.tail:
        cache["tail"] = {
            f"pos{i}": block_cache_init_paged(
                cfg, dims, kind, batch, n_pages, page, max_seq, dtype,
                device=device)
            for i, kind in enumerate(cfg.tail)
        }
    return cache


def decode_step(
    params: dict,
    cache: dict,
    token: torch.Tensor,  # (B,) int
    pos: torch.Tensor,  # (B,) int absolute position of `token`
    cfg: ArchConfig,
    dims: Dims,
    page_tbl=None,  # (B, span) int slot->page table; None = dense pool
    page: int = 0,
) -> tuple[torch.Tensor, dict]:
    """One-token step: returns (logits (B, V_padded) f32, cache), the cache
    updated in place."""
    dtype = compute_dtype(cfg)
    h = embed_apply(params["embed"], token[:, None], dtype=dtype,
                    scale=cfg.scale_embed)
    for where, kind in _groups(params, cfg):
        h, _, _ = block_apply(
            _at(params, where), h, pos, cfg, dims, kind,
            cache=_at(cache, where), spe=None, dtype=dtype,
            page_tbl=page_tbl, page=page,
        )
    h = norm_apply(cfg.norm, params["final_norm"], h)
    return _logits(params, h, cfg, dtype)[:, 0], cache


def prefill(
    params: dict,
    tokens: torch.Tensor,  # (B, S)
    cfg: ArchConfig,
    dims: Dims,
    *,
    max_seq: int,
) -> tuple[torch.Tensor, dict]:
    """Process a prompt, build the decode cache. Returns (last-token
    logits (B, V_padded), cache).

    Runs each block in train mode while also building its decode cache:
    an attention layer's ring cache from the (k, v) it computed, a
    recurrent layer's final state."""
    dtype = compute_dtype(cfg)
    b, s = tokens.shape
    pos = _positions(cfg, b, s, tokens.device)
    h = embed_apply(params["embed"], tokens, dtype=dtype,
                    scale=cfg.scale_embed)
    caches: dict[str, Any] = {"blocks": {}}
    for where, kind in _groups(params, cfg):
        h, c = _prefill_block(_at(params, where), h, pos, cfg, dims, kind,
                              max_seq=max_seq, dtype=dtype)
        top, key, _ = where
        caches.setdefault(top, {}).setdefault(key, []).append(c)
    # stack the groups' caches along the leading group axis; the tail's
    # positions hold one cache each
    cache = {
        top: {key: _stack(lst) if top == "blocks" else _fresh(lst[0])
              for key, lst in sub.items()}
        for top, sub in caches.items()
    }
    h = norm_apply(cfg.norm, params["final_norm"], h)
    return _logits(params, h[:, -1:], cfg, dtype)[:, 0], cache


def _prefill_block(p: dict, h: torch.Tensor, pos: torch.Tensor,
                   cfg: ArchConfig, dims: Dims, kind: str, *, max_seq: int,
                   dtype) -> tuple[torch.Tensor, dict]:
    """A train-mode block that also returns its decode cache."""
    if kind == "rwkv":
        h, nc = RWKV.block_apply(p["rwkv"], h, cfg.rwkv_head_dim, dtype=dtype)
        return h, {"rwkv": nc}
    b, s = h.shape[:2]
    a_in = norm_apply(cfg.norm, p["ln1"], h)
    if kind == "rglru":
        mixed, nc = RG.rglru_apply(p["mix"], a_in, dtype=dtype)
        cache = {"rglru": nc}
    else:
        q, k, v = _qkv(p["mix"], a_in, pos, cfg, dims, None, dtype)
        out = A.attention(
            q, k, v, kind=kind, window=cfg.window, cap=cfg.attn_softcap,
            causal=True, block_q=cfg.attn_block, block_k=cfg.attn_block,
        )
        mixed = linear_apply(
            p["mix"]["wo"], out.reshape(b, s, dims.n_heads * cfg.hd),
            dtype=dtype,
        )
        cache = {"attn": attn_cache_from_prefill(k, v, cfg, kind, max_seq)}
    h, _ = _ffn_half(p, h, mixed, cfg, spe=None, dtype=dtype)
    return h, cache


def _fresh(tree: Any) -> Any:
    """`tree` with every leaf in its own contiguous storage (a recurrent
    state can be a slice of a prompt-long activation)."""
    if isinstance(tree, dict):
        return {k: _fresh(v) for k, v in tree.items()}
    return tree.contiguous()


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)
