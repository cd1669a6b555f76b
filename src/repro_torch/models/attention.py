"""Attention: GQA with global / sliding-window / chunked variants.

Port of `repro.models.attention`, in plain PyTorch (the reference is jnp
compiled by XLA, not a Pallas kernel). The training/prefill path is
blockwise (flash-style): all query blocks at once along a leading block
axis (the reference's vmap) and a Python loop over KV blocks (its
`lax.scan`) with an online softmax, so the score buffer is
O(S · block), not O(S²). Three structural specializations:

  * global  — online softmax over all KV blocks (causal or
              bidirectional);
  * local   — banded: each query block attends only to its window-span of
              KV (FLOPs O(S·W) instead of O(S²));
  * chunked — chunk-diagonal (llama4): fold chunks into the batch and run
              the causal path inside each chunk (FLOPs O(S·C)).

The decode path is single-token attention over a cache with explicit
`slot_pos` validity (ring buffers for local/chunked layers).

Scores and softmax run in float32 (`SCORE_DTYPE`; the `score_dtype`
knob sets bfloat16): the reference asks its einsums for a float32
result (`preferred_element_type`), and a bfloat16 einsum in torch
returns bfloat16, so operands are cast up first. A masked score is
`NEG`, so once its row has a valid score its weight exp(NEG - max) is
exactly 0 (the direct softmax also floors the max at `NEG / 2`). The
reference's `constrain` layout hints do nothing on one device and are
dropped (`dist.sharding` ports the rules; `constrain` and
`activation_context` are ROADMAP.md queue 1 item 8b).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG = -1e30

SCORE_DTYPE = torch.float32  # set bfloat16 via score_dtype()


@contextlib.contextmanager
def score_dtype(dtype):
    """Experiment knob: compute blockwise scores/softmax in `dtype`
    (accumulators stay float32)."""
    global SCORE_DTYPE
    prev = SCORE_DTYPE
    SCORE_DTYPE = dtype
    try:
        yield
    finally:
        SCORE_DTYPE = prev


def _pos_mask(
    qi: torch.Tensor,  # (..., bq) absolute query positions
    kj: torch.Tensor,  # (bk,) or (..., bk) absolute key positions
    *,
    kind: str,
    window: int,
    causal: bool,
) -> torch.Tensor:
    """(..., bq, bk) validity; left-pad slots carry negative positions."""
    q = qi[..., :, None]
    k = kj[..., None, :]
    m = k >= 0
    if causal:
        m = m & (q >= k)
    if kind == "local" and window:
        m = m & ((q - k) < window)
    if kind == "chunked" and window:
        m = m & (torch.div(q, window, rounding_mode="floor")
                 == torch.div(k, window, rounding_mode="floor"))
    return m


def _scores(qb, kb, cap):
    """(N,B,bq,G,R,hd) x (N,B,bk,G,hd) -> (N,B,G,R,bq,bk), scaled+capped,
    in SCORE_DTYPE."""
    hd = qb.shape[-1]
    s = torch.einsum(
        "nbqgrd,nbkgd->nbgrqk", qb.to(SCORE_DTYPE), kb.to(SCORE_DTYPE)
    )
    s = s * (1.0 / torch.sqrt(torch.tensor(hd, dtype=SCORE_DTYPE)))
    if cap:
        s = cap * torch.tanh(s / cap)
    return s


def _attend_block(s, vspan, mask):
    """Direct softmax over one contiguous KV span (the local path).

    s: (N,B,G,R,bq,span) scores; vspan: (N,B,span,G,hd); mask:
    (N,bq,span). Returns (N,B,bq,G,R,hd) float32.
    """
    s = torch.where(mask[:, None, None, None], s, NEG)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - torch.clamp(m, min=NEG / 2))
    l = torch.sum(p, dim=-1, dtype=torch.float32)  # (N,B,G,R,bq)
    o = torch.einsum(
        "nbgrqk,nbkgd->nbqgrd", p.to(torch.float32), vspan.to(torch.float32)
    )
    return o / torch.clamp(l.movedim(4, 2)[..., None], min=1e-20)


def _global_blockwise(
    q, k, v, *, causal, cap, q0, k0, block_q, block_k
) -> torch.Tensor:
    """Online softmax over all KV blocks. q (B,Sq,G,R,hd), k/v (B,Sk,G,hd)."""
    b, sq, g, r, hd = q.shape
    sk = k.shape[1]
    dev = q.device
    bq = min(block_q, sq)
    bk = min(block_k, sk)
    pq = (-sq) % bq
    pk = (-sk) % bk
    qp = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
    kp = F.pad(k, (0, 0, 0, 0, 0, pk))
    vp = F.pad(v, (0, 0, 0, 0, 0, pk))
    nq = qp.shape[1] // bq
    nk = kp.shape[1] // bk
    ar = torch.arange(kp.shape[1], device=dev)
    kpos = torch.where(ar < sk, ar + k0, -1)  # pad invalid

    qbs = qp.reshape(b, nq, bq, g, r, hd).movedim(1, 0)  # (nq,B,bq,G,R,hd)
    qi = (torch.arange(nq, device=dev)[:, None] * bq
          + torch.arange(bq, device=dev) + q0)  # (nq, bq)
    m = torch.full((nq, b, g, r, bq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((nq, b, g, r, bq), dtype=torch.float32, device=dev)
    acc = torch.zeros((nq, b, g, r, bq, hd), dtype=torch.float32, device=dev)
    for j in range(nk):
        kb = kp[None, :, j * bk : (j + 1) * bk]
        vb = vp[None, :, j * bk : (j + 1) * bk]
        kj = kpos[j * bk : (j + 1) * bk]
        s = _scores(qbs, kb, cap)  # (nq,B,G,R,bq,bk)
        mask = _pos_mask(qi, kj, kind="global", window=0, causal=causal)
        s = torch.where(mask[:, None, None, None], s, NEG)
        m_new = torch.maximum(m, torch.amax(s, dim=-1).to(torch.float32))
        p = torch.exp(s.to(SCORE_DTYPE) - m_new[..., None].to(SCORE_DTYPE))
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1, dtype=torch.float32)
        pv = torch.einsum(
            "nbgrqk,nbkgd->nbgrqd", p.to(torch.float32), vb.to(torch.float32)
        )
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-20)  # (nq,B,G,R,bq,hd)
    out = out.movedim(4, 2)  # (nq,B,bq,G,R,hd)
    out = out.movedim(0, 1).reshape(b, nq * bq, g, r, hd)
    return out[:, :sq].to(q.dtype)


def _local_banded(q, k, v, *, window, cap, block) -> torch.Tensor:
    """Sliding window: query block i sees KV span [i*b - Wb, i*b + b)."""
    b, sq, g, r, hd = q.shape
    sk = k.shape[1]
    dev = q.device
    bq = min(block, sq)
    wb = -(-window // bq) * bq  # window rounded up to whole blocks
    pq = (-sq) % bq
    qp = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
    nq = qp.shape[1] // bq
    # left-pad KV by wb; right-pad to cover the last query block
    rpad = max(nq * bq - sk, 0)
    kp = F.pad(k, (0, 0, 0, 0, wb, rpad))
    vp = F.pad(v, (0, 0, 0, 0, wb, rpad))
    kpos = torch.arange(kp.shape[1], device=dev) - wb
    kpos = torch.where((kpos >= 0) & (kpos < sk), kpos, -1)
    span = wb + bq

    starts = range(0, nq * bq, bq)
    ks = torch.stack([kp[:, i : i + span] for i in starts])  # (nq,B,span,G,hd)
    vs = torch.stack([vp[:, i : i + span] for i in starts])
    kj = torch.stack([kpos[i : i + span] for i in starts])  # (nq, span)
    qbs = qp.reshape(b, nq, bq, g, r, hd).movedim(1, 0)
    qi = (torch.arange(nq, device=dev)[:, None] * bq
          + torch.arange(bq, device=dev))
    s = _scores(qbs, ks, cap)
    mask = _pos_mask(qi, kj, kind="local", window=window, causal=True)
    outs = _attend_block(s, vs, mask)  # (nq,B,bq,G,R,hd)
    out = outs.movedim(0, 1).reshape(b, nq * bq, g, r, hd)
    return out[:, :sq].to(q.dtype)


def attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Kv, hd)
    v: torch.Tensor,  # (B, Sk, Kv, hd)
    *,
    kind: str = "global",  # global | local | chunked
    window: int = 0,
    cap: float = 0.0,
    causal: bool = True,
    q_offset: int = 0,  # absolute position of q[0] (cross-attn: 0)
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """Multi-head attention with GQA; returns (B, Sq, H, hd)."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    assert h % kv == 0, (h, kv)
    qg = q.reshape(b, sq, kv, h // kv, hd)
    sk = k.shape[1]

    if kind == "chunked" and window and window < sq:
        assert sq == sk and q_offset == 0, (
            "chunked train path expects self-attention"
        )
        pad = (-sq) % window  # right-pad to whole chunks (causal-safe)
        qp = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad))
        kp = F.pad(k, (0, 0, 0, 0, 0, pad))
        vp = F.pad(v, (0, 0, 0, 0, 0, pad))
        nc = (sq + pad) // window
        qc = qp.reshape(b * nc, window, kv, h // kv, hd)
        kc = kp.reshape(b * nc, window, kv, hd)
        vc = vp.reshape(b * nc, window, kv, hd)
        out = _global_blockwise(
            qc, kc, vc, causal=causal, cap=cap, q0=0, k0=0,
            block_q=block_q, block_k=block_k,
        )
        return out.reshape(b, sq + pad, h, hd)[:, :sq]

    if kind == "local" and window and window < sk:
        assert sq == sk and q_offset == 0, "banded path is self-attention"
        out = _local_banded(qg, k, v, window=window, cap=cap, block=block_q)
        return out.reshape(b, sq, h, hd)

    out = _global_blockwise(
        qg, k, v, causal=causal, cap=cap, q0=q_offset, k0=0,
        block_q=block_q, block_k=block_k,
    )
    return out.reshape(b, sq, h, hd)


def attention_reference(
    q, k, v, *, kind="global", window=0, cap=0.0, causal=True, q_offset=0
) -> torch.Tensor:
    """Naive O(S²) oracle for tests."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    s = torch.einsum(
        "bqgrd,bkgd->bgrqk", qg.to(torch.float32), k.to(torch.float32)
    ) / math.sqrt(hd)
    if cap:
        s = cap * torch.tanh(s / cap)
    qi = torch.arange(sq, device=q.device) + q_offset
    kj = torch.arange(k.shape[1], device=q.device)
    mask = _pos_mask(qi, kj, kind=kind, window=window, causal=causal)
    s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.to(torch.float32))
    return o.reshape(b, sq, h, hd).to(q.dtype)


def _decode_valid(slot_pos, pos, kind, window):
    p = pos[:, None]
    valid = (slot_pos >= 0) & (slot_pos <= p)
    if kind == "local" and window:
        valid = valid & ((p - slot_pos) < window)
    if kind == "chunked" and window:
        valid = valid & (torch.div(slot_pos, window, rounding_mode="floor")
                         == torch.div(p, window, rounding_mode="floor"))
    return valid


def attention_decode(
    q: torch.Tensor,  # (B, H, hd) — one new token per sequence
    k_cache: torch.Tensor,  # (B, S_cache, Kv, hd) — bf16/f32 or int8
    v_cache: torch.Tensor,  # (B, S_cache, Kv, hd)
    slot_pos: torch.Tensor,  # (B, S_cache) int32 absolute positions, -1 empty
    pos: torch.Tensor,  # (B,) absolute position of the new token
    *,
    kind: str = "global",
    window: int = 0,
    cap: float = 0.0,
    block_k: int = 8192,
    k_scale: Optional[torch.Tensor] = None,  # (B, S_cache, Kv) for int8 KV
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token attention over a (ring) cache.

    Caches longer than `block_k` go through an online softmax over KV
    blocks, so the float32 score buffer is O(block_k), not O(S_cache).
    int8 caches (per-slot-per-head scales) dequantize per block.
    """
    b, h, hd = q.shape
    kv = k_cache.shape[2]
    qg = q.reshape(b, kv, h // kv, hd).to(torch.float32)
    sc = k_cache.shape[1]
    dt = q.dtype

    def block(kb, vb, sp_b, ksb, vsb):
        if ksb is not None:  # dequantize the block
            kb = (kb.to(torch.float32) * ksb[..., None]).to(dt)
            vb = (vb.to(torch.float32) * vsb[..., None]).to(dt)
        s = torch.einsum(
            "bgrd,bkgd->bgrk", qg, kb.to(torch.float32)
        ) / math.sqrt(hd)
        if cap:
            s = cap * torch.tanh(s / cap)
        valid = _decode_valid(sp_b, pos, kind, window)
        return torch.where(valid[:, None, None, :], s, NEG), vb

    if sc <= block_k:
        s, vd = block(k_cache, v_cache, slot_pos, k_scale, v_scale)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bgrk,bkgd->bgrd", p, vd.to(torch.float32))
        return o.reshape(b, h, hd).to(dt)

    dev = q.device
    m = torch.full((b, kv, h // kv), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kv, h // kv), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kv, h // kv, hd), dtype=torch.float32, device=dev)
    for j0 in range(0, sc, block_k):
        sl = slice(j0, j0 + block_k)
        ksb = vsb = None
        if k_scale is not None:
            ksb, vsb = k_scale[:, sl], v_scale[:, sl]
        s, vb = block(k_cache[:, sl], v_cache[:, sl], slot_pos[:, sl], ksb, vsb)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        pv = torch.einsum("bgrk,bkgd->bgrd", p, vb.to(torch.float32))
        acc = acc * alpha[..., None] + pv
        m = m_new
    o = acc / torch.clamp(l[..., None], min=1e-20)
    return o.reshape(b, h, hd).to(dt)
