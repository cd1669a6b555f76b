"""Mixture-of-Experts: top-k routing with sort-based capacity dispatch.

Port of `repro.models.moe`. Tokens are ranked within their expert by a
per-row stable argsort, which gives each (token, expert-slot) a position;
tokens beyond the capacity C = ceil(S·k·cf / E) (clipped to S·k) are
dropped (weight 0). So a 16-token prefill can drop tokens that a one-token
decode step keeps, as in the reference.

The expert weights are bare (E, d, f) float32 arrays, so
`serve.engine.quantize_for_serving` leaves them dense; `moe_apply` casts
them to the compute dtype on every call and runs its own einsums, as the
reference does. The shared expert (llama4) is an `ffn_init` block and is
packed like any other FFN.

Tensor parallelism (sharded serving, `serve.sharded`): the reference's
rules put the experts' hidden axis F over `model` (`w_gate` / `w_up`
(E, D, F) column-parallel, `w_down` (E, F, D) row-parallel), and
`dist.sharding.gather_block` marks the MoE dict `"tp": "hidden"` where
the leaves' specs split F (a F that `model` does not divide stays whole,
and so unmarked). The router stays replicated, so the gates, capacity
and dispatch are the same on every rank; the dispatched `xe` enters
`model` (`enter_model`), each rank computes its F block of `h`, and its
partial `ye` is summed over `model` (`reduce_model`) before the combine.
The shared expert takes the same rules through `linear_apply`. The
reference's `constrain` call sites are kept as checks of the port's
local shapes (`dist.sharding.constrain`): F split, D whole, where the
reference keeps D on `model` too (GSPMD then reduce-scatters `ye`).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import MoESpec
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import constrain
from repro_torch.models.layers import _randn, ffn_apply, ffn_init, silu


def moe_init(gen: torch.Generator, d: int, spec: MoESpec,
             lead: tuple = ()) -> dict:
    e, f = spec.num_experts, spec.d_ff_expert
    s_in = 1.0 / (d ** 0.5)
    s_out = 1.0 / (f ** 0.5)
    p = {
        "router": {"w": _randn(gen, (*lead, d, e)).mul_(s_in)},
        "w_gate": _randn(gen, (*lead, e, d, f)).mul_(s_in),
        "w_up": _randn(gen, (*lead, e, d, f)).mul_(s_in),
        "w_down": _randn(gen, (*lead, e, f, d)).mul_(s_out),
    }
    if spec.shared_expert_ff:
        p["shared"] = ffn_init(gen, d, spec.shared_expert_ff, act="swiglu",
                               lead=lead)
    return p


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: the k largest, ties to the lower
    index (a stable descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _positions_within_expert(
    eidx: torch.Tensor,  # (B, S*k) expert ids, flattened slot-major
    num_experts: int,
) -> torch.Tensor:
    """pos[b, t] = rank of token-slot t among the slots routed to the same
    expert in row b (arrival order)."""
    b, n = eidx.shape
    order = torch.argsort(eidx, dim=1, stable=True)  # (B, N)
    sorted_e = torch.take_along_dim(eidx, order, dim=1)
    counts = torch.zeros((b, num_experts), dtype=torch.long,
                         device=eidx.device)
    counts.scatter_add_(1, eidx, torch.ones_like(eidx))
    starts = torch.cumsum(counts, dim=1) - counts  # exclusive cumsum (B, E)
    pos_sorted = torch.arange(n, device=eidx.device)[None, :] - \
        torch.take_along_dim(starts, sorted_e, dim=1)
    inv = torch.argsort(order, dim=1)
    return torch.take_along_dim(pos_sorted, inv, dim=1)  # (B, N)


def capacity_for(s: int, spec: MoESpec) -> int:
    """Slots per expert for a row of `s` tokens: ceil(S·k·cf / E), at least
    1 and at most S·k."""
    c = max(1, int(-(-s * spec.top_k * spec.capacity_factor
                     // spec.num_experts)))
    return min(c, s * spec.top_k)


def moe_apply(
    params: dict,
    x: torch.Tensor,  # (B, S, D)
    spec: MoESpec,
    *,
    dtype: torch.dtype = torch.bfloat16,
    capacity: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,D) in `dtype`, aux_loss scalar float32)."""
    b, s, d = x.shape
    e, k = spec.num_experts, spec.top_k
    c = min(capacity or capacity_for(s, spec), s * k)

    logits = x.to(torch.float32) @ params["router"]["w"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)  # (B,S,E)
    gates, eidx = top_k(probs, k)  # (B,S,k)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

    pos = _positions_within_expert(eidx.reshape(b, s * k), e).reshape(b, s, k)
    keep = pos < c
    pos_c = torch.clamp(pos, max=c - 1)

    barange = torch.arange(b, device=x.device)[:, None]
    xe = torch.zeros((b, e, c, d), dtype=dtype, device=x.device)
    xc = x.to(dtype)
    zero = torch.zeros((), dtype=dtype, device=x.device)
    for i in range(k):  # one scatter-add per expert-slot
        # a dropped token adds a zero row into slot c-1: a kept token's
        # row there stays bit-identical
        upd = torch.where(keep[:, :, i, None], xc, zero)
        xe.index_put_((barange, eidx[:, :, i], pos_c[:, :, i]), upd,
                      accumulate=True)

    local = params.get("tp") == "hidden"  # this rank's block of F
    if local:
        xe = shd.enter_model(xe)
    xe = constrain(xe, "dp", None, None, None, shape=(None, e, c, d))
    wg = params["w_gate"].to(dtype)
    wu = params["w_up"].to(dtype)
    wd = params["w_down"].to(dtype)
    h = silu(torch.einsum("becd,edf->becf", xe, wg)) * torch.einsum(
        "becd,edf->becf", xe, wu)
    h = constrain(h, "dp", None, None, "tp",
                  shape=(None, e, c, spec.d_ff_expert))
    ye = torch.einsum("becf,efd->becd", h, wd)  # (B,E,C,D)
    if local:
        ye = shd.reduce_model(ye)
    ye = constrain(ye, "dp", None, None, None, shape=(None, e, c, d))

    y = torch.zeros((b, s, d), dtype=torch.float32, device=x.device)
    for i in range(k):
        gath = ye[barange, eidx[:, :, i], pos_c[:, :, i]]  # (B,S,D)
        w_i = torch.where(keep[:, :, i], gates[:, :, i], 0.0)
        y = y + gath.to(torch.float32) * w_i[:, :, None]

    if "shared" in params:
        y = y + ffn_apply(params["shared"], x, act="swiglu",
                          dtype=dtype).to(torch.float32)

    # Switch-style load-balance aux: E * sum_e (token_frac_e * prob_mass_e)
    # one-hot by comparison: `F.one_hot` reads max(eidx) on the host to
    # check it against E, a wait for the card inside the step
    onehot = eidx[..., None] == torch.arange(e, device=eidx.device)
    frac = onehot.to(torch.float32).mean(dim=(1, 2))  # (B, E)
    pmass = probs.mean(dim=1)  # (B, E)
    aux = e * torch.mean(torch.sum(frac * pmass, dim=-1))
    y = constrain(y, "dp", None, None, shape=(None, s, d))
    return y.to(dtype), aux
