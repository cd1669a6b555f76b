"""Co-design balanced pruning — the SPE's sparse weight format.

Port of `repro.core.sparsity`. G:2G balanced group pruning along the
contraction (K) dimension: within every group of `group_size`
consecutive K entries of each output channel exactly `keep` survive
(the paper: 16:8).

Compressed format (what the `nm_spmm` kernel consumes):
  values : (K_kept, N) float or int8 — surviving weights, group-major
  select : (K_kept, N) uint8         — position inside the group

Dense K index of compressed row r, channel n:
  k = (r // keep) * group_size + select[r, n]

Two PyTorch traps the reference does not have: top-k ranking must use a
*stable* argsort (as `jnp.argsort` is), or tied |w| keep other weights;
and a uint8 index tensor is a boolean mask in PyTorch, so `select` is
cast to int64 before every gather or scatter.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Balanced-group sparsity configuration (the paper: 16/8)."""

    group_size: int = 16
    keep: int = 8

    def __post_init__(self):
        if not 0 < self.keep <= self.group_size:
            raise ValueError(f"invalid keep={self.keep}/{self.group_size}")


def _grouped(w: torch.Tensor, group_size: int) -> torch.Tensor:
    """(K, N) -> (K//G, G, N). K must divide; callers pad first."""
    k, n = w.shape
    if k % group_size:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    return w.reshape(k // group_size, group_size, n)


def _keep_ranks(absg: torch.Tensor) -> torch.Tensor:
    """Rank of each position by descending |w| within its group; ties go
    to the lower position (stable sort, as `jnp.argsort`)."""
    order = torch.argsort(-absg, dim=1, stable=True)
    return torch.argsort(order, dim=1, stable=True)


def balanced_prune_mask(w: torch.Tensor, cfg: SparsityConfig) -> torch.Tensor:
    """Boolean keep-mask with exactly `keep` True per (group, channel).

    A trailing partial group is zero-padded for ranking, then the mask is
    sliced back to K.
    """
    k = w.shape[0]
    pad = (-k) % cfg.group_size
    if pad:
        wp = torch.nn.functional.pad(w, (0, 0, 0, pad))
        return balanced_prune_mask(wp, cfg)[:k]
    ranks = _keep_ranks(_grouped(w.abs(), cfg.group_size))
    return (ranks < cfg.keep).reshape(w.shape)


def apply_prune(w: torch.Tensor, cfg: SparsityConfig) -> torch.Tensor:
    """Dense weights with the balanced mask applied (zeros at pruned slots)."""
    return torch.where(balanced_prune_mask(w, cfg), w, torch.zeros_like(w))


class _PruneSTE(torch.autograd.Function):
    """Balanced prune forward, identity (straight-through) backward."""

    @staticmethod
    def forward(ctx, w, group_size, keep):
        return apply_prune(w, SparsityConfig(group_size, keep))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def prune_ste(w: torch.Tensor, group_size: int, keep: int) -> torch.Tensor:
    """Masked weights with straight-through gradients (co-design QAT)."""
    return _PruneSTE.apply(w, group_size, keep)


# ---------------------------------------------------------------------------
# Compressed (values + select) format
# ---------------------------------------------------------------------------


def compress(
    w: torch.Tensor, cfg: SparsityConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense (K, N) -> (values (K_kept, N), select uint8 (K_kept, N)).

    Select indices within each group come out in ascending dense order
    (the chip's register scan order).
    """
    k, n = w.shape
    g = _grouped(w, cfg.group_size)  # (Kg, G, N)
    keep_mask = _keep_ranks(g.abs()) < cfg.keep
    # ascending dense position among kept entries: sort positions by
    # (not kept, position) and take the first `keep`
    pos = torch.arange(cfg.group_size, device=w.device)[None, :, None]
    sort_key = torch.where(keep_mask, pos, cfg.group_size + pos)
    sel = torch.argsort(sort_key, dim=1, stable=True)[:, : cfg.keep, :]
    vals = torch.take_along_dim(g, sel, dim=1)  # (Kg, keep, N)
    return vals.reshape(-1, n), sel.reshape(-1, n).to(torch.uint8)


def decompress(
    values: torch.Tensor, select: torch.Tensor, cfg: SparsityConfig, k: int
) -> torch.Tensor:
    """(values, select) -> dense (K, N) with zeros at pruned positions."""
    _, n = values.shape
    kg = k // cfg.group_size
    vals = values.reshape(kg, cfg.keep, n)
    sel = select.to(torch.int64).reshape(kg, cfg.keep, n)
    out = torch.zeros(
        (kg, cfg.group_size, n), dtype=values.dtype, device=values.device
    )
    return out.scatter_(1, sel, vals).reshape(k, n)


def sparse_matmul_ref(
    x: torch.Tensor,
    values: torch.Tensor,
    select: torch.Tensor,
    cfg: SparsityConfig,
) -> torch.Tensor:
    """Gather-MAC reference of the SPE: y[...,n] = sum_r v[r,n]*x[...,k(r,n)].

    Materializes the gathered activations (..., K_kept, N) — fine as an
    oracle, which is why the tiled kernel exists for production.
    """
    kept = select.shape[0]
    group_of_r = torch.arange(kept, device=select.device) // cfg.keep
    dense_k = group_of_r[:, None] * cfg.group_size + select.to(torch.int64)
    x_g = x[..., dense_k]  # (..., K_kept, N)
    return torch.sum(x_g * values.to(x.dtype), dim=-2)


def verify_balance(mask: torch.Tensor, cfg: SparsityConfig) -> bool:
    """Compiler invariant: every (group, channel) has exactly `keep` nnz."""
    counts = _grouped(mask.to(torch.int32), cfg.group_size).sum(dim=1)
    return bool(torch.all(counts == cfg.keep))
