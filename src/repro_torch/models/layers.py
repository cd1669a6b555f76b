"""Primitive NN layers — init/apply pairs over nested dicts of tensors.

Port of `repro.models.layers`. Conventions (whole substrate):
  * params are trees of float32 "master" tensors; applies cast to the
    compute dtype (bfloat16 by default) at use — standard mixed
    precision;
  * every init draws from an explicit `torch.Generator`, on the
    generator's device; `lead` prepends stacking axes (the reference
    vmaps its inits over a layer-group axis);
  * 2-D weights are (in_features, out_features), as in the reference;
  * the paper's technique enters through `linear_apply`: an optional
    `SPEConfig` applies co-design prune-STE + fake-quant to dense
    weights, and a *compiled* param dict ({"packed","scale"} or
    {"values_q","select","meta","scale"}) swaps in compressed storage
    at serve time. Those two go through the port's hand-written kernels
    (`kernels.ops.quant_matmul` and `kernels.ops.nm_spmm`): a CUDA
    tensor launches the kernel, a CPU tensor takes its plain version;
  * tensor parallelism (sharded serving, `serve.sharded`): inside
    `dist.sharding.activation_context` a linear that `gather_block`
    marked `"tp": "col"` holds its output columns and emits them (its
    replicated `scale` and bias sliced to them); one marked `"tp": "row"`
    holds its input rows, takes its block of x, and all-reduces its
    partial products over the model group, the bias added once after.
    The packed branch runs `quant_matmul` on the rank's shard either
    way. The embedding with its vocab rows over `model` looks up its
    rows masked and all-reduces. Training differentiates through it: a
    column-parallel linear's whole x passes `dist.sharding.enter_model`
    (once for the linears that share it, `col_inputs`), whose backward
    sums the ranks' partial `dx` over `model`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import quant as Q
from repro_torch.core import sparsity as S
from repro_torch.core.spe import SPEConfig, spe_train_weight
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# Linear (+ the SPE/quant entry point)
# ---------------------------------------------------------------------------


def _randn(gen: torch.Generator, shape: tuple) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def linear_init(
    gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
    scale: Optional[float] = None, lead: tuple = (),
) -> dict:
    s = scale if scale is not None else d_in ** -0.5
    p = {"w": _randn(gen, (*lead, d_in, d_out)).mul_(s)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), device=gen.device)
    return p


def _pad_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """x with its last axis zero-padded to `k` (zeros add nothing)."""
    return F.pad(x, (0, k - x.shape[-1])) if k > x.shape[-1] else x


def _row_scale_reductions() -> dict:
    """`spe_train_weight`'s reductions of a row block's per-column
    statistics over `model` (none at a model size of 1)."""
    group = shd.model_group()
    if group is None:
        return {}
    return {"reduce_max": lambda t: shd.all_reduce(t, group,
                                                   op=dist.ReduceOp.MAX),
            "reduce_sum": lambda t: shd.all_reduce(t, group)}


def linear_apply(
    params: dict,
    x: torch.Tensor,
    *,
    spe: Optional[SPEConfig] = None,
    dtype: torch.dtype = torch.bfloat16,
    x_local: bool = False,
    entered: bool = False,
) -> torch.Tensor:
    """y = x @ W (+ b). Dispatches on the param format:

    {"w"}                      dense master weights (training / baseline);
                               `spe` applies the paper's QAT constraints.
    {"packed","scale"}         compiled mixed-bit-width storage (CMUL):
                               `ops.quant_matmul`, the kernel the
                               reference's XLA unpack + matmul stands in
                               for. The kernel takes float32 x and
                               returns float32, so x is cast up and y
                               down to `dtype`.
    {"values_q","select","meta","scale"}  compiled sparse+quant storage
                               (SPE): `ops.nm_spmm`, with x's K padded
                               with zeros to the group multiple the
                               compiler padded W to.

    Tensor parallelism (`params["tp"]`, set by `dist.sharding.gather_block`):
    `x_local` says that x holds this rank's block of its last dim (the
    output of a column-parallel linear) rather than all of it. A "row"
    linear takes x's block (sliced where x is whole), runs the local K
    (the packed bit width from the local rows and the local K: codes
    pack along K, so a row block is a contiguous K block; the SPE
    format's block is Kk / M compressed rows, whole groups of `keep`,
    whose dense K is the rank's block of x), applies the scale to each
    partial (per output column, so the all-reduced sum is the scaled sum)
    and all-reduces in float32 for the packed and SPE paths, in `dtype`
    for the dense one. Under `spe` a "row" weight's per-column scales are
    reduced over `model` (`_row_scale_reductions`); a row block that cuts
    a prune group raises `ShardingGuardError`. A linear
    that is not row-parallel given a local x gathers x over `model`
    first. A "col" linear's whole x enters `model` (`shd.enter_model`)
    unless the caller did (`entered`).
    """
    tp = params.get("tp")
    if tp == "row":
        if not x_local:
            x = shd.model_block(x)
    elif x_local:
        x = shd.gather_model(x)
    if tp == "col" and not entered:
        x = shd.enter_model(x)
    scale = params.get("scale")
    if tp == "col" and scale is not None:
        scale = shd.model_block(scale)
    if "w" in params:
        w = params["w"]
        if spe is not None:
            if tp == "row" and spe.sparse and w.shape[-2] % spe.group_size:
                raise shd.ShardingGuardError(
                    f"a row-parallel block of shape {tuple(w.shape)} cuts "
                    f"the {spe.group_size}-row prune groups")
            w = spe_train_weight(w, spe, **(
                _row_scale_reductions() if tp == "row" else {}))
        y = x.to(dtype) @ w.to(dtype)
    elif "packed" in params:
        # bit width is encoded in the packed shape (keeps the param tree
        # tensor-only, so a stacked group slices cleanly):
        # rows = ceil(K*b/8)
        packed = params["packed"]
        k = x.shape[-1]
        bits = (8 * packed.shape[-2]) // k
        xk = _pad_k(x.to(torch.float32), packed.shape[-2] * (8 // bits))
        y = ops.quant_matmul(xk, packed, scale, bits=bits)
    elif "values_q" in params:
        meta = params["meta"]
        group, keep = int(meta["group"]), int(meta["keep"])
        kk = params["values_q"].shape[-2]
        k_dense = (kk // keep) * group
        if tp == "row" and (kk % keep or x.shape[-1] != k_dense):
            raise shd.ShardingGuardError(
                f"a row-parallel SPE block of {kk} compressed rows "
                f"({keep} a group) does not cover this rank's "
                f"{x.shape[-1]} input columns")
        xk = _pad_k(x.to(torch.float32), k_dense)
        y = ops.nm_spmm(
            xk, params["values_q"], params["select"], scale,
            group_size=group, keep=keep,
        )
    else:
        raise ValueError(f"unknown linear param format: {list(params)}")
    if tp == "row":
        y = shd.reduce_model(y)
    y = y.to(dtype)
    if "b" in params:
        b = params["b"]
        y = y + (shd.model_block(b) if tp == "col" else b).to(dtype)
    return y


def col_local(params: dict) -> bool:
    """True where a linear emits this rank's block of its columns."""
    return params.get("tp") == "col"


def col_inputs(x: torch.Tensor, *linears: dict) -> list:
    """x for each of `linears` that share it, to be applied with
    `entered=True`: entered into `model` once (one all-reduce in the
    backward) for the column-parallel ones, x itself for the others."""
    xe = shd.enter_model(x) if any(map(col_local, linears)) else x
    return [xe if col_local(p) else x for p in linears]


def compile_linear_quant(params: dict, bits: int) -> dict:
    """Dense {"w"} -> packed mixed-bit-width serving format.

    Handles stacked (n_groups, K, N) block weights one group at a time
    (the reference vmaps; a loop keeps the quantizer's float32
    temporaries to one (K, N) slice). The bit width is recoverable from
    the packed shape, so the output tree stays tensor-only.
    """
    w = params["w"]

    def one(w2):
        q, scale = Q.quantize(w2, Q.QuantConfig(bits=bits))
        return Q.pack_planes(q, bits), scale.reshape(1, -1)

    if w.ndim == 3:
        pairs = [one(w[g]) for g in range(w.shape[0])]
        packed = torch.stack([p for p, _ in pairs])
        scale = torch.stack([s for _, s in pairs])
    else:
        packed, scale = one(w)
    out = {"packed": packed, "scale": scale}
    if "b" in params:
        out["b"] = params["b"]
    return out


def compile_linear_sparse_quant(
    params: dict, bits: int, group: int = 16, keep: int = 8
) -> dict:
    """Dense {"w"} -> SPE compressed (values+select) serving format."""
    w = params["w"]
    k = w.shape[0]
    pad = (-k) % group
    if pad:
        w = F.pad(w, (0, 0, 0, pad))
    scfg = S.SparsityConfig(group, keep)
    values, select = S.compress(S.apply_prune(w, scfg), scfg)
    q, scale = Q.quantize(values, Q.QuantConfig(bits=bits))
    out = {
        "values_q": q,
        "select": select,
        "scale": scale.reshape(1, -1),
        "meta": {"group": group, "keep": keep, "bits": bits},
    }
    if "b" in params:
        out["b"] = params["b"]
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, *, lead: tuple = (), device=None) -> dict:
    return {"scale": torch.ones((*lead, d), device=device)}


def rmsnorm_apply(params: dict, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"]
    return y.to(dt)


def layernorm_init(d: int, *, lead: tuple = (), device=None) -> dict:
    return {"scale": torch.ones((*lead, d), device=device),
            "bias": torch.zeros((*lead, d), device=device)}


def layernorm_apply(params: dict, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y.to(dt)


def norm_init(kind: str, d: int, *, lead: tuple = (), device=None) -> dict:
    init = rmsnorm_init if kind == "rmsnorm" else layernorm_init
    return init(d, lead=lead, device=device)


def norm_apply(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm_apply(params, x)
    return layernorm_apply(params, x)


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE + M-RoPE)
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    ar = torch.arange(0, hd, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / hd))


def apply_rope(
    x: torch.Tensor,  # (B, S, H, hd)
    pos: torch.Tensor,  # (B, S) int — or (B, 3, S) for M-RoPE
    *,
    theta: float,
    sections: Sequence[int] = (),
) -> torch.Tensor:
    """Rotate half-pairs. With `sections` (M-RoPE), the hd/2 frequency
    slots are split into (t, h, w) groups, each indexed by its own
    position row of `pos` (text positions use identical rows, which
    reduces exactly to standard RoPE)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    if sections:
        assert sum(sections) == hd // 2, (sections, hd)
        assert pos.ndim == 3 and pos.shape[1] == len(sections)
        parts = []
        start = 0
        for i, sec in enumerate(sections):
            p = pos[:, i, :].to(torch.float32)  # (B, S)
            parts.append(p[:, :, None] * freqs[start : start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)  # (B, S, hd/2)
    else:
        ang = pos.to(torch.float32)[:, :, None] * freqs  # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# FFN (SwiGLU / GeGLU / plain GELU MLP)
# ---------------------------------------------------------------------------


# The activations are written op by op in the working dtype, as
# `jax.nn.silu` and `jax.nn.gelu` are: XLA rounds a bfloat16 result after
# every elementwise op (its logistic is 1 / (1 + exp(-x))), where torch's
# fused F.silu / F.gelu round once; the difference, one bfloat16 ulp on a
# third of the elements, would compound over the layers.


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.sigmoid` as XLA expands it: 1 / (1 + exp(-x))."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def dtype_constant(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype` as torch rounds a Python float into a
    tensor of it (through float32, then to nearest, ties to even), as a
    Python float, which that dtype holds exactly: an op of a tensor of
    `dtype` with it computes what the op with a 0-dim tensor of `dtype`
    holding `value` computes, and makes no tensor from host data inside a
    cell (a copy from the host on the card)."""
    if dtype == torch.float64:
        return float(value)
    f = np.float32(value)
    if dtype == torch.float16:
        return float(np.float16(f))
    if dtype == torch.bfloat16:
        bits = np.array(f, np.float32).view(np.uint32)
        bits = (bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16))
                                            & np.uint32(1)))
        return float((bits & np.uint32(0xFFFF0000)).view(np.float32))
    if dtype == torch.float32:
        return float(f)
    raise ValueError(f"no float constant of dtype {dtype}")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default, the tanh approximation. Both constants
    are rounded to x's dtype first, as XLA rounds a weakly typed constant
    (torch would multiply by the Python float at float32)."""
    c = dtype_constant(np.sqrt(2 / np.pi), x.dtype)
    k = dtype_constant(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x ** 3))))
    return x * cdf


def ffn_init(
    gen: torch.Generator, d: int, f: int, *, act: str, bias: bool = False,
    lead: tuple = (),
) -> dict:
    if act in ("swiglu", "geglu"):
        return {
            "w_gate": linear_init(gen, d, f, bias=bias, lead=lead),
            "w_up": linear_init(gen, d, f, bias=bias, lead=lead),
            "w_down": linear_init(gen, f, d, bias=bias, lead=lead),
        }
    return {
        "w_up": linear_init(gen, d, f, bias=bias, lead=lead),
        "w_down": linear_init(gen, f, d, bias=bias, lead=lead),
    }


def ffn_apply(
    params: dict,
    x: torch.Tensor,
    *,
    act: str,
    spe: Optional[SPEConfig] = None,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    local = col_local(params["w_up"])  # d_ff split over model
    if act in ("swiglu", "geglu"):
        xg, xu = col_inputs(x, params["w_gate"], params["w_up"])
        g = linear_apply(params["w_gate"], xg, spe=spe, dtype=dtype,
                         entered=True)
        u = linear_apply(params["w_up"], xu, spe=spe, dtype=dtype,
                         entered=True)
        g = silu(g) if act == "swiglu" else gelu(g)
        return linear_apply(params["w_down"], g * u, spe=spe, dtype=dtype,
                            x_local=local)
    h = linear_apply(params["w_up"], x, spe=spe, dtype=dtype)
    return linear_apply(params["w_down"], gelu(h), spe=spe, dtype=dtype,
                        x_local=local)


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def embed_init(gen: torch.Generator, vocab: int, d: int) -> dict:
    return {"w": _randn(gen, (vocab, d)).mul_(0.02)}


def embed_apply(
    params: dict, tokens: torch.Tensor, *,
    dtype: torch.dtype = torch.bfloat16, scale: bool = False,
) -> torch.Tensor:
    # gather, then cast: bit-identical to the reference's cast-then-gather
    # (the cast is elementwise), without casting the whole table per call
    w = params["w"]
    if params.get("tp") == "row":
        # vocab rows over `model`: each rank looks up the ids it holds,
        # zeros elsewhere; the all-reduce adds exact zeros (bit for bit)
        ctx = shd.current()
        lo = ctx.groups.model_rank * w.shape[0]
        idx = tokens - lo
        mine = (idx >= 0) & (idx < w.shape[0])
        h = w[idx.clamp(0, w.shape[0] - 1)] * mine[..., None].to(w.dtype)
        h = shd.reduce_model(h).to(dtype)
    else:
        h = w[tokens].to(dtype)
    if scale:
        # sqrt(d) in float32 (correctly rounded), then in the compute dtype
        h = h * dtype_constant(np.sqrt(np.float32(w.shape[1])), dtype)
    return h


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)
