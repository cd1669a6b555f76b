"""Int8 gradient compression with error feedback for the cross-pod wire
(port of `repro.dist.compression`).

  * `quantize_leaf` — per-leaf symmetric int8 (scale = amax/127, round
    half to even, clip ±127), so the one-shot error is bounded by
    scale/2;
  * `compress_residual` — error feedback: quantize (grad + carried
    residual), carry the new residual. Telescoping makes the scheme
    lossless over time: sum(dequantized sent) + residual == sum(grads);
  * `compressed_psum_mean` ("gather") — every rank of the pod group
    all-gathers the int8 codes and the float32 scales of every peer and
    dequantize-averages locally. One error buffer per leaf;
  * `two_stage_psum_mean` ("two_stage") — quantized reduce-scatter +
    all-gather: stage 1 all-to-alls int8 chunks so rank j owns shard j of
    the dequantized mean; stage 2 re-quantizes the owned shard and
    all-gathers it back. Error feedback at both quantization points
    (err1 full-leaf, err2 shard-sized);
  * `uncompressed_psum_mean` — the float32 all-reduce baseline, with the
    same finite guard by default.

Each reduction takes the process group of the mesh's "pod" dimension
(`DeviceMesh.get_group("pod")`) where the reference takes the axis name
inside `shard_map`; the collectives are `torch.distributed`'s
(`all_gather_into_tensor`, `all_to_all_single`, `all_reduce`): NCCL on
the card, gloo on the CPU. A rank's position in the group is its pod
coordinate, so the all-to-all's row j goes to pod j.

Wire accounting: a ring all-reduce of f32 costs each rank
~2·(n-1)/n·4·|leaf| bytes of egress; the gather scheme (n-1)·|leaf| int8,
a (8/n)x reduction; the two-stage scheme ~2·(n-1)/n·|leaf| int8, ~4x at
any pod count. `wire_bytes` / `wire_calls` count, by collective, the
bytes of the tensors this module hands to its collectives and the calls
(`reset_wire` sets them to 0); `benchmarks.dist_compression` reads them.

Non-finite gradients are zeroed before quantization so they can neither
corrupt the wire values nor lodge in the persistent error buffer.

The `*_` forms work in place, for a gradient tree as large as the card
allows: the error buffer holds g + err, the gradient buffer receives the
mean, and the elementwise steps run over chunks of `CHUNK` elements, so
a leaf's temporaries stay bounded whatever its size (the int8 codes and
the gathered codes are a quarter of a float32 leaf each, per pod). The
functional forms copy their inputs and call them. Every elementwise op
is the reference's, in its order: on identical inputs the codes, the
scales and the error buffers agree bit for bit.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch._tree import leaves, tree_map

CHUNK = 1 << 26  # elements an elementwise pass takes at a time

# bytes handed to the pod group's collectives, and calls, by collective
wire_bytes: dict[str, int] = {}
wire_calls: dict[str, int] = {}


def reset_wire() -> None:
    wire_bytes.clear()
    wire_calls.clear()


def count_call(op: str, t: torch.Tensor) -> None:
    """Count one collective over a pod group handing `t` to it (a caller
    outside this module calls it before its own collective)."""
    wire_bytes[op] = wire_bytes.get(op, 0) + t.numel() * t.element_size()
    wire_calls[op] = wire_calls.get(op, 0) + 1


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): row j is rank j's `x`."""
    n = dist.get_world_size(group)
    flat = x.reshape(-1).contiguous()
    out = torch.empty(n * flat.numel(), dtype=x.dtype, device=x.device)
    count_call("all_gather", flat)
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.reshape((n,) + tuple(x.shape))


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Row j of `x` (n, shard) goes to rank j; row j of the result came
    from rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    count_call("all_to_all", x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _chunks(n: int):
    for lo in range(0, n, CHUNK):
        yield slice(lo, min(n, lo + CHUNK))


def _amax(t: torch.Tensor) -> torch.Tensor:
    """max |t| without a |t| temporary."""
    if t.numel() == 0:
        return torch.zeros((), dtype=t.dtype, device=t.device)
    lo, hi = torch.aminmax(t)
    return torch.maximum(hi, -lo)


def _scale(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(_amax(t), min=1e-30) / 127.0


def _codes(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(t / scale), -127, 127) as int8, chunk by chunk."""
    flat = t.reshape(-1)
    q = torch.empty(flat.shape, dtype=torch.int8, device=t.device)
    for c in _chunks(flat.numel()):
        q[c] = torch.clamp(torch.round(flat[c] / scale), -127, 127)
    return q.reshape(t.shape)


def quantize_leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-leaf int8: (q int8, scale float32 0-d) with
    |dequantize(q, scale) - g| <= scale / 2 elementwise."""
    gf = g.to(torch.float32)
    scale = _scale(gf)
    return _codes(gf, scale), scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _residual_(t: torch.Tensor, q: torch.Tensor, scale) -> None:
    """t -= dequantize(q, scale), in place, chunk by chunk."""
    ft, fq = t.reshape(-1), q.reshape(-1)
    for c in _chunks(ft.numel()):
        ft[c] -= fq[c].to(torch.float32) * scale


def _guard_(t: torch.Tensor) -> torch.Tensor:
    """Non-finite entries to 0, in place (the reference's
    where(isfinite(t), t, 0))."""
    return torch.nan_to_num_(t, nan=0.0, posinf=0.0, neginf=0.0)


def compress_residual_(g: torch.Tensor, err: torch.Tensor):
    """In place: err <- g + err with non-finite entries zeroed, then
    quantized; err keeps the residual. Returns (q, scale)."""
    err.add_(g)
    _guard_(err)
    scale = _scale(err)
    q = _codes(err, scale)
    _residual_(err, q, scale)
    return q, scale


def compress_residual(
    g: torch.Tensor, err: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback step: quantize (g + err), return (q, scale,
    new_err) where new_err is the quantization residual to carry into
    the next step. Telescoping identity: across steps,
    sum(dequantize(q_t, s_t)) + err_T == sum(g_t).

    Non-finite entries of (g + err) are zeroed first so one bad step
    cannot poison the carried residual forever."""
    new_err = err.to(torch.float32).clone()
    q, scale = compress_residual_(g.to(torch.float32), new_err)
    return q, scale, new_err


def _dequantized_mean_(out: torch.Tensor, qs: torch.Tensor,
                       ss: torch.Tensor) -> None:
    """out <- sum_j(qs[j] · ss[j]) / n over the gathered rows, in place."""
    n = qs.shape[0]
    fo, fq = out.reshape(-1), qs.reshape(n, -1)
    for c in _chunks(fo.numel()):
        acc = fq[0, c].to(torch.float32) * ss[0]
        for j in range(1, n):
            acc += fq[j, c].to(torch.float32) * ss[j]
        fo[c] = acc / n


def _buckets(sizes: list[int]) -> list[list[int]]:
    """Consecutive leaf indices grouped so that each group's elements
    stay within `CHUNK` (a larger leaf is a group of its own): one
    collective carries a group, as a DDP bucket does."""
    out, cur, total = [], [], 0
    for i, s in enumerate(sizes):
        if cur and total + s > CHUNK:
            out.append(cur)
            cur, total = [], 0
        cur.append(i)
        total += s
    if cur:
        out.append(cur)
    return out


def _cat(xs: list[torch.Tensor]) -> torch.Tensor:
    return xs[0].reshape(-1) if len(xs) == 1 else torch.cat(
        [x.reshape(-1) for x in xs])


def _gather_mean_(gs: list, es: list, group) -> None:
    """One bucket of the gather scheme: quantize every leaf, all-gather
    the bucket's codes and scales in one call each, dequantize-average."""
    qs, scales = zip(*(compress_residual_(g, e) for g, e in zip(gs, es)))
    codes = _all_gather(_cat(list(qs)), group)  # (n, total) int8
    del qs
    ss = _all_gather(torch.stack(scales), group)  # (n, leaves) f32
    off = 0
    for i, g in enumerate(gs):
        _dequantized_mean_(g, codes[:, off:off + g.numel()], ss[:, i])
        off += g.numel()


def compressed_psum_mean_(grads: Any, err: Any, group) -> None:
    """`compressed_psum_mean` in place: each gradient leaf receives the
    mean, each error leaf the new residual."""
    gs, es = leaves(grads), leaves(err)
    for b in _buckets([g.numel() for g in gs]):
        _gather_mean_([gs[i] for i in b], [es[i] for i in b], group)


def compressed_psum_mean(grads: Any, err: Any, group) -> tuple[Any, Any]:
    """Mean of `grads` over the ranks of `group` via int8 + error-feedback
    compression. Returns (mean_grads, new_err); per rank, mean +
    mean-of-residuals telescopes to the true mean.

    Per-rank egress per leaf: (n-1) · (|leaf| int8 + 4 B scale) via ring
    all-gather, against ~2·(n-1)/n · 4·|leaf| for an f32 ring all-reduce.
    The leaves' codes travel in buckets of up to `CHUNK` elements, one
    all-gather of codes and one of scales a bucket.
    """
    mean = tree_map(lambda g: g.to(torch.float32).clone(), grads)
    new_err = tree_map(lambda e: e.to(torch.float32).clone(), err)
    compressed_psum_mean_(mean, new_err, group)
    return mean, new_err


def two_stage_shard_len(size: int, n: int) -> int:
    """Length of the per-rank stage-2 shard (and err2 buffer) for a leaf
    of `size` elements reduced over `n` ranks: ceil(size/n)."""
    return -(-size // n)


def _two_stage_mean_(gs: list, e1s: list, e2s: list, group) -> None:
    """One bucket of the two-stage scheme, one all-to-all and three
    all-gathers for all its leaves."""
    n = dist.get_world_size(group)
    shards = [two_stage_shard_len(g.numel(), n) for g in gs]
    # stage 1: quantize g + err1. The reference pads each flat leaf to
    # shard·n with zeros before quantizing; zeros change neither the
    # amax nor their own codes, so the codes are padded afterwards.
    send = torch.zeros((n, sum(shards)), dtype=torch.int8,
                       device=gs[0].device)
    s1 = []
    off = 0
    for g, e1, shard in zip(gs, e1s, shards):
        q, s = compress_residual_(g, e1)
        s1.append(s)
        padded = torch.zeros(shard * n, dtype=torch.int8, device=g.device)
        padded[:g.numel()] = q.reshape(-1)
        send[:, off:off + shard] = padded.reshape(n, shard)
        off += shard
    # row j of `send` holds this rank's shard-j chunks; after the
    # all-to-all, row j holds peer j's chunks of the shards this rank
    # owns
    recv = _all_to_all(send, group)
    del send
    s1_all = _all_gather(torch.stack(s1), group)  # (n, leaves) f32
    # stage 2: re-quantize each owned shard, gather all shards back
    q2, s2 = [], []
    off = 0
    for i, (e2, shard) in enumerate(zip(e2s, shards)):
        own = torch.empty(shard, dtype=torch.float32, device=e2.device)
        _dequantized_mean_(own, recv[:, off:off + shard], s1_all[:, i])
        q, s = compress_residual_(own, e2)
        q2.append(q)
        s2.append(s)
        off += shard
    del recv
    q2_all = _all_gather(_cat(q2), group)  # (n, sum(shards)) int8
    s2_all = _all_gather(torch.stack(s2), group)  # (n, leaves) f32
    off = 0
    for i, (g, shard) in enumerate(zip(gs, shards)):
        flat, size = g.reshape(-1), g.numel()
        for j in range(n):
            lo = j * shard
            hi = min(size, lo + shard)
            if hi > lo:
                flat[lo:hi] = (q2_all[j, off:off + hi - lo].to(torch.float32)
                               * s2_all[j, i])
        off += shard


def two_stage_psum_mean_(grads: Any, err1: Any, err2: Any, group) -> None:
    """`two_stage_psum_mean` in place: each gradient leaf receives the
    mean, the error leaves their new residuals."""
    gs, e1s, e2s = leaves(grads), leaves(err1), leaves(err2)
    for b in _buckets([g.numel() for g in gs]):
        _two_stage_mean_([gs[i] for i in b], [e1s[i] for i in b],
                         [e2s[i] for i in b], group)


def two_stage_psum_mean(
    grads: Any, err1: Any, err2: Any, group
) -> tuple[Any, Any, Any]:
    """Mean of `grads` over the ranks of `group` via quantized
    reduce-scatter + all-gather with two-stage error feedback. Returns
    (mean_grads, new_err1, new_err2).

    Stage 1 (reduce-scatter): quantize (g + err1) per leaf, split the
    int8 codes into n chunks and all-to-all them, so rank j receives
    chunk j from every peer; dequantize with the all-gathered per-peer
    scales and average -> rank j owns shard j of the mean. err1 is the
    full-leaf quantization residual.

    Stage 2 (all-gather): quantize (owned shard + err2), all-gather the
    int8 shards + scales, dequantize into the full mean. err2 is the
    shard-sized residual: shape (ceil(|leaf|/n),), carried per rank.

    Both stages telescope, so over steps (zero-initialized buffers):

        sum_t(returned mean) + mean over ranks(err1_T) + assembled(err2_T)
            == sum_t(true f32 mean)

    where assembled(err2) concatenates the per-rank shards in group
    order (how a checkpoint lays them out: `trainer.init_dp_err`). The
    leaves travel in buckets of up to `CHUNK` elements: one all-to-all
    and three all-gathers a bucket.
    """
    mean = tree_map(lambda g: g.to(torch.float32).clone(), grads)
    new1 = tree_map(lambda e: e.to(torch.float32).clone(), err1)
    new2 = tree_map(lambda e: e.to(torch.float32).clone(), err2)
    two_stage_psum_mean_(mean, new1, new2, group)
    return mean, new1, new2


def uncompressed_psum_mean_(grads: Any, group, *,
                            finite_guard: bool = True) -> None:
    """`uncompressed_psum_mean` in place, one all-reduce a bucket."""
    n = dist.get_world_size(group)
    gs = leaves(grads)
    for b in _buckets([g.numel() for g in gs]):
        parts = [gs[i] for i in b]
        if finite_guard:
            for g in parts:
                _guard_(g)
        buf = _cat(parts) if len(parts) > 1 else parts[0]
        count_call("all_reduce", buf)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        buf.div_(n)
        if len(parts) > 1:
            off = 0
            for g in parts:
                g.copy_(buf[off:off + g.numel()].reshape(g.shape))
                off += g.numel()


def uncompressed_psum_mean(grads: Any, group, *,
                           finite_guard: bool = True) -> Any:
    """Baseline: the f32 mean over `group` (all_reduce SUM / n).

    By default non-finite entries are zeroed before the reduction — the
    same guard the compressed paths apply before quantizing — so
    `compress=False` ablations share failure semantics with the
    compressed run. `finite_guard=False` opts out (raw IEEE
    propagation)."""
    out = tree_map(lambda g: g.clone(), grads)
    uncompressed_psum_mean_(out, group, finite_guard=finite_guard)
    return out
