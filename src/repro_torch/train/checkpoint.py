"""Checkpointing: atomic, keep-k (port of `repro.train.checkpoint`).

Layout:  <dir>/step_<N>/
            arrays.npz       one entry per tree leaf, key = '/'-path
            meta.json        {"step": N, "time": ..., "n_leaves": ...}
         <dir>/LATEST        text file with the newest complete step

The format is the reference's: the same npz keys in the same order
(dict keys sorted at each level, as jax flattens a dict), `None` leaves
written as no entry (jax's empty subtree, e.g. `sgd`'s `{"mu": None}`
without momentum), the same dtypes and the same meta.json keys. So a
checkpoint written by either package restores in the other.

Atomicity: each checkpoint is written into `step_<N>.tmp` and
`os.rename`d into place (rename is atomic on POSIX), then LATEST is
updated the same way — a crash mid-save can never corrupt the newest
complete checkpoint. Keep-k GC never prunes the just-saved step or the
LATEST target even when saves land out of order (rollback re-saves),
and deletes meta.json before the dir so an interrupted prune leaves an
invisible partial, not a listed-but-unloadable step (see `_gc`).

Arrays are saved gathered to the host with their logical paths.
`restore(..., device=...)` puts every leaf on one device. Across ranks
(`shardings=`, a tree of `dist.sharding.NamedSharding`s mirroring the
state, as `trainer.make_multipod_train_step` returns it): `save` gathers
every leaf a spec shards (the per-pod error buffers) over its mesh axis
into the global array, in the reference's layout (n_pod, *leaf); rank 0
writes, and every rank waits at a barrier after. `restore` reads the
global array and keeps this rank's block of it (`dist.sharding.
shard_local`); a global shape other than the saved one (another pod
count) raises.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import _device
from repro_torch._tree import map_with_path
from repro_torch.dist import sharding as shd


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _gather(leaf: torch.Tensor, sharding) -> torch.Tensor:
    """The global tensor whose blocks the ranks hold under `sharding`
    (the leaf itself where nothing is sharded), on the host."""
    out = leaf.detach()
    if sharding is None:
        return out.cpu()
    for dim, axis in enumerate(sharding.spec):
        names = axis if isinstance(axis, (tuple, list)) else (axis,)
        if axis is None or shd._axis_size(axis, sharding.mesh) == 1:
            continue
        if len(names) != 1:
            raise ValueError(
                f"save: dim {dim} sharded over several axes {names}: not "
                f"ported yet (ROADMAP.md queue 1 item 8b)")
        group = sharding.mesh.get_group(names[0])
        n = dist.get_world_size(group)
        part = out.movedim(dim, 0).contiguous()
        full = torch.empty(n * part.numel(), dtype=part.dtype,
                           device=part.device)
        dist.all_gather_into_tensor(full, part.reshape(-1), group=group)
        full = full.reshape((n * part.shape[0],) + tuple(part.shape[1:]))
        out = full.movedim(0, dim)
    return out.cpu()


def _flatten(tree: Any, shardings: Any = None) -> dict[str, np.ndarray]:
    """'/'-joined path -> host array, in jax's leaf order; `None` leaves
    are skipped. With `shardings`, each sharded leaf is gathered."""
    items = []

    def visit(path, leaf, *sh):
        if leaf is not None:
            arr = _gather(leaf, sh[0] if sh else None).numpy()
            items.append((path, arr))

    map_with_path(visit, tree, *(() if shardings is None else (shardings,)))
    items.sort(key=lambda kv: kv[0])  # jax flattens a dict by sorted keys
    return {_key(path): arr for path, arr in items}


def _mesh_of(shardings: Any):
    found = []
    map_with_path(lambda _, s: found.append(s.mesh) if s is not None
                  else None, shardings)
    return found[0] if found else None


def save(state: Any, ckpt_dir: str, step: int, *, keep: int = 3,
         shardings: Any = None) -> str:
    """Atomic checkpoint write; returns the final path. With
    `shardings`, every rank of their mesh calls it: the sharded leaves
    are gathered, the mesh's first rank writes, and every rank of the
    mesh waits for it (a barrier over each mesh dimension's group)."""
    flat = _flatten(state, shardings)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    mesh = None if shardings is None else _mesh_of(shardings)
    if mesh is None or not any(mesh.get_coordinate()):
        _write(flat, ckpt_dir, step, keep)
    if mesh is not None:
        for dim in range(mesh.ndim):
            dist.barrier(group=mesh.get_group(dim))
    return final


def _write(flat: dict, ckpt_dir: str, step: int, keep: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        # repro: allow[wallclock-ban] wall-clock save time is metadata
        json.dump({"step": int(step), "time": time.time(),
                   "n_leaves": len(flat)}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _update_latest(ckpt_dir, step)
    _gc(ckpt_dir, keep, protect=(step,))


def _update_latest(ckpt_dir: str, step: int) -> None:
    tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(str(int(step)))
    os.rename(tmp, os.path.join(ckpt_dir, "LATEST"))


def _latest_pointer(ckpt_dir: str) -> Optional[int]:
    """Raw LATEST file contents (no completeness check), or None."""
    path = os.path.join(ckpt_dir, "LATEST")
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def _gc(ckpt_dir: str, keep: int, *, protect: tuple = ()) -> None:
    """Prune step dirs down to the newest `keep` at-or-below the
    just-saved step (`protect`, the lineage frontier), never touching
    the protected step or the LATEST target, and deleting everything
    ABOVE the frontier.

    Saves can land out of order: `fault.run_training` rolls back to an
    earlier checkpoint on failure and re-saves *lower* step numbers into
    a dir that still holds higher ones. Steps beyond the frontier belong
    to the abandoned lineage (deterministic replay regenerates them), so
    they are deleted outright: after any save, every on-disk checkpoint
    is <= the step LATEST points at, and the LATEST-lost fallback
    (`latest_step` -> newest complete dir) can never jump forward.

    Deletion removes meta.json first: `all_steps` treats a dir without
    meta.json as nonexistent, so a prune interrupted mid-`rmtree` leaves
    an invisible partial dir rather than a listed-but-unloadable
    checkpoint."""
    steps = all_steps(ckpt_dir)
    frontier = max(protect) if protect else None
    if frontier is not None:
        live = [s for s in steps if s <= frontier]
    else:
        live = steps
    keep_set = set(live[-keep:]) | set(protect)
    latest = _latest_pointer(ckpt_dir)
    if latest is not None and (frontier is None or latest <= frontier):
        keep_set.add(latest)
    for s in steps:
        if s in keep_set:
            continue
        path = os.path.join(ckpt_dir, f"step_{s:08d}")
        try:
            os.remove(os.path.join(path, "meta.json"))
        except OSError:
            pass
        shutil.rmtree(path, ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "LATEST")
    steps = all_steps(ckpt_dir)
    if not steps:
        return None
    if os.path.exists(path):
        with open(path) as f:
            cand = int(f.read().strip())
        if cand in steps:
            return cand
    return steps[-1]  # LATEST lost/corrupt: fall back to newest complete


def restore(
    ckpt_dir: str,
    like: Any,
    *,
    step: Optional[int] = None,
    device: _device.DeviceLike = None,
    shardings: Any = None,
) -> tuple[Any, int]:
    """Restore into the structure of `like` (a tree of tensors; a `None`
    leaf stays `None`). Each leaf takes the dtype of `like`'s leaf and
    its device, or `device` where given. With `shardings` (mirroring
    `like`), `like`'s leaves are this rank's blocks: each saved array
    must have the global shape of its block, and this rank keeps its
    block of it. Returns (state, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    dev = None if device is None else _device.resolve(device)
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as data:

        def leaf(path_elts, like_leaf, *sh):
            if like_leaf is None:
                return None
            key = _key(path_elts)
            arr = data[key]
            sharding = sh[0] if sh else None
            want = tuple(like_leaf.shape)
            if sharding is not None:
                want = shd.global_shape(want, sharding.spec, sharding.mesh)
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"{key}: checkpoint shape {arr.shape}, expected "
                    f"{want}")
            if sharding is not None:
                arr = np.array(  # a contiguous copy; keeps 0-d leaves 0-d
                    shd.shard_local(arr, sharding.spec, sharding.mesh))
            return torch.from_numpy(arr).to(
                device=like_leaf.device if dev is None else dev,
                dtype=like_leaf.dtype,
            )

        state = map_with_path(
            leaf, like, *(() if shardings is None else (shardings,)))
    return state, step
