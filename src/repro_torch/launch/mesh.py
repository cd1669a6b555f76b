"""Mesh construction over the ranks of a `torch.distributed` group (port
of `repro.launch.mesh`).

FUNCTIONS, not module-level constants: importing this module touches no
process group. Each builds a `DeviceMesh` over the first ranks of the
default group — one rank a device, the card's `"cuda"` or the CPU's
`"cpu"` (gloo) — whose dimensions carry the reference's axis names:

  pod    — pods (multi-pod only): pure DP; cross-pod traffic is where
           `dist.compression` applies.
  data   — in-pod DP + FSDP.
  model  — in-pod TP.

Every rank of the default group calls the same function (building a
mesh creates its process groups, a collective); a rank outside a mesh of
fewer ranks gets a mesh whose `get_coordinate()` is None.
`launch._spawn.run` brings the ranks up.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import _device


def _mesh(shape: tuple, names: tuple, device: _device.DeviceLike,
          what: str) -> DeviceMesh:
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if need > have:
        raise ValueError(
            f"{what} needs {need} ranks but the process group has {have} "
            f"(launch._spawn.run brings them up)"
        )
    dev = _device.resolve(device)
    return DeviceMesh(dev.type, torch.arange(need).reshape(shape),
                      mesh_dim_names=names)


def _check_cards(flag: str, spec: str, need: int,
                 device: _device.DeviceLike) -> None:
    """On the card: one rank a card, so `need` cards (the reference's
    check against `jax.device_count()`)."""
    if _device.resolve(device).type == "cuda":
        avail = torch.cuda.device_count()
        if need > avail:
            raise SystemExit(
                f"{flag} {spec} needs {need} devices but only {avail} "
                f"available (torch.cuda.device_count())"
            )


def make_production_mesh(*, multi_pod: bool = False,
                         device: _device.DeviceLike = None) -> DeviceMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) with "pod" first;
    raises where the group has fewer ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device, "the production mesh")


def make_smoke_mesh(n_data: int = 1, n_model: int = 1,
                    device: _device.DeviceLike = None) -> DeviceMesh:
    """A ("data", "model") mesh over the first n_data * n_model ranks."""
    return _mesh((n_data, n_model), ("data", "model"), device,
                 f"a {n_data}x{n_model} mesh")


def parse_mesh_spec(spec: str) -> tuple[int, int]:
    """CLI mesh spec -> (n_data, n_model). "8" means 8-way data
    parallel; "4x2" means data=4, model=2."""
    parts = spec.lower().split("x")
    if len(parts) == 1:
        return int(parts[0]), 1
    if len(parts) == 2:
        return int(parts[0]), int(parts[1])
    raise ValueError(f"mesh spec {spec!r}: expected 'D' or 'DxM'")


def parse_multipod_spec(spec: str) -> tuple[int, int, int]:
    """CLI multi-pod mesh spec -> (n_pod, n_data, n_model). "2x4" means
    2 pods x 4-way in-pod data parallel; "2x2x2" adds a 2-way in-pod
    model (TP) axis."""
    parts = spec.lower().split("x")
    if len(parts) == 2:
        return int(parts[0]), int(parts[1]), 1
    if len(parts) == 3:
        return int(parts[0]), int(parts[1]), int(parts[2])
    raise ValueError(
        f"multi-pod spec {spec!r}: expected 'PxD' or 'PxDxM' "
        f"(pods x data [x model])"
    )


def make_multipod_mesh(spec: str,
                       device: _device.DeviceLike = None) -> DeviceMesh:
    """('PxD' | 'PxDxM') -> a ("pod", "data", "model") mesh over the
    first P*D*M ranks — the shape `trainer.make_multipod_train_step`
    composes over. On the card it needs P*D*M cards."""
    n_pod, n_data, n_model = parse_multipod_spec(spec)
    need = n_pod * n_data * n_model
    _check_cards("--multi-pod", spec, need, device)
    return _mesh((n_pod, n_data, n_model), ("pod", "data", "model"),
                 device, f"--multi-pod {spec}")


def make_serving_mesh(spec: str,
                      device: _device.DeviceLike = None) -> DeviceMesh:
    """('D' | 'DxM') -> a ("data", "model") mesh over the first D*M
    ranks."""
    n_data, n_model = parse_mesh_spec(spec)
    _check_cards("--mesh", spec, n_data * n_model, device)
    return make_smoke_mesh(n_data, n_model, device)


def make_data_mesh(n_devices: int,
                   device: _device.DeviceLike = None) -> DeviceMesh | None:
    """1-D ("data",) mesh over the first n ranks; None at one (the
    reference's `launch.stream.make_data_mesh`)."""
    if n_devices <= 1:
        return None
    _check_cards("--devices", str(n_devices), n_devices, device)
    return _mesh((n_devices,), ("data",), device, f"--devices {n_devices}")
