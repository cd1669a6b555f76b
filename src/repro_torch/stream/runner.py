"""Bucketed batched inference over the compiled accelerator program.

Port of `repro.stream.runner`, on one device or, with `mesh=`, data
parallel over the ranks of a 1-D ("data",) `DeviceMesh`
(`launch.mesh.make_data_mesh`): every rank is handed the same bucket,
classifies its bucket/N rows (`dist.sharding.batch_specs`, then
`shard_local`) on its own device, and all-gathers the predictions over
the mesh's group, so every rank holds the bucket's — the reference's
"N chip twins over disjoint fleet slices". Each rank of the mesh calls
`classify` with the same bucket. Each `classify` is a cell tracked by
the telemetry probe
(`stream.classify.<path>`), and the runner keeps the set of bucket
shapes it has classified: the scheduler's pad-to-bucket contract keeps
`jit_cache_misses()` at the number of declared buckets. Compute paths:

  * ``twin``      — the program's sparse-quantized weights decompressed
    once at construction into dequantized dense conv weights and run
    through `F.conv1d` in full float32: numerically the per-layer
    ``dense`` path, at convolution speed.
  * ``reference`` / ``kernel`` / ``dense`` — `compiler.execute`'s
    per-layer im2col dataflow; ``kernel`` is the CUDA `nm_spmm` on the
    card.

Time accounting is the modelled chip's: every segment costs
`program.report.latency_s` (the perf model, not a measurement).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import _device, obs
from repro_torch.core import compiler, sparsity, vadetect
from repro_torch.core.spe import conv1d_same
from repro_torch.dist import sharding as shd


class _FleetShardCfg:
    """Profile for `dist.sharding`: the VA fleet is pure data
    parallelism — no tensor parallelism, params replicated."""

    use_tp: bool = False
    fsdp: bool = False


def twin_weights(program: compiler.AcceleratorProgram) -> list[dict]:
    """Decompress the program's layers into dequantized dense conv weights
    (ks, c_in, c_out) — what `spe_matmul`'s "dense" path contracts with."""
    out = []
    for m in program.layer_meta:
        layer = program.layers[m["name"]]
        ks, c_in, c_out = m["ksize"], m["c_in"], m["c_out"]
        vals = layer.values_q.to(torch.float32)
        if layer.sparse:
            dense = sparsity.decompress(
                vals,
                layer.select,
                sparsity.SparsityConfig(layer.group_size, layer.keep),
                layer.k_dense,
            )
        else:
            dense = vals
        # drop the compiler's group padding of K before the reshape
        w = (dense * layer.scale)[: ks * c_in].reshape(ks, c_in, c_out)
        out.append({"w": w, "b": program.biases[m["name"]]})
    return out


def _twin_logits(
    weights: list[dict], meta: list[dict], x: torch.Tensor
) -> torch.Tensor:
    """(B, 512) -> (B, 2) logits through the decompressed conv twin."""
    h = vadetect.pad_input(x)
    n = len(meta)
    for i, (m, wb) in enumerate(zip(meta, weights)):
        y = conv1d_same(h, wb["w"], m["stride"]) + wb["b"]
        h = torch.relu(y) if i < n - 1 else y
    return h.mean(dim=1)


class FleetRunner:
    """Fixed-shape batched classifier over one compiled program, on one
    device (`None` means the CUDA card; the program is moved there),
    each bucket's rows split over the ranks of `mesh` where one is
    given (its device type must be the runner's)."""

    def __init__(
        self,
        program: compiler.AcceleratorProgram,
        cfg: vadetect.VAConfig = vadetect.VAConfig(),
        *,
        path: str = "twin",
        device: _device.DeviceLike = None,
        record: bool = False,
        mesh=None,
    ):
        self.device = _device.resolve(device)
        self.mesh = mesh
        if mesh is not None and mesh.ndim != 1:
            raise ValueError(
                f"FleetRunner shards over a 1-D data mesh, got dims "
                f"{mesh.mesh_dim_names} (launch.mesh.make_data_mesh)"
            )
        self.program = program.to(self.device)
        self.cfg = cfg
        self.path = path
        self._shapes_seen: set[int] = set()
        # with `record`, the (input, logits) device tensors of every
        # classified bucket, in order — for checking one path against
        # another on the same inputs
        self.recorded: list[tuple[torch.Tensor, torch.Tensor]] | None = (
            [] if record else None
        )
        if path == "twin":
            weights = twin_weights(self.program)
            meta = self.program.layer_meta
            self._logits = lambda x: _twin_logits(weights, meta, x)
        else:
            self._logits = lambda x: compiler.execute(
                self.program, x, cfg, path=path
            )
        self._infer = obs.get().probe.track(
            f"stream.classify.{path}", self._predict
        )

    def _predict(self, x: torch.Tensor) -> torch.Tensor:
        y = self._logits(x)
        if self.recorded is not None:
            self.recorded.append((x, y))
        return torch.argmax(y, dim=-1).to(torch.int32)

    def logits(self, signals) -> torch.Tensor:
        """(bucket, 512) -> (bucket, 2) float32 logits on the runner's
        device."""
        x = torch.as_tensor(signals, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            return self._logits(x)

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a bucket: all of them without a mesh, else
        its bucket/N block of the batch dim over the data axes."""
        if self.mesh is None:
            return x
        if x.shape[0] % self.n_devices:
            # silently classifying on one device would void the "N chip
            # twins over disjoint fleet slices" contract — declare
            # divisible bucket shapes instead
            raise ValueError(
                f"bucket {x.shape[0]} not divisible by "
                f"{self.n_devices} mesh devices"
            )
        spec = shd.batch_specs({"x": x}, _FleetShardCfg(), self.mesh)["x"]
        return shd.shard_local(x, spec, self.mesh)

    def classify(self, signals) -> torch.Tensor:
        """(bucket, 512) f32 -> (bucket,) int32 predictions on the
        runner's device. With a mesh this rank classifies its rows and
        the predictions are all-gathered over the mesh."""
        x = torch.as_tensor(signals, dtype=torch.float32, device=self.device)
        local = self.local_rows(x)
        self._shapes_seen.add(int(x.shape[0]))
        with torch.inference_mode():
            pred = self._infer(local)
            if self.mesh is None:
                return pred
            out = torch.empty(x.shape[0], dtype=pred.dtype,
                              device=pred.device)
            dist.all_gather_into_tensor(out, pred.contiguous(),
                                        group=self.mesh.get_group())
            return out

    # -- accounting (the modelled chip's time, not a measurement) ----------

    @property
    def n_devices(self) -> int:
        return 1 if self.mesh is None else self.mesh.size()

    @property
    def chip_latency_s(self) -> float:
        """Modelled silicon latency of one segment inference."""
        return self.program.report.latency_s

    def batch_service_s(self, bucket: int) -> float:
        """Modelled service time of one packed bucket: each device's chip
        twin runs its ceil(bucket/N) segments serially (padding rows
        included)."""
        per_dev = -(-bucket // max(1, self.n_devices))
        return per_dev * self.chip_latency_s

    def modeled_segments_per_s(self) -> float:
        """Modelled chip-fleet throughput (N chips, saturated)."""
        return self.n_devices / self.chip_latency_s

    def jit_cache_misses(self) -> int:
        """Distinct batch shapes `classify` has seen — the count of
        compiled variants in the reference. The scheduler's pad-to-bucket
        contract keeps this at len(buckets)."""
        return len(self._shapes_seen)

