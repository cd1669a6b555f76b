"""The PyTorch port's CUDA kernels on the card, against their plain
versions, nm_spmm through the service path and the streaming fleet,
the training step on the card against the same step on the CPU, a
checkpoint of a card state restored bit for bit, the training loop's
wait for the card inside its step span, LM serving, and the paged cache,
chunked prefill and serving frontend (paged decode equal to dense bit for
bit), a packed layer's tensor-parallel halves in a world-1 NCCL
group, the open-loop load lab (the stream sweep's kernel path, a
serve point's tails), and the cell auditor on the card (a copy between
host and card flagged; quant_matmul's flops counted in a cell's cost).

Needs a CUDA card, so every test here is marked `cuda` and skips on a
host without one. The file imports no jax (the card's machine has none);
run it there with the repository's conftest left out:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: 1e-4 relative to max|y| for the kernel against its plain
version (float32, summed in another order — tests/test_kernels.py's
float32 tolerance; for the CMUL and SPE kernels, two TF32 passes on the tensor
cores, about 1e-6), a repeated launch bit-identical, the fused
sparse_conv1d bit-identical to im2col -> pad -> nm_spmm, 1e-3 on logits across compute paths
(tests/test_vadetect.py), 1e-4 relative for a train step on the card
against the CPU (cuDNN sums the gradients in another order), 1e-5
relative for a gradient with cuDNN's TF32 allowed against one without
(TF32 would differ by about 1e-3).
"""

import pytest
import torch

from repro_torch import optim
from repro_torch._tree import leaves, tree_map
from repro_torch.configs import va_cnn
from repro_torch.core import compiler, spe, vadetect
from repro_torch.data import iegm
from repro_torch.core import quant
from repro_torch.kernels import bitserial as tbs
from repro_torch.kernels import nm_spmm as tk
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import sparse_conv1d as tsc
from repro_torch.serve.va_service import VAService
from repro_torch.stream import FleetConfig, FleetRunner, simulate
from repro_torch.train import trainer

G, KEEP = 16, 8

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,nn", [(65536, 32, 16), (4096, 192, 96),
                                    (130, 64, 130), (1, 16, 1)])
def test_nm_spmm_kernel_matches_plain(cuda, m, k, nn):
    gen = torch.Generator(device=cuda).manual_seed(m + nn)
    layer = spe.compile_layer(
        torch.randn((k, nn), generator=gen, device=cuda), spe.SPEConfig()
    )
    x = torch.randn((m, k), generator=gen, device=cuda)
    args = (x, layer.values_q, layer.select, layer.scale)
    before = tk.launches
    y = ops.nm_spmm(*args, group_size=G, keep=KEEP)
    torch.cuda.synchronize()
    assert tk.launches == before + 1
    y_plain = tk.nm_spmm_plain(*args, group_size=G, keep=KEEP)
    assert float((y - y_plain).abs().max()) <= 1e-4 * float(y_plain.abs().max())


def test_nm_spmm_wrapper_rejects_wrong_dtype(cuda):
    x = torch.zeros((4, 32), device=cuda)
    values = torch.zeros((16, 8), dtype=torch.float32, device=cuda)
    select = torch.zeros((16, 8), dtype=torch.uint8, device=cuda)
    scale = torch.ones((1, 8), device=cuda)
    with pytest.raises(TypeError, match="values must be torch.int8"):
        tk.nm_spmm_cuda(x, values, select, scale, group_size=G, keep=KEEP)


def test_service_kernel_path_matches_reference(cuda):
    gen = torch.Generator().manual_seed(1)
    cfg = va_cnn.CONFIG
    program = compiler.compile_model(vadetect.init(gen, cfg, device=cuda), cfg)
    recs = iegm.synth_diagnosis_batch(gen, 2, device=cuda)["signal"]
    before = tk.launches
    diag_k = VAService(program, cfg, path="kernel", device=cuda).diagnose_batch(recs)
    assert tk.launches - before == 7  # one execute, 7 sparse layers
    diag_r = VAService(program, cfg, path="reference", device=cuda).diagnose_batch(recs)
    assert [(d.is_va, d.segment_preds) for d in diag_k] == [
        (d.is_va, d.segment_preds) for d in diag_r
    ]
    x = recs.reshape(-1, 512)
    y_k = compiler.execute(program, x, cfg, path="kernel")
    y_r = compiler.execute(program, x, cfg, path="reference")
    assert float((y_k - y_r).abs().max()) <= 1e-3


def _rel_err(y: torch.Tensor, y_plain: torch.Tensor) -> float:
    return float((y - y_plain).abs().max()) / float(y_plain.abs().max())


@pytest.mark.parametrize("b,tt,c,nn,ks,stride", [
    (256, 512, 4, 16, 7, 2),  # VA conv0 at bucket 256
    (3, 200, 8, 40, 5, 2),    # ragged: T_out 100 and N 40 off the tiles
])
def test_sparse_conv1d_kernel_matches_plain(cuda, b, tt, c, nn, ks, stride):
    gen = torch.Generator(device=cuda).manual_seed(tt + nn)
    k_dense = -(-(ks * c) // G) * G
    layer = spe.compile_layer(
        torch.randn((k_dense, nn), generator=gen, device=cuda), spe.SPEConfig()
    )
    x = torch.randn((b, tt, c), generator=gen, device=cuda)
    args = (x, layer.values_q, layer.select, layer.scale)
    kw = dict(ksize=ks, stride=stride, group_size=G, keep=KEEP)
    before = tsc.launches
    y = ops.sparse_conv1d(*args, **kw)
    torch.cuda.synchronize()
    assert tsc.launches == before + 1
    assert tuple(y.shape) == (b, (tt - 1) // stride + 1, nn)
    assert _rel_err(y, tsc.sparse_conv1d_plain(*args, **kw)) <= 1e-4


def test_sparse_conv1d_matches_im2col_nm_spmm_at_conv2(cuda):
    """conv2 (24 channels x 5 taps = 120, group-padded to 128): the fused
    kernel equals execute's im2col -> pad -> nm_spmm on the card, bit for
    bit (both stage the same values and run the same plan, spe_tc.cuh)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    layer = spe.compile_layer(
        torch.randn((128, 32), generator=gen, device=cuda), spe.SPEConfig()
    )
    x = torch.randn((256, 128, 24), generator=gen, device=cuda)
    kw = dict(group_size=G, keep=KEEP)
    flat = torch.nn.functional.pad(spe.im2col(x, 5, 1), (0, 8))
    before = (tsc.launches, tk.launches)
    y_mm = ops.nm_spmm(flat, layer.values_q, layer.select, layer.scale, **kw)
    y = ops.sparse_conv1d(x, layer.values_q, layer.select, layer.scale,
                          ksize=5, stride=1, **kw)
    torch.cuda.synchronize()
    assert (tsc.launches, tk.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(y.reshape(y_mm.shape), y_mm)


# the SPE kernels' tiling (spe_tc.cuh): 64-row M tiles, output tiles 8 to
# 96 wide (N tiled above 96, narrowed where the tiles would not fill the
# SMs or the B tile would not fit), 32-wide K chunks; K = 800 narrows the
# tile to fit the B tile in shared memory
SPE_M = [1, 63, 64, 65, 4097]
SPE_N = [1, 16, 24, 40, 96, 130]
SPE_K = [16, 32, 192, 800]


def _spe_layer(cuda, k_dense, nn, gen):
    """A compiled random (k_dense, N) layer; where N > 1 its last column is
    all zero with scale 0."""
    w = torch.randn((k_dense, nn), generator=gen, device=cuda)
    if nn > 1:
        w[:, -1] = 0.0
    layer = spe.compile_layer(w, spe.SPEConfig())
    if nn > 1:
        layer.scale[:, -1] = 0.0
    return layer


@pytest.mark.parametrize("m", SPE_M)
@pytest.mark.parametrize("nn", SPE_N)
@pytest.mark.parametrize("k", SPE_K)
def test_nm_spmm_at_the_tile_edges(cuda, m, nn, k):
    """Against the plain version and itself (a second launch on the same
    inputs is bit-identical); a zero column with scale 0 stays zero."""
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + nn + k)
    layer = _spe_layer(cuda, k, nn, gen)
    x = torch.randn((m, k), generator=gen, device=cuda)
    args = (x, layer.values_q, layer.select, layer.scale)
    y = tk.nm_spmm_cuda(*args, group_size=G, keep=KEEP)
    again = tk.nm_spmm_cuda(*args, group_size=G, keep=KEEP)
    torch.cuda.synchronize()
    assert tuple(y.shape) == (m, nn)
    y_plain = tk.nm_spmm_plain(*args, group_size=G, keep=KEEP)
    assert float((y - y_plain).abs().max()) <= 1e-4 * float(y_plain.abs().max())
    assert torch.equal(y, again)
    if nn > 1:
        assert bool((y[:, -1] == 0).all())


@pytest.mark.parametrize("t_out", [1, 16, 32, 65])
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("c", [4, 24, 64])
@pytest.mark.parametrize("ks", [1, 3, 5, 7])
def test_sparse_conv1d_at_the_tile_edges(cuda, t_out, stride, c, ks):
    """Five batch rows, so 64-row tiles cross batch rows wherever T_out <
    64; K group-padded wherever ks * C is not a multiple of 16. Against the
    plain version, itself, and im2col -> pad -> nm_spmm bit for bit; a zero
    column with scale 0 stays zero."""
    b, nn = 5, 24
    gen = torch.Generator(device=cuda).manual_seed(t_out * 31 + stride * 7 + c + ks)
    k_dense = -(-(ks * c) // G) * G
    layer = _spe_layer(cuda, k_dense, nn, gen)
    x = torch.randn((b, t_out * stride, c), generator=gen, device=cuda)
    args = (x, layer.values_q, layer.select, layer.scale)
    kw = dict(ksize=ks, stride=stride, group_size=G, keep=KEEP)
    y = tsc.sparse_conv1d_cuda(*args, **kw)
    again = tsc.sparse_conv1d_cuda(*args, **kw)
    flat = torch.nn.functional.pad(spe.im2col(x, ks, stride),
                                   (0, k_dense - ks * c))
    y_mm = tk.nm_spmm_cuda(flat.reshape(b * t_out, k_dense), layer.values_q,
                           layer.select, layer.scale, group_size=G, keep=KEEP)
    torch.cuda.synchronize()
    assert tuple(y.shape) == (b, t_out, nn)
    assert _rel_err(y, tsc.sparse_conv1d_plain(*args, **kw)) <= 1e-4
    assert torch.equal(y, again)
    assert torch.equal(y.reshape(y_mm.shape), y_mm)
    assert bool((y[..., -1] == 0).all())


def _wide_range(x, gen):
    """x from 1e-20 to 1e20: row 0 spans the whole range, every other row
    has one magnitude from that range."""
    rows, k = x.shape[0], x.shape[-1]
    exps = torch.empty((rows, 1), device=x.device).uniform_(-20, 20, generator=gen)
    exps[0] = 0.0
    spread = torch.empty((1, k), device=x.device).uniform_(-20, 20, generator=gen)
    x = x * 10.0 ** exps
    x[0] = x[0] * 10.0 ** spread[0]
    return x


@pytest.mark.parametrize("m,k,nn", [(33, 192, 40), (130, 64, 130), (4097, 96, 48)])
def test_spe_kernels_over_a_wide_range_of_x(cuda, m, k, nn):
    """Each row is held at 1e-4 of its own max|y|, so the split of x into
    TF32 parts must hold at every scale; sparse_conv1d at ksize 1 (its
    patch rows are the signal's rows) on the same x."""
    gen = torch.Generator(device=cuda).manual_seed(m + k + nn)
    layer = _spe_layer(cuda, k, nn, gen)
    x = _wide_range(torch.randn((m, k), generator=gen, device=cuda), gen)
    args = (layer.values_q, layer.select, layer.scale)
    kw = dict(group_size=G, keep=KEEP)
    y_plain = tk.nm_spmm_plain(x, *args, **kw)
    ys = [tk.nm_spmm_cuda(x, *args, **kw),
          tsc.sparse_conv1d_cuda(x[None], *args, ksize=1, stride=1, **kw)[0]]
    torch.cuda.synchronize()
    for y in ys:
        assert bool(torch.isfinite(y).all())
        row_err = (y - y_plain).abs().amax(dim=1)
        assert bool((row_err <= 1e-4 * y_plain.abs().amax(dim=1)).all())


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
@pytest.mark.parametrize("m,k,nn", [(128, 512, 256), (33, 128, 40)])
def test_quant_matmul_kernel_matches_plain(cuda, bits, m, k, nn):
    gen = torch.Generator(device=cuda).manual_seed(bits)
    q, scale = quant.quantize(
        torch.randn((k, nn), generator=gen, device=cuda),
        quant.QuantConfig(bits=bits),
    )
    packed = quant.pack_planes(q, bits)
    x = torch.randn((m, k), generator=gen, device=cuda)
    before = tqm.launches
    y = ops.quant_matmul(x, packed, scale, bits=bits)
    torch.cuda.synchronize()
    assert tqm.launches == before + 1
    assert _rel_err(y, tqm.quant_matmul_plain(x, packed, scale, bits=bits)) <= 1e-4


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
@pytest.mark.parametrize("m,k,nn", [(8, 64, 16), (33, 128, 40)])
def test_bitserial_kernel_matches_plain(cuda, bits, m, k, nn):
    gen = torch.Generator(device=cuda).manual_seed(bits + m)
    q, scale = quant.quantize(
        torch.randn((k, nn), generator=gen, device=cuda),
        quant.QuantConfig(bits=bits),
    )
    packed = quant.pack_planes(q, bits)
    x = torch.randn((m, k), generator=gen, device=cuda)
    before = tbs.launches
    y = ops.bitserial_matmul(x, packed, scale, bits=bits)
    torch.cuda.synchronize()
    assert tbs.launches == before + 1
    assert _rel_err(y, tbs.bitserial_matmul_plain(x, packed, scale, bits=bits)) <= 1e-4
    assert _rel_err(y, tqm.quant_matmul_cuda(x, packed, scale, bits=bits)) <= 1e-4


# the CMUL kernels' tiling: 64-row tiles (M), 32-column tiles (N), 32-wide
# K chunks split across a cluster; K = 136 is not a whole number of chunks
CMUL_M = [1, 33, 64, 65, 128]
CMUL_N = [1, 40, 256]
CMUL_K = ["vpb", 64, 136, 512, 4096]  # vpb: one packed row


def _cmul_operands(cuda, bits, m, k, nn, seed):
    """x, packed, scale of a random weight; where N > 1 its last column is
    all zero with scale 0."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randn((k, nn), generator=gen, device=cuda)
    if nn > 1:
        w[:, -1] = 0.0
    q, scale = quant.quantize(w, quant.QuantConfig(bits=bits))
    if nn > 1:
        scale[:, -1] = 0.0
    x = torch.randn((m, k), generator=gen, device=cuda)
    return x, quant.pack_planes(q, bits), scale


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
@pytest.mark.parametrize("m", CMUL_M)
@pytest.mark.parametrize("nn", CMUL_N)
@pytest.mark.parametrize("k", CMUL_K)
def test_cmul_kernels_at_the_tile_edges(cuda, bits, m, nn, k):
    """Both CMUL kernels against their plain versions, each other and
    themselves (a second launch on the same inputs is bit-identical: the
    cluster sums its K split in a fixed order, no atomics)."""
    k = 8 // bits if k == "vpb" else k
    x, packed, scale = _cmul_operands(cuda, bits, m, k, nn, bits * m + nn + k)
    y = {}
    for name, fn, plain in (
        ("quant", tqm.quant_matmul_cuda, tqm.quant_matmul_plain),
        ("bitserial", tbs.bitserial_matmul_cuda, tbs.bitserial_matmul_plain),
    ):
        y[name] = fn(x, packed, scale, bits=bits)
        again = fn(x, packed, scale, bits=bits)
        torch.cuda.synchronize()
        assert tuple(y[name].shape) == (m, nn)
        y_plain = plain(x, packed, scale, bits=bits)
        err = float((y[name] - y_plain).abs().max())
        assert err <= 1e-4 * float(y_plain.abs().max()), name
        assert torch.equal(y[name], again), name
        if nn > 1:
            assert bool((y[name][:, -1] == 0).all()), name
    err = float((y["bitserial"] - y["quant"]).abs().max())
    assert err <= 1e-4 * float(y["quant"].abs().max())


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
@pytest.mark.parametrize("m,k,nn", [(33, 136, 40), (128, 512, 256)])
def test_cmul_kernels_over_a_wide_range_of_x(cuda, bits, m, k, nn):
    """x from 1e-20 to 1e20: row 0 spans the whole range, every other row
    has one magnitude from that range. Each row is held at 1e-4 of its own
    max|y|, so the split of x into TF32 parts must hold at every scale."""
    x, packed, scale = _cmul_operands(cuda, bits, m, k, nn, bits + k)
    gen = torch.Generator(device=cuda).manual_seed(bits)
    exps = torch.empty((m, 1), device=cuda).uniform_(-20, 20, generator=gen)
    exps[0] = 0.0
    spread = torch.empty((1, k), device=cuda).uniform_(-20, 20, generator=gen)
    x = x * 10.0 ** exps
    x[0] = x[0] * 10.0 ** spread[0]
    for fn, plain in ((tqm.quant_matmul_cuda, tqm.quant_matmul_plain),
                      (tbs.bitserial_matmul_cuda, tbs.bitserial_matmul_plain)):
        y = fn(x, packed, scale, bits=bits)
        torch.cuda.synchronize()
        y_plain = plain(x, packed, scale, bits=bits)
        assert bool(torch.isfinite(y).all())
        row_err = (y - y_plain).abs().amax(dim=1)
        assert bool((row_err <= 1e-4 * y_plain.abs().amax(dim=1)).all())


def _rel_tree(a, b) -> float:
    pairs = list(zip(leaves(a), leaves(b)))
    err = max(float((x.cpu() - y.cpu()).abs().max()) for x, y in pairs)
    return err / max(float(y.abs().max()) for _, y in pairs)


@pytest.mark.parametrize("name", ["CONFIG", "MIXED", "DENSE"])
def test_train_step_on_the_card_matches_the_cpu(cuda, name):
    """From warm Adam moments (3 CPU steps), one quickstart step on the
    card and on the CPU on the same batch."""
    cfg = getattr(va_cnn, name)
    cpu = torch.device("cpu")
    opt = optim.adam(3e-3)
    step = trainer.make_train_step(lambda p, b: vadetect.loss_fn(p, b, cfg),
                                   opt, clip_norm=1.0)
    state = trainer.init_state(
        vadetect.init(torch.Generator().manual_seed(0), cfg, device=cpu), opt,
        device=cpu)
    stream = iegm.IEGMStream(batch=16, seed=0, device=cpu)
    for i in range(3):
        state, _ = step(state, stream.batch_at(i))
    batch = stream.batch_at(3)
    new_c, m_c = step(state, batch)
    new_d, m_d = step(tree_map(lambda v: v.to(cuda), state),
                      {k: v.to(cuda) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        assert float(m_d[key]) == pytest.approx(float(m_c[key]), rel=1e-4)
    assert _rel_tree(new_d["params"], new_c["params"]) <= 1e-4
    assert _rel_tree(new_d["opt"]["m"], new_c["opt"]["m"]) <= 1e-4


def test_conv_backward_stays_float32_with_tf32_allowed(cuda):
    """cuDNN allows TF32 by default; the port's convolution keeps its
    backward in float32 all the same (VA conv2 at batch 64)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((64, 128, 24), generator=gen, device=cuda)
    w = torch.randn((5, 24, 32), generator=gen, device=cuda) * 0.1
    g_y = torch.randn((64, 128, 32), generator=gen, device=cuda)

    def grads():
        xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = spe.conv1d_same(xl, wl, 1)
        return torch.autograd.grad((y * g_y).sum(), (xl, wl))

    default = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = False
        want = grads()
        torch.backends.cudnn.allow_tf32 = True
        got = grads()
    finally:
        torch.backends.cudnn.allow_tf32 = default
    for g, g_ref in zip(got, want):
        assert _rel_err(g, g_ref) <= 1e-5


@pytest.mark.parametrize("bucket", [8, 32, 128, 256, 512])
def test_fleet_on_the_kernel_path_matches_the_cpu(cuda, bucket):
    """The fleet on the card's kernel path against the same run on the
    CPU (plain nm_spmm): every bucket's logits within 1e-3, a differing
    prediction only where the CPU's margin |l1 - l0| is under it, and the
    same counts."""
    cfg = FleetConfig(n_patients=bucket, segments_per_patient=6,
                      buckets=(bucket,), va_fraction=0.05, jitter_frac=0.05,
                      seed=bucket, path="kernel")
    program = compiler.compile_model(
        vadetect.init(torch.Generator().manual_seed(bucket), device="cpu"))
    runs = []
    for dev in (cuda, torch.device("cpu")):
        runner = FleetRunner(program, path="kernel", device=dev, record=True)
        before = tk.launches
        out = simulate(cfg, runner=runner)
        torch.cuda.synchronize()
        seen = [(x.cpu(), y.cpu()) for x, y in runner.recorded]
        runs.append((out, seen, tk.launches - before))
    (out_c, seen_c, n_c), (out_p, seen_p, n_p) = runs
    # 7 sparse layers a bucket, the warm-up bucket included
    assert n_c == 7 * (out_c["metrics"]["batches_total"] + 1) and n_p == 0
    assert len(seen_c) == len(seen_p)
    for (x_c, y_c), (x_p, y_p) in zip(seen_c, seen_p):
        assert torch.equal(x_c, x_p)
        assert float((y_c - y_p).abs().max()) <= 1e-3
        flips = y_c.argmax(-1) != y_p.argmax(-1)
        margin = (y_p[:, 1] - y_p[:, 0]).abs()
        assert bool((margin[flips] < 1e-3).all())
    wall = ("wall_s", "segments_per_s_wall", "diagnoses_per_s_wall")
    assert ({k: v for k, v in out_c["metrics"].items() if k not in wall}
            == {k: v for k, v in out_p["metrics"].items() if k not in wall})
    assert out_c["metrics"]["dropped_total"] == 0
    assert out_c["jit_cache_misses"] == out_p["jit_cache_misses"] == 1


def test_checkpoint_roundtrip_of_a_card_state(cuda, tmp_path):
    """A CONFIG adamw state trained a step on the card: saved, restored
    onto the card bit for bit (dtypes, devices and the 0-d int32 step
    kept), and onto the CPU with `device="cpu"`."""
    from repro_torch.train import checkpoint

    cfg = va_cnn.CONFIG
    opt = optim.adamw(3e-3)
    state = trainer.init_state(
        vadetect.init(torch.Generator().manual_seed(0), cfg, device=cuda), opt,
        device=cuda)
    step = trainer.make_train_step(lambda p, b: vadetect.loss_fn(p, b, cfg),
                                   opt, clip_norm=1.0)
    state, _ = step(state, iegm.IEGMStream(batch=16, device=cuda).batch_at(0))
    checkpoint.save(state, str(tmp_path), 1)
    for dev in (None, "cpu"):
        restored, s = checkpoint.restore(str(tmp_path), state, device=dev)
        assert s == 1
        pairs = []
        tree_map(lambda g, w: pairs.append((g, w)), restored, state)
        assert len(pairs) == 49
        for g, w in pairs:
            assert g.dtype == w.dtype
            assert g.device.type == ("cuda" if dev is None else "cpu")
            assert torch.equal(g.cpu(), w.cpu())


def test_run_training_waits_for_the_card_inside_the_span(cuda):
    """With telemetry on, every `train.step_latency_s` observation (the
    step's `wall_s`) is at least the device time of that step's work:
    `run_training` waits for the card inside the `train/step` span. A
    step here is one long device-side sleep, its time read from CUDA
    events around it."""
    from repro_torch import obs
    from repro_torch.train import fault

    events = []

    def train_step(state, batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        events.append((start, end))
        return state + 1, {"loss": state.to(torch.float32)}

    tel = obs.configure(enabled=True)
    try:
        final, history = fault.run_training(
            train_step, torch.zeros((), device=cuda), lambda step: None,
            num_steps=5, log_every=0)
    finally:
        obs.reset()
    torch.cuda.synchronize()
    device_s = [s.elapsed_time(e) / 1e3 for s, e in events]
    assert int(final) == 5 and len(history) == 5
    assert min(device_s) > 1e-3
    for h, d in zip(history, device_s):
        assert h["wall_s"] >= d, (h["wall_s"], d)
    hist = tel.registry.snapshot()["histograms"]["train.step_latency_s"]
    assert hist["count"] == 5
    assert hist["min"] >= min(device_s)
    assert hist["sum"] == pytest.approx(sum(h["wall_s"] for h in history))


# ---------------------------------------------------------------------------
# LM serving: the packed and sparse linear formats, and generate
# ---------------------------------------------------------------------------


def _lm(dtype="float32", max_seq=32):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import api

    cfg = dataclasses.replace(configs.reduced("qwen3_8b"), dtype=dtype)
    return api.build_model(cfg, max_seq=max_seq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_packed_linear_on_the_card_matches_the_cpu(cuda, bits, dtype):
    """`linear_apply`'s packed branch on a stacked group slice at a reduced
    width: one quant_matmul launch, its result within 1e-4 of max|y| of
    the CPU's plain version in float32, and within the bfloat16 tolerance
    (3e-2) once rounded to bfloat16."""
    from repro_torch.models import layers

    gen = torch.Generator().manual_seed(bits)
    w = torch.randn((3, 64, 96), generator=gen) * 0.125
    x = torch.randn((2, 5, 64), generator=gen)
    packed = layers.compile_linear_quant({"w": w, "b": torch.ones(96)}, bits)
    on_cpu = {"packed": packed["packed"][1], "scale": packed["scale"][1],
              "b": packed["b"]}
    on_card = {k: v.to(cuda) for k, v in on_cpu.items()}
    before = tqm.launches
    y = layers.linear_apply(on_card, x.to(cuda), dtype=dtype)
    torch.cuda.synchronize()
    assert tqm.launches == before + 1
    want = layers.linear_apply(on_cpu, x, dtype=dtype)
    assert y.dtype == dtype and y.shape == (2, 5, 96)
    if dtype == torch.float32:
        err = float((y.cpu() - want).abs().max() / want.abs().max())
        assert err <= 1e-4, err
    else:
        torch.testing.assert_close(y.cpu().float(), want.float(), rtol=3e-2,
                                   atol=3e-2)


def test_generate_launches_quant_matmul_once_a_projection(cuda):
    """A quantized `generate` at the reduced qwen3-8b (float32) on the card:
    7 quant_matmul launches a layer a forward, one prefill and max_new
    decode steps, and the CPU's greedy tokens."""
    from repro_torch.serve import engine

    model = _lm()
    params = engine.quantize_for_serving(model.init(0, device="cpu"), 8)
    prompts = torch.randint(0, model.cfg.vocab, (3, 8),
                            generator=torch.Generator().manual_seed(1))
    want = engine.generate(model, params, prompts, max_new=4, device="cpu")
    on_card = tree_map(lambda v: v.to(cuda), params)
    tqm.launches = 0
    got = engine.generate(model, on_card, prompts, max_new=4)
    torch.cuda.synchronize()
    assert tqm.launches == 7 * model.cfg.n_layers * (1 + 4)
    assert torch.equal(got.cpu(), want)


def test_engine_burst_on_the_card_matches_the_cpu(cuda):
    """The slot engine's burst (batched admission, recycling, the in-place
    cache re-fed to idle slots) on the card against the CPU, float32."""
    from repro_torch.serve import engine

    model = _lm(max_seq=64)
    params = model.init(0, device="cpu")
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, model.cfg.vocab, (4 + i % 3,), generator=gen)
               for i in range(5)]
    outs = []
    for dev, p in (("cpu", params), (cuda, tree_map(lambda v: v.to(cuda), params))):
        eng = engine.Engine(model, p, batch_size=2, device=dev)
        reqs = [engine.Request(uid=i, prompt=pr, max_new=5)
                for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run(max_ticks=60)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_sparse_linear_at_the_widest_k_the_kernel_takes(cuda):
    """`linear_apply`'s SPE branch through nm_spmm at N = 1024 (qwen3-8b's
    K/V width), against the CPU, one launch each: at the widest K whose
    whole dense strip fits a block's shared memory (one segment), and at
    K = 12 288 (qwen3-8b's d_ff), which the kernel streams in K segments
    of whole groups, as the reference's grid walks K."""
    from repro_torch.models import layers

    n_out = 1024
    k = 12288
    assert tk.launch_geometry(4, k, n_out, group_size=G)["seg_k"] < k
    widest = k
    while tk.launch_geometry(4, widest, n_out, group_size=G)["seg_k"] < widest:
        widest -= 16
    assert 4096 <= widest < k
    gen = torch.Generator().manual_seed(3)
    for k_in in (widest, k):
        w = torch.randn((k_in, n_out), generator=gen) * k_in ** -0.5
        x = torch.randn((4, k_in), generator=gen)
        sparse = layers.compile_linear_sparse_quant({"w": w}, 8)
        on_card = {kk: (v.to(cuda) if isinstance(v, torch.Tensor) else v)
                   for kk, v in sparse.items()}
        before = tk.launches
        y = layers.linear_apply(on_card, x.to(cuda), dtype=torch.float32)
        torch.cuda.synchronize()
        assert tk.launches == before + 1
        want = layers.linear_apply(sparse, x, dtype=torch.float32)
        err = float((y.cpu() - want).abs().max() / want.abs().max())
        assert err <= 1e-4, (k_in, err)


@pytest.mark.parametrize("extra", [0, G])
@pytest.mark.parametrize("m", [1, 4, 64, 130])
def test_nm_spmm_at_the_segment_boundaries(cuda, m, extra):
    """Where the strip streams in segments (K near 12 288 at N = 1024): K a
    whole number of segments exactly, and K one group past it (a last
    segment of one group); 130 rows take three M tiles, each decoding
    every segment again. Within 1e-4 of max|y| of the plain version, a
    repeat bit-identical."""
    n_out = 1024
    seg = tk.launch_geometry(m, 65536, n_out, group_size=G)["seg_k"]
    k = 12288 // seg * seg + extra  # past any whole strip at N = 1024
    geom = tk.launch_geometry(m, k, n_out, group_size=G)
    assert geom["seg_k"] == seg and k % seg == extra
    gen = torch.Generator(device=cuda).manual_seed(m + extra)
    layer = spe.compile_layer(
        torch.randn((k, n_out), generator=gen, device=cuda), spe.SPEConfig())
    x = torch.randn((m, k), generator=gen, device=cuda)
    args = (x, layer.values_q, layer.select, layer.scale)
    y = tk.nm_spmm_cuda(*args, group_size=G, keep=KEEP)
    y_again = tk.nm_spmm_cuda(*args, group_size=G, keep=KEEP)
    torch.cuda.synchronize()
    y_plain = tk.nm_spmm_plain(*args, group_size=G, keep=KEEP)
    assert torch.equal(y, y_again)
    assert float((y - y_plain).abs().max()) <= 1e-4 * float(
        y_plain.abs().max())


# ---------------------------------------------------------------------------
# The MoE, RG-LRU, RWKV-6 and whisper families
# ---------------------------------------------------------------------------


# recurrentgemma-2b's and rwkv6-3b's packed projection widths (K, N)
FAMILY_SHAPES = [(2560, 2560), (2560, 256), (2560, 7680), (7680, 2560),
                 (2560, 8960), (8960, 2560)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k,nn", FAMILY_SHAPES)
def test_quant_matmul_at_the_new_families_widths(cuda, k, nn, bits):
    """The kernel at a decode step's and a prefill's rows (4 and 64) of
    the new families' projections: within 1e-4 of max|y| of its plain
    version, a repeat bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(k + nn + bits)
    w = torch.randn((k, nn), generator=gen, device=cuda) * k ** -0.5
    q, scale = quant.quantize(w, quant.QuantConfig(bits=bits))
    packed = quant.pack_planes(q, bits)
    for m in (4, 64):
        x = torch.randn((m, k), generator=gen, device=cuda)
        y = tqm.quant_matmul_cuda(x, packed, scale, bits=bits)
        again = tqm.quant_matmul_cuda(x, packed, scale, bits=bits)
        assert torch.equal(y, again)
        assert _rel_err(y, tqm.quant_matmul_plain(x, packed, scale,
                                                  bits=bits)) <= 1e-4


def _family(name, max_seq=40):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import api

    cfg = dataclasses.replace(configs.reduced(name), dtype="float32")
    return api.build_model(cfg, max_seq=max_seq)


def _packed_linears(tree) -> int:
    """Packed linears a forward applies: a stacked one once a group."""
    if not isinstance(tree, dict):
        return 0
    if "packed" in tree:
        return tree["packed"].shape[0] if tree["packed"].ndim == 3 else 1
    return sum(_packed_linears(v) for v in tree.values())


@pytest.mark.parametrize("name", ["olmoe_1b_7b", "llama4_scout_17b_a16e",
                                  "recurrentgemma_2b", "rwkv6_3b"])
def test_reduced_family_on_the_card_matches_the_cpu(cuda, name):
    """A reduced config in float32, dense and packed at 8 bits: the
    prefill and 4 decode steps (the recurrent states and MoE dispatch on
    the card) within 1e-4 of max|logit| of the CPU, generate's greedy
    tokens equal, and one quant_matmul launch a packed linear a forward."""
    from repro_torch.serve import engine

    model = _family(name)
    dense = model.init(0, device="cpu")
    prompts = torch.randint(0, model.cfg.vocab, (3, 16),
                            generator=torch.Generator().manual_seed(1))
    for params in (dense, engine.quantize_for_serving(dense, 8)):
        on_card = tree_map(lambda v: v.to(cuda), params)
        l_cpu, c_cpu = model.prefill(params, prompts)
        l_card, c_card = model.prefill(on_card, prompts.to(cuda))
        assert _rel_err(l_card.cpu(), l_cpu) <= 1e-4
        tok = l_cpu.argmax(-1)
        for step in range(4):
            pos = torch.full((3,), 16 + step, dtype=torch.long)
            l_cpu, c_cpu = model.decode_step(params, c_cpu, tok, pos)
            l_card, c_card = model.decode_step(on_card, c_card, tok.to(cuda),
                                               pos.to(cuda))
            assert _rel_err(l_card.cpu(), l_cpu) <= 1e-4
            tok = l_cpu.argmax(-1)
        want = engine.generate(model, params, prompts, max_new=4, device="cpu")
        tqm.launches = 0
        got = engine.generate(model, on_card, prompts, max_new=4)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        assert tqm.launches == _packed_linears(on_card) * (1 + 4)


def test_whisper_on_the_card_matches_the_cpu(cuda):
    """The reduced whisper in float32: prefill with frames and 4 decode
    steps on the card within 1e-4 of max|logit| of the CPU, dense and
    packed at 8 bits (6 launches an encoder layer, 10 a decoder layer in
    the prefill, 8 a decoder layer a step)."""
    from repro_torch.serve import engine

    model = _family("whisper_tiny", max_seq=24)
    cfg = model.cfg
    gen = torch.Generator().manual_seed(2)
    frames = torch.randn((2, cfg.enc_seq, cfg.d_model), generator=gen)
    prompts = torch.randint(0, cfg.vocab, (2, 8), generator=gen)
    dense = model.init(0, device="cpu")
    for bits, params in ((None, dense),
                         (8, engine.quantize_for_serving(dense, 8))):
        on_card = tree_map(lambda v: v.to(cuda), params)
        tqm.launches = 0
        l_card, c_card = model.prefill(on_card, prompts.to(cuda),
                                       frames.to(cuda))
        l_cpu, c_cpu = model.prefill(params, prompts, frames)
        assert _rel_err(l_card.cpu(), l_cpu) <= 1e-4
        tok = l_cpu.argmax(-1)
        for step in range(4):
            pos = torch.full((2,), 8 + step, dtype=torch.long)
            l_card, c_card = model.decode_step(on_card, c_card, tok.to(cuda),
                                               pos.to(cuda))
            l_cpu, c_cpu = model.decode_step(params, c_cpu, tok, pos)
            assert _rel_err(l_card.cpu(), l_cpu) <= 1e-4
            tok = l_cpu.argmax(-1)
        torch.cuda.synchronize()
        want = (cfg.enc_layers * 6 + cfg.n_layers * 10
                + 4 * cfg.n_layers * 8) if bits else 0
        assert tqm.launches == want


# ---------------------------------------------------------------------------
# The paged KV cache, chunked prefill and the serving frontend
# ---------------------------------------------------------------------------


def _paged_runs(model, params, dev, prompts, **kw):
    """The same requests through a dense and a paged chunked engine on
    `dev`: ({label: tokens}, {label: [(logits, occupied)] a decode step})."""
    from repro_torch.serve import engine
    from repro_torch.serve.paging import PagingConfig

    outs, logs = {}, {}
    # a pool that never defers these requests: both engines keep one
    # schedule, so their decode steps pair up
    for label, paging in (("dense", None), ("paged", PagingConfig(4, 32))):
        eng = engine.Engine(model, params, batch_size=2, paging=paging,
                            chunk_tokens=4, device=dev, **kw)
        log, inner = [], eng._decode

        def step(p, cache, tok, pos, inner=inner, log=log, eng=eng):
            logits, cache = inner(p, cache, tok, pos)
            log.append((logits.cpu(), [s is not None for s in eng._slots]))
            return logits, cache

        eng._decode = step
        reqs = [engine.Request(uid=i, prompt=pr, max_new=5)
                for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run(max_ticks=80)
        assert all(r.done for r in reqs) and eng.cache_bytes_in_use() == 0
        outs[label], logs[label] = [r.output for r in reqs], log
    return outs, logs


@pytest.mark.parametrize("name", ["qwen3_8b", "recurrentgemma_2b"])
def test_paged_decode_equals_dense_bitwise_on_the_card(cuda, name):
    """Reduced qwen3-8b and recurrentgemma-2b in float32 through a dense
    and a paged engine (both with chunked prefill) on the card: the same
    tokens, the occupied slots' decode logits equal bit for bit, and the
    tokens those of the same engines on the CPU."""
    model = _family(name, max_seq=24)
    params = model.init(0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, model.cfg.vocab, (s,), generator=gen)
               for s in (2, 5, 9, 13, 3)]
    card, logs = _paged_runs(model, tree_map(lambda v: v.to(cuda), params),
                             cuda, prompts)
    assert card["dense"] == card["paged"]
    assert len(logs["dense"]) == len(logs["paged"]) > 0
    for (lp, occ_p), (ld, occ) in zip(logs["paged"], logs["dense"]):
        assert occ_p == occ
        keep = torch.tensor(occ)
        assert torch.equal(lp[keep], ld[keep])
    cpu, _ = _paged_runs(model, params, "cpu", prompts)
    assert cpu == card


def test_scatter_gather_pages_roundtrip_on_the_card(cuda):
    """`scatter_pages` then `gather_pages` on the card recovers the seated
    rows bit for bit and equals the same seating on the CPU."""
    from repro_torch.serve import seating

    model = _lm(max_seq=24)
    gen = torch.Generator().manual_seed(4)
    rows = tree_map(lambda v: (torch.randint(-1, 20, v.shape, generator=gen,
                                             dtype=v.dtype)
                               if v.dtype == torch.int32
                               else torch.randn(v.shape, generator=gen)),
                    model.init_cache(2, device="cpu"))
    layouts = model.page_layouts(4)
    phys = [list(range(6)), list(range(6, 12))]
    pools = {}
    for dev in ("cpu", cuda):
        pool = model.init_cache_paged(4, 16, 4, device=dev)
        seating.scatter_pages(pool, tree_map(lambda v: v.to(dev), rows),
                              [0, 1], [1, 3], phys, layouts=layouts)
        back = seating.gather_pages(pool, [1, 3], phys, layouts=layouts)
        for a, b in zip(leaves(back), leaves(rows)):
            assert torch.equal(a.cpu(), b)
        pools[str(dev)] = pool
    for a, b in zip(leaves(pools["cpu"]), leaves(pools["cuda"])):
        assert torch.equal(a, b.cpu())


def test_frontend_lm_roundtrip_on_the_card(cuda):
    """An InProcClient sends LM requests through a Frontend whose paged
    chunked engine runs on the card (8-bit packed params, so the driver
    thread launches quant_matmul): every request completes with the
    tokens the same engine gives on the CPU."""
    import asyncio

    from repro_torch.serve import engine, frontend
    from repro_torch.serve.paging import PagingConfig

    model = _lm(max_seq=24)
    params = engine.quantize_for_serving(model.init(0, device="cpu"), 8)
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, model.cfg.vocab, (s,), generator=gen).tolist()
               for s in (3, 9, 6)]

    def replies(dev, p):
        fe = frontend.Frontend(engine=engine.Engine(
            model, p, batch_size=2, paging=PagingConfig(4, 13),
            chunk_tokens=4, device=dev), cfg=frontend.FrontendConfig())

        async def go():
            await fe.start(host=None)
            client = frontend.InProcClient(fe)
            futs = [await client.send_lm(uid=i, prompt=pr, max_new=4)
                    for i, pr in enumerate(prompts)]
            out = [await asyncio.wait_for(f, 120.0) for f in futs]
            await fe.stop()
            return [(r["status"], r.get("tokens")) for r in out]

        return asyncio.run(go())

    want = replies("cpu", params)
    tqm.launches = 0
    got = replies(cuda, tree_map(lambda v: v.to(cuda), params))
    assert tqm.launches > 0
    assert got == want and all(s == "completed" for s, _ in got)


# ---------------------------------------------------------------------------
# LM training: the train step on the card, functional and donated
# ---------------------------------------------------------------------------


def _lm_train_setup(name, cuda):
    """(model, AdamW, functional step, CPU state after 3 CPU steps,
    batch_at on the CPU) of a reduced config in float32."""
    from repro_torch.data import lm
    from repro_torch.launch.train import lm_batch_at

    model = _family(name, max_seq=16)
    opt = optim.adamw(optim.linear_warmup_cosine(3e-3, 2, 20),
                      weight_decay=0.01)
    step = trainer.make_train_step(model.loss, opt, clip_norm=1.0)
    state = trainer.init_state(model.init(0, device="cpu"), opt, device="cpu")
    stream = lm.TokenStream(batch=4, seq_len=16, vocab=model.cfg.vocab,
                            device="cpu")
    batch_at = lm_batch_at(stream, model.cfg, 4)
    for i in range(3):
        state, _ = step(state, batch_at(i))
    return model, opt, step, state, batch_at


@pytest.mark.parametrize("name", ["qwen3_8b", "recurrentgemma_2b",
                                  "olmoe_1b_7b", "whisper_tiny"])
def test_lm_train_step_on_the_card_matches_the_cpu(cuda, name):
    """From warm AdamW moments (3 CPU steps), one train step of a reduced
    LM in float32 (TF32 off) on the card and on the CPU on the same batch:
    loss, grad norm, params, m and v within 1e-4."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, _, step, state, batch_at = _lm_train_setup(name, cuda)
        batch = batch_at(3)
        new_c, m_c = step(state, batch)
        new_d, m_d = step(tree_map(lambda v: v.to(cuda), state),
                          {k: v.to(cuda) for k, v in batch.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    for key in ("loss", "grad_norm"):
        assert float(m_d[key]) == pytest.approx(float(m_c[key]), rel=1e-4)
    assert _rel_tree(new_d["params"], new_c["params"]) <= 1e-4
    for k in ("m", "v"):
        assert _rel_tree(new_d["opt"][k], new_c["opt"][k]) <= 1e-4


def test_donated_lm_step_on_the_card_keeps_its_storage(cuda):
    """A donated step on the card writes the update into the state it is
    given (every tensor keeps its data_ptr) and equals the functional step
    on the card within 1e-6 (each computes its own gradients; a scatter's
    atomic adds may sum in another order)."""
    model, opt, step, state, batch_at = _lm_train_setup("qwen3_8b", cuda)
    donated = trainer.make_train_step(model.loss, opt, clip_norm=1.0,
                                      donate=True)
    batch = {k: v.to(cuda) for k, v in batch_at(3).items()}
    on_card = tree_map(lambda v: v.to(cuda), state)
    want, _ = step(on_card, batch)
    ptrs = [x.data_ptr() for x in leaves(on_card)]
    got, _ = donated(on_card, batch)
    torch.cuda.synchronize()
    assert got is on_card
    assert [x.data_ptr() for x in leaves(got)] == ptrs
    assert int(got["step"]) == 4
    assert _rel_tree(got["params"], want["params"]) <= 1e-6
    for k in ("m", "v"):
        assert _rel_tree(got["opt"][k], want["opt"][k]) <= 1e-6


# ---------------------------------------------------------------------------
# the pod and data axes over NCCL, at world 1 on one card
# ---------------------------------------------------------------------------


def test_nccl_brings_up_the_pod_group_at_world_one(cuda):
    from repro_torch.launch import _spawn
    from repro_torch.launch.mesh import make_multipod_mesh

    with _spawn.process_group("cuda", timeout_s=120):
        assert torch.distributed.get_backend() == "nccl"
        mesh = make_multipod_mesh("1x1", "cuda")
        assert mesh.device_type == "cuda"
        assert mesh.get_local_rank("pod") == 0 and mesh.size() == 1
    assert not torch.distributed.is_initialized()


def _reductions(device):
    """quantize_leaf, compressed_psum_mean and two_stage_psum_mean at
    world 1 on `device` (NCCL on the card, gloo on the CPU), on seeded
    inputs; results on the host."""
    from repro_torch.dist import compression as C
    from repro_torch.launch import _spawn

    gen = torch.Generator().manual_seed(11)
    g = {"a": torch.randn((257, 33), generator=gen) * 3,
         "b": torch.randn(1000, generator=gen)}
    g = tree_map(lambda x: x.to(device), g)
    with _spawn.process_group(device, timeout_s=120):
        group = torch.distributed.group.WORLD
        q, s = C.quantize_leaf(g["a"])
        z = tree_map(torch.zeros_like, g)
        mean, err = C.compressed_psum_mean(g, z, group)
        two, e1, e2 = C.two_stage_psum_mean(
            g, z, tree_map(lambda x: torch.zeros(x.numel(), device=device),
                           g), group)
    return tree_map(lambda x: x.cpu(), {"q": q, "s": s, "mean": mean,
                                        "err": err, "two": two, "e1": e1,
                                        "e2": e2})


def test_compressed_reductions_on_the_card_equal_the_cpu(cuda):
    card, host = _reductions("cuda"), _reductions("cpu")
    assert torch.equal(card["q"], host["q"])  # the codes exactly
    assert torch.equal(card["s"], host["s"])
    for k in ("mean", "err", "two", "e1", "e2"):
        for a, b in zip(leaves(card[k]), leaves(host[k])):
            assert torch.equal(a, b), k


def test_sharded_fleet_runner_on_one_card_equals_unsharded(cuda):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import _spawn

    params = vadetect.init(torch.Generator().manual_seed(0), device=cuda)
    program = compiler.compile_model(params)
    x = torch.randn((64, 512), generator=torch.Generator().manual_seed(1))
    one = FleetRunner(program, path="kernel", device=cuda)
    with _spawn.process_group("cuda", timeout_s=120):
        mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("data",))
        sharded = FleetRunner(program, path="kernel", device=cuda, mesh=mesh)
        before = tk.launches
        got = sharded.classify(x)
        torch.cuda.synchronize()
        assert tk.launches == before + 7
    assert torch.equal(got, one.classify(x))
    assert sharded.n_devices == 1


def test_no_gloo_fallback_on_the_card(cuda, monkeypatch):
    from repro_torch.launch import _spawn

    monkeypatch.setattr(torch.distributed, "is_nccl_available",
                        lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        _spawn.backend("cuda")
    with pytest.raises(RuntimeError, match="NCCL"):
        with _spawn.process_group("cuda"):
            pass
    assert not torch.distributed.is_initialized()


def test_tp_halves_of_a_packed_layer_on_one_card(cuda):
    """One qwen3-reduced 8-bit layer's column- and row-parallel halves —
    the blocks a 2-way `model` split hands each rank: `w_up` by columns
    with its scale's columns, `w_down` by rows, the partial products
    summed — through the quant_matmul kernel in a world-1 NCCL group,
    against the plain version of the whole projection; then
    `launch.serve --mesh 1` at the reduced config equal to the unsharded
    run."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import _spawn
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import api
    from repro_torch.serve import engine as E

    cfg = dataclasses.replace(configs.reduced("qwen3_8b"), dtype="float32")
    model = api.build_model(cfg, tp=1, max_seq=32)
    params = E.quantize_for_serving(model.init(0, device=cuda), 8)
    ffn = params["blocks"]["pos0"]["ffn"]
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((4, cfg.d_model), generator=gen, device=cuda)
    h = torch.randn((4, cfg.d_ff), generator=gen, device=cuda)

    def half(t, dim, r):
        n = t.shape[dim] // 2
        return t.narrow(dim, r * n, n).contiguous()

    with _spawn.process_group("cuda", timeout_s=120):
        assert torch.distributed.get_backend() == "nccl"
        before = tqm.launches
        packed, scale = ffn["w_up"]["packed"][0], ffn["w_up"]["scale"][0]
        col = torch.cat([ops.quant_matmul(x, half(packed, -1, r),
                                          half(scale, -1, r), bits=8)
                         for r in range(2)], dim=-1)
        assert _rel_err(col, tqm.quant_matmul_plain(x, packed, scale,
                                                    bits=8)) <= 1e-4
        packed, scale = ffn["w_down"]["packed"][0], ffn["w_down"]["scale"][0]
        row = sum(ops.quant_matmul(half(h, -1, r), half(packed, -2, r), scale,
                                   bits=8) for r in range(2))
        assert _rel_err(row, tqm.quant_matmul_plain(h, packed, scale,
                                                    bits=8)) <= 1e-4
        torch.cuda.synchronize()
        assert tqm.launches == before + 4
        argv = ["--arch", "qwen3-8b", "--reduced", "--quant-bits", "8"]
        rec = launch_serve.main(argv + ["--mesh", "1"])
    assert rec["backend"] == "nccl"
    assert rec["param_bytes_placed"] == rec["param_bytes_per_device"]
    assert rec["tokens"] == launch_serve.main(argv)["tokens"]


def test_sharded_train_step_on_one_card_equals_the_donated_step(cuda):
    """`trainer.make_sharded_train_step` on a 1x1 ("data", "model") mesh
    in a world-1 NCCL group (the activation context, the spec tree, the
    sharded norm; every in-pod collective bypassed) against the donated
    single-card step from the same warm state on the same batch: loss,
    grad norm, params, m and v within 1e-6 (each computes its own
    gradients), and no in-pod collective handed over."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import _spawn
    from repro_torch.launch.mesh import make_smoke_mesh

    model, opt, _, state, batch_at = _lm_train_setup("qwen3_8b", cuda)
    batch = {k: v.to(cuda) for k, v in batch_at(3).items()}
    donated = trainer.make_train_step(model.loss, opt, clip_norm=1.0,
                                      donate=True)
    want, m_want = donated(tree_map(lambda v: v.to(cuda), state), batch)
    with _spawn.process_group("cuda", timeout_s=120):
        mesh = make_smoke_mesh(1, 1, "cuda")
        on_card = tree_map(lambda v: v.to(cuda), state)
        step, sh, _ = trainer.make_sharded_train_step(
            model.loss, opt, model.cfg, mesh, on_card, batch)
        shd.reset_comm()
        got, m_got = step(on_card, batch)
        torch.cuda.synchronize()
        assert shd.comm_calls == {}
    assert sh["params"]["embed"]["w"].spec == ("model", "data")
    for key in ("loss", "grad_norm"):
        assert float(m_got[key]) == pytest.approx(float(m_want[key]),
                                                  rel=1e-6)
    assert int(got["step"]) == 4
    assert _rel_tree(got["params"], want["params"]) <= 1e-6
    for k in ("m", "v"):
        assert _rel_tree(got["opt"][k], want["opt"][k]) <= 1e-6


def test_stream_load_sweep_kernel_path_equals_twin_on_the_card(cuda):
    """`launch.stream --load-sweep --path kernel` classifies every flushed
    bucket through the nm_spmm kernel; latency is modelled, so its record
    equals the twin path's and the CPU's key for key."""
    from repro_torch.launch import stream

    argv = ["--load-sweep", "--patients", "16", "--buckets", "8,32",
            "--segments-at-capacity", "128"]
    before = tk.launches
    kernel = stream.main(argv + ["--path", "kernel"])
    assert tk.launches > before
    twin = stream.main(argv + ["--path", "twin"])
    cpu = stream.main(argv + ["--path", "kernel"], device="cpu")
    assert kernel == twin == cpu
    assert kernel["overload"]["verdict"] == "graceful_degradation"


def test_run_serve_point_on_the_card(cuda):
    """One open-loop point over the reduced qwen3-8b's engine on the card:
    every request completes, with non-null tails measured from intended
    arrival, and intended >= submit for each request's TTFT."""
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.obs import loadlab
    from repro_torch.serve.engine import Engine

    cfg = configs.reduced("qwen3_8b")
    model = api.build_model(cfg, tp=1, max_seq=16)
    params = model.init(0, device=cuda)
    gen = torch.Generator().manual_seed(7)
    prompts = list(torch.randint(0, cfg.vocab, (8, 6), generator=gen))
    pt = loadlab.run_serve_point(
        lambda: Engine(model, params, batch_size=4, device=cuda), prompts,
        rate_rps=50.0, max_new=4, seed=(0, 1))
    assert pt["latency"]["count"] == pt["ttft"]["count"] == 8
    assert None not in (pt["p50_s"], pt["p99_s"], pt["p999_s"])
    assert pt["achieved_rps"] > 0
    guard = loadlab.co_guard(pt["_raw"]["ttft_intended"],
                             pt["_raw"]["ttft_submit"], saturated=False)
    assert guard["intended_ge_dequeue"]


def _audited(fn, *args):
    from repro_torch.obs import torchprobe

    info = torchprobe.CellInfo(name="t.cell", fn=fn)
    torchprobe.record_call(info, *args)
    return info


def test_cell_audit_flags_copies_between_host_and_card(cuda):
    """A cell's `x.cpu()` (the card to the host) and its
    `torch.as_tensor(numpy)` on the card (the host to the card) are
    flagged; the same arithmetic on the card alone is clean."""
    import numpy as np

    from repro_torch.analysis import cellaudit

    x = torch.ones(4, device=cuda)

    def violations(fn):
        return cellaudit.audit_cell(_audited(fn, x)).violations

    assert violations(lambda x: x * 2) == []
    v = violations(lambda x: x.cpu() + 1)
    assert any("cuda:0 -> cpu" in s for s in v), v
    v = violations(lambda x: x + torch.as_tensor(
        np.ones(4, np.float32), device=x.device))
    assert any("cpu -> cuda:0" in s or "lift_fresh" in s for s in v), v


def test_cost_gauges_count_quant_matmul_on_the_card(cuda):
    """One 8-bit packed projection: the kernel's wrapper reports its own
    launch (the dispatcher cannot see it), so the cell's flops are
    quant_matmul's 2·M·K·N."""
    from repro_torch.models import layers
    from repro_torch.obs import registry, torchprobe

    m, k, n = 4, 256, 128
    gen = torch.Generator(device=cuda).manual_seed(0)
    lin = layers.compile_linear_quant(
        {"w": torch.randn((k, n), generator=gen, device=cuda)}, 8)
    x = torch.randn((m, k), generator=gen, device=cuda)
    info = _audited(lambda x: layers.linear_apply(lin, x), x)
    assert info.call_record.kernel_launches == {tqm.NAME: 1}
    got = torchprobe.cost_gauges(registry.Registry(), "proj", info)
    assert got["flops"] == 2 * m * k * n
    assert got["bytes accessed"] >= m * k * 4 + lin["packed"].numel()


@pytest.mark.parametrize("which", ["nm_spmm", "quant_matmul",
                                   "bitserial_matmul", "sparse_conv1d"])
def test_kernel_wrappers_on_fake_cuda_tensors_never_touch_ctypes(
        cuda, monkeypatch, which):
    """A fake CUDA tensor (the dry-run's) takes the card's route without
    the launch: the output on the card's device, float32, of the kernel's
    shape; no kernel library built or loaded, no CUDA function, no plain
    version, no launch counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def refuse(*a, **k):
        raise AssertionError("touched on a fake tensor")

    for mod in (tk, tqm, tbs, tsc):
        for fn in dir(mod):
            if fn.endswith(("_plain", "_cuda")) or fn == "_library":
                monkeypatch.setattr(mod, fn, refuse)
    before = [mod.launches for mod in (tk, tqm, tbs, tsc)]
    with FakeTensorMode():
        x = torch.zeros((2, 3, 64), device=cuda)
        values = torch.zeros((32, 32), dtype=torch.int8, device=cuda)
        select = torch.zeros((32, 32), dtype=torch.uint8, device=cuda)
        packed = torch.zeros((64, 32), dtype=torch.uint8, device=cuda)
        y = {
            "nm_spmm": lambda: ops.nm_spmm(x, values, select, group_size=G,
                                           keep=KEEP),
            "quant_matmul": lambda: ops.quant_matmul(x, packed, bits=8),
            "bitserial_matmul": lambda: ops.bitserial_matmul(x, packed,
                                                             bits=8),
            "sparse_conv1d": lambda: ops.sparse_conv1d(
                torch.zeros((2, 10, 8), device=cuda), values, select,
                ksize=3, group_size=G, keep=KEEP),
        }[which]()
    assert y.device.type == "cuda" and y.dtype == torch.float32
    assert y.shape[-1] == 32
    assert [mod.launches for mod in (tk, tqm, tbs, tsc)] == before


def test_dryrun_counts_on_fake_cuda_equal_fake_cpu(cuda, tmp_path):
    """The dry-run of the reduced qwen3-8b's 8-bit decode cell on a fake
    2x2 gives the same flops, bytes, kernel launches, collectives and
    argument bytes on fake CUDA tensors as on fake CPU ones."""
    from repro_torch.launch import dryrun

    def one(device):
        return dryrun.run_cell(
            "qwen3-8b", "decode_32k", False, str(tmp_path / device),
            serve_quant_bits=8, reduced=True, batch=8, seq=64,
            mesh_shape=(2, 2), device=device)

    try:
        recs = {d: one(d) for d in ("cpu", "cuda")}
    finally:
        dryrun.close_fake_world()
    for key in ("cost", "collectives"):
        assert recs["cuda"][key] == recs["cpu"][key], key
    assert (recs["cuda"]["memory"]["argument_bytes"]
            == recs["cpu"]["memory"]["argument_bytes"])
    assert recs["cuda"]["cost"]["kernel_launches"] == {"quant_matmul": 14}
