"""The PyTorch port's CUDA kernels on the card, against their plain
versions, nm_spmm through the service path and the streaming fleet, and
the training step on the card against the same step on the CPU.

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
