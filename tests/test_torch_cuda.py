"""The PyTorch port's CUDA kernels on the card, against their plain
versions, nm_spmm through the service path, and the training step on the
card against the same step on the CPU.

Needs a CUDA card, so every test here is marked `cuda` and skips on a
host without one. The file imports no jax (the card's machine has none);
run it there with the repository's conftest left out:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: 1e-4 relative to max|y| for the kernel against its plain
version (float32, summed in another order — tests/test_kernels.py's
float32 tolerance), 1e-3 on logits across compute paths
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
    kernel equals execute's im2col -> pad -> nm_spmm on the card."""
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
    assert _rel_err(y, y_mm) <= 1e-4


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
