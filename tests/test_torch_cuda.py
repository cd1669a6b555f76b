"""The PyTorch port's CUDA kernels on the card, against their plain
versions and through the service path.

Needs a CUDA card, so every test here is marked `cuda` and skips on a
host without one. The file imports no jax (the card's machine has none);
run it there with the repository's conftest left out:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: 1e-4 relative to max|y| for the kernel against its plain
version (float32, summed in another order — tests/test_kernels.py's
float32 tolerance), 1e-3 on logits across compute paths
(tests/test_vadetect.py).
"""

import pytest
import torch

from repro_torch.configs import va_cnn
from repro_torch.core import compiler, spe, vadetect
from repro_torch.data import iegm
from repro_torch.kernels import nm_spmm as tk
from repro_torch.kernels import ops
from repro_torch.serve.va_service import VAService

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
