"""The SPE serving tree of an LM, for the tests and `chip_smoke.py`: the
dense params with each linear that `serve.engine.quantize_for_serving`
packs compiled instead to the paper's 16:8 sparse-quantized format."""

import torch

from repro_torch.models import layers
from repro_torch.serve import engine


def sparse_for_serving(params, bits: int):
    """Dense master params -> the SPE serving format: each linear that
    `serve.engine.quantize_for_serving` packs compiled instead by
    `layers.compile_linear_sparse_quant` (16:8, `bits`), a stacked (G, K,
    N) weight a group at a time (its values, selects and scales stacked,
    its `meta` shared), each master dropped once compiled. The
    reference has no such walker, so the port has none either: this one
    serves the tests and `chip_smoke.py`."""

    def one(node):
        w = node.pop("w")
        if w.ndim == 2:
            return layers.compile_linear_sparse_quant({"w": w, **node}, bits)
        parts = []
        for g in range(w.shape[0]):
            parts.append(layers.compile_linear_sparse_quant({"w": w[g]}, bits))
        del w
        out = {k: torch.stack([q[k] for q in parts])
               for k in ("values_q", "select", "scale")}
        out["meta"] = parts[0]["meta"]
        out.update(node)  # a bias
        return out

    def visit(tree, name=""):
        if isinstance(tree, dict):
            if ("w" in tree and name in engine._QUANT_TARGETS
                    and tree["w"].ndim in (2, 3)):
                return one(tree)
            return {k: visit(v, k) for k, v in tree.items()}
        return tree

    return visit(params)
