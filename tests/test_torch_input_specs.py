"""`models.api.input_specs` against the reference's: for every config in
`configs/` (full and reduced) and every shape cell that applies to it,
the same structure, shapes and dtypes — "meta" tensors in place of
`ShapeDtypeStruct`s, nothing allocated."""

import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch.models import api as tapi


def _tree(x):
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v) for v in x]
    return (tuple(x.shape), str(x.dtype).removeprefix("torch."))


def _meta_only(x) -> bool:
    if isinstance(x, dict):
        return all(_meta_only(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_meta_only(v) for v in x)
    return isinstance(x, torch.Tensor) and x.device.type == "meta"


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", jconfigs.ALL_ARCHS)
def test_input_specs_equal_the_references(name, reduced):
    jcfg = jconfigs.reduced(name) if reduced else jconfigs.get(name)
    tcfg = tconfigs.reduced(name) if reduced else tconfigs.get(name)
    cells = jconfigs.applicable_shapes(jcfg)
    assert [c.name for c in tconfigs.applicable_shapes(tcfg)] == [
        c.name for c in cells]
    for cell in cells:
        got = tapi.input_specs(tcfg, tconfigs.SHAPES[cell.name])
        assert _tree(got) == _tree(japi.input_specs(jcfg, cell)), cell.name
        assert _meta_only(got)
