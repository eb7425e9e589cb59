"""Parity of the port's input specs (`repro_torch.models.registry.sds`,
`supports_shape`, `input_specs`) with the reference's, for every arch of
`ARCHS` x every shape of `SHAPES`.

The port's specs are meta tensors; the reference's are ShapeDtypeStructs.
The port's decode cache is per layer where the reference's is stacked: each
port leaf must have the reference leaf's shape without the stacked dims
(the dims its layer indices select), and every stacked slot must have its
port leaf.
"""
import math
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.models import registry as ref_registry
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import sharding as sh
from repro_torch.models import registry


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _ref_dtype(leaf) -> str:
    return np.dtype(leaf.dtype).name


def test_arch_and_shape_lists_match_the_reference():
    assert list(ARCHS) == list(REF_ARCHS) and len(ARCHS) == 10
    assert list(SHAPES) == list(REF_SHAPES) and len(SHAPES) == 4


def test_sds_is_a_meta_tensor():
    t = registry.sds((3, 5), torch.bfloat16)
    assert t.device.type == "meta" and t.shape == (3, 5)
    assert t.dtype == torch.bfloat16
    assert registry.sds((), torch.int32).shape == ()


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_input_specs_equal_the_reference(arch, shape_name):
    """The SKIP flag and its reason word for word; where supported, every
    input's shape and dtype (the decode cache per layer)."""
    cfg, rcfg = ARCHS[arch], REF_ARCHS[arch]
    got = registry.supports_shape(cfg, SHAPES[shape_name])
    assert got == ref_registry.supports_shape(rcfg, REF_SHAPES[shape_name])
    if not got[0]:
        assert shape_name == "long_500k" and not cfg.long_context_ok
        return
    port = registry.input_specs(cfg, shape_name)
    ref = ref_registry.input_specs(rcfg, REF_SHAPES[shape_name])
    assert list(port) == list(ref)
    # the ShapeConfig and its name give the same specs
    by_config = registry.input_specs(cfg, SHAPES[shape_name])
    assert list(by_config) == list(port)
    for key, want in ref.items():
        if key == "cache":
            continue
        t = port[key]
        assert t.device.type == "meta", key
        assert (tuple(t.shape), _dtype(t)) == \
            (tuple(want.shape), _ref_dtype(want)), key
        assert tuple(by_config[key].shape) == tuple(t.shape)
    if "cache" not in ref:
        return
    ref_leaves = {jax.tree_util.keystr(kp): leaf for kp, leaf in
                  jax.tree_util.tree_flatten_with_path(ref["cache"])[0]}
    port_leaves = sh._flatten(port["cache"])
    count, stacked_dims = dict.fromkeys(ref_leaves, 0), {}
    for path, t in port_leaves:
        ref_path = re.sub(r"\[\d+\]", "", path)
        stacked = len(re.findall(r"\[\d+\]", path))
        want = ref_leaves[ref_path]
        assert t.device.type == "meta", path
        assert (tuple(t.shape), _dtype(t)) == \
            (tuple(want.shape[stacked:]), _ref_dtype(want)), path
        count[ref_path] += 1
        stacked_dims[ref_path] = stacked
    # one port leaf for every stacked slot of every reference leaf
    assert count == {p: math.prod(leaf.shape[:stacked_dims.get(p, 0)])
                     for p, leaf in ref_leaves.items()}
    assert set(stacked_dims) == set(ref_leaves)
