"""The port's sharding rules against the reference's (CPU, no processes).

``logical_to_spec`` is pure Python in both packages and needs only a
mesh's ``axis_names`` and ``shape``, so a stand-in object serves for the
reference's ``Mesh`` and no device or process group is involved.  Held
equal, entry for entry: every leaf of every config's ``param_logical()``
(and its cache's and batch's logical axes) on the production meshes
(16, 16) and (2, 16, 16) and on (2, 4) and (1, 3); the roles; the
divisibility fallback.
"""
from types import SimpleNamespace

import pytest

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as ref_config
from repro.distributed import sharding as ref_shd
from repro.models import api as ref_api
from repro.models import build as ref_build
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.models import api
from repro_torch.models import build
from repro_torch.models.layers import tree_leaves

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x3": ((1, 3), ("data", "model"))}


def stand_in(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def _ref_leaves(tree):
    import jax
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple))


def _ref_spec(logical, shape, mesh):
    return tuple(ref_shd.logical_to_spec(logical, shape, mesh))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh):
    m = stand_in(mesh)
    ref = ref_build(ref_config(arch))
    port = build(get_config(arch))
    ref_lg = _ref_leaves(ref.param_logical())
    ref_shapes = [s.shape for s in _ref_leaves(ref.param_structs())]
    lg = tree_leaves(port.param_logical())
    shapes = [tuple(t.shape) for t in tree_leaves(port.param_structs())]
    assert lg == ref_lg and shapes == [tuple(s) for s in ref_shapes]
    for logical, shape in zip(lg, shapes):
        assert shd.logical_to_spec(logical, shape, m) == _ref_spec(
            logical, shape, m), (logical, shape)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_reference(arch, mesh):
    m = stand_in(mesh)
    cfg, ref_cfg = get_config(arch), ref_config(arch)
    port, ref = build(cfg), ref_build(ref_cfg)
    for name, shape in SHAPES.items():
        if shape.kind == "decode":
            structs = port.cache_structs(shape.global_batch, shape.seq_len)
            for n, lg in port.cache_logical().items():
                assert lg == tuple(ref.cache_logical()[n])
                dims = tuple(structs[n].shape)
                assert shd.logical_to_spec(lg, dims, m) == _ref_spec(
                    lg, dims, m), (name, n)
        specs = api.input_specs(cfg, shape)
        logical = api.batch_logical(cfg, shape)
        assert logical == ref_api.batch_logical(ref_cfg, shape)
        for k, t in specs.items():
            dims = tuple(t.shape)
            assert shd.logical_to_spec(logical[k], dims, m) == _ref_spec(
                logical[k], dims, m), (name, k)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_roles_equal_reference(mesh):
    m = stand_in(mesh)
    assert shd.mesh_roles(m) == ref_shd.mesh_roles(m)


# (logical, shape, mesh) where a role's axes do not divide the dim: the
# suffix that divides is kept, else the dim is replicated; an axis is never
# used twice; trailing Nones are dropped
FALLBACKS = [
    (("batch", None), (1, 4096), "2x16x16"),        # long_500k decode
    (("batch", None), (16, 4096), "2x16x16"),       # pod dropped, data kept
    (("batch", None), (34, 8), "2x16x16"),          # pod kept alone: no
    (("layers", "embed", "heads"), (4, 4096, 40 * 128), "16x16"),
    (("vocab", "embed"), (151936, 5120), "16x16"),  # vocab 151936 % 16 == 0
    (("layers", "batch", "seq_kv", "kv_heads", None),
     (32, 1, 524288, 8, 128), "16x16"),              # seq over model first
    (("expert", "embed", "expert_ff"), (40, 1536, 512), "16x16"),
    (("moe_cap", None), (192, 64), "2x16x16"),
    (("heads", "kv_heads"), (48, 16), "1x3"),        # model taken once
    ((None, "ssm_state"), (8, 16), "2x4"),
]


@pytest.mark.parametrize("logical,shape,mesh", FALLBACKS)
def test_fallback_equals_reference(logical, shape, mesh):
    m = stand_in(mesh)
    assert shd.logical_to_spec(logical, shape, m) == _ref_spec(
        logical, shape, m)


def test_rules_equal_reference():
    assert shd.LOGICAL_RULES == ref_shd.LOGICAL_RULES
