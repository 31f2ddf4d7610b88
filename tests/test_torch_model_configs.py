"""The port's ten model configs and the model API's structure against the
reference's (``repro.configs``, ``repro.models.api``): every field, the
smoke configs, the derived properties, the shape cells, the registry,
``iter_cells``, and each model's parameter, cache and input shapes with
their logical axes.  Plain data, no model is run."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import api as rapi
from repro_torch.configs import base as pbase
from repro_torch.models import api as papi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = rbase.ARCH_IDS
DERIVED = ("padded_vocab", "d_inner", "ssm_nheads", "attn_layers",
           "is_subquadratic")


def _pair(arch, smoke=False):
    r, p = rbase.get_config(arch), pbase.get_config(arch)
    return (r.smoke(), p.smoke()) if smoke else (r, p)


def test_arch_ids_registry_and_families():
    assert pbase.ARCH_IDS == rbase.ARCH_IDS
    assert pbase.FAMILIES == rbase.FAMILIES
    assert pbase.list_configs() == rbase.list_configs()
    assert [f.name for f in dataclasses.fields(pbase.ModelConfig)] == \
        [f.name for f in dataclasses.fields(rbase.ModelConfig)]
    with pytest.raises(KeyError):
        pbase.get_config("no-such-arch")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_the_reference(arch, smoke):
    r, p = _pair(arch, smoke)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_derived_properties_equal_the_reference(arch, smoke):
    r, p = _pair(arch, smoke)
    for name in DERIVED:
        assert getattr(p, name) == getattr(r, name), name


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_dtype_stands_for_the_jax_dtype(arch, smoke):
    r, p = _pair(arch, smoke)
    assert str(p.torch_dtype) == f"torch.{r.jnp_dtype.name}"
    assert str(pbase.torch_dtype(p.cache_dtype)) == \
        f"torch.{jnp.dtype(r.cache_dtype).name}"


def test_fp8_cache_type_and_unknown_names():
    assert pbase.torch_dtype(pbase.get_config("qwen1.5-32b").cache_dtype) \
        == torch.float8_e4m3fn
    with pytest.raises(ValueError, match="no torch type"):
        pbase.torch_dtype("int4")


def test_scaled_equals_the_reference():
    r = rbase.get_config("jamba-v0.1-52b").scaled(num_layers=8, d_model=128)
    p = pbase.get_config("jamba-v0.1-52b").scaled(num_layers=8, d_model=128)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert all(getattr(p, n) == getattr(r, n) for n in DERIVED)


def test_shapes_and_cells_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in pbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rbase.SHAPES.items()}
    cells = lambda mod: [(c.name, s.name, ok, why)
                         for c, s, ok, why in mod.iter_cells()]
    assert cells(pbase) == cells(rbase)
    assert len(cells(pbase)) == 40


def test_configs_package_does_not_import_the_engine():
    """``repro_torch.configs`` gives the model configs without importing
    the vector-engine grids (and so the engine)."""
    code = ("import sys, repro_torch.configs as c; c.get_config('llama3-8b');"
            "bad = [m for m in sys.modules if m.startswith("
            "('repro_torch.configs.vector_engine', 'repro_torch.core'))];"
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def _shapes(tree):
    return jax.tree.map(lambda x: tuple(x.shape), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_structs_and_logical_equal_the_reference(arch):
    """The parameter tree's names, shapes, types and logical axes."""
    r, p = _pair(arch)
    rm, pm = rapi.build(r), papi.build(p)
    rs, ps = rm.param_structs(), pm.param_structs()
    assert jax.tree.map(lambda x: (tuple(x.shape), x.dtype.name), rs) == \
        jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)[6:]), ps)
    assert all(t.device.type == "meta" for t in jax.tree.leaves(ps))
    is_axes = lambda x: isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)
    assert jax.tree.map(tuple, rm.param_logical(), is_leaf=is_axes) == \
        jax.tree.map(tuple, pm.param_logical(), is_leaf=is_axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_structs_and_logical_equal_the_reference(arch):
    r, p = _pair(arch)
    rm, pm = rapi.build(r), papi.build(p)
    rc, pc = rm.cache_structs(4, 128), pm.cache_structs(4, 128)
    assert jax.tree.map(lambda x: (tuple(x.shape), x.dtype.name), rc) == \
        jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)[6:]), pc)
    assert pm.cache_logical() == rm.cache_logical()


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    r, p = _pair(arch)
    for shape in rbase.SHAPES:
        rs = rapi.input_specs(r, rbase.SHAPES[shape])
        ps = papi.input_specs(p, pbase.SHAPES[shape])
        assert {k: (tuple(v.shape), v.dtype.name) for k, v in rs.items()} \
            == {k: (tuple(v.shape), str(v.dtype)[6:])
                for k, v in ps.items()}, shape
        assert all(v.device.type == "meta" for v in ps.values())
        assert papi.batch_logical(p, pbase.SHAPES[shape]) == \
            rapi.batch_logical(r, rbase.SHAPES[shape])


def test_init_honours_scale_and_fan_in():
    """``init_params`` draws normal leaves with the stacked leaf's
    ``shape[-2] ** -0.5`` (or its ``scale``), zeros and ones as declared."""
    from repro_torch.models import layers as L
    defs = {"w": L.PD((64, 256, 32), ("layers", "a", "b")),
            "e": L.PD((512, 16), ("v", "d"), scale=1.0),
            "z": L.PD((8,), ("d",), "zeros"), "o": L.PD((8,), ("d",), "ones")}
    p = L.init_params(defs, torch.Generator().manual_seed(0), torch.float32)
    assert abs(float(p["w"].std()) - 256 ** -0.5) < 0.002
    assert abs(float(p["e"].std()) - 1.0) < 0.02
    assert torch.equal(p["z"], torch.zeros(8))
    assert torch.equal(p["o"], torch.ones(8))
    again = L.init_params(defs, torch.Generator().manual_seed(0),
                          torch.float32)
    assert all(torch.equal(p[k], again[k]) for k in p)
    assert np.isclose(float(p["w"].mean()), 0.0, atol=1e-3)
