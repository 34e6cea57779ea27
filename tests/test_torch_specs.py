"""The dry run's shapes and inputs against the reference's: every
(arch, input shape) is supported or skipped for the reference's reason,
and ``launch/specs.py``'s meta-tensor specs have the reference's
``ShapeDtypeStruct`` shapes and logical axes (tokens in the port's
int64), the decode caches leaf for leaf at full size."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import shape_supported as j_supported
from repro.launch import specs as jspecs
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs, shape_supported
from repro_torch.launch.specs import input_axes, input_specs, step_kind
from repro_torch.serve.slab import _map_trees

CASES = [(a, s) for a in list_archs() for s in INPUT_SHAPES]
#: the cases with inputs: the reference's supported ones
SUPPORTED = [(a, s) for a, s in CASES if j_supported(jax_get_config(a), J_SHAPES[s])[0]]


def test_input_shapes_are_the_references():
    assert list(INPUT_SHAPES) == list(J_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        j = J_SHAPES[name]
        assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)
        assert step_kind(shape) == jspecs.step_kind(j)


@pytest.mark.parametrize("arch,shape", CASES)
def test_support_and_reason_equal_the_references(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.sub_quadratic() == jcfg.sub_quadratic()
    assert shape_supported(cfg, INPUT_SHAPES[shape]) == j_supported(jcfg, J_SHAPES[shape])


def _axes(a):
    return None if a is None else tuple(a)


def _port_caches_as_reference(cfg, caches):
    """The port's cache tree mapped as ``caches_from_numpy`` maps the
    reference's: per-segment dicts (a pattern: a list of them)."""
    return _map_trees(caches, lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")))


@pytest.mark.parametrize("arch,shape", SUPPORTED)
def test_specs_and_axes_equal_the_references(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for coded in ((False, True) if INPUT_SHAPES[shape].kind == "train" else (False,)):
        kw = dict(coded=True, n_workers=16, s_max=3) if coded else {}
        specs, axes = input_specs(cfg, INPUT_SHAPES[shape], **kw)
        jsp, jax_axes = jspecs.input_specs(jcfg, J_SHAPES[shape], **kw)
        assert set(specs) == set(jsp) and set(axes) == set(jax_axes)
        assert input_axes(cfg, INPUT_SHAPES[shape], **kw) == axes
        for key, spec in specs.items():
            want = jsp[key]
            if key == "caches":
                got = _port_caches_as_reference(cfg, spec)
                ref = _map_trees([*want], lambda t: (tuple(t.shape), str(t.dtype)))
                assert got == ref
                ref_axes = _map_trees([*jax_axes[key]], _axes)
                assert _map_trees(axes[key], _axes) == ref_axes
                continue
            assert axes[key] == _axes(jax_axes[key]), key
            if want is None:  # coded dec_w: filled by the caller
                assert spec is None
                continue
            assert spec.device.type == "meta" and tuple(spec.shape) == tuple(want.shape)
            want_dtype = np.dtype(want.dtype)
            if want_dtype == np.int32:  # tokens
                assert spec.dtype == torch.int64
            else:
                assert spec.dtype == getattr(torch, want_dtype.name)
