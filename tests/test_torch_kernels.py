"""Kernel layer of the PyTorch port against the JAX reference.

``repro_torch.kernels.ops.encode_decode`` (on the CPU: the plain version
``ref.encode_decode_ref``) against both JAX forms of the fused combine —
the jnp oracle ``repro.kernels.ref.encode_decode_ref`` and the Pallas
kernel ``encode_decode_pallas`` in interpret mode — over ragged widths,
fp32/bf16 and NB in {1, 3}; ``ops.encode`` and ``ops.decode`` likewise
against ``_encode_math``/``encode_pallas`` and ``_decode_math``/
``decode_pallas``, and the kernel-level coded round trip.  Inputs are drawn with numpy and rounded to
the working dtype once, so both packages see the same values; the
coefficients a and B go in as fp32, as on the training path.  The CUDA
kernel itself is checked on the card (tests/test_torch_cuda.py, chip_smoke.py).

Fold order (ROADMAP 3.2): the port and the jnp oracle round the folded
weight w = a ⊙ B to G's dtype once; the TPU kernel folds in G's dtype
and its bf16 product is not rounded the same way, so against the Pallas
form a bf16 comparison also allows one bf16 rounding of every term,
2^-8 · (|w| @ |G|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decode_weights as jax_decode_weights
from repro.core import make_code as jax_make_code
from repro.kernels import ref as jref
from repro.kernels.gc_decode import decode_pallas
from repro.kernels.gc_encode import encode_pallas
from repro.kernels.gc_fused import encode_decode_pallas
from repro_torch.core.coding import decode_weights, make_code
from repro_torch.kernels import _build, gc_decode, gc_encode, gc_fused, ops, ref

RAGGED_D = [1, 127, 129, 512, 513, 1021]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    # the reference's kernel-parity tolerances (tests/test_kernel_parity.py):
    # fp32 differs only by summation order over K; bf16 by one rounding of
    # the output (8-bit mantissa)
    return dict(rtol=2e-2, atol=1e-4) if name == "bfloat16" else \
        dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, nb, k, d, name):
    """(numpy fp32 values already rounded to the dtype) a, b, g."""
    jdt, _ = DTYPES[name]
    rng = np.random.default_rng(seed)
    raw = (rng.standard_normal(nb), rng.standard_normal((nb, k)),
           rng.standard_normal((k, d)))
    return [np.array(jnp.asarray(x, jdt).astype(jnp.float32)) for x in raw]


def _fold_slack(a, b, g, name):
    """Bound on the output change from rounding each folded weight to bf16
    once (half an ulp is 2^-9 of the value; 2^-8 leaves a factor 2)."""
    if name != "bfloat16":
        return 0.0
    return 2.0 ** -8 * (np.abs(a[:, None] * b) @ np.abs(g))


def _port(a, b, g, name):
    _, tdt = DTYPES[name]
    return ops.encode_decode(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(g).to(tdt))


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("d", RAGGED_D)
def test_encode_decode_matches_jax_oracle_and_pallas(d, name, nb):
    jdt, tdt = DTYPES[name]
    a, b, g = _inputs(1000 * nb + d, nb, 5, d, name)
    got = _port(a, b, g, name)
    assert got.dtype == tdt and tuple(got.shape) == (nb, d)
    got = got.float().numpy()
    ja, jb, jg = jnp.asarray(a), jnp.asarray(b), jnp.asarray(g, jdt)
    want_ref = np.asarray(jref.encode_decode_ref(ja, jb, jg), np.float32)
    np.testing.assert_allclose(got, want_ref, err_msg=f"d={d}", **_tol(name))
    want_pallas = np.asarray(encode_decode_pallas(ja, jb, jg, tile_d=128,
                                                  interpret=True), np.float32)
    tol = _tol(name)
    bound = tol["atol"] + tol["rtol"] * np.abs(want_pallas) + _fold_slack(a, b, g, name)
    assert np.all(np.abs(got - want_pallas) <= bound), f"d={d}"


def _rounded(rng, shape, name):
    """numpy fp32 values already rounded to the dtype (both packages see
    the same values)."""
    return np.array(jnp.asarray(rng.standard_normal(shape), DTYPES[name][0])
                    .astype(jnp.float32))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("d", RAGGED_D)
def test_encode_matches_jax_oracle_and_pallas(d, name):
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(d)
    b, g = _rounded(rng, (3, 5), name), _rounded(rng, (5, d), name)
    got = ops.encode(torch.from_numpy(b), torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (3, d)
    got = got.float().numpy()
    jb, jg = jnp.asarray(b, jdt), jnp.asarray(g, jdt)
    for want in (jref._encode_math(jb, jg),
                 encode_pallas(jb, jg, tile_d=128, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), err_msg=f"d={d}",
                                   **_tol(name))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("d", RAGGED_D)
def test_decode_matches_jax_oracle_and_pallas(d, name):
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(1000 + d)
    a, c = _rounded(rng, (6,), name), _rounded(rng, (6, d), name)
    got = ops.decode(torch.from_numpy(a), torch.from_numpy(c).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (d,)
    got = got.float().numpy()
    ja, jc = jnp.asarray(a, jdt), jnp.asarray(c, jdt)
    for want in (jref._decode_math(ja, jc),
                 decode_pallas(ja, jc, tile_d=128, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), err_msg=f"d={d}",
                                   **_tol(name))


def test_encode_is_exact_on_integer_digits_at_the_2_24_bound():
    """The coded checkpoint's contract (ROADMAP 3.3): integer digits whose
    parity sums reach 2^24 - 1 come out exact, as the int64 product."""
    rng = np.random.default_rng(3)
    p = np.array([[1.0, 1.0, 1.0, 1.0], [1.0, 2.0, 3.0, 4.0]], np.float32)
    digits = rng.integers(0, 2 ** 16, (4, 4099)).astype(np.float32)
    digits[:, 0] = 2 ** 16 - 1
    digits[:, 1] = [0, 0, 0, (2 ** 24 - 1) // 4]  # 2nd row: 4 * that = 2^24 - 4
    want = p.astype(np.int64) @ digits.astype(np.int64)
    assert want.max() < 2 ** 24 and want.max() > 2 ** 24 - 2 ** 16
    got = ops.encode(torch.from_numpy(p), torch.from_numpy(digits)).numpy()
    assert np.array_equal(got.astype(np.int64), want)


@pytest.mark.parametrize("d", [128 + 129, 512 + 129])  # the reference's tile_d + 129
def test_decode_of_encode_round_trip(d):
    """The reference's kernel-level round trip: encode with a cyclic code,
    strike s stragglers, decode — recovers sum_j g_j (fp32, 1e-4); the
    port's code and decode weights equal the reference's."""
    n, s = 6, 2
    rng = np.random.default_rng(d)
    b_mat = make_code(n, s, rng=3, prefer_fractional=False)
    np.testing.assert_array_equal(b_mat, jax_make_code(n, s, rng=3, prefer_fractional=False))
    g = rng.standard_normal((n, d))
    coded = ops.encode(torch.tensor(b_mat, dtype=torch.float32),
                       torch.tensor(g, dtype=torch.float32))
    fastest = np.setdiff1d(np.arange(n), rng.choice(n, size=s, replace=False))
    a = decode_weights(b_mat, fastest)
    np.testing.assert_array_equal(a, jax_decode_weights(b_mat, fastest))
    y = ops.decode(torch.tensor(a, dtype=torch.float32), coded)
    np.testing.assert_allclose(y.numpy(), g.sum(axis=0), rtol=1e-4, atol=1e-4)
    j_coded = encode_pallas(jnp.asarray(b_mat, jnp.float32), jnp.asarray(g, jnp.float32),
                            tile_d=128, interpret=True)
    j_y = decode_pallas(jnp.asarray(a, jnp.float32), j_coded, tile_d=128, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_y), rtol=1e-5, atol=1e-5)


def test_fused_equals_encode_then_scale():
    """The fold is exact up to fp reassociation: (a ⊙ B) @ G vs
    a[:, None] * (B @ G)."""
    a, b, g = _inputs(5, 2, 4, 700, "float32")
    fused = ref.encode_decode_ref(torch.from_numpy(a), torch.from_numpy(b),
                                  torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(fused, a[:, None] * (b @ g), rtol=1e-5, atol=1e-5)


def test_ops_takes_the_plain_version_on_cpu_without_launching():
    a, b, g = (torch.from_numpy(x) for x in _inputs(7, 1, 16, 300, "float32"))
    before = (gc_fused.launches, gc_encode.launches, gc_decode.launches)
    out = ops.encode_decode(a, b, g)
    assert torch.equal(out, ref.encode_decode_ref(a, b, g))
    assert torch.equal(ops.encode(b, g), ref.encode_ref(b, g))
    assert torch.equal(ops.decode(b[0], g), ref.decode_ref(b[0], g))
    assert (gc_fused.launches, gc_encode.launches, gc_decode.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        ops.encode(b.to("meta"), g.to("meta"))


def test_kernel_wrapper_refuses_non_cuda_tensors():
    a, b, g = (torch.from_numpy(x) for x in _inputs(8, 1, 4, 16, "float32"))
    meta = [t.to("meta") for t in (a, b, g)]
    for args in ((a, b, g), meta):
        with pytest.raises(ValueError, match="CUDA"):
            gc_fused.encode_decode(*args)
        with pytest.raises(ValueError, match="CUDA"):
            gc_encode.encode(*args[1:])
        with pytest.raises(ValueError, match="CUDA"):
            gc_decode.decode(args[1][0], args[2])
    with pytest.raises(ValueError, match="shapes"):
        gc_encode.encode(b, g.t())
    with pytest.raises(ValueError, match="shapes"):
        gc_decode.decode(b, g)


def test_build_without_toolkit_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="CUDA toolkit"):
        _build._nvcc()


def test_build_target_names_hash_the_source(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build._target(src)
    src.write_text("// two\n")
    assert _build._target(src) != first
    assert first.parent == _build.BUILD_DIR and first.name.startswith("k-")
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == ["gc_decode", "gc_encode",
                                                                 "gc_fused"]


def test_build_target_names_hash_the_shared_header(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    header = tmp_path / "shared.cuh"
    header.write_text("// a\n")
    first = _build._target(src)
    header.write_text("// b\n")
    assert _build._target(src) != first

