"""Kernel layer of the PyTorch port against the JAX reference.

``repro_torch.kernels.ops.encode_decode`` (on the CPU: the plain version
``ref.encode_decode_ref``) against both JAX forms of the fused combine —
the jnp oracle ``repro.kernels.ref.encode_decode_ref`` and the Pallas
kernel ``encode_decode_pallas`` in interpret mode — over ragged widths,
fp32/bf16 and NB in {1, 3}; ``ops.encode`` and ``ops.decode`` likewise
against ``_encode_math``/``encode_pallas`` and ``_decode_math``/
``decode_pallas``, and the kernel-level coded round trip.  The grouped
combine ``ops.encode_decode_leaves`` (many leaves, one weight set each)
is held to the per-leaf forms, and the pure-Python launch planner of the
grouped CUDA kernel (``kernels/_pipe.py``) to its contract.  Inputs are
drawn with numpy and rounded to
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
from repro_torch.kernels import _build, _pipe, gc_decode, gc_encode, gc_fused, ops, ref

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


GROUPED_D = [1, 127, 129, 513, 1021, 1024]


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("name", list(DTYPES))
def test_grouped_combine_matches_per_leaf_and_pallas(name, nb):
    """``ops.encode_decode_leaves`` on the CPU over a mixed list of leaves
    with two weight sets: bit-equal to ``ref.encode_decode_ref`` leaf by
    leaf, and within the file's tolerances of the Pallas kernel."""
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(40 + nb)
    a = _rounded(rng, (nb,), "float32")
    b_codes = _rounded(rng, (2, nb, 5), "float32")
    which = [j % 2 for j in range(len(GROUPED_D))]
    gs = [_rounded(rng, (5, d), name) for d in GROUPED_D]
    got = ops.encode_decode_leaves(torch.from_numpy(a), torch.from_numpy(b_codes), which,
                                   [torch.from_numpy(g).to(tdt) for g in gs])
    assert len(got) == len(gs)
    for y, g, i, d in zip(got, gs, which, GROUPED_D):
        assert y.dtype == tdt and tuple(y.shape) == (nb, d)
        want = ref.encode_decode_ref(torch.from_numpy(a), torch.from_numpy(b_codes[i]),
                                     torch.from_numpy(g).to(tdt))
        assert torch.equal(y, want), f"d={d}"
        want_pallas = np.asarray(encode_decode_pallas(
            jnp.asarray(a), jnp.asarray(b_codes[i]), jnp.asarray(g, jdt), tile_d=128,
            interpret=True), np.float32)
        tol = _tol(name)
        bound = tol["atol"] + tol["rtol"] * np.abs(want_pallas) + \
            _fold_slack(a, b_codes[i], g, name)
        assert np.all(np.abs(y.float().numpy() - want_pallas) <= bound), f"d={d}"


def _columns_of(launch, widths, tile_cols):
    """{leaf: list of (first column, columns)} that gc_pipe.cuh's tile
    walk gives each leaf of one launch: tiles in order, a leaf cursor that
    moves past every leaf whose tiles start at or before the tile."""
    seen, slot = {}, 0
    for t in range(launch.n_tiles):
        while slot + 1 < len(launch.leaves) and t >= launch.tile0[slot + 1]:
            slot += 1
        leaf = launch.leaves[slot]
        c0 = (t - launch.tile0[slot]) * tile_cols
        seen.setdefault(leaf, []).append((c0, min(tile_cols, widths[leaf] - c0)))
    return seen


#: an H100's opt-in shared memory of one block, bytes (227 KB)
H100_SMEM = 232_448


@pytest.mark.parametrize("n_leaves,itemsize,k", [(1, 4, 16), (11, 4, 16), (32, 2, 4),
                                                 (33, 4, 6), (70, 2, 16), (65, 4, 40),
                                                 (11, 4, 100), (40, 2, 400)])
def test_launch_planner_covers_every_column_once(n_leaves, itemsize, k):
    """Every column of every leaf lies in exactly one tile of one launch,
    and a list of n leaves takes ceil(n / MAX_LEAVES) launches."""
    rng = np.random.default_rng(n_leaves)
    widths = [int(w) for w in rng.integers(1, 40_000, n_leaves)]
    widths[0] = 28_311_552 if n_leaves == 11 else widths[0]
    tile_cols, stages = _pipe.tile_shape(k, itemsize, 4 * k, H100_SMEM)
    launches = _pipe.plan_launches(widths, tile_cols)
    assert len(launches) == -(-n_leaves // _pipe.MAX_LEAVES)
    assert [j for ln in launches for j in ln.leaves] == list(range(n_leaves))
    for ln in launches:
        assert len(ln.leaves) <= _pipe.MAX_LEAVES and ln.tile0[0] == 0
        cols = _columns_of(ln, widths, tile_cols)
        for j in ln.leaves:
            spans = sorted(cols[j])
            assert spans[0][0] == 0 and all(c > 0 for _, c in spans)
            assert all(s0 + c == s1 for (s0, c), (s1, _) in zip(spans, spans[1:]))
            assert spans[-1][0] + spans[-1][1] == widths[j]
    if k * 32 * 16 * 2 <= _pipe.RING_BYTES:
        # the ring: at least two stages, within its budget, 512-byte rows
        assert 2 <= stages <= _pipe.MAX_STAGES
        assert stages * k * tile_cols * itemsize <= _pipe.RING_BYTES
        assert (tile_cols * itemsize) % 512 == 0
    else:  # too wide for two stages: no ring, one 16-byte group per thread
        assert (tile_cols, stages) == (_pipe.CONSUMERS * 16 // itemsize, 0)


def test_launch_planner_tile_shape_and_limits():
    # the main path: K = 16 fp32 -> up to 512 columns, 3 stages of 32 KB
    assert _pipe.tile_shape(16, 4, 48, H100_SMEM) == (512, 3)
    assert _pipe.tile_shape(6, 4, 6, H100_SMEM) == (1024, 4)  # the round trip's decode
    assert _pipe.tile_shape(16, 2, 16, H100_SMEM) == (1024, 3)
    assert _pipe.tile_shape(40, 4, 40, H100_SMEM) == (256, 2)  # wide K: narrower tiles
    assert _pipe.tile_shape(96, 4, 96, H100_SMEM) == (128, 2)  # the widest K with a ring
    # every K runs: past two stages of 128 fp32 columns there is no ring
    # (N = 20 workers: s_max = 4 gives K = 100, s_max = 19 gives K = 400)
    for k in (97, 100, 400, 4096):
        assert _pipe.tile_shape(k, 4, k, H100_SMEM) == (1024, 0)
    assert _pipe.tile_shape(400, 2, 20 * 400, H100_SMEM) == (2048, 0)
    # the weight table shares the block's shared memory with the ring
    assert _pipe.tile_shape(16, 4, 40_000, H100_SMEM) == (512, 2)
    assert _pipe.tile_shape(16, 4, 56_000, H100_SMEM) == (1024, 0)
    # every table the loop took (48 KB) fits; only one past the card's is refused
    assert _pipe.tile_shape(12288, 4, 12288, H100_SMEM) == (1024, 0)
    with pytest.raises(ValueError, match="shared memory"):
        _pipe.tile_shape(16, 4, H100_SMEM // 4, H100_SMEM)
    # gc-lm-110m's step: one launch of 269,222 tiles of 512 columns
    widths = [24_576_000, 768] + [28_311_552] * 3 + [7_077_888] * 4 + [9_216] * 2
    (step,) = _pipe.plan_launches(widths, 512)
    assert step.leaves == tuple(range(11)) and step.n_tiles == 269_222
    # empty leaves take no tile; a launch of only empty leaves is dropped
    assert _pipe.plan_launches([0, 5, 0], 1024) == [_pipe.Launch((0, 1, 2), (0, 0, 1), 1)]
    assert _pipe.plan_launches([0] * 3, 1024) == []


def test_launch_planner_aligned_class_and_descriptors():
    """A leaf goes to the TMA ring (or, with no ring, to 16-byte loads)
    only with 16-byte rows and pointers; the descriptors pack
    gc_pipe.cuh's 40-byte ``Leaf`` in launch order."""
    ring, direct, col = _pipe.RING, _pipe.DIRECT, _pipe.PER_COLUMN
    assert _pipe.leaf_mode(1024, 4, 256, 512, 3) == ring
    assert _pipe.leaf_mode(1024, 4, 256, 512, 0) == direct
    assert _pipe.leaf_mode(8, 2, 16, 32, 2) == ring
    assert _pipe.leaf_mode(1021, 4, 256, 512, 3) == col   # ragged width
    assert _pipe.leaf_mode(1021, 4, 256, 512, 0) == col
    assert _pipe.leaf_mode(4, 2, 256, 512, 3) == col      # 8-byte rows in bf16
    assert _pipe.leaf_mode(1024, 4, 260, 512, 3) == col   # unaligned G
    assert _pipe.leaf_mode(1024, 4, 256, 520, 3) == col   # unaligned output
    widths = [1024, 127, 3000]
    launch = _pipe.plan_launches(widths, 1024)[0]
    blob = _pipe.descriptors(launch, [4096, 8192, 12288], [16, 32, 48], widths, [1, 0, 2],
                             [ring, col, direct])
    assert _pipe.LEAF.size == 40 and len(blob) == 3 * 40
    rows = [_pipe.LEAF.unpack_from(blob, 40 * i) for i in range(3)]
    assert rows == [(4096, 16, 1024, 0, 1, 1), (8192, 32, 127, 1, 0, 0),
                    (12288, 48, 3000, 2, 2, 2)]
    assert launch.n_tiles == 5


@pytest.mark.parametrize("k,modes", [(16, (_pipe.RING, _pipe.PER_COLUMN)),
                                     (100, (_pipe.DIRECT, _pipe.PER_COLUMN))])
def test_wrapper_launch_arguments_serve_every_k(k, modes):
    """The wrappers' cached launch arguments: the main path's K takes the
    ring, N = 20 workers' K = 100 takes 16-byte loads without one, ragged
    leaves take per-column loads in either, and a split list packs each
    launch's descriptors with its own tile prefix sums."""
    from repro_torch.kernels import _launch

    n = _pipe.MAX_LEAVES + 3
    widths = tuple(1024 if j % 2 == 0 else 1021 for j in range(n))
    g_ptrs = tuple(4096 * (j + 1) for j in range(n))
    out_ptrs = tuple(1 << 20 | 4096 * j for j in range(n))
    launches = _launch.pipe_launches(widths, k, 4, 5 * k, H100_SMEM, g_ptrs, out_ptrs,
                                     tuple(j % 5 for j in range(n)))
    assert [ln[2] for ln in launches] == [_pipe.MAX_LEAVES, 3]
    first = 0
    for tile_cols, stages, n_leaves, blob, n_tiles in launches:
        assert (tile_cols, stages) == _pipe.tile_shape(k, 4, 5 * k, H100_SMEM)
        rows = [_pipe.LEAF.unpack_from(blob, 40 * i) for i in range(n_leaves)]
        assert [r[0] for r in rows] == list(g_ptrs[first:first + n_leaves])
        assert [r[5] for r in rows] == [modes[(first + i) % 2] for i in range(n_leaves)]
        assert rows[0][3] == 0 and n_tiles == sum(-(-r[2] // tile_cols) for r in rows)
        first += n_leaves
    with pytest.raises(ValueError, match="shared memory"):
        _launch.pipe_launches(widths, k, 4, H100_SMEM, H100_SMEM, g_ptrs, out_ptrs,
                              (0,) * n)


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
    grouped = ops.encode_decode_leaves(a, b[None], [0, 0], [g, g[:, :7].contiguous()])
    assert torch.equal(grouped[0], out)
    assert torch.equal(grouped[1], ref.encode_decode_ref(a, b, g[:, :7]))
    assert ops.encode_decode_leaves(a, b[None], [], []) == []
    assert torch.equal(ops.encode(b, g), ref.encode_ref(b, g))
    assert torch.equal(ops.decode(b[0], g), ref.decode_ref(b[0], g))
    # meta (the dry run) takes the plain version too: shapes only, no launch
    y = ops.encode(b.to("meta"), g.to("meta"))
    assert y.device.type == "meta" and tuple(y.shape) == tuple(ops.encode(b, g).shape)
    assert (gc_fused.launches, gc_encode.launches, gc_decode.launches) == before

    class Elsewhere:  # a tensor on a device with neither route
        is_cuda = False
        device = torch.device("xpu")

    with pytest.raises(ValueError, match="unsupported device"):
        ops._route(Elsewhere(), gc_encode.encode, ref.encode_ref)


def test_kernel_wrapper_refuses_non_cuda_tensors():
    a, b, g = (torch.from_numpy(x) for x in _inputs(8, 1, 4, 16, "float32"))
    meta = [t.to("meta") for t in (a, b, g)]
    for args in ((a, b, g), meta):
        with pytest.raises(ValueError, match="CUDA"):
            gc_fused.encode_decode(*args)
        with pytest.raises(ValueError, match="CUDA"):
            gc_fused.encode_decode_leaves(args[0], args[1][None], [0], [args[2]])
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

