"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

The CUDA kernels have no CPU mode, so these skip without CUDA.  The file
imports no JAX, so it runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import ShiftedExponential
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.checkpoint import CodedSpec, restore_coded_train_state, save_coded_checkpoint
from repro_torch.kernels import gc_decode, gc_encode, gc_fused, ops, ref
from repro_torch.models.params import params_to_numpy
from repro_torch.train.coded import make_coded_grad_fn, uncoded_grad_fn
from repro_torch.train.trainer import TrainConfig, Trainer

pytestmark = pytest.mark.cuda

# the kernel-parity tolerances of tests/test_kernel_parity.py
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gc_fused_matches_plain_version(cuda, dtype):
    gen = torch.Generator(device="cpu").manual_seed(0)
    for nb, k, d in [(1, 16, 768), (1, 16, 1021), (3, 4, 129), (3, 4, 4096), (8, 16, 1)]:
        a, b = torch.randn(nb, generator=gen), torch.randn(nb, k, generator=gen)
        g = torch.randn(k, d, generator=gen).to(dtype)
        a, b, g = a.to(cuda), b.to(cuda), g.to(cuda)
        before = gc_fused.launches
        got = ops.encode_decode(a, b, g)
        torch.cuda.synchronize()
        assert gc_fused.launches == before + 1
        assert got.dtype == dtype and tuple(got.shape) == (nb, d)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.encode_decode_ref(a, b, g).float().cpu().numpy(),
                                   **TOL[dtype])


def test_gc_fused_rejects_what_it_cannot_run(cuda):
    g = torch.zeros(4, 16, device=cuda)
    with pytest.raises(ValueError, match="NB"):
        gc_fused.encode_decode(torch.zeros(9, device=cuda), torch.zeros(9, 4, device=cuda), g)
    with pytest.raises(ValueError, match="contiguous"):
        gc_fused.encode_decode(torch.zeros(1, device=cuda), torch.zeros(1, 4, device=cuda),
                               torch.zeros(16, 4, device=cuda).t())
    with pytest.raises(TypeError):
        gc_fused.encode_decode(torch.zeros(1, device=cuda), torch.zeros(1, 4, device=cuda),
                               g.half())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gc_encode_and_gc_decode_match_plain_versions(cuda, dtype):
    gen = torch.Generator(device="cpu").manual_seed(1)
    for nb, k, d in [(1, 3, 4096), (3, 5, 1021), (12, 12, 129), (6, 6, 1), (1, 2, 513)]:
        b = torch.randn(nb, k, generator=gen).to(cuda)
        g = torch.randn(k, d, generator=gen).to(dtype).to(cuda)
        before = gc_encode.launches
        got = ops.encode(b, g)
        torch.cuda.synchronize()
        assert gc_encode.launches == before + -(-nb // gc_encode.MAX_NB)
        assert got.dtype == dtype and tuple(got.shape) == (nb, d)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.encode_ref(b, g).float().cpu().numpy(), **TOL[dtype])
        a = torch.randn(k, generator=gen).to(cuda)
        before = gc_decode.launches
        y = ops.decode(a, g)
        torch.cuda.synchronize()
        assert gc_decode.launches == before + 1
        assert y.dtype == dtype and tuple(y.shape) == (d,)
        np.testing.assert_allclose(y.float().cpu().numpy(),
                                   ref.decode_ref(a, g).float().cpu().numpy(), **TOL[dtype])


def test_gc_encode_is_exact_on_integer_digits(cuda):
    """Parity sums up to 2^24 - 4 (the coded checkpoint's budget) come
    out as the exact int64 product: true fp32 FMA, no TF32."""
    rng = np.random.default_rng(0)
    p = np.array([[1, 1, 1, 1], [1, 2, 3, 4]], np.float32)
    digits = rng.integers(0, 2 ** 16, (4, 100_003)).astype(np.float32)
    digits[:, 1] = [0, 0, 0, (2 ** 24 - 1) // 4]
    got = gc_encode.encode(torch.from_numpy(p).to(cuda), torch.from_numpy(digits).to(cuda))
    want = p.astype(np.int64) @ digits.astype(np.int64)
    assert np.array_equal(got.cpu().numpy().astype(np.int64), want)


def test_coded_checkpoint_of_cuda_tensors_goes_through_gc_encode(cuda, tmp_path):
    gen = torch.Generator(device="cpu").manual_seed(2)
    tree = {"w": torch.randn(1000, 37, generator=gen).to(cuda),
            "h": torch.randn(77, generator=gen).to(torch.bfloat16).to(cuda)}
    before = gc_encode.launches
    save_coded_checkpoint(str(tmp_path), 1, tree, CodedSpec(n_shards=4, parity=1))
    assert gc_encode.launches == before + 1
    template = {k: torch.zeros_like(v) for k, v in tree.items()}
    got = restore_coded_train_state(template, str(tmp_path), missing=[1])
    assert gc_encode.launches == before + 2  # the survivors' contribution
    assert got["w"].is_cuda and torch.equal(got["w"].view(torch.int32),
                                            tree["w"].view(torch.int32))
    assert torch.equal(got["h"].view(torch.int16), tree["h"].view(torch.int16))


def test_coded_step_on_cuda_matches_uncoded_and_launches_per_leaf(cuda):
    """Reduced gc-lm-110m on the card: coded == uncoded for 0 and s_max
    stragglers (fp32, TF32 off), one kernel launch per leaf per step."""
    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    tr = Trainer(cfg, TrainConfig(), ShiftedExponential(), n_workers=4,
                 global_batch=8, device="cuda", seq_len=32)
    plan, model = tr.plan, tr.state.params
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
    wb = coded_worker_batches(data, 0, 4, plan.s_max)
    shards = np.stack([data.shard(0, i, 4) for i in range(4)])
    g_ref = uncoded_grad_fn(cfg, 4)(model, shards)
    coded = make_coded_grad_fn(cfg, plan)
    for u in (0, plan.s_max):
        times = np.ones(4)
        times[:u] = 1e6
        before = gc_fused.launches
        g = coded(model, wb, plan.decode_weights(times).astype(np.float32))
        assert gc_fused.launches == before + plan.flat_layout.n_leaves
        for gc, gu in zip(g, g_ref):
            assert float((gc - gu).abs().max()) <= 1e-4 * float(gu.abs().max())
    cpu = Trainer(cfg, TrainConfig(), ShiftedExponential(), n_workers=4,
                  global_batch=8, device="cpu", seq_len=32,
                  params=params_to_numpy(model))
    tr.run(2, log_every=0)
    cpu.run(2, log_every=0)
    for hg, hc in zip(tr.history, cpu.history):
        np.testing.assert_allclose(hg["loss"], hc["loss"], rtol=1e-4)
