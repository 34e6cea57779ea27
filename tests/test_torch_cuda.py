"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

The CUDA kernel has no CPU mode, so these skip without CUDA.  The file
imports no JAX, so it runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import ShiftedExponential
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.kernels import gc_fused, ops, ref
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
