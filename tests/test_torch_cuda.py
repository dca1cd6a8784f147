"""The port's CUDA kernel against its plain version, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a
CUDA kernel has no CPU mode. The file imports no jax, so it also runs on
a machine that has none, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: rtol 1e-5 / atol 1e-6, the bound the CPU tests hold the
plain version to against the JAX package. The kernel sums in the plain
version's order with explicitly rounded operations, so the two are
expected to agree to the bit; the tolerance covers a compiler that
rounds otherwise.
"""

import numpy as np
import pytest
import torch

from fast_tffm_tpu_torch.ops import fm_kernel, interaction

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, B, L, U, K):
    rng = np.random.default_rng(seed)
    params = (rng.normal(size=(U, K + 1)) * 0.1).astype(np.float32)
    params[-1] = 0.0
    idx = rng.integers(0, U - 1, size=(B, L)).astype(np.int32)
    vals = rng.random(size=(B, L)).astype(np.float32)
    tail = np.arange(L)[None, :] >= rng.integers(0, L + 1, size=B)[:, None]
    idx[tail] = U - 1
    vals[tail] = 0.0
    return [torch.from_numpy(a) for a in (params, idx, vals)]


@pytest.mark.parametrize("B,L,U,K", [(64, 16, 128, 8), (32, 64, 512, 4),
                                     (8, 8, 16, 16), (8192, 64, 1 << 20, 16),
                                     (300, 100, 4096, 40), (7, 1, 9, 1)])
def test_kernel_matches_plain_version(card, B, L, U, K):
    cpu = _case(B + L + K, B, L, U, K)
    plain = interaction.fm_batch_scores(*cpu)
    before = fm_kernel.launches
    got = fm_kernel.fm_batch_scores(*(t.to(card) for t in cpu))
    torch.cuda.synchronize()
    assert fm_kernel.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_kernel_bits_independent_of_padding_and_batch(card):
    params, idx, vals = (t.to(card) for t in _case(5, 64, 16, 512, 16))
    ref = fm_kernel.fm_batch_scores(params, idx, vals).cpu()
    wide_idx = torch.full((64, 128), params.shape[0] - 1, dtype=torch.int32,
                          device=card)
    wide_vals = torch.zeros((64, 128), dtype=torch.float32, device=card)
    wide_idx[:, :16], wide_vals[:, :16] = idx, vals
    wide = fm_kernel.fm_batch_scores(params, wide_idx, wide_vals).cpu()
    assert torch.equal(wide, ref)
    one = fm_kernel.fm_batch_scores(params, idx[9:10].contiguous(),
                                    vals[9:10].contiguous()).cpu()
    assert torch.equal(one, ref[9:10])


def test_out_of_range_row_scores_nan(card):
    params, idx, vals = (t.to(card) for t in _case(6, 4, 8, 32, 8))
    idx[2, 3] = params.shape[0]
    got = fm_kernel.fm_batch_scores(params, idx, vals).cpu()
    assert torch.isnan(got[2]) and torch.isfinite(got[[0, 1, 3]]).all()


def test_wrapper_checks_dtype_and_contiguity(card):
    params, idx, vals = (t.to(card) for t in _case(7, 4, 8, 32, 8))
    with pytest.raises(TypeError):
        fm_kernel.fm_batch_scores(params, idx.long(), vals)
    with pytest.raises(ValueError, match="contiguous"):
        fm_kernel.fm_batch_scores(params, idx.t().contiguous().t(),
                                  vals.t().contiguous().t())
