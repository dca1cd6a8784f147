"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a
CUDA kernel has no CPU mode. The file imports no jax, so it also runs on
a machine that has none, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances:

- forward (csrc/fm_score.cu): rtol 1e-5 / atol 1e-6, the bound the CPU
  tests hold the plain version to against the JAX package. The kernel
  sums in the plain version's order with explicitly rounded operations,
  so the two are expected to agree to the bit; the tolerance covers a
  compiler that rounds otherwise.
- backward (csrc/fm_score_bwd.cu): float atomics add the rows'
  contributions in an order that changes from run to run, so each
  element of ``dparams`` is held to rtol 1e-5 of its sum of absolute
  contributions (which the plain version computes alongside), plus atol
  1e-6; ``dvals``, summed by a warp butterfly, likewise against
  ``|g|·(|w| + Σ_f |v_f·(s_f − z_f)|)``.
- one train step on the card against the same step on the CPU: rtol
  1e-4 / atol 1e-6, the bound the CPU tests hold the step to against the
  JAX package.
"""

import numpy as np
import pytest
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.models import fm as port_fm
from fast_tffm_tpu_torch.ops import fm_kernel, interaction

BWD_RTOL, BWD_ATOL = 1e-5, 1e-6

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


def _assert_within(got, want, magnitude, what):
    err = (got.cpu() - want).abs()
    bound = BWD_ATOL + BWD_RTOL * magnitude
    assert torch.isfinite(got).all(), what
    assert (err <= bound).all(), (
        f"{what}: max err {float(err.max())}, worst excess "
        f"{float((err - bound).max())}")


@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("B,L,U,K", [(64, 16, 128, 8), (32, 64, 512, 4),
                                     (8, 8, 16, 16), (8192, 64, 1 << 18, 16),
                                     (300, 100, 4096, 40), (7, 1, 9, 1)])
def test_bwd_kernel_matches_plain_version(card, B, L, U, K, need_dx):
    cpu = _case(B + L + K, B, L, U, K)
    g = torch.from_numpy(np.random.default_rng(B).normal(size=B)
                         .astype(np.float32))
    dp, dv, dp_abs, dv_abs = interaction.fm_batch_scores_bwd(
        *cpu, g, need_dx=True, magnitudes=True)
    before = fm_kernel.bwd_launches
    got_dp, got_dv = fm_kernel.fm_batch_scores_bwd(
        *(t.to(card) for t in cpu), g.to(card), need_dx=need_dx)
    torch.cuda.synchronize()
    assert fm_kernel.bwd_launches == before + 1
    _assert_within(got_dp, dp, dp_abs, "dparams")
    if need_dx:
        _assert_within(got_dv, dv, dv_abs, "dvals")
    else:
        assert got_dv is None
    assert not got_dp[-1].any().item()  # only pad cells point at it


def test_bwd_kernel_hot_row(card):
    """One row in every example (a categorical value every line
    shares): B atomics per column on one row."""
    B, L, U, K = 4096, 32, 2048, 16
    params, idx, vals = _case(11, B, L, U, K)
    idx[:, 0] = 3
    vals[:, 0] = 1.0
    g = torch.from_numpy(np.random.default_rng(11).normal(size=B)
                         .astype(np.float32))
    dp, dv, dp_abs, dv_abs = interaction.fm_batch_scores_bwd(
        params, idx, vals, g, need_dx=True, magnitudes=True)
    got_dp, got_dv = fm_kernel.fm_batch_scores_bwd(
        params.to(card), idx.to(card), vals.to(card), g.to(card),
        need_dx=True)
    torch.cuda.synchronize()
    _assert_within(got_dp, dp, dp_abs, "dparams")
    _assert_within(got_dv, dv, dv_abs, "dvals")
    assert float(dp_abs[3].max()) > 100 * float(dp_abs[4].max())


def test_fm_scores_autograd_runs_both_kernels(card):
    params, idx, vals = (t.to(card) for t in _case(12, 128, 32, 1024, 16))
    p = params.clone().requires_grad_(True)
    v = vals.clone().requires_grad_(True)
    f0, b0 = fm_kernel.launches, fm_kernel.bwd_launches
    scores = fm_kernel.fm_batch_scores(p, idx, v)
    scores.square().sum().backward()
    torch.cuda.synchronize()
    assert (fm_kernel.launches, fm_kernel.bwd_launches) == (f0 + 1, b0 + 1)
    g = 2 * scores.detach()
    dp, dv, dp_abs, dv_abs = interaction.fm_batch_scores_bwd(
        params.cpu(), idx.cpu(), vals.cpu(), g.cpu(), need_dx=True,
        magnitudes=True)
    _assert_within(p.grad, dp, dp_abs, "dparams")
    _assert_within(v.grad, dv, dv_abs, "dvals")


def test_bwd_out_of_range_row_makes_dvals_nan(card):
    params, idx, vals = (t.to(card) for t in _case(13, 4, 8, 32, 8))
    idx[1, 2] = params.shape[0]
    g = torch.ones(4, device=card)
    dp, dv = fm_kernel.fm_batch_scores_bwd(params, idx, vals, g,
                                           need_dx=True)
    torch.cuda.synchronize()
    assert torch.isnan(dv[1, 2]) and torch.isfinite(dp).all()
    assert torch.isfinite(dv[0]).all()


def test_train_step_on_card_matches_cpu(card):
    cfg = FmConfig(vocabulary_size=5000, factor_num=16, batch_size=512,
                   learning_rate=0.1, factor_lambda=1e-4, bias_lambda=1e-4)
    spec = port_fm.ModelSpec.from_config(cfg)
    rng = np.random.default_rng(14)
    table = rng.uniform(-0.1, 0.1, (cfg.num_rows, cfg.row_dim)
                        ).astype(np.float32)
    table[-1] = 0.0
    acc = np.full_like(table, cfg.adagrad_init)
    B, L = cfg.batch_size, 32
    idx = rng.zipf(1.3, size=(B, L)).astype(np.int64) % cfg.vocabulary_size
    vals = rng.random((B, L)).astype(np.float32)
    tail = np.arange(L)[None, :] >= rng.integers(1, L + 1, size=B)[:, None]
    idx[tail] = cfg.pad_id
    vals[tail] = 0.0
    batch = dict(labels=(rng.random(B) < 0.3).astype(np.float32),
                 weights=np.ones(B, np.float32),
                 local_idx=idx.astype(np.int32), vals=vals)
    out = {}
    for dev in ("cpu", card):
        # Copies: the step updates the table and accumulator in place.
        t = torch.from_numpy(table.copy()).to(dev)
        a = torch.from_numpy(acc.copy()).to(dev)
        args = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        f0, b0 = fm_kernel.launches, fm_kernel.bwd_launches
        for _ in range(3):
            t, a, loss, scores = port_fm.train_step_body(spec, t, a, **args)
        out[str(dev)] = [x.cpu().numpy() for x in (t, a, loss, scores)]
        if dev == card:
            assert fm_kernel.launches == f0 + 3
            assert fm_kernel.bwd_launches == b0 + 3
    for got, want in zip(out[str(card)], out["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
