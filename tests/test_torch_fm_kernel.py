"""The port's FM score wrappers (fast_tffm_tpu_torch/ops/fm_kernel.py)
against the JAX package's Pallas kernels and XLA path.

On the CPU the wrappers run their plain versions; the inputs are made
with numpy from a seed and handed to both packages. Tolerances: the
reference's own Pallas-vs-XLA bounds (tests/test_pallas_fm.py), rtol
1e-5 / atol 1e-6 on scores and rtol 1e-4 / atol 1e-6 on gradients —
both sides accumulate in f32, in different orders. The CUDA kernels
themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.ops.interaction import fm_batch_scores as jax_fm_xla
from fast_tffm_tpu.ops.pallas_fm import fm_batch_scores_pallas
from fast_tffm_tpu_torch.ops import fm_kernel, interaction


# The plain versions run many small torch ops on the CPU; with one
# intra-op thread, torch's idle OpenMP workers do not spin on every core
# and starve the suite's other test processes.
torch.set_num_threads(1)

def _case(seed, B, L, U, K, pad_tail=False):
    """params [U, K+1] (last row zero when padding), idx [B, L], vals."""
    rng = np.random.default_rng(seed)
    params = (rng.normal(size=(U, K + 1)) * 0.1).astype(np.float32)
    idx = rng.integers(0, U, size=(B, L)).astype(np.int32)
    vals = (rng.random(size=(B, L))
            * (rng.random(size=(B, L)) > 0.3)).astype(np.float32)
    if pad_tail:
        # Pipeline layout: a zero pad row, each example's slots past its
        # length point at it with value 0.
        params[-1] = 0.0
        lengths = rng.integers(0, L + 1, size=B)
        tail = np.arange(L)[None, :] >= lengths[:, None]
        idx[tail] = U - 1
        vals[tail] = 0.0
    return params, idx, vals


def _port(params, idx, vals):
    return fm_kernel.fm_batch_scores(
        torch.from_numpy(params), torch.from_numpy(idx),
        torch.from_numpy(vals)).numpy()


CASES = [(64, 16, 128, 8, False), (32, 64, 512, 4, False),
         (8, 8, 16, 16, False), (48, 64, 256, 16, True)]


@pytest.mark.parametrize("B,L,U,K,pad", CASES)
def test_forward_parity_with_pallas_and_xla(B, L, U, K, pad):
    params, idx, vals = _case(B * L + K, B, L, U, K, pad)
    got = _port(params, idx, vals)
    assert got.dtype == np.float32 and got.shape == (B,)
    pallas = np.asarray(fm_batch_scores_pallas(
        jnp.asarray(params), jnp.asarray(idx), jnp.asarray(vals)))
    xla = np.asarray(jax_fm_xla(jnp.asarray(params), jnp.asarray(idx),
                                jnp.asarray(vals)))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-6)


def test_plain_scores_independent_of_padding_and_batch():
    """Serve and predict pad one line to different (B, L): the plain
    version's per-example sum order must give the same bits."""
    params, idx, vals = _case(3, 16, 16, 64, 8, pad_tail=True)
    U = params.shape[0]
    ref = _port(params, idx, vals)
    wide_idx = np.full((16, 64), U - 1, dtype=np.int32)
    wide_vals = np.zeros((16, 64), dtype=np.float32)
    wide_idx[:, :16], wide_vals[:, :16] = idx, vals
    assert _port(params, wide_idx, wide_vals).tobytes() == ref.tobytes()
    for b in (0, 5, 15):
        one = _port(params, idx[b:b + 1], vals[b:b + 1])
        assert one.tobytes() == ref[b:b + 1].tobytes()


def test_cpu_path_does_not_count_launches():
    params, idx, vals = _case(1, 8, 8, 16, 4)
    before = fm_kernel.launches
    _port(params, idx, vals)
    assert fm_kernel.launches == before


def test_wrapper_is_the_plain_version_on_cpu():
    params, idx, vals = _case(2, 8, 8, 16, 4)
    t = [torch.from_numpy(a) for a in (params, idx, vals)]
    assert (fm_kernel.fm_batch_scores(*t).numpy().tobytes()
            == interaction.fm_batch_scores(*t).numpy().tobytes())


def test_wrapper_refuses_mixed_devices():
    params, idx, vals = _case(2, 4, 4, 16, 4)
    with pytest.raises(ValueError, match="one device"):
        fm_kernel.fm_batch_scores(torch.from_numpy(params),
                                  torch.from_numpy(idx),
                                  torch.from_numpy(vals).to("meta"))


def test_build_module_imports_without_nvcc():
    build = importlib.import_module("fast_tffm_tpu_torch.ops.build")
    for src in build.SOURCES:
        path = build.library_path(src)
        assert path.startswith(build.BUILD_DIR)
        assert path == build.library_path(src)
    assert build.library_path(build.FM_SCORE_SRC) != build.library_path(
        build.FM_SCORE_BWD_SRC)
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def _port_grads(params, idx, vals, g):
    """dparams, dvals of sum(g * scores) through FmScores on the CPU."""
    p = torch.from_numpy(params).requires_grad_(True)
    v = torch.from_numpy(vals).requires_grad_(True)
    scores = fm_kernel.fm_batch_scores(p, torch.from_numpy(idx), v)
    assert scores.grad_fn is not None
    scores.backward(torch.from_numpy(g))
    return p.grad.numpy(), v.grad.numpy()


@pytest.mark.parametrize("B,L,U,K,pad", CASES)
def test_backward_parity_with_pallas_vjp_and_xla_grad(B, L, U, K, pad):
    params, idx, vals = _case(B * L + K + 1, B, L, U, K, pad)
    g = np.random.default_rng(B + U).normal(size=B).astype(np.float32)
    before = fm_kernel.bwd_launches
    dp, dv = _port_grads(params, idx, vals, g)
    assert fm_kernel.bwd_launches == before
    assert dp.shape == params.shape and dv.shape == vals.shape
    jp, jv = jnp.asarray(params), jnp.asarray(vals)
    _, vjp = jax.vjp(lambda p, x: fm_batch_scores_pallas(p, idx, x), jp, jv)
    pallas_dp, pallas_dv = vjp(jnp.asarray(g))
    xla_dp, xla_dv = jax.grad(
        lambda p, x: jnp.sum(jnp.asarray(g) * jax_fm_xla(p, idx, x)),
        argnums=(0, 1))(jp, jv)
    for want_dp, want_dv in ((pallas_dp, pallas_dv), (xla_dp, xla_dv)):
        np.testing.assert_allclose(dp, np.asarray(want_dp), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(dv, np.asarray(want_dv), rtol=1e-4,
                                   atol=1e-6)


def test_backward_skips_dvals_when_vals_need_no_grad():
    params, idx, vals = _case(8, 16, 8, 32, 4, pad_tail=True)
    g = np.linspace(-1, 1, 16).astype(np.float32)
    p = torch.from_numpy(params).requires_grad_(True)
    scores = fm_kernel.fm_batch_scores(p, torch.from_numpy(idx),
                                       torch.from_numpy(vals))
    scores.backward(torch.from_numpy(g))
    dp, dv = _port_grads(params, idx, vals, g)
    assert torch.equal(p.grad, torch.from_numpy(dp))
    dp2, dv2 = interaction.fm_batch_scores_bwd(
        torch.from_numpy(params), torch.from_numpy(idx),
        torch.from_numpy(vals), torch.from_numpy(g), need_dx=False)
    assert dv2 is None and torch.equal(dp2, p.grad)


def test_backward_magnitudes_bound_the_sums():
    params, idx, vals = _case(9, 32, 16, 24, 8, pad_tail=True)
    g = np.random.default_rng(9).normal(size=32).astype(np.float32)
    t = [torch.from_numpy(a) for a in (params, idx, vals, g)]
    dp, dv, dp_abs, dv_abs = interaction.fm_batch_scores_bwd(
        *t, need_dx=True, magnitudes=True)
    assert (dp.abs() <= dp_abs * (1 + 1e-6)).all()
    assert (dv.abs() <= dv_abs * (1 + 1e-6)).all()
    plain = interaction.fm_batch_scores_bwd(*t, need_dx=True)
    assert torch.equal(plain[0], dp) and torch.equal(plain[1], dv)


def test_gradcheck_float64():
    params, idx, vals = _case(4, 6, 5, 7, 3, pad_tail=True)
    p = torch.from_numpy(params).double().requires_grad_(True)
    v = torch.from_numpy(vals).double().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b: fm_kernel.FmScores.apply(a, torch.from_numpy(idx), b),
        (p, v), eps=1e-6, atol=1e-8, rtol=1e-6)

