"""The port's FM score wrapper (fast_tffm_tpu_torch/ops/fm_kernel.py)
against the JAX package's Pallas kernel and XLA path.

On the CPU the wrapper runs its plain version; the inputs are made with
numpy from a seed and handed to both packages. Tolerance: the reference's
own Pallas-vs-XLA bound (tests/test_pallas_fm.py), rtol 1e-5 / atol
1e-6 — both sides accumulate in f32, in different orders. The CUDA
kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.ops.interaction import fm_batch_scores as jax_fm_xla
from fast_tffm_tpu.ops.pallas_fm import fm_batch_scores_pallas
from fast_tffm_tpu_torch.ops import fm_kernel, interaction


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
    path = build.library_path(build.FM_SCORE_SRC)
    assert path.startswith(build.BUILD_DIR)
    assert path == build.library_path(build.FM_SCORE_SRC)
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS

