"""The port's copies of jax-free modules — config loader, metrics,
metrics registry, logger — against the JAX package's originals."""

import dataclasses
import logging

import numpy as np
import pytest

from fast_tffm_tpu import config as jax_config
from fast_tffm_tpu import metrics as jax_metrics
from fast_tffm_tpu.obs.registry import MetricsRegistry as JaxRegistry
from fast_tffm_tpu_torch import config, metrics
from fast_tffm_tpu_torch.obs.registry import MetricsRegistry
from fast_tffm_tpu_torch.utils.logging import get_logger


def test_same_fields_and_defaults():
    want = {f.name: f.default for f in dataclasses.fields(
        jax_config.FmConfig)}
    got = {f.name: f.default for f in dataclasses.fields(config.FmConfig)}
    assert got == want


def test_sample_cfg_loads_the_same():
    want = dataclasses.asdict(jax_config.load_config("sample.cfg"))
    got = dataclasses.asdict(config.load_config("sample.cfg"))
    assert got == want
    cfg = config.load_config("sample.cfg")
    assert (cfg.pad_id, cfg.num_rows, cfg.row_dim) == (200, 201, 9)


@pytest.mark.parametrize("text", [
    "[General]\nvocabulary_sise = 10\n",          # typo
    "[Train]\nfactor_num = 4\n",                  # known key, wrong section
    "[Serve]\nlookup = host\n",
    "[General]\norder = 1\n",                     # __post_init__ error
    "[Train]\nkernel = cuda\n",
    "[Train]\nbatch_size = many\n",
])
def test_config_errors_match(tmp_path, text):
    p = tmp_path / "bad.cfg"
    p.write_text(text)
    with pytest.raises(Exception) as want:
        jax_config.load_config(str(p))
    with pytest.raises(type(want.value)) as got:
        config.load_config(str(p))
    assert str(got.value) == str(want.value)


def test_missing_config_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        config.load_config(str(tmp_path / "none.cfg"))


def test_env_overrides_match(monkeypatch):
    monkeypatch.setenv("FM_SERVE_PORT", "7123")
    base = config.load_config("sample.cfg")
    got = config.apply_env_overrides(base)
    want = jax_config.apply_env_overrides(jax_config.load_config(
        "sample.cfg"))
    assert got.serve_port == want.serve_port == 7123


def test_sigmoid_and_exact_auc_match():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=500).astype(np.float32) * 8,
                        np.float32([0.0, -0.0, 80.0, -80.0])])
    got, want = metrics.sigmoid(x), jax_metrics.sigmoid(x)
    assert got.dtype == want.dtype == np.float64
    assert got.tobytes() == want.tobytes()
    y = (rng.random(len(x)) < 0.4).astype(np.float32)
    w = rng.random(len(x))
    assert metrics.exact_auc(x, y) == jax_metrics.exact_auc(x, y)
    assert metrics.exact_auc(x, y, w) == jax_metrics.exact_auc(x, y, w)
    assert np.isnan(metrics.exact_auc(x, np.zeros_like(y)))


def test_registry_matches():
    bounds = (1.0, 2.0, 5.0)
    regs = (MetricsRegistry(), JaxRegistry())
    for r in regs:
        r.count("a")
        r.count("a", 2)
        r.set("g", 3.5)
        for v in (0.5, 1.5, 4.0, 9.0):
            r.observe("h", v, bounds=bounds)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].histogram("h", bounds).quantile(0.5) == 2.0


def test_logger_writes_to_log_file(tmp_path):
    path = tmp_path / "log" / "fm.log"
    log = get_logger("fast_tffm_tpu_torch.test", log_file=str(path))
    log.info("hello")
    for h in log.handlers:
        h.flush()
    assert log.level == logging.INFO
    assert "hello" in path.read_text()
