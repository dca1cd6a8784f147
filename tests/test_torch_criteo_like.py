"""AUC parity of the port's CLI on synthesized CTR data, on the CPU —
the counterpart of ``tests/test_criteo_like.py``'s two parity tests.

``python -m fast_tffm_tpu_torch train`` then ``predict`` (in process,
``--device cpu``) on the port's ``data/synth.py`` draws, and the score
file's test AUC against the port's independent NumPy SGD trainer
(``synth.numpy_fm_train_predict`` / ``numpy_ffm_train_predict``:
hand-derived gradients, no model code shared with the port) trained on
the same parsed data at the same batch size and hyperparameters. The
bounds are the reference's: |AUC - oracle AUC| < 0.015, above a floor,
below the generator's Bayes ceiling.

Sizes: the FM leg is the reference's (30,000 / 10,000 lines, seed 3,
B = 512, hashed 2^20, k = 8, 2 epochs); the FFM leg too (30,000 / 8,000
lines, seed 5, B = 512, k = 4, 2 epochs). Both are tier-1: the port
trains each in seconds on one CPU thread.
"""

import os

import numpy as np
import torch

from fast_tffm_tpu_torch.__main__ import main
from fast_tffm_tpu_torch.data import synth
from fast_tffm_tpu_torch.metrics import exact_auc

torch.set_num_threads(1)

N_TRAIN, N_TEST = 30000, 10000
VOCAB = 1 << 20
K, LR, EPOCHS = 8, 0.05, 2
LAM = 1e-6
BATCH = 512
AUC_TOL = 0.015        # tests/test_criteo_like.py's parity bound


def _write_cfg(path, tmp, train, test, *, vocab, k, mfpe, general=""):
    with open(path, "w") as fh:
        fh.write(f"""
[General]
vocabulary_size = {vocab}
factor_num = {k}
{general}
model_file = {tmp}/model/ck
log_file = {tmp}/log/ck.log

[Train]
train_files = {train}
epoch_num = {EPOCHS}
batch_size = {BATCH}
learning_rate = {LR}
factor_lambda = {LAM}
bias_lambda = {LAM}
init_value_range = 0.01
loss_type = logistic
max_features_per_example = {mfpe}
bucket_ladder = {mfpe}
shuffle = False

[Predict]
predict_files = {test}
score_path = {tmp}/score
""")


def _cli_auc(cfg_path, tmp, test, n_test):
    assert main(["train", cfg_path, "--device", "cpu"]) == 0
    assert main(["predict", cfg_path, "--device", "cpu"]) == 0
    scores = np.loadtxt(os.path.join(
        tmp, "score", os.path.basename(test) + ".score"))
    labels = np.loadtxt(test, usecols=0)
    assert scores.shape == (n_test,) and np.isfinite(scores).all()
    return exact_auc(scores, labels), labels


def test_criteo_like_auc_parity(tmp_path):
    train, test = str(tmp_path / "train.txt"), str(tmp_path / "test.txt")
    meta = synth.write_dataset(train, test, N_TRAIN, N_TEST, seed=3)
    # sane generator: Criteo-like positive rate, a real signal to learn
    assert 0.15 < meta["positive_rate_test"] < 0.35
    assert meta["bayes_auc"] > 0.85

    cfg_path = str(tmp_path / "ck.cfg")
    _write_cfg(cfg_path, tmp_path, train, test, vocab=VOCAB, k=K, mfpe=48,
               general="hash_feature_id = True")
    fw_auc, labels = _cli_auc(cfg_path, tmp_path, test, N_TEST)

    tr = synth.parse_file_blocks(train, VOCAB, BATCH)
    te = synth.parse_file_blocks(test, VOCAB, BATCH)
    oracle_auc = exact_auc(synth.numpy_fm_train_predict(
        tr, te, VOCAB, k=K, lr=LR, epochs=EPOCHS, factor_lambda=LAM,
        bias_lambda=LAM), labels)

    assert abs(fw_auc - oracle_auc) < AUC_TOL, (fw_auc, oracle_auc)
    assert fw_auc > 0.72, fw_auc
    assert fw_auc < meta["bayes_auc"]


def test_avazu_like_ffm_auc_parity(tmp_path):
    F = len(synth.FFM_FIELDS)
    vocab = synth.ffm_vocab_size()
    train, test = str(tmp_path / "tr.txt"), str(tmp_path / "te.txt")
    meta = synth.write_ffm_dataset(train, test, 30000, 8000, seed=5)
    assert meta["bayes_auc"] > 0.8

    cfg_path = str(tmp_path / "ckffm.cfg")
    _write_cfg(cfg_path, tmp_path, train, test, vocab=vocab, k=4, mfpe=F,
               general=f"model_type = ffm\nfield_num = {F}")
    fw_auc, labels = _cli_auc(cfg_path, tmp_path, test, 8000)

    tr = synth.parse_ffm_file(train, BATCH)
    te = synth.parse_ffm_file(test, BATCH)
    oracle_auc = exact_auc(synth.numpy_ffm_train_predict(
        tr, te, vocab, k=4, lr=LR, epochs=EPOCHS, factor_lambda=LAM,
        bias_lambda=LAM), labels)

    assert abs(fw_auc - oracle_auc) < AUC_TOL, (fw_auc, oracle_auc)
    # both learned real signal (0.5 = chance; 30k rows only start to
    # resolve the pairwise truth, so the bar is modest)
    assert fw_auc > 0.58, fw_auc
    assert fw_auc < meta["bayes_auc"]
