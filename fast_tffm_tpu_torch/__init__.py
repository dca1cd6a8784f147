"""fast_tffm_tpu_torch — the PyTorch/CUDA port of fast_tffm_tpu.

A second package beside the JAX one, which stays the reference. It
trains a 2nd-order FM (logistic or mse loss, sparse Adagrad, one device)
with checkpoints and resume under ``<model_file>.ckpt/``, predicts from
the newest checkpoint step and serves the published one, hot-reloading
each newly published step.
On the card every score runs through the hand-written CUDA kernel in
``csrc/fm_score.cu`` and every training gradient through
``csrc/fm_score_bwd.cu``:

    python -m fast_tffm_tpu_torch train   <cfg> [--device cuda|cpu]
    python -m fast_tffm_tpu_torch predict <cfg> [--device cuda|cpu]
    python -m fast_tffm_tpu_torch serve   <cfg> [--device cuda|cpu]

It imports torch and numpy, never jax and nothing of fast_tffm_tpu.
"""
