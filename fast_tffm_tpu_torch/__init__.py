"""fast_tffm_tpu_torch — the PyTorch/CUDA port of fast_tffm_tpu.

A second package beside the JAX one, which stays the reference. It
trains an FM of order 2 or higher or a field-aware FM (logistic or mse
loss, sparse Adagrad; one device, or ``dist_train`` ranks over a
row-sharded table) with checkpoints and resume under
``<model_file>.ckpt/``, predicts from the newest checkpoint step and
serves the published one, hot-reloading each newly published step;
batches cross to the card padded or packed (``wire.py``). On the card
every 2nd-order FM score runs through the hand-written CUDA kernel in
``csrc/fm_score.cu`` and every such training gradient through
``csrc/fm_score_bwd.cu``; FFM and order > 2 run as torch ops:

    python -m fast_tffm_tpu_torch train   <cfg> [--device cuda|cpu]
                                                [dist_train worker <i>]
    python -m fast_tffm_tpu_torch predict <cfg> [--device cuda|cpu]
                                                [dist_train worker <i>]
    python -m fast_tffm_tpu_torch serve   <cfg> [--device cuda|cpu]

It imports torch and numpy, never jax and nothing of fast_tffm_tpu.
"""
