"""fast_tffm_tpu_torch — the PyTorch/CUDA port of fast_tffm_tpu.

A second package beside the JAX one, which stays the reference. This
slice serves and predicts a 2nd-order FM with logistic loss from the
dense ``<model_file>.npz`` export; every score runs through the
hand-written CUDA kernel in ``csrc/fm_score.cu`` on the card:

    python -m fast_tffm_tpu_torch predict <cfg> [--device cuda|cpu]
    python -m fast_tffm_tpu_torch serve   <cfg> [--device cuda|cpu]

It imports torch and numpy, never jax and nothing of fast_tffm_tpu.
"""
