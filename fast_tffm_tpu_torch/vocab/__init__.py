"""Vocabulary management — frequency-gated admission over an unbounded
hashed id space (``vocab_mode = admit``; the JAX package's
``fast_tffm_tpu/vocab/``, README "Unbounded vocabulary").

``vocab_mode = fixed`` (the default): feature ids mod straight into a
table of ``vocabulary_size`` rows. ``vocab_mode = admit``: ids hash into
``sketch.HASH_SPACE`` and a host-side slot map gives the ids whose
sketched frequency crossed ``vocab_admit_threshold`` private physical
rows, while every other id shares the cold row 0. The table stays
``vocabulary_size`` rows and batch shapes never change.

- ``vocab/sketch.py`` — the count-min frequency sketch (host numpy).
- ``vocab/table.py``  — the slot map, the batch remap seam, the
  admission/eviction barrier and the in-place row reset.
"""

from fast_tffm_tpu_torch.vocab.sketch import HASH_SPACE, CountMinSketch
from fast_tffm_tpu_torch.vocab.table import (COLD_ROW, VocabMap,
                                             VocabRuntime, payload_crc_ok)

__all__ = ["HASH_SPACE", "COLD_ROW", "CountMinSketch", "VocabMap",
           "VocabRuntime", "payload_crc_ok"]
