"""Feature-id hashing — MurmurHash64A, bit-identical in Python and C++.

The reference hashes string feature ids to table rows when
``hash_feature_id`` is on (SURVEY.md §2 ``fm_parser`` row; exact upstream
hash is [M]-confidence murmur-family). This framework fixes the hash to
MurmurHash64A with seed 0, implemented twice — here (reference/oracle) and
in ``_parser.cc`` (throughput) — with golden tests pinning both to the same
values so a model trained by either parser is usable by the other.

A copy of ``fast_tffm_tpu/data/hashing.py``: the port hashes string ids
to the same rows, so an exported table scores the same lines in both.
"""

from __future__ import annotations

_M = 0xC6A4A7935BD1E995
_R = 47
_MASK = (1 << 64) - 1

SEED = 0


def murmur64(data: bytes, seed: int = SEED) -> int:
    """MurmurHash64A (Austin Appleby's 64-bit variant, little-endian)."""
    h = (seed ^ ((len(data) * _M) & _MASK)) & _MASK
    nblocks = len(data) // 8
    for i in range(nblocks):
        k = int.from_bytes(data[i * 8:(i + 1) * 8], "little")
        k = (k * _M) & _MASK
        k ^= k >> _R
        k = (k * _M) & _MASK
        h ^= k
        h = (h * _M) & _MASK
    tail = data[nblocks * 8:]
    if tail:
        h ^= int.from_bytes(tail, "little")
        h = (h * _M) & _MASK
    h ^= h >> _R
    h = (h * _M) & _MASK
    h ^= h >> _R
    return h


def hash_feature(fid: str, vocabulary_size: int) -> int:
    """String feature id -> row index in [0, vocabulary_size)."""
    return murmur64(fid.encode("utf-8")) % vocabulary_size
