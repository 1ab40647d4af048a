"""Base encoding.

Semantics match the reference 2-bit tables (src/utils.h:72-81):
A/a -> 0, C/c -> 1, G/g -> 2, T/t -> 3, anything else -> 4 (ambiguous).
Decoding maps 0..3 to ACGT and >=4 to 'N'.

Reverse complement follows src/sequence_batch.h:90-98: complement is
``3 ^ code`` for unambiguous bases; ambiguous bases decode to 'N' after the
XOR (3 ^ 4 = 7 -> 'N'), so N stays N.

The port's copy of fem_tpu/core/encoding.py.
"""

from __future__ import annotations

import numpy as np

BASE_A = np.uint8(0)
BASE_AMBIG = np.uint8(4)

# char -> code table (identical mapping to src/utils.h:72).
CHAR_TO_CODE = np.full(256, 4, dtype=np.uint8)
for _c, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    CHAR_TO_CODE[ord(_c)] = _v
    CHAR_TO_CODE[ord(_c.lower())] = _v

# code -> char table (src/utils.h:73: indices 4..7 are all 'N').
CODE_TO_CHAR = np.frombuffer(b"ACGTNNNN", dtype=np.uint8).copy()


def encode(seq: bytes | str | np.ndarray) -> np.ndarray:
    """Encode an ASCII sequence into uint8 codes 0..4."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return CHAR_TO_CODE[arr]


def decode(codes: np.ndarray) -> str:
    """Decode uint8 codes back to an ASCII string (>=4 becomes 'N')."""
    return CODE_TO_CHAR[np.minimum(codes, 7)].tobytes().decode("ascii")


def reverse_complement_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement encoded bases; 3 ^ code, reversed.

    For ambiguous input (code 4) the reference produces char 'N' which
    re-encodes to 4, so we clamp 3^4=7 back to 4 to keep codes canonical.
    """
    rc = (3 ^ codes[::-1]).astype(np.uint8)
    return np.where(rc > 3, BASE_AMBIG, rc)
