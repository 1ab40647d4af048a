"""SAM text header.

The records themselves are written by the native emitter
(native/src/emit.cpp); this module holds the @SQ header and the strand flag.
The port's copy of that part of fem_tpu/io/sam.py; the record formatter and
the buffered writer come with the command line.
"""

from __future__ import annotations

from typing import Sequence

FLAG_REVERSE = 16


def sam_header_text(names: Sequence[bytes], lengths: Sequence[int]) -> bytes:
    """@SQ-only header, matching output_sam_header (src/output_queue.c:93-116)."""
    return b"".join(
        b"@SQ\tSN:%s\tLN:%d\n" % (n, int(l)) for n, l in zip(names, lengths)
    )
