"""SAM text output: the port's copy of fem_tpu/io/sam.py.

Produces records byte-equivalent to the reference's htslib path: the
reference fills a bam1_t by hand (src/align.c:546-632) and writes text SAM
via sam_write1 (src/output_queue.c:83). Field semantics reproduced here:

  QNAME  read name
  FLAG   0 or 16 (reverse), | 256 for secondary records (src/align.c:82-84)
  RNAME  reference sequence name
  POS    1-based mapping start
  MAPQ   255 (hardcoded, src/align.c:81)
  CIGAR  M/I/D ops only (src/align.c:470-496)
  RNEXT  "*"  (mtid = -1, src/align.c:573)
  PNEXT  0    (mpos = -1)
  TLEN   0
  SEQ    nt16-canonicalized read chars for the primary record; "*" for
         secondary records (l_qseq = 0, src/align.c:85). NOTE: the
         reference stores the *forward* read sequence even for
         reverse-strand mappings (src/align.c:79); reproduced faithfully.
  QUAL   original quality string; "*" for secondary records
  tags   NM:i:<edit distance>  MD:Z:<md>  (src/align.c:630-631)

The device engine's records come from the native emitter
(native/src/emit.cpp); `format_record` serves the golden oracle. One
change to the copy: `SamWriter.tell()` also flushes the file object, so
the offset it returns (a checkpoint's) is in the file.
"""

from __future__ import annotations

from typing import IO, List, Sequence

import numpy as np

FLAG_REVERSE = 16
FLAG_SECONDARY = 256

# htslib seq_nt16 mapping for the characters that occur in real data;
# everything unlisted canonicalizes to 'N' (nibble 15).
_NT16_CHARS = b"=ACMGRSVTWYHKDBN"
_CHAR_TO_NT16 = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(_NT16_CHARS):
    _CHAR_TO_NT16[_c] = _i
    _CHAR_TO_NT16[ord(chr(_c).lower())] = _i
_CHAR_TO_NT16[ord("U")] = 8
_CHAR_TO_NT16[ord("u")] = 8

_CANON = np.frombuffer(_NT16_CHARS, dtype=np.uint8)


def canonicalize_seq(seq: bytes) -> bytes:
    """Round-trip a read through the 4-bit nt16 encoding like htslib does
    (bam_set_seqi on write, seq_nt16_str on print)."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return _CANON[_CHAR_TO_NT16[arr]].tobytes()


_CIGAR_OPS = b"MIDNSHP=X"


def cigar_to_bytes(ops: Sequence[tuple[int, int]]) -> bytes:
    """ops: sequence of (op_code, length) with op codes per BAM (M=0,I=1,D=2)."""
    return b"".join(b"%d%c" % (n, _CIGAR_OPS[op]) for op, n in ops)


def sam_header_text(names: Sequence[bytes], lengths: Sequence[int]) -> bytes:
    """@SQ-only header, matching output_sam_header (src/output_queue.c:93-116)."""
    return b"".join(
        b"@SQ\tSN:%s\tLN:%d\n" % (n, int(l)) for n, l in zip(names, lengths)
    )


def format_record(
    qname: bytes,
    flag: int,
    rname: bytes,
    pos0: int,
    cigar: bytes,
    seq: bytes,
    qual: bytes,
    edit_distance: int,
    md: bytes,
    secondary: bool,
) -> bytes:
    if secondary:
        flag |= FLAG_SECONDARY
        seq_field = b"*"
        qual_field = b"*"
    else:
        seq_field = canonicalize_seq(seq) if seq else b"*"
        qual_field = qual if qual else b"*"
    return b"\t".join(
        (
            qname,
            b"%d" % flag,
            rname,
            b"%d" % (pos0 + 1),
            b"255",
            cigar,
            b"*",
            b"0",
            b"0",
            seq_field,
            qual_field,
            b"NM:i:%d" % edit_distance,
            b"MD:Z:%s" % md,
        )
    ) + b"\n"


class SamWriter:
    """Buffered SAM text writer (single stream per host shard)."""

    def __init__(self, path_or_file: str | IO[bytes], names: Sequence[bytes], lengths: Sequence[int]):
        if isinstance(path_or_file, str):
            self._f: IO[bytes] = open(path_or_file, "wb")
            self._owned = True
        else:
            self._f = path_or_file
            self._owned = False
        self._buf: List[bytes] = []
        self._buf_bytes = 0
        self._f.write(sam_header_text(names, lengths))

    def write_record(self, record: bytes) -> None:
        self._buf.append(record)
        self._buf_bytes += len(record)
        # Byte-based flush threshold: a record may be one read's line or a
        # whole batch's blob (the native emitter and the shadow-warm CPU
        # path return per-batch blobs) — an item-count threshold held
        # megabytes in memory until close.
        if len(self._buf) >= 4096 or self._buf_bytes >= (1 << 20):
            self.flush()

    def flush(self) -> None:
        if self._buf:
            self._f.write(b"".join(self._buf))
            self._buf.clear()
            self._buf_bytes = 0

    def tell(self) -> int:
        """Byte offset of the flushed stream (checkpoint bookkeeping). The
        file object is flushed too, so that a process killed right after
        the checkpoint leaves at least this many bytes in the file."""
        self.flush()
        self._f.flush()
        return self._f.tell()

    def close(self) -> None:
        self.flush()
        if self._owned:
            self._f.close()

    def __enter__(self) -> "SamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
