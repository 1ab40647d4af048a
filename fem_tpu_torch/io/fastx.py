"""FASTA/FASTQ input.

Behavioral equivalent of the reference's kseq-based sequence loading
(src/sequence_batch.c:30-121, src/kseq.h:185-242): gzip-capable streaming,
record name cut at first whitespace, multi-line sequences concatenated.

The reference streams reads in batches of up to 10,000 records through a
bounded ring buffer (src/FEM_map.c:150-152, src/input_queue.c). Here a
generator yields `ReadBatch` objects; the engine overlaps parsing with
device compute.

The port's copy of fem_tpu/io/fastx.py.
"""

from __future__ import annotations

import dataclasses
import functools
import gzip
import io
from typing import Iterator, List

import numpy as np

from fem_tpu_torch.core.encoding import CHAR_TO_CODE, encode
from fem_tpu_torch.utils.metrics import span


@dataclasses.dataclass
class FastxRecord:
    name: bytes
    seq: bytes
    qual: bytes | None = None
    comment: bytes | None = None


class ReadBatch:
    """A fixed-size batch of reads, host-side.

    `seqs`/`names`/`quals` are raw bytes (needed for SAM emission and
    char-exact traceback); `codes` is the padded uint8 code matrix fed to
    the device, with `lengths` carrying true read lengths.

    Batches from the native C++ reader instead carry flat blobs with
    offsets (plus `packed`, the ready-to-upload buffer, a uint8 tensor);
    the list views materialize lazily so fallback paths keep working.
    """

    def __init__(
        self,
        names: List[bytes] | None = None,
        seqs: List[bytes] | None = None,
        quals: List[bytes] | None = None,
        codes: np.ndarray | None = None,
        lengths: np.ndarray | None = None,
        packed: "torch.Tensor | None" = None,
        names_blob: bytes | None = None,
        name_offsets: np.ndarray | None = None,
        seqs_blob: bytes | None = None,
        seq_offsets: np.ndarray | None = None,
        quals_blob: bytes | None = None,
        num_reads: int | None = None,
    ):
        self._names = names
        self._seqs = seqs
        self._quals = quals
        self.codes = codes
        self.lengths = lengths
        self.packed = packed
        self.names_blob = names_blob
        self.name_offsets = name_offsets
        self.seqs_blob = seqs_blob
        self.seq_offsets = seq_offsets
        self.quals_blob = quals_blob
        self._num_reads = num_reads if num_reads is not None else len(seqs or ())

    @property
    def num_reads(self) -> int:
        return self._num_reads

    @staticmethod
    def _split(blob: bytes, offsets: np.ndarray, n: int) -> List[bytes]:
        return [bytes(blob[offsets[i] : offsets[i + 1]]) for i in range(n)]

    @property
    def names(self) -> List[bytes]:
        if self._names is None:
            self._names = self._split(self.names_blob, self.name_offsets, self._num_reads)
        return self._names

    @property
    def seqs(self) -> List[bytes]:
        if self._seqs is None:
            self._seqs = self._split(self.seqs_blob, self.seq_offsets, self._num_reads)
        return self._seqs

    @property
    def quals(self) -> List[bytes]:
        if self._quals is None:
            self._quals = self._split(self.quals_blob, self.seq_offsets, self._num_reads)
        return self._quals

    @property
    def has_blobs(self) -> bool:
        return self.names_blob is not None


def _open(path: str) -> io.BufferedReader:
    f = open(path, "rb")
    magic = f.peek(2)[:2]
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))  # type: ignore[arg-type]
    return f


def _split_name(header: bytes) -> tuple[bytes, bytes | None]:
    for i, b in enumerate(header):
        if b in (0x20, 0x09):
            return header[:i], header[i + 1 :]
    return header, None


def iter_fastx(path: str) -> Iterator[FastxRecord]:
    """Iterate records of a (possibly gzipped) FASTA or FASTQ file."""
    with _open(path) as f:
        first = f.peek(1)[:1]
        if first == b">":
            yield from _iter_fasta(f)
        elif first == b"@":
            yield from _iter_fastq(f)
        elif first == b"":
            return
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def _iter_fasta(f: io.BufferedReader) -> Iterator[FastxRecord]:
    name: bytes | None = None
    comment: bytes | None = None
    chunks: List[bytes] = []
    for line in f:
        line = line.rstrip(b"\r\n")
        if line.startswith(b">"):
            if name is not None:
                yield FastxRecord(name, b"".join(chunks), None, comment)
            name, comment = _split_name(line[1:])
            chunks = []
        else:
            chunks.append(line)
    if name is not None:
        yield FastxRecord(name, b"".join(chunks), None, comment)


def _iter_fastq(f: io.BufferedReader) -> Iterator[FastxRecord]:
    while True:
        header = f.readline()
        if not header:
            return
        header = header.rstrip(b"\r\n")
        if not header:
            continue
        if not header.startswith(b"@"):
            raise ValueError(f"malformed FASTQ header: {header!r}")
        name, comment = _split_name(header[1:])
        seq_chunks: List[bytes] = []
        line = f.readline()
        while line and not line.startswith(b"+"):
            seq_chunks.append(line.rstrip(b"\r\n"))
            line = f.readline()
        seq = b"".join(seq_chunks)
        qual_chunks: List[bytes] = []
        qlen = 0
        while qlen < len(seq):
            line = f.readline()
            if not line:
                break
            line = line.rstrip(b"\r\n")
            qual_chunks.append(line)
            qlen += len(line)
        yield FastxRecord(name, seq, b"".join(qual_chunks), comment)


@dataclasses.dataclass
class Reference:
    """A fully loaded reference, equivalent of the all-sequences batch
    (src/sequence_batch.c:82-121) plus a flat layout for the device.

    `flat_codes` concatenates every chromosome's codes separated by
    `gap` sentinel bases (code 4) so windowed gathers near boundaries
    never cross into a neighboring chromosome.
    """

    names: List[bytes]
    seqs: List[bytes]  # raw chars, kept for char-exact traceback / MD tags
    lengths: np.ndarray  # (num_seqs,) int64
    offsets: np.ndarray  # (num_seqs,) int64 — offset of each seq in flat_codes
    flat_codes: np.ndarray  # (total,) uint8 with inter-sequence gaps of 4s

    @property
    def num_seqs(self) -> int:
        return len(self.seqs)

    def codes_of(self, i: int) -> np.ndarray:
        off = int(self.offsets[i])
        return self.flat_codes[off : off + int(self.lengths[i])]

    @functools.cached_property
    def seqs_blob(self) -> tuple[bytes, np.ndarray]:
        """Every sequence joined into one bytes object, and its offsets:
        made once and shared by the native emitter and host mapper (3 GB
        at GRCh38 scale)."""
        return blob(self.seqs)


def seqs_blob(reference) -> tuple[bytes, np.ndarray]:
    """`reference.seqs` joined, and the offsets: kept by the port's
    Reference (Reference.seqs_blob); made anew for a reference of another
    type with the same fields."""
    return reference.seqs_blob if isinstance(reference, Reference) else blob(reference.seqs)


def blob(items: List[bytes]) -> tuple[bytes, np.ndarray]:
    """`items` joined into one bytes object, and the (n + 1,) int64
    offsets of each in it, as the native library takes them."""
    offsets = np.zeros(len(items) + 1, np.int64)
    np.cumsum([len(x) for x in items], out=offsets[1:])
    return b"".join(items), offsets


def _fasta_records(path: str) -> tuple[List[bytes], List[bytes]]:
    """Names and sequences of a FASTA file, as `iter_fastx` parses them,
    read whole: each record's lines are joined by one bytes.replace
    instead of a Python loop over its lines (a 3 Gb genome has ~38 M).
    A record holding a carriage return takes the line rules of
    `_iter_fasta` (strip trailing CR/LF a line); a file that is not FASTA
    goes through `iter_fastx`."""
    with _open(path) as f:
        if f.peek(1)[:1] != b">":
            recs = list(iter_fastx(path))
            return [r.name for r in recs], [r.seq for r in recs]
        data = f.read()
    names: List[bytes] = []
    seqs: List[bytes] = []
    start, n = 0, len(data)
    while start < n:  # data[start] is the '>' of a header line
        eol = data.find(b"\n", start)
        eol = n if eol < 0 else eol
        names.append(_split_name(data[start + 1 : eol].rstrip(b"\r\n"))[0])
        nxt = data.find(b"\n>", eol)
        end = n if nxt < 0 else nxt + 1
        body = data[eol + 1 : end]
        if b"\r" in body:
            seqs.append(b"".join(line.rstrip(b"\r\n") for line in body.split(b"\n")))
        else:
            seqs.append(body.replace(b"\n", b""))
        start = end
    return names, seqs


def read_fasta(path: str, gap: int = 256) -> Reference:
    names, seqs = _fasta_records(path)
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    offsets = np.zeros(len(seqs), dtype=np.int64)
    pos = gap
    for i, n in enumerate(lengths):
        offsets[i] = pos
        pos += int(n) + gap
    flat = np.full(pos, 4, dtype=np.uint8)
    codes = CHAR_TO_CODE.tobytes()  # encode() as one bytes.translate
    for i, s in enumerate(seqs):
        off = int(offsets[i])
        flat[off : off + len(s)] = np.frombuffer(s.translate(codes), np.uint8)
    return Reference(names, seqs, lengths, offsets, flat)


def _probe_fastq(path: str) -> bool:
    try:
        with _open(path) as f:
            return f.peek(1)[:1] == b"@"
    except Exception:
        return False


def stream_fastq_batches(
    path: str,
    batch_size: int = 10000,
    pad_to_multiple: int = 32,
    use_native: bool | None = None,
) -> Iterator[ReadBatch]:
    """Yield fixed-size read batches (default 10,000 reads, matching the
    reference batch geometry src/FEM_map.c:151).

    FASTQ parses through the native C++ reader (single C call per batch
    producing the device upload buffer directly); FASTA and exotic records
    (reads > 508 bp, very long names) go to the Python parser, resuming
    exactly where the native stream stopped. A native library that does
    not build raises; `use_native=False` asks for the Python parser. Each
    batch's parse is a `fem::parse` span on the thread that reads."""
    batches = _fastq_batches(path, batch_size, pad_to_multiple, use_native)
    try:
        while True:
            with span("fem::parse") as sp:
                batch = next(batches, None)
                sp.tag(reads=batch and batch.num_reads)
            if batch is None:
                return
            yield batch
    finally:
        batches.close()


def _fastq_batches(path: str, batch_size: int, pad_to_multiple: int,
                   use_native: bool | None) -> Iterator[ReadBatch]:
    import os

    yielded = 0
    if use_native is None:
        use_native = os.environ.get("FEM_TPU_NO_NATIVE", "") != "1"
    if use_native and _probe_fastq(path):
        from fem_tpu_torch.native.reader import (
            NativeReadError,
            stream_fastq_batches_native,
        )

        try:
            for b in stream_fastq_batches_native(
                path, batch_size, pad_to_multiple=pad_to_multiple
            ):
                yield b
                yielded += b.num_reads
            return
        except NativeReadError:
            pass  # python fallback resumes after `yielded` reads

    names: List[bytes] = []
    seqs: List[bytes] = []
    quals: List[bytes] = []
    skip = yielded
    for rec in iter_fastx(path):
        if skip:
            skip -= 1
            continue
        names.append(rec.name)
        seqs.append(rec.seq)
        quals.append(rec.qual if rec.qual is not None else b"I" * len(rec.seq))
        if len(seqs) == batch_size:
            yield _finalize_batch(names, seqs, quals, pad_to_multiple)
            names, seqs, quals = [], [], []
    if seqs:
        yield _finalize_batch(names, seqs, quals, pad_to_multiple)


def _finalize_batch(
    names: List[bytes], seqs: List[bytes], quals: List[bytes], pad_to_multiple: int
) -> ReadBatch:
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    max_len = int(lengths.max()) if len(seqs) else 0
    max_len = -(-max_len // pad_to_multiple) * pad_to_multiple
    codes = np.full((len(seqs), max_len), 4, dtype=np.uint8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode(s)
    return ReadBatch(names, seqs, quals, codes, lengths)
