"""The golden scalar model of FEM's mapping, frozen for the benchmark.

A copy of the port's golden oracle (fem_tpu_torch/golden/model.py), made
self-contained: the few types it took from the package (the mapping
parameters, the base codes, the SAM record format, the counters) are
copied below, so this folder imports nothing of the program. Two changes
to the copy: a mapper takes the reference as (names, seqs, lengths) and
the index as any object with `lookup`, `occurrences` and
`num_occurrences`; and the reference's codes are made per mapping from its
chars (`_codes_at`), not for the whole genome at once, so that records of
a few reads against a 3 Gb genome cost no 3 GB copy.

A deliberately literal, readable Python implementation of the reference
mapping semantics. Every function cites the reference behavior it
reproduces (FEM's sources, src/...).

Pipeline per read (src/map.c:27-55):
  for each strand: group-seeding candidates (src/filter.c:146-223) ->
  banded Myers verification (src/align.c:4-51,102-147) ; then mapping sort +
  traceback + SAM records (src/align.c:56-92,279-544).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FemArgs:
    """FEM's mapping parameters (src/utils.h:63-70)."""

    kmer_size: int = 12
    step_size: int = 3
    error_threshold: int = 2
    num_additional_qgrams: int = 1

    @property
    def num_qgrams(self) -> int:
        """Seeds selected per group: e + 1 + a (src/filter.c:194,204)."""
        return self.error_threshold + 1 + self.num_additional_qgrams

    @property
    def seed_span_in_group(self) -> int:
        """Seed footprint in group coordinates: ceil(k/step) (src/filter.c:162-165)."""
        return -(-self.kmer_size // self.step_size)


@dataclasses.dataclass
class MappingStats:
    """The five self-reported counters (src/utils.h:55-61)."""

    num_reads: int = 0
    num_mapped_reads: int = 0
    num_candidates_without_additional_qgram_filter: int = 0
    num_candidates: int = 0
    num_mappings: int = 0

    def __iadd__(self, other: "MappingStats") -> "MappingStats":
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))
        return self


# char -> code (src/utils.h:72): A/C/G/T either case -> 0..3, else 4.
CHAR_TO_CODE = np.full(256, 4, dtype=np.uint8)
for _c, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    CHAR_TO_CODE[ord(_c)] = _v
    CHAR_TO_CODE[ord(_c.lower())] = _v

FLAG_REVERSE = 16
FLAG_SECONDARY = 256
_CIGAR_OPS = b"MIDNSHP=X"
# htslib's seq_nt16 round trip (bam_set_seqi, seq_nt16_str): unlisted -> N.
_NT16_CHARS = b"=ACMGRSVTWYHKDBN"
_CHAR_TO_NT16 = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(_NT16_CHARS):
    _CHAR_TO_NT16[_c] = _i
    _CHAR_TO_NT16[ord(chr(_c).lower())] = _i
_CHAR_TO_NT16[ord("U")] = 8
_CHAR_TO_NT16[ord("u")] = 8
_CANON = np.frombuffer(_NT16_CHARS, dtype=np.uint8)


def canonicalize_seq(seq: bytes) -> bytes:
    return _CANON[_CHAR_TO_NT16[np.frombuffer(seq, dtype=np.uint8)]].tobytes()


def cigar_to_bytes(ops: Sequence[tuple[int, int]]) -> bytes:
    """ops: (op_code, length) with BAM op codes (M=0, I=1, D=2)."""
    return b"".join(b"%d%c" % (n, _CIGAR_OPS[op]) for op, n in ops)


def format_record(qname: bytes, flag: int, rname: bytes, pos0: int, cigar: bytes,
                  seq: bytes, qual: bytes, edit_distance: int, md: bytes,
                  secondary: bool) -> bytes:
    """One SAM line as FEM's htslib path prints it (src/align.c:546-632):
    MAPQ 255, no mate, SEQ and QUAL '*' on secondary records, NM and MD."""
    if secondary:
        flag |= FLAG_SECONDARY
        seq_field = qual_field = b"*"
    else:
        seq_field = canonicalize_seq(seq) if seq else b"*"
        qual_field = qual if qual else b"*"
    return b"\t".join((qname, b"%d" % flag, rname, b"%d" % (pos0 + 1), b"255", cigar,
                        b"*", b"0", b"0", seq_field, qual_field,
                        b"NM:i:%d" % edit_distance, b"MD:Z:%s" % md)) + b"\n"


@dataclasses.dataclass
class Genome:
    """A reference as the golden model reads it: names, raw chars, lengths."""

    names: List[bytes]
    seqs: List[bytes]
    lengths: np.ndarray


_U32 = 0xFFFFFFFF


def read_strands(
    seq: bytes,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(read_chars, read_codes, neg_chars, neg_codes) for a read.

    Negative-strand chars use the reference's char-space reverse complement
    (src/sequence_batch.h:90-98): uint8_to_char(3 ^ code), reversed —
    ambiguous bases become literal 'N' chars on the negative strand.
    """
    read_chars = np.frombuffer(seq, dtype=np.uint8)
    read_codes = CHAR_TO_CODE[read_chars]
    neg_codes_raw = (3 ^ read_codes[::-1]).astype(np.uint8)
    neg_chars = np.frombuffer(b"ACGTNNNN", dtype=np.uint8)[np.minimum(neg_codes_raw, 7)]
    neg_codes = CHAR_TO_CODE[neg_chars]
    return read_chars, read_codes, neg_chars, neg_codes


@dataclasses.dataclass
class GoldenMapping:
    """Equivalent of the packed Mapping record (src/utils.h:44-49)."""

    direction: int  # 0 positive, 1 negative
    edit_distance: int
    candidate_position: int  # seqid << 32 | band start position (u64)
    end_position_offset: int

    def sort_key(self) -> int:
        # src/align.c:53: ED<<60 | direction<<59 | (position + end offset)
        return (
            (self.edit_distance << 60)
            | (self.direction << 59)
            | ((self.candidate_position + self.end_position_offset) & ((1 << 59) - 1))
        )


@dataclasses.dataclass
class _Seed:
    """Seed record (src/utils.h:119-124)."""

    hash_value: int
    start_position: int
    num_positions: int


def hash_all_seeds(read_codes: np.ndarray, kmer_size: int) -> Tuple[np.ndarray, int]:
    """All (L-k+1) rolling seed hashes + ambiguous-base count.

    Matches hash_all_seeds_in_sequence (src/utils.h:101-117): ambiguous
    bases hash as A, and the ambiguity counter counts ambiguous bases at
    read positions [k, L-1] (bases entering after the first window).
    """
    num_seeds = read_codes.shape[0] - kmer_size + 1
    c4 = np.where(read_codes > 3, 0, read_codes).astype(np.int64)
    weights = 1 << (2 * np.arange(kmer_size - 1, -1, -1, dtype=np.int64))
    windows = np.lib.stride_tricks.sliding_window_view(c4, kmer_size)[:num_seeds]
    hashes = (windows @ weights).astype(np.uint32)
    num_ambiguous = int(np.count_nonzero(read_codes[kmer_size:] > 3))
    return hashes, num_ambiguous


def select_optimal_prefix_qgrams(
    args: FemArgs,
    occurrence_table_size: int,
    seed_span: int,
    num_seeds_in_group: int,
    frequencies: Sequence[int],
) -> Tuple[int, List[int]]:
    """Optimal non-overlapping prefix q-gram DP + traceback
    (src/filter.c:3-43). Returns (min total frequency, selected positions
    in traceback order: decreasing position). Arithmetic is u32-wrapping,
    as in the reference's uint32 DP matrix.
    """
    num_rows = args.num_qgrams + 1
    num_cols = num_seeds_in_group - args.num_qgrams * seed_span + 2
    if num_cols < 2:
        # Degenerate group: the reference's DP loops don't run, its
        # traceback stops immediately at D[r][0]==3 selecting zero seeds,
        # and M[rows-1][0] == occurrence_table_size feeds the pre-filter
        # counter — but it then merges *uninitialized* Seed structs (C UB,
        # src/filter.c:193-208). Defined behavior here: report the counter
        # the reference reports and contribute no candidates.
        return occurrence_table_size & _U32, []
    M = np.zeros((num_rows, num_cols), dtype=np.uint32)
    D = np.full((num_rows, num_cols), 3, dtype=np.uint8)
    M[1:, 0] = np.uint32(occurrence_table_size & _U32)
    M[0, 1:] = 0
    for row in range(1, num_rows):
        for col in range(1, num_cols):
            position = col + (row - 1) * seed_span - 1
            with_new = np.uint32(
                (int(M[row - 1, col]) + frequencies[position]) & _U32
            )
            if with_new < M[row, col - 1]:
                M[row, col] = with_new
                D[row, col] = 2
            else:
                M[row, col] = M[row, col - 1]
                D[row, col] = 1
    selected: List[int] = []
    row, col = num_rows - 1, num_cols - 1
    while D[row, col] != 3:
        if D[row, col] == 2:
            selected.append(col + (row - 1) * seed_span - 1)
            row -= 1
        else:
            col -= 1
    return int(M[num_rows - 1, num_cols - 1]), selected


def _merge_candidate_locations(
    index, seeds: List[_Seed]
) -> List[int]:
    """k-way merge of occurrence lists into diagonal-normalized positions
    (src/filter.c:80-116). Reproduces two quirks exactly: occurrences whose
    in-chromosome position precedes the seed's start are skipped
    (src/filter.c:89-90), and the *last* seed's tail — positions beyond the
    final element of the previously merged buffer — is dropped (loop
    condition at src/filter.c:85).
    """
    buffer1: List[int] = []
    for si, seed in enumerate(seeds):
        occs = index.occurrences_of(seed.hash_value)
        buffer2: List[int] = []
        i1 = 0
        io = 0
        is_last = si == len(seeds) - 1
        while i1 < len(buffer1) or ((not is_last) and io < seed.num_positions):
            if i1 < len(buffer1):
                b1p = buffer1[i1]
                if io < seed.num_positions:
                    occ = int(occs[io])
                    if (occ & _U32) < seed.start_position:
                        io += 1
                    else:
                        seed_position = occ - seed.start_position
                        if seed_position <= b1p:
                            buffer2.append(seed_position)
                            io += 1
                        else:
                            buffer2.append(b1p)
                            i1 += 1
                else:
                    buffer2.append(b1p)
                    i1 += 1
            else:
                occ = int(occs[io])
                if (occ & _U32) >= seed.start_position:
                    buffer2.append(occ - seed.start_position)
                io += 1
        buffer1 = buffer2
    return buffer1


def _additional_qgram_filter(args: FemArgs, buffer: List[int]) -> List[int]:
    """Pigeonhole vote (src/filter.c:118-131): keep position p only if more
    than `num_additional_qgrams` merged positions fall in [p, p+e]."""
    out: List[int] = []
    e = args.error_threshold
    a = args.num_additional_qgrams
    n = len(buffer)
    for ci in range(n):
        in_range = 1
        while ci + in_range < n and buffer[ci + in_range] <= buffer[ci] + e:
            in_range += 1
            if in_range > a:
                break
        if in_range > a:
            out.append(buffer[ci])
    return out


def _merge_dedup(args: FemArgs, buffer1: List[int], buffer2: List[int]) -> List[int]:
    """Sorted merge of two candidate lists with greedy +-e dedup
    (src/filter.c:45-78): an element is kept only if it exceeds the last
    kept element by more than the error threshold."""
    e = args.error_threshold
    out: List[int] = []
    i1 = i2 = 0
    while i1 < len(buffer1) or i2 < len(buffer2):
        if i1 < len(buffer1) and (
            i2 >= len(buffer2) or buffer1[i1] < buffer2[i2]
        ):
            v = buffer1[i1]
            i1 += 1
        else:
            v = buffer2[i2]
            i2 += 1
        if not out or v > out[-1] + e:
            out.append(v)
    return out


class GoldenMapper:
    def __init__(self, args: FemArgs, reference: Genome, index):
        self.args = args
        self.reference = reference
        self.index = index
        # Raw chromosome chars as uint8 (for char-exact traceback and MD).
        self._ref_chars = [np.frombuffer(s, dtype=np.uint8) for s in reference.seqs]

    def _codes_at(self, sid: int, start: int, stop: int) -> np.ndarray:
        """Codes of chromosome `sid`'s chars [start, stop)."""
        return CHAR_TO_CODE[self._ref_chars[sid][start:stop]]

    # ----------------------------------------------------------------- filter

    def generate_candidates(
        self, read_codes: np.ndarray
    ) -> Tuple[List[int], int]:
        """Group-seeding candidate generation
        (generate_group_seeding_candidates, src/filter.c:146-223).
        Returns (candidate band starts as u64 seqid<<32|pos, DP total)."""
        args = self.args
        read_length = read_codes.shape[0]
        seed_span = args.seed_span_in_group
        num_seeds_in_read = read_length - args.kmer_size + 1
        assert num_seeds_in_read > 0
        min_group = num_seeds_in_read // args.step_size
        if args.num_qgrams > min_group:
            return [], 0  # read too short (src/filter.c:166-172)
        hashes, num_ambiguous = hash_all_seeds(read_codes, args.kmer_size)
        if num_ambiguous > args.error_threshold:
            return [], 0  # too many ambiguous bases (src/filter.c:180-182)

        lookup = self.index.lookup
        dp_total = 0
        candidates: List[int] = []
        for si in range(args.step_size):
            num_in_group = (num_seeds_in_read - si) // args.step_size
            group_positions = si + args.step_size * np.arange(num_in_group)
            group_hashes = hashes[group_positions]
            freqs = (
                lookup[group_hashes.astype(np.int64) + 1]
                - lookup[group_hashes.astype(np.int64)]
            ).astype(np.int64)
            total, picked = select_optimal_prefix_qgrams(
                args,
                self.index.num_occurrences,
                seed_span,
                num_in_group,
                freqs,
            )
            dp_total += total
            if len(picked) < args.num_qgrams:
                continue  # degenerate group (see select_optimal_prefix_qgrams)
            seeds = [
                _Seed(
                    hash_value=int(group_hashes[p]),
                    start_position=int(group_positions[p]),
                    num_positions=int(freqs[p]),
                )
                for p in picked
            ]
            # Stable sort by frequency (qsort with a 3-way comparator on
            # num_positions, src/filter.c:204 + src/utils.h:126-136; glibc's
            # qsort is a stable merge sort in practice).
            seeds.sort(key=lambda s: s.num_positions)
            merged = _merge_candidate_locations(self.index, seeds)
            survivors = _additional_qgram_filter(args, merged)
            candidates = _merge_dedup(args, candidates, survivors)

        # Range filter + band-start shift (src/filter.c:133-144).
        out: List[int] = []
        e = args.error_threshold
        for c in candidates:
            sid = c >> 32
            rpos = c & _U32
            ref_len = int(self.reference.lengths[sid])
            assert rpos < ref_len
            if rpos >= e and rpos + read_length + e < ref_len:
                out.append(c - e)
        return out, dp_total

    # ----------------------------------------------------------------- verify

    def banded_edit_distance(
        self, pattern_codes: np.ndarray, text_codes: np.ndarray
    ) -> Tuple[int, Optional[int]]:
        """Scalar banded Myers bit-parallel edit distance
        (src/align.c:102-147). Returns (min ED, end position) or
        (e+1, None) when the 3e early-exit bound triggers."""
        e = self.args.error_threshold
        Peq = [0, 0, 0, 0, 0]
        for i in range(2 * e):
            Peq[int(pattern_codes[i])] |= 1 << i
        hb = 1 << (2 * e)
        VP = VN = 0
        nerr = 0
        L = text_codes.shape[0]
        for i in range(L):
            Peq[int(pattern_codes[i + 2 * e])] |= hb
            X = Peq[int(text_codes[i])] | VN
            D0 = ((((VP + (X & VP)) & _U32) ^ VP) | X) & _U32
            HN = VP & D0
            HP = (VN | ~(VP | D0)) & _U32
            X = D0 >> 1
            VN = X & HP
            VP = (HN | ~(X | HP)) & _U32
            nerr += 1 - (D0 & 1)
            if nerr > 3 * e:
                return e + 1, None
            for a in range(5):
                Peq[a] >>= 1
        end = L - 1
        min_err = nerr
        for i in range(2 * e):
            nerr += (VP >> i) & 1
            nerr -= (VN >> i) & 1
            if nerr < min_err:
                min_err = nerr
                end = L - 1 + 1 + i
        return min_err, end

    def verify_candidates(
        self,
        read_codes: np.ndarray,
        direction: int,
        candidates: List[int],
        mappings: List[GoldenMapping],
    ) -> int:
        """Candidate verification (src/align.c:4-51). The SSE 8-lane split
        changes nothing observable — accepted mappings and their (ED, end)
        match the scalar path — so the golden model verifies serially."""
        e = self.args.error_threshold
        L = read_codes.shape[0]
        num = 0
        for cand in candidates:
            sid = cand >> 32
            start = cand & _U32
            pattern = self._codes_at(sid, start, start + L + 2 * e)
            ed, end = self.banded_edit_distance(pattern, read_codes)
            if ed <= e:
                mappings.append(GoldenMapping(direction, ed, cand, int(end)))
                num += 1
        return num

    # -------------------------------------------------------------- traceback

    def generate_alignment(
        self,
        pattern_chars: np.ndarray,
        pattern_codes: np.ndarray,
        text_chars: np.ndarray,
        text_codes: np.ndarray,
        mapping_edit_distance: int,
        mapping_end_position: int,
    ) -> Tuple[int, List[Tuple[int, int]], bytes]:
        """CIGAR/MD traceback (generate_alignment, src/align.c:279-499).

        The DP runs on base codes, but match/mismatch classification and MD
        characters use the *raw chars* exactly as the reference does
        (src/align.c:290,345,377), so e.g. soft-masked lowercase reference
        bases behave identically.

        Returns (mapping start position relative to the band start, CIGAR
        ops [(bam_op, len)...] left-to-right, MD tag bytes).
        """
        e = self.args.error_threshold
        L = text_codes.shape[0]
        mapping_start_position = mapping_end_position - L + 1
        assert mapping_start_position >= 0
        window = pattern_chars[mapping_start_position : mapping_start_position + L]
        if int(np.count_nonzero(window != text_chars)) == 0:
            cigar = [(0, L)]  # a single L M op (src/align.c:294-299)
            md = self._generate_md(pattern_chars, text_chars, mapping_start_position, cigar)
            return mapping_start_position, cigar, md

        # Re-run the banded DP storing per-column D0/HP (src/align.c:303-338).
        D0s = np.zeros(L, dtype=np.uint32)
        HPs = np.zeros(L, dtype=np.uint32)
        Peq = [0, 0, 0, 0, 0]
        for i in range(2 * e):
            Peq[int(pattern_codes[i])] |= 1 << i
        hb = 1 << (2 * e)
        VP = VN = 0
        for i in range(L):
            Peq[int(pattern_codes[i + 2 * e])] |= hb
            X = Peq[int(text_codes[i])] | VN
            D0 = ((((VP + (X & VP)) & _U32) ^ VP) | X) & _U32
            HN = VP & D0
            HP = (VN | ~(VP | D0)) & _U32
            X = D0 >> 1
            VN = X & HP
            VP = (HN | ~(X | HP)) & _U32
            D0s[i] = D0
            HPs[i] = HP
            for a in range(5):
                Peq[a] >>= 1

        pattern_bit_position = mapping_end_position - L + 1
        text_position = L - 1
        num_errors = 0
        end = mapping_end_position

        def d0_bit() -> int:
            return (int(D0s[text_position]) >> pattern_bit_position) & 1

        def hp_bit() -> int:
            return (int(HPs[text_position]) >> pattern_bit_position) & 1

        # First (rightmost) column classification (src/align.c:345-368).
        if d0_bit() and pattern_chars[end] == text_chars[text_position]:
            text_position -= 1
            end -= 1
            pre_op, pre_n = "M", 1
        elif not d0_bit():
            assert pattern_chars[end] != text_chars[text_position]
            text_position -= 1
            end -= 1
            num_errors += 1
            pre_op, pre_n = "S", 1  # 'S' = substitution run, folded into M later
        elif d0_bit() and hp_bit():
            text_position -= 1
            pattern_bit_position += 1
            num_errors += 1
            pre_op, pre_n = "S", 1
            mapping_start_position += 1
        else:
            raise AssertionError("deletion cannot end the alignment")

        ops: List[str] = []
        lens: List[int] = []
        while text_position >= 0:
            if num_errors == mapping_edit_distance:
                break
            if d0_bit() and pattern_chars[end] == text_chars[text_position]:
                text_position -= 1
                end -= 1
                if pre_op != "M":
                    ops.append(pre_op)
                    lens.append(pre_n)
                    pre_op, pre_n = "M", 1
                else:
                    pre_n += 1
            elif not d0_bit():
                assert pattern_chars[end] != text_chars[text_position]
                text_position -= 1
                end -= 1
                num_errors += 1
                if pre_op == "S":
                    pre_n += 1
                elif pre_op != "M":
                    ops.append(pre_op)
                    lens.append(pre_n)
                    pre_op, pre_n = "M", 1
                else:
                    pre_n += 1
            elif d0_bit() and hp_bit():
                text_position -= 1
                pattern_bit_position += 1
                num_errors += 1
                if pre_op == "S":
                    pre_n += 1
                elif pre_op != "I":
                    ops.append(pre_op)
                    lens.append(pre_n)
                    pre_op, pre_n = "I", 1
                else:
                    pre_n += 1
                mapping_start_position += 1
            else:  # deletion
                pattern_bit_position -= 1
                end -= 1
                num_errors += 1
                if pre_op != "D":
                    ops.append(pre_op)
                    lens.append(pre_n)
                    pre_op, pre_n = "D", 1
                else:
                    pre_n += 1
                mapping_start_position -= 1

        # Tail: once the error budget is consumed, the rest is matches
        # (src/align.c:445-459).
        if text_position >= 0:
            if pre_op != "M":
                ops.append(pre_op)
                lens.append(pre_n)
                ops.append("M")
                lens.append(text_position + 1)
            else:
                ops.append("M")
                lens.append(pre_n + text_position + 1)
        else:
            ops.append(pre_op)
            lens.append(pre_n)

        # Fold a trailing substitution run into its neighbor and emit ops
        # reversed, i.e. left-to-right (src/align.c:465-496).
        start_i = 0
        if ops[0] == "S":
            assert len(ops) > 1, "whole-read substitution run is unreachable"
            lens[1] += lens[0]
            start_i = 1
        op_code = {"M": 0, "I": 1, "D": 2}
        cigar = [(op_code[ops[i]], lens[i]) for i in range(len(ops) - 1, start_i - 1, -1)]
        md = self._generate_md(pattern_chars, text_chars, mapping_start_position, cigar)
        return mapping_start_position, cigar, md

    @staticmethod
    def _generate_md(
        pattern_chars: np.ndarray,
        text_chars: np.ndarray,
        mapping_start_position: int,
        cigar: List[Tuple[int, int]],
    ) -> bytes:
        """MD tag synthesis (generate_MD_tag, src/align.c:501-544)."""
        md: List[bytes] = []
        num_matches = 0
        ref = pattern_chars[mapping_start_position:]
        rp = 0
        qp = 0
        for op, n in cigar:
            if op == 0:  # M
                for _ in range(n):
                    if ref[rp] == text_chars[qp]:
                        num_matches += 1
                    else:
                        if num_matches:
                            md.append(b"%d" % num_matches)
                            num_matches = 0
                        md.append(bytes([int(ref[rp])]))
                    rp += 1
                    qp += 1
            elif op == 1:  # I
                qp += n
            elif op == 2:  # D
                if num_matches:
                    md.append(b"%d" % num_matches)
                    num_matches = 0
                md.append(b"^")
                for _ in range(n):
                    md.append(bytes([int(ref[rp])]))
                    rp += 1
        if num_matches:
            md.append(b"%d" % num_matches)
        return b"".join(md)

    # ------------------------------------------------------------------- emit

    def emit_records(
        self,
        name: bytes,
        seq: bytes,
        qual: bytes,
        read_chars: np.ndarray,
        read_codes: np.ndarray,
        neg_chars: np.ndarray,
        neg_codes: np.ndarray,
        mappings: List[GoldenMapping],
    ) -> List[bytes]:
        """Sort mappings and emit SAM records (process_mappings,
        src/align.c:56-92)."""
        mappings = sorted(mappings, key=GoldenMapping.sort_key)  # stable
        records: List[bytes] = []
        for mi, m in enumerate(mappings):
            sid = m.candidate_position >> 32
            start = m.candidate_position & _U32
            pattern_chars = self._ref_chars[sid][start:]
            pattern_codes = self._codes_at(
                sid, start, start + len(read_codes) + 2 * self.args.error_threshold + 1)
            t_chars = read_chars if m.direction == 0 else neg_chars
            t_codes = read_codes if m.direction == 0 else neg_codes
            rel_start, cigar, md = self.generate_alignment(
                pattern_chars,
                pattern_codes,
                t_chars,
                t_codes,
                m.edit_distance,
                m.end_position_offset,
            )
            pos = rel_start + start
            flag = 0 if m.direction == 0 else FLAG_REVERSE
            records.append(
                format_record(
                    qname=name,
                    flag=flag,
                    rname=self.reference.names[sid],
                    pos0=pos,
                    cigar=cigar_to_bytes(cigar),
                    seq=seq,  # forward read even on reverse strand (src/align.c:79)
                    qual=qual,
                    edit_distance=m.edit_distance,
                    md=md,
                    secondary=mi > 0,
                )
            )
        return records

    # ------------------------------------------------------------------- map

    def map_read(
        self,
        name: bytes,
        seq: bytes,
        qual: bytes,
    ) -> Tuple[List[bytes], MappingStats]:
        """Map one single-end read on both strands; returns SAM records in
        emission order plus this read's stats (src/map.c:27-55)."""
        args = self.args
        stats = MappingStats(num_reads=1)
        read_chars, read_codes, neg_chars, neg_codes = read_strands(seq)

        mappings: List[GoldenMapping] = []
        for direction, codes in ((0, read_codes), (1, neg_codes)):
            candidates, dp_total = self.generate_candidates(codes)
            stats.num_candidates_without_additional_qgram_filter += dp_total
            stats.num_candidates += len(candidates)
            if candidates:
                stats.num_mappings += self.verify_candidates(
                    codes, direction, candidates, mappings
                )
        if not mappings:
            return [], stats
        stats.num_mapped_reads = 1
        records = self.emit_records(
            name, seq, qual, read_chars, read_codes, neg_chars, neg_codes, mappings
        )
        return records, stats

    def map_reads(
        self, names: List[bytes], seqs: List[bytes], quals: List[bytes]
    ) -> Tuple[List[bytes], MappingStats]:
        total = MappingStats()
        records: List[bytes] = []
        for name, seq, qual in zip(names, seqs, quals):
            recs, stats = self.map_read(name, seq, qual)
            records.extend(recs)
            total += stats
        return records, total
