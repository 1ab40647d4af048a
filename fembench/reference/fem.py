"""FEM's mapping semantics as plain batched torch operations: the
benchmark's reference.

It works each read's counters and mappings out again from the genome, the
index and the reads that the benchmark made, and imports nothing of the
program. The semantics are those of the golden model beside it
(golden.py, a frozen copy of the port's scalar oracle, which cites FEM's
sources line by line); this file states them over whole blocks of reads
at once, so that the reference can cover every read of a run's pool:

  seeds     every k-mer of each strand hashed (ambiguous bases as A);
            a strand with more than e ambiguous bases after the first
            k-mer has no candidates and adds nothing to the counters;
  groups    for each of the `step` groups of seeds, the DP of
            golden.select_optimal_prefix_qgrams (u32 arithmetic) picks
            e + 1 + a seeds; its minimum is the group's share of the
            counter `num_candidates_without_additional_qgram_filter`;
  merge     the picked seeds' occurrences minus the seed's offset, those
            before the seed's offset dropped; the seed with the most
            occurrences (the last after a stable sort by count) keeps only
            values up to the largest of the others (golden's
            _merge_candidate_locations);
  filter    a value survives if at least `a` later values of the sorted
            merge lie within e of it (_additional_qgram_filter);
  dedup     each group's survivors merged into the strand's candidates,
            keeping a value only if it exceeds the last kept one by more
            than e (_merge_dedup);
  range     a candidate at position p of a sequence of length n stays if
            p >= e and p + L + e < n; its band starts at p - e;
            `num_candidates` counts these;
  verify    banded Myers over the band of L + 2e reference bases
            (golden.banded_edit_distance, 3e early exit); a candidate
            within e is a mapping (edit distance, end offset).

Everything is exact integer arithmetic; `map_reads` returns per-read
counters and the mappings in golden's generation order (forward strand
ascending, then reverse). SAM records of chosen reads come from golden's
traceback (`records`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fembench.reference import golden

U32 = 0xFFFFFFFF


@dataclasses.dataclass
class Mapped:
    """What `map_reads` found for N reads: per-read counters (N,) int64,
    and the mappings (M,) in generation order."""

    dp: torch.Tensor  # num_candidates_without_additional_qgram_filter
    nc: torch.Tensor  # num_candidates
    nmap: torch.Tensor  # num_mappings
    m_read: torch.Tensor
    m_dir: torch.Tensor
    m_band: torch.Tensor  # band start: seqid << 32 | position
    m_ed: torch.Tensor
    m_end: torch.Tensor

    def counters(self, weights: torch.Tensor | None = None) -> dict:
        """The five counters summed over the reads, each read counted
        `weights[r]` times (once without)."""
        w = torch.ones_like(self.dp) if weights is None else weights.to(self.dp.device).long()
        return {
            "num_reads": int(w.sum()),
            "num_mapped_reads": int((w * (self.nmap > 0)).sum()),
            "num_candidates_without_additional_qgram_filter": int((w * self.dp).sum()),
            "num_candidates": int((w * self.nc).sum()),
            "num_mappings": int((w * self.nmap).sum()),
        }


class PlainFem:
    """The reference over one genome and its index, on `device`."""

    def __init__(self, kmer_size: int, step_size: int, error_threshold: int,
                 num_additional_qgrams: int, lookup, occurrences, names, seqs,
                 device: str | torch.device = "cpu", block_reads: int = 16384):
        self.k, self.step = kmer_size, step_size
        self.e, self.a = error_threshold, num_additional_qgrams
        self.q = self.e + 1 + self.a
        self.span = -(-self.k // self.step)
        self.device = torch.device(device)
        self.block_reads = block_reads
        self.names, self.seqs = list(names), list(seqs)
        self.lengths = np.array([len(s) for s in self.seqs], np.int64)
        as_t = lambda x: torch.as_tensor(np.ascontiguousarray(x)).to(self.device)
        self.lookup = as_t(np.asarray(lookup).astype(np.int64))
        self.occ = as_t(np.asarray(occurrences).view(np.int64))
        self.table_size = int(np.asarray(occurrences).shape[0])
        # The genome's codes, each sequence at offsets[sid], for the bands.
        self.offsets = np.zeros(len(self.seqs) + 1, np.int64)
        np.cumsum(self.lengths, out=self.offsets[1:])
        flat = np.empty(int(self.offsets[-1]), np.uint8)
        for sid, s in enumerate(self.seqs):
            flat[self.offsets[sid]: self.offsets[sid + 1]] = golden.CHAR_TO_CODE[
                np.frombuffer(s, np.uint8)]
        self.ref = as_t(flat)
        self.ref_offsets = as_t(self.offsets[:-1])
        self.ref_lengths = as_t(self.lengths)
        # Segment keys: row * VB + value, value = seqid << 32 | pos, and
        # value + e never reaches the next row's range.
        self.vb = (len(self.seqs) + 1) << 32
        self._golden = None

    # ------------------------------------------------------------ per block

    def map_reads(self, codes: np.ndarray | torch.Tensor) -> Mapped:
        """Counters and mappings of reads given as (N, L) codes 0..4 (one
        read length), in blocks of `block_reads`."""
        codes = torch.as_tensor(codes)
        parts = [self._block(codes[lo: lo + self.block_reads].to(self.device))
                 for lo in range(0, codes.shape[0], self.block_reads)]
        for i, p in enumerate(parts):
            p.m_read += i * self.block_reads
        return Mapped(*(torch.cat([getattr(p, f.name) for p in parts])
                        for f in dataclasses.fields(Mapped)))

    def _block(self, codes: torch.Tensor) -> Mapped:
        dev, e, k = self.device, self.e, self.k
        N, L = codes.shape
        x = codes.long()
        rev = x.flip(1)
        rows = torch.cat([x, torch.where(rev < 4, 3 - rev, torch.full_like(rev, 4))])
        R = 2 * N
        S = L - k + 1
        zeros = torch.zeros(N, dtype=torch.long, device=dev)
        empty = torch.zeros(0, dtype=torch.long, device=dev)
        if S <= 0 or self.q > S // self.step:
            return Mapped(zeros, zeros, zeros, empty, empty, empty, empty, empty)
        c4 = torch.where(rows > 3, torch.zeros_like(rows), rows)
        h = torch.zeros((R, S), dtype=torch.long, device=dev)
        for j in range(k):
            h = (h << 2) | c4[:, j: j + S]
        live = (rows[:, k:] > 3).sum(1) <= e  # else no candidates, no counts

        dp = torch.zeros(R, dtype=torch.long, device=dev)
        cand = torch.zeros(0, dtype=torch.long, device=dev)  # sorted row keys
        for si in range(self.step):
            n_g = (S - si) // self.step
            gpos = si + self.step * torch.arange(n_g, device=dev)
            gh = h[:, gpos]
            freq = self.lookup[gh + 1] - self.lookup[gh]
            total, picks, full = self._select(freq, n_g)
            dp += torch.where(live, total, torch.zeros_like(total))
            if picks is None:
                continue
            use = live & full
            survivors = self._merge_filter(gh, freq, gpos, picks, use)
            cand = self._dedup(torch.sort(torch.cat([cand, survivors])).values)

        # Range filter and band start.
        row = torch.div(cand, self.vb, rounding_mode="floor")
        val = cand - row * self.vb
        sid, rpos = val >> 32, val & U32
        ok = (rpos >= e) & (rpos + L + e < self.ref_lengths[sid])
        row, band = row[ok], val[ok] - e
        nc = torch.bincount(row, minlength=R)

        ed, end = self._verify(rows[row], band)
        acc = ed <= e
        nmap = torch.bincount(row[acc], minlength=R)
        m_row = row[acc]
        read, direction = m_row % N, m_row // N
        # Generation order: a read's forward mappings then its reverse ones,
        # each ascending (rows are sorted by (row, band) already).
        order = torch.argsort(read * 2 + direction, stable=True)
        fold = lambda t: t[:N] + t[N:]
        return Mapped(fold(dp), fold(nc), fold(nmap), read[order], direction[order],
                      band[acc][order], ed[acc][order], end[acc][order])

    def _select(self, freq: torch.Tensor, n_g: int):
        """golden.select_optimal_prefix_qgrams for every row: (total (R,),
        picked seed numbers (R, q) in traceback order, rows with all q)."""
        R = freq.shape[0]
        q, span = self.q, self.span
        cols = n_g - q * span + 2
        if cols < 2:  # degenerate group: the counter, no candidates
            return torch.full((R,), self.table_size & U32, device=freq.device), None, None
        dev = freq.device
        M = torch.zeros((R, q + 1, cols), dtype=torch.long, device=dev)
        M[:, 1:, 0] = self.table_size & U32
        D = torch.full((R, q + 1, cols), 3, dtype=torch.uint8, device=dev)
        for r in range(1, q + 1):
            for c in range(1, cols):
                p = c + (r - 1) * span - 1
                with_new = (M[:, r - 1, c] + freq[:, p]) & U32
                take = with_new < M[:, r, c - 1]
                M[:, r, c] = torch.where(take, with_new, M[:, r, c - 1])
                D[:, r, c] = torch.where(take, 2, 1).to(torch.uint8)
        total = M[:, q, cols - 1]
        ar = torch.arange(R, device=dev)
        r_at = torch.full((R,), q, device=dev)
        c_at = torch.full((R,), cols - 1, device=dev)
        npick = torch.zeros(R, dtype=torch.long, device=dev)
        picks = torch.zeros((R, q), dtype=torch.long, device=dev)
        for _ in range(q + cols):
            d = D[ar, r_at, c_at]
            active = d != 3
            took = active & (d == 2)
            p = c_at + (r_at - 1) * span - 1
            slot = torch.where(took, npick, torch.zeros_like(npick))
            picks[ar, slot] = torch.where(took, p, picks[ar, slot])
            npick += took.long()
            r_at = r_at - took.long()
            c_at = c_at - (active & ~took).long()
        return total, picks, npick == q

    def _merge_filter(self, gh, freq, gpos, picks, use):
        """The merged occurrences of each used row's picked seeds and the
        additional q-gram filter: the survivors as sorted row keys."""
        dev = freq.device
        e, a = self.e, self.a
        rows_used = torch.nonzero(use).squeeze(1)
        if rows_used.numel() == 0:
            return torch.zeros(0, dtype=torch.long, device=dev)
        pk = picks[rows_used]  # (U, q), traceback order
        f = freq[rows_used].gather(1, pk)
        hv = gh[rows_used].gather(1, pk)
        start = gpos[pk]
        # The last seed after a stable sort by count: the largest count,
        # the last of equal ones in traceback order.
        order = torch.sort(f, dim=1, stable=True).indices
        is_last = torch.zeros_like(f, dtype=torch.bool)
        is_last.scatter_(1, order[:, -1:], True)
        counts = f.reshape(-1)
        seg = rows_used.repeat_interleave(self.q)
        n = int(counts.sum())
        if n == 0:
            return torch.zeros(0, dtype=torch.long, device=dev)
        owner = torch.repeat_interleave(torch.arange(counts.numel(), device=dev), counts)
        first = torch.cumsum(counts, 0) - counts
        idx = torch.arange(n, device=dev) - first[owner]
        occ = self.occ[self.lookup[hv.reshape(-1)][owner] + idx]
        st = start.reshape(-1)[owner]
        keep = (occ & U32) >= st
        val = occ - st
        last = is_last.reshape(-1)[owner]
        rseg = seg[owner]
        R = gh.shape[0]
        top = torch.full((R,), -1, dtype=torch.long, device=dev)
        other = keep & ~last
        top.scatter_reduce_(0, rseg[other], val[other], reduce="amax")
        keep = other | (keep & last & (val <= top[rseg]))
        keys = torch.sort(rseg[keep] * self.vb + val[keep]).values
        if a == 0 or keys.numel() == 0:
            return keys
        later = torch.searchsorted(keys, keys + e, right=True) - 1 - torch.arange(
            keys.numel(), device=dev)
        return keys[later >= a]

    def _dedup(self, keys: torch.Tensor) -> torch.Tensor:
        """Greedy dedup within each row of sorted keys: keep a value only if
        it exceeds the last kept one by more than e."""
        n = keys.numel()
        if n == 0:
            return keys
        seg = torch.div(keys, self.vb, rounding_mode="floor")
        head = torch.ones(n, dtype=torch.bool, device=keys.device)
        head[1:] = seg[1:] != seg[:-1]
        nxt = torch.searchsorted(keys, keys + self.e, right=True)
        kept = torch.zeros(n, dtype=torch.bool, device=keys.device)
        cur = torch.nonzero(head).squeeze(1)
        while cur.numel():
            kept[cur] = True
            nx = nxt[cur]
            ok = nx < n
            cur, nx = cur[ok], nx[ok]
            cur = nx[seg[nx] == seg[cur]]
        return keys[kept]

    def _verify(self, text: torch.Tensor, band: torch.Tensor):
        """golden.banded_edit_distance for every (read strand, band start):
        (edit distance, end offset); e + 1 where the 3e bound ends it."""
        e = self.e
        C, L = text.shape
        dev = text.device
        if C == 0:
            z = torch.zeros(0, dtype=torch.long, device=dev)
            return z, z
        sid, pos = band >> 32, band & U32
        base = self.ref_offsets[sid] + pos
        pat = self.ref[base[:, None] + torch.arange(L + 2 * e, device=dev)].long()
        onehot = lambda col: torch.nn.functional.one_hot(col, 5)
        peq = torch.zeros((C, 5), dtype=torch.long, device=dev)
        for i in range(2 * e):
            peq |= onehot(pat[:, i]) << i
        hb = 1 << (2 * e)
        vp = torch.zeros(C, dtype=torch.long, device=dev)
        vn = torch.zeros_like(vp)
        nerr = torch.zeros_like(vp)
        dead = torch.zeros(C, dtype=torch.bool, device=dev)
        for i in range(L):
            peq |= onehot(pat[:, i + 2 * e]) * hb
            xx = peq.gather(1, text[:, i: i + 1]).squeeze(1) | vn
            d0 = ((((vp + (xx & vp)) & U32) ^ vp) | xx) & U32
            hn = vp & d0
            hp = (vn | ~(vp | d0)) & U32
            xx = d0 >> 1
            vn = xx & hp
            vp = (hn | ~(xx | hp)) & U32
            nerr += 1 - (d0 & 1)
            dead |= nerr > 3 * e
            peq >>= 1
        end = torch.full((C,), L - 1, dtype=torch.long, device=dev)
        best = nerr.clone()
        for i in range(2 * e):
            nerr += ((vp >> i) & 1) - ((vn >> i) & 1)
            better = nerr < best
            best = torch.where(better, nerr, best)
            end = torch.where(better, torch.full_like(end, L + i), end)
        return torch.where(dead, torch.full_like(best, e + 1), best), end

    # -------------------------------------------------------------- records

    def records(self, mapped: Mapped, reads: list) -> dict:
        """SAM records of chosen reads, by golden's traceback: `reads` is
        [(i, name, seq, qual)] with i the read's row in `mapped`; returns
        {i: [record, ...]} in FEM's emission order."""
        if self._golden is None:
            args = golden.FemArgs(self.k, self.step, self.e, self.a)
            genome = golden.Genome(self.names, self.seqs, self.lengths)
            self._golden = golden.GoldenMapper(args, genome, index=None)
        g = self._golden
        cols = [t.cpu().numpy() for t in (mapped.m_read, mapped.m_dir, mapped.m_band,
                                           mapped.m_ed, mapped.m_end)]
        lo = np.searchsorted(cols[0], [i for i, *_ in reads], side="left")
        hi = np.searchsorted(cols[0], [i for i, *_ in reads], side="right")
        out = {}
        for (i, name, seq, qual), a, b in zip(reads, lo, hi):
            ms = [golden.GoldenMapping(int(cols[1][j]), int(cols[3][j]), int(cols[2][j]),
                                       int(cols[4][j])) for j in range(a, b)]
            out[i] = g.emit_records(name, seq, qual, *golden.read_strands(seq), ms) if ms else []
        return out
