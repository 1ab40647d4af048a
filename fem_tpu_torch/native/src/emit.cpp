// fem_tpu native host library: mapping sort + traceback + SAM emission.
//
// The device pipeline returns a small accepted-hit set per batch; this
// module performs the host-side tail of the mapping loop at C++ speed:
// per-read stable mapping sort (key semantics of reference src/align.c:53),
// banded Myers re-run + CIGAR/MD traceback (src/align.c:279-544), and SAM
// text formatting matching htslib's record rendering (src/align.c:546-632,
// src/output_queue.c:83). Behavior is validated byte-for-byte against the
// Python golden model (fem_tpu/golden/model.py) in tests.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "align_core.h"

using namespace femtpu;

namespace {

struct MappingRec {
  uint8_t direction;
  uint8_t edit_distance;
  int32_t sid;
  uint64_t band_pos;   // in-chromosome band start
  int32_t end_offset;  // end position relative to band start
  uint64_t key;        // sort key (src/align.c:53)
};

}  // namespace

extern "C" {

// Emit SAM records for a batch. Mappings are grouped per read via
// map_counts and must be in generation order (+ strand candidates then
// - strand, each ascending) — the stable sort here reproduces the
// radix-sorted emission order (src/align.c:56-57).
//
// Returns a malloc'd buffer in *out_buf (length *out_len); caller frees
// with fem_free. `per_read_ends` (optional, caller-allocated, num_reads
// entries) receives each read's exclusive end offset into the buffer so
// callers can splice records per read (the engine's capacity-retry path
// re-emits overflowed reads and needs read-granular segments).
// Returns 0 on success.
int fem_emit_batch(
    const uint8_t* ref_blob, const int64_t* ref_offsets, const int64_t* ref_lens,
    const uint8_t* ref_names_blob, const int64_t* ref_name_offsets,
    int32_t /*num_refs*/,
    const uint8_t* names_blob, const int64_t* name_offsets,
    const uint8_t* seqs_blob, const int64_t* seq_offsets,
    const uint8_t* quals_blob,
    int32_t num_reads,
    const int32_t* map_counts,
    const uint8_t* m_dir, const uint8_t* m_ed, const int32_t* m_sid,
    const int64_t* m_pos, const int32_t* m_end,
    int32_t error_threshold,
    uint8_t** out_buf, int64_t* out_len, int64_t* per_read_ends) {
  (void)ref_lens;
  const int e = error_threshold;
  const Tables& tbl = tables();

  // Per-read mapping-index prefix so read ranges can emit independently.
  std::vector<int64_t> mprefix(num_reads + 1, 0);
  for (int32_t r = 0; r < num_reads; ++r)
    mprefix[r + 1] = mprefix[r] + map_counts[r];

  std::vector<int64_t> read_sizes(per_read_ends ? num_reads : 0, 0);

  auto emit_range = [&](int32_t r_lo, int32_t r_hi, std::string& out) {
    out.reserve(64 + (size_t)(r_hi - r_lo) * 192);
    std::vector<MappingRec> recs;
    std::vector<uint8_t> neg;
    std::vector<std::pair<char, int>> cigar;
    std::string md;
    for (int32_t r = r_lo; r < r_hi; ++r) {
      const size_t out0 = out.size();
      int32_t cnt = map_counts[r];
      if (cnt == 0) continue;
      const int64_t mi0 = mprefix[r];
      const uint8_t* seq = seqs_blob + seq_offsets[r];
      const uint8_t* qual = quals_blob + seq_offsets[r];
      const int L = (int)(seq_offsets[r + 1] - seq_offsets[r]);
      recs.clear();
      for (int32_t i = 0; i < cnt; ++i) {
        MappingRec m;
        m.direction = m_dir[mi0 + i];
        m.edit_distance = m_ed[mi0 + i];
        m.sid = m_sid[mi0 + i];
        m.band_pos = (uint64_t)m_pos[mi0 + i];
        m.end_offset = m_end[mi0 + i];
        uint64_t cand = ((uint64_t)m.sid << 32) | m.band_pos;
        m.key = ((uint64_t)m.edit_distance << 60) |
                ((uint64_t)m.direction << 59) |
                ((cand + (uint64_t)m.end_offset) & ((1ull << 59) - 1));
        recs.push_back(m);
      }
      std::stable_sort(recs.begin(), recs.end(),
                       [](const MappingRec& a, const MappingRec& b) {
                         return a.key < b.key;
                       });
      // Negative-strand chars (src/sequence_batch.h:90-98).
      neg.resize(L);
      for (int i = 0; i < L; ++i)
        neg[i] = (uint8_t)Tables::kCodeToChar[(3 ^ c2c(seq[L - 1 - i])) & 7];

      for (size_t k = 0; k < recs.size(); ++k) {
        const MappingRec& m = recs[k];
        const uint8_t* pattern = ref_blob + ref_offsets[m.sid] + m.band_pos;
        const uint8_t* text = m.direction ? neg.data() : seq;
        int start = generate_alignment(pattern, text, L, m.edit_distance,
                                       m.end_offset, e, cigar, md);
        int64_t pos0 = (int64_t)m.band_pos + start;
        int flag = (m.direction ? 16 : 0) | (k > 0 ? 256 : 0);
        // QNAME FLAG RNAME POS MAPQ CIGAR RNEXT PNEXT TLEN SEQ QUAL NM MD
        out.append((const char*)(names_blob + name_offsets[r]),
                   name_offsets[r + 1] - name_offsets[r]);
        out.push_back('\t');
        append_int(out, flag);
        out.push_back('\t');
        out.append((const char*)(ref_names_blob + ref_name_offsets[m.sid]),
                   ref_name_offsets[m.sid + 1] - ref_name_offsets[m.sid]);
        out.push_back('\t');
        append_int(out, pos0 + 1);
        out.append("\t255\t");
        for (auto& [op, n] : cigar) {
          append_int(out, n);
          out.push_back(op);
        }
        out.append("\t*\t0\t0\t");
        if (k == 0) {
          // SEQ: nt16 round trip of the *forward* read (src/align.c:79,619-621).
          for (int i = 0; i < L; ++i)
            out.push_back(Tables::kNt16Chars[tbl.nt16[seq[i]]]);
          out.push_back('\t');
          out.append((const char*)qual, L);
        } else {
          out.append("*\t*");  // secondary: l_qseq = 0 (src/align.c:85)
        }
        out.append("\tNM:i:");
        append_int(out, m.edit_distance);
        out.append("\tMD:Z:");
        out.append(md);
        out.push_back('\n');
      }
      if (per_read_ends) read_sizes[r] = (int64_t)(out.size() - out0);
    }
  };

  // Thread over contiguous read ranges (per-thread buffers concatenated in
  // order, so output is byte-identical to the serial emission — the
  // reference's writer thread kept no cross-read state either,
  // src/output_queue.c:60-91).
  int nthreads = 1;
  if (const char* envt = getenv("FEM_TPU_EMIT_THREADS")) {
    nthreads = atoi(envt);
  } else {
    unsigned hw = std::thread::hardware_concurrency();
    nthreads = hw > 1 ? (int)(hw > 16 ? 8 : hw / 2) : 1;
  }
  if (nthreads < 1) nthreads = 1;
  if (num_reads < 1024 || mprefix[num_reads] < 1024) nthreads = 1;

  std::vector<std::string> parts(nthreads);
  if (nthreads == 1) {
    emit_range(0, num_reads, parts[0]);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) {
      int32_t lo = (int32_t)((int64_t)num_reads * t / nthreads);
      int32_t hi = (int32_t)((int64_t)num_reads * (t + 1) / nthreads);
      threads.emplace_back([&, lo, hi, t] { emit_range(lo, hi, parts[t]); });
    }
    for (auto& th : threads) th.join();
  }

  if (per_read_ends) {
    int64_t acc = 0;
    for (int32_t r = 0; r < num_reads; ++r) {
      acc += read_sizes[r];
      per_read_ends[r] = acc;
    }
  }

  int64_t total = 0;
  for (auto& p : parts) total += (int64_t)p.size();
  *out_len = total;
  *out_buf = (uint8_t*)malloc(total ? total : 1);
  if (!*out_buf) return 1;
  uint8_t* w = *out_buf;
  for (auto& p : parts) {
    memcpy(w, p.data(), p.size());
    w += p.size();
  }
  return 0;
}

void fem_free(uint8_t* p) { free(p); }

}  // extern "C"
