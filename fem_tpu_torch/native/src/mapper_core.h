// Complete CPU mapping core over non-owning views — shared by the
// standalone fem_baseline binary and the in-process C API used as the
// engine's fast exact fallback path. Semantics are the pinned reference
// behavior (fem_tpu/golden/model.py carries the file:line spec).
#pragma once

#include <algorithm>
#include <cstdint>
#include <string>
#include <vector>

#include "align_core.h"

namespace femtpu {

struct IndexView {
  int32_t k = 12;
  int32_t step = 3;
  const uint32_t* lookup = nullptr;  // 4^k + 1 CSR offsets
  const uint64_t* occ = nullptr;     // seqid<<32|pos, bucket-sorted
  uint64_t occ_size = 0;

  uint32_t freq(uint32_t h) const { return lookup[h + 1] - lookup[h]; }
  const uint64_t* occs(uint32_t h) const { return occ + lookup[h]; }
};

struct RefView {
  const uint8_t* blob = nullptr;        // concatenated raw chromosome chars
  const int64_t* offsets = nullptr;     // n+1 offsets into blob
  const uint8_t* names_blob = nullptr;  // concatenated names
  const int64_t* name_offsets = nullptr;
  int32_t n = 0;

  int64_t len(int32_t i) const { return offsets[i + 1] - offsets[i]; }
  const uint8_t* seq(int32_t i) const { return blob + offsets[i]; }
};

struct MapParams {
  int e = 2;
  int a = 1;
};

struct MapStats {
  uint64_t reads = 0, mapped = 0, cand_pre = 0, cand = 0, mappings = 0;
  void operator+=(const MapStats& o) {
    reads += o.reads;
    mapped += o.mapped;
    cand_pre += o.cand_pre;
    cand += o.cand;
    mappings += o.mappings;
  }
};

struct SeedSel {
  uint32_t hash;
  int start;
  uint32_t freq;
};

// Optimal prefix q-gram DP (uint32-wrapping; ties prefer horizontal).
// Returns min total; fills `picked` in traceback order.
inline uint32_t select_qgrams_cpu(uint64_t occ_size, int S, int span, int ng,
                                  const uint32_t* freqs,
                                  std::vector<int>& picked) {
  picked.clear();
  int rows = S + 1;
  int cols = ng - S * span + 2;
  if (cols < 2) return (uint32_t)occ_size;  // degenerate (defined behavior)
  static thread_local std::vector<uint32_t> M;
  static thread_local std::vector<uint8_t> D;
  M.assign((size_t)rows * cols, 0);
  D.assign((size_t)rows * cols, 3);
  for (int r = 1; r < rows; ++r) M[(size_t)r * cols] = (uint32_t)occ_size;
  for (int r = 1; r < rows; ++r) {
    for (int c = 1; c < cols; ++c) {
      int p = c + (r - 1) * span - 1;
      uint32_t vert = M[(size_t)(r - 1) * cols + c] + freqs[p];
      uint32_t horiz = M[(size_t)r * cols + c - 1];
      if (vert < horiz) {
        M[(size_t)r * cols + c] = vert;
        D[(size_t)r * cols + c] = 2;
      } else {
        M[(size_t)r * cols + c] = horiz;
        D[(size_t)r * cols + c] = 1;
      }
    }
  }
  int r = rows - 1, c = cols - 1;
  while (D[(size_t)r * cols + c] != 3) {
    if (D[(size_t)r * cols + c] == 2) {
      picked.push_back(c + (r - 1) * span - 1);
      --r;
    } else {
      --c;
    }
  }
  return M[(size_t)rows * cols - 1];
}

// Per-group candidate generation: sorted union of the selected seeds'
// filtered diagonal positions (last seed truncated at the running merge's
// maximum), pigeonhole vote, then greedy merge-dedup into `cands`.
inline void group_candidates_cpu(const IndexView& index, const MapParams& P,
                                 std::vector<SeedSel>& sel,
                                 std::vector<uint64_t>& cands,
                                 std::vector<uint64_t>& merged,
                                 std::vector<uint64_t>& scratch) {
  std::stable_sort(sel.begin(), sel.end(),
                   [](const SeedSel& x, const SeedSel& y) {
                     return x.freq < y.freq;
                   });
  merged.clear();
  size_t n = sel.size();
  for (size_t si = 0; si + 1 < n; ++si) {
    const uint64_t* o = index.occs(sel[si].hash);
    scratch.clear();
    for (uint32_t i = 0; i < sel[si].freq; ++i) {
      if ((uint32_t)o[i] >= (uint32_t)sel[si].start)
        scratch.push_back(o[i] - sel[si].start);
    }
    size_t mid = merged.size();
    merged.insert(merged.end(), scratch.begin(), scratch.end());
    std::inplace_merge(merged.begin(), merged.begin() + mid, merged.end());
  }
  if (n && !merged.empty()) {
    size_t si = n - 1;
    uint64_t cap = merged.back();
    const uint64_t* o = index.occs(sel[si].hash);
    scratch.clear();
    for (uint32_t i = 0; i < sel[si].freq; ++i) {
      if ((uint32_t)o[i] >= (uint32_t)sel[si].start) {
        uint64_t v = o[i] - sel[si].start;
        if (v <= cap)
          scratch.push_back(v);
        else
          break;  // positions ascend within a bucket
      }
    }
    size_t mid = merged.size();
    merged.insert(merged.end(), scratch.begin(), scratch.end());
    std::inplace_merge(merged.begin(), merged.begin() + mid, merged.end());
  }
  // Pigeonhole vote: keep p iff more than `a` positions lie in [p, p+e].
  scratch.clear();
  size_t m = merged.size();
  for (size_t i = 0; i < m; ++i) {
    if ((size_t)P.a + i < m && merged[i + P.a] <= merged[i] + (uint64_t)P.e)
      scratch.push_back(merged[i]);
    else if (P.a == 0)
      scratch.push_back(merged[i]);
  }
  // Greedy +-e dedup over the sorted union with the running candidates.
  merged.clear();
  std::merge(cands.begin(), cands.end(), scratch.begin(), scratch.end(),
             std::back_inserter(merged));
  cands.clear();
  for (uint64_t v : merged)
    if (cands.empty() || v > cands.back() + (uint64_t)P.e) cands.push_back(v);
}

struct CpuMapping {
  uint8_t dir;
  uint8_t ed;
  uint64_t cand;
  int32_t end;
  uint64_t key() const {
    return ((uint64_t)ed << 60) | ((uint64_t)dir << 59) |
           ((cand + (uint64_t)end) & ((1ull << 59) - 1));
  }
};

class CpuMapper {
 public:
  CpuMapper(const RefView& ref, const IndexView& index, const MapParams& params)
      : ref_(ref), index_(index), P_(params) {}

  // Maps one read; appends SAM lines to `out`.
  void map_read(const uint8_t* name, int64_t name_len, const uint8_t* seq,
                int64_t L64, const uint8_t* qual, MapStats& st,
                std::string& out) {
    st.reads += 1;
    const int L = (int)L64;
    neg_.resize(L);
    for (int i = 0; i < L; ++i)
      neg_[i] = Tables::kCodeToChar[(3 ^ c2c(seq[L - 1 - i])) & 7];
    mappings_.clear();
    for (int dir = 0; dir < 2; ++dir) {
      const uint8_t* text = dir ? (const uint8_t*)neg_.data() : seq;
      cands_.clear();
      uint32_t pre = generate_candidates(text, L);
      st.cand_pre += pre;
      st.cand += cands_.size();
      verify(text, L, (uint8_t)dir, st);
    }
    if (mappings_.empty()) return;
    st.mapped += 1;
    emit(name, name_len, seq, qual, L, out);
  }

 private:
  uint32_t generate_candidates(const uint8_t* text, int L) {
    const int k = index_.k, step = index_.step;
    int span = (k + step - 1) / step;
    int S = P_.e + 1 + P_.a;
    int num_seeds = L - k + 1;
    if (num_seeds <= 0) return 0;
    if (S > num_seeds / step) return 0;
    hashes_.resize(num_seeds);
    uint32_t mask = (1u << (2 * k)) - 1;
    uint32_t h = 0;
    int ambig = 0;
    for (int i = 0; i < k; ++i) {
      uint8_t b = c2c(text[i]);
      h = ((h << 2) | (b < 4 ? b : 0)) & mask;
    }
    hashes_[0] = h;
    for (int i = 1; i < num_seeds; ++i) {
      uint8_t b = c2c(text[i + k - 1]);
      if (b < 4) {
        h = ((h << 2) | b) & mask;
      } else {
        h = (h << 2) & mask;
        ++ambig;
      }
      hashes_[i] = h;
    }
    if (ambig > P_.e) return 0;
    cands_.clear();
    uint32_t pre_total = 0;
    for (int si = 0; si < step; ++si) {
      int ng = (num_seeds - si) / step;
      freqs_.resize(ng);
      for (int p = 0; p < ng; ++p)
        freqs_[p] = index_.freq(hashes_[si + p * step]);
      pre_total +=
          select_qgrams_cpu(index_.occ_size, S, span, ng, freqs_.data(), picked_);
      if ((int)picked_.size() < S) continue;  // degenerate group
      sel_.clear();
      for (int p : picked_) {
        int pos = si + p * step;
        sel_.push_back({hashes_[pos], pos, freqs_[p]});
      }
      group_candidates_cpu(index_, P_, sel_, cands_, merged_, scratch_);
    }
    size_t w = 0;
    for (uint64_t c : cands_) {
      uint32_t sid = (uint32_t)(c >> 32);
      uint32_t pos = (uint32_t)c;
      uint64_t len = (uint64_t)ref_.len(sid);
      if (pos >= (uint32_t)P_.e && (uint64_t)pos + L + P_.e < len)
        cands_[w++] = c - (uint64_t)P_.e;
    }
    cands_.resize(w);
    return pre_total;
  }

  void verify(const uint8_t* text, int L, uint8_t dir, MapStats& st) {
    for (uint64_t c : cands_) {
      uint32_t sid = (uint32_t)(c >> 32);
      uint32_t pos = (uint32_t)c;
      const uint8_t* pattern = ref_.seq(sid) + pos;
      int end = 0;
      int ed = banded_edit_distance(pattern, text, L, P_.e, &end);
      if (ed <= P_.e) {
        mappings_.push_back({dir, (uint8_t)ed, c, end});
        st.mappings += 1;
      }
    }
  }

  void emit(const uint8_t* name, int64_t name_len, const uint8_t* seq,
            const uint8_t* qual, int L, std::string& out) {
    std::stable_sort(mappings_.begin(), mappings_.end(),
                     [](const CpuMapping& x, const CpuMapping& y) {
                       return x.key() < y.key();
                     });
    const Tables& tbl = tables();
    for (size_t k = 0; k < mappings_.size(); ++k) {
      const CpuMapping& m = mappings_[k];
      uint32_t sid = (uint32_t)(m.cand >> 32);
      uint64_t band = (uint32_t)m.cand;
      const uint8_t* pattern = ref_.seq(sid) + band;
      const uint8_t* text =
          m.dir ? (const uint8_t*)neg_.data() : seq;
      int start =
          generate_alignment(pattern, text, L, m.ed, m.end, P_.e, cigar_, md_);
      int flag = (m.dir ? 16 : 0) | (k > 0 ? 256 : 0);
      out.append((const char*)name, name_len);
      out.push_back('\t');
      append_int(out, flag);
      out.push_back('\t');
      out.append(
          (const char*)(ref_.names_blob + ref_.name_offsets[sid]),
          ref_.name_offsets[sid + 1] - ref_.name_offsets[sid]);
      out.push_back('\t');
      append_int(out, (int64_t)band + start + 1);
      out.append("\t255\t");
      for (auto& [op, n] : cigar_) {
        append_int(out, n);
        out.push_back(op);
      }
      out.append("\t*\t0\t0\t");
      if (k == 0) {
        for (int i = 0; i < L; ++i)
          out.push_back(Tables::kNt16Chars[tbl.nt16[seq[i]]]);
        out.push_back('\t');
        out.append((const char*)qual, L);
      } else {
        out.append("*\t*");
      }
      out.append("\tNM:i:");
      append_int(out, m.ed);
      out.append("\tMD:Z:");
      out.append(md_);
      out.push_back('\n');
    }
  }

  RefView ref_;
  IndexView index_;
  MapParams P_;
  std::vector<uint32_t> hashes_, freqs_;
  std::vector<int> picked_;
  std::vector<SeedSel> sel_;
  std::vector<uint64_t> cands_, merged_, scratch_;
  std::vector<char> neg_;
  std::vector<CpuMapping> mappings_;
  std::vector<std::pair<char, int>> cigar_;
  std::string md_;
};

}  // namespace femtpu
