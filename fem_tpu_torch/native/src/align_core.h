// Shared host-side alignment core: base tables, banded Myers (scalar and
// plane-storing), CIGAR/MD traceback, SAM field rendering helpers.
// Semantics are the pinned reference behavior (see fem_tpu/golden/model.py
// for the cited spec); used by both the engine's native emitter (emit.cpp)
// and the standalone CPU baseline mapper (baseline.cpp).
#pragma once

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

namespace femtpu {

struct Tables {
  uint8_t char_to_code[256];
  uint8_t nt16[256];
  static constexpr const char* kNt16Chars = "=ACMGRSVTWYHKDBN";
  static constexpr char kCodeToChar[8] = {'A', 'C', 'G', 'T', 'N', 'N', 'N', 'N'};
  Tables() {
    memset(char_to_code, 4, sizeof(char_to_code));
    const char* b = "ACGT";
    for (int i = 0; i < 4; ++i) {
      char_to_code[(uint8_t)b[i]] = (uint8_t)i;
      char_to_code[(uint8_t)(b[i] + 32)] = (uint8_t)i;
    }
    memset(nt16, 15, sizeof(nt16));
    for (int i = 0; i < 16; ++i) {
      uint8_t c = (uint8_t)kNt16Chars[i];
      nt16[c] = (uint8_t)i;
      if (c >= 'A' && c <= 'Z') nt16[c + 32] = (uint8_t)i;
    }
    nt16[(uint8_t)'U'] = 8;
    nt16[(uint8_t)'u'] = 8;
  }
};

inline const Tables& tables() {
  static Tables t;
  return t;
}

inline uint8_t c2c(uint8_t c) { return tables().char_to_code[c]; }

inline void append_int(std::string& out, int64_t v) {
  char buf[24];
  int n = snprintf(buf, sizeof(buf), "%lld", (long long)v);
  out.append(buf, n);
}

// Scalar banded Myers with the 3e early exit; returns edit distance and
// sets *end_pos (band-relative). Early exit returns e+1.
inline int banded_edit_distance(const uint8_t* pattern, const uint8_t* text,
                                int L, int e, int* end_pos) {
  uint32_t Peq[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < 2 * e; ++i) Peq[c2c(pattern[i])] |= 1u << i;
  const uint32_t hb = 1u << (2 * e);
  uint32_t VP = 0, VN = 0;
  int nerr = 0;
  for (int i = 0; i < L; ++i) {
    Peq[c2c(pattern[i + 2 * e])] |= hb;
    uint32_t X = Peq[c2c(text[i])] | VN;
    uint32_t D0 = ((VP + (X & VP)) ^ VP) | X;
    uint32_t HN = VP & D0;
    uint32_t HP = VN | ~(VP | D0);
    X = D0 >> 1;
    VN = X & HP;
    VP = HN | ~(X | HP);
    nerr += 1 - (int)(D0 & 1);
    if (nerr > 3 * e) return e + 1;
    for (int a = 0; a < 5; ++a) Peq[a] >>= 1;
  }
  int end = L - 1;
  int mn = nerr;
  for (int i = 0; i < 2 * e; ++i) {
    nerr += (int)((VP >> i) & 1u);
    nerr -= (int)((VN >> i) & 1u);
    if (nerr < mn) {
      mn = nerr;
      end = L - 1 + 1 + i;
    }
  }
  *end_pos = end;
  return mn;
}

inline void run_myers_planes(const uint8_t* pattern, const uint8_t* text, int L,
                             int e, std::vector<uint32_t>& D0s,
                             std::vector<uint32_t>& HPs) {
  uint32_t Peq[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < 2 * e; ++i) Peq[c2c(pattern[i])] |= 1u << i;
  const uint32_t hb = 1u << (2 * e);
  uint32_t VP = 0, VN = 0;
  for (int i = 0; i < L; ++i) {
    Peq[c2c(pattern[i + 2 * e])] |= hb;
    uint32_t X = Peq[c2c(text[i])] | VN;
    uint32_t D0 = ((VP + (X & VP)) ^ VP) | X;
    uint32_t HN = VP & D0;
    uint32_t HP = VN | ~(VP | D0);
    X = D0 >> 1;
    VN = X & HP;
    VP = HN | ~(X | HP);
    D0s[i] = D0;
    HPs[i] = HP;
    for (int a = 0; a < 5; ++a) Peq[a] >>= 1;
  }
}

// CIGAR/MD traceback; returns mapping start relative to the band start.
inline int generate_alignment(const uint8_t* pattern, const uint8_t* text,
                              int L, int ed, int end_pos, int e,
                              std::vector<std::pair<char, int>>& cigar,
                              std::string& md) {
  cigar.clear();
  md.clear();
  int start = end_pos - L + 1;
  bool clean = true;
  for (int i = 0; i < L; ++i)
    if (text[i] != pattern[start + i]) {
      clean = false;
      break;
    }
  if (clean) {
    cigar.emplace_back('M', L);
  } else {
    static thread_local std::vector<uint32_t> D0s, HPs;
    D0s.resize(L);
    HPs.resize(L);
    run_myers_planes(pattern, text, L, e, D0s, HPs);
    int bit = end_pos - L + 1;
    int tp = L - 1;
    int errs = 0;
    int end = end_pos;
    char pre;
    int pre_n = 1;
    auto d0 = [&]() { return (D0s[tp] >> bit) & 1u; };
    auto hp = [&]() { return (HPs[tp] >> bit) & 1u; };
    if (d0() && pattern[end] == text[tp]) {
      --tp; --end; pre = 'M';
    } else if (!d0()) {
      --tp; --end; ++errs; pre = 'S';
    } else if (d0() && hp()) {
      --tp; ++bit; ++errs; pre = 'S'; ++start;
    } else {
      abort();
    }
    std::vector<char> ops;
    std::vector<int> lens;
    while (tp >= 0) {
      if (errs == ed) break;
      if (d0() && pattern[end] == text[tp]) {
        --tp; --end;
        if (pre != 'M') { ops.push_back(pre); lens.push_back(pre_n); pre = 'M'; pre_n = 1; }
        else ++pre_n;
      } else if (!d0()) {
        --tp; --end; ++errs;
        if (pre == 'S') ++pre_n;
        else if (pre != 'M') { ops.push_back(pre); lens.push_back(pre_n); pre = 'M'; pre_n = 1; }
        else ++pre_n;
      } else if (d0() && hp()) {
        --tp; ++bit; ++errs;
        if (pre == 'S') ++pre_n;
        else if (pre != 'I') { ops.push_back(pre); lens.push_back(pre_n); pre = 'I'; pre_n = 1; }
        else ++pre_n;
        ++start;
      } else {
        --bit; --end; ++errs;
        if (pre != 'D') { ops.push_back(pre); lens.push_back(pre_n); pre = 'D'; pre_n = 1; }
        else ++pre_n;
        --start;
      }
    }
    if (tp >= 0) {
      if (pre != 'M') {
        ops.push_back(pre); lens.push_back(pre_n);
        ops.push_back('M'); lens.push_back(tp + 1);
      } else {
        ops.push_back('M'); lens.push_back(pre_n + tp + 1);
      }
    } else {
      ops.push_back(pre); lens.push_back(pre_n);
    }
    size_t lo = 0;
    if (ops[0] == 'S') { lens[1] += lens[0]; lo = 1; }
    for (size_t i = ops.size(); i-- > lo;)
      cigar.emplace_back(ops[i] == 'S' ? 'M' : ops[i], lens[i]);
  }
  const uint8_t* ref = pattern + start;
  int rp = 0, qp = 0, matches = 0;
  for (auto& [op, n] : cigar) {
    if (op == 'M') {
      for (int i = 0; i < n; ++i) {
        if (ref[rp] == text[qp]) {
          ++matches;
        } else {
          if (matches) { append_int(md, matches); matches = 0; }
          md.push_back((char)ref[rp]);
        }
        ++rp; ++qp;
      }
    } else if (op == 'I') {
      qp += n;
    } else {
      if (matches) { append_int(md, matches); matches = 0; }
      md.push_back('^');
      for (int i = 0; i < n; ++i) md.push_back((char)ref[rp++]);
    }
  }
  if (matches) append_int(md, matches);
  return start;
}

}  // namespace femtpu
