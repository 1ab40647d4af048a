// ThreadSanitizer stress driver for the native host layer (SURVEY §5.2:
// "host pipeline tested with TSAN where C++ is used"). Builds a synthetic
// genome and the direct-address index in-process (same hash and CSR
// semantics as src/index.c:57-98 / fem_tpu/index/build.py), then
// exercises the library's two concurrency contracts under TSAN:
//
//   1. fem_emit_batch from N threads concurrently — the engine's drain
//      threads call it exactly this way (pipeline/engine.py drain pool);
//      it must be data-race-free via thread_local scratch
//      (align_core.h:129) with no shared mutable state. Outputs are also
//      checked for cross-thread determinism (same batch -> same bytes).
//   2. fem_mapper_map on (a) one handle per thread concurrently (handles
//      share only the read-only ref/index views) and (b) one SHARED
//      handle serialized by a mutex — the documented contract in
//      fem_tpu/native/mapper.py (handle scratch is not reentrant).
//
// Built and run by tests/test_native.py::test_tsan_stress with
// g++ -fsanitize=thread; TSAN exits non-zero on any report.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
void* fem_mapper_create(const uint8_t* ref_blob, const int64_t* ref_offsets,
                        const uint8_t* ref_names_blob,
                        const int64_t* ref_name_offsets, int32_t num_refs,
                        const uint32_t* lookup, const uint64_t* occ,
                        uint64_t occ_size, int32_t k, int32_t step,
                        int32_t e, int32_t a);
void fem_mapper_destroy(void* vh);
int fem_mapper_map(void* vh, const uint8_t* names_blob,
                   const int64_t* name_offsets, const uint8_t* seqs_blob,
                   const int64_t* seq_offsets, const uint8_t* quals_blob,
                   int32_t num_reads, uint8_t** out_buf, int64_t* out_len,
                   uint64_t stats_out[5]);
int fem_emit_batch(
    const uint8_t* ref_blob, const int64_t* ref_offsets,
    const int64_t* ref_lens, const uint8_t* ref_names_blob,
    const int64_t* ref_name_offsets, int32_t num_refs,
    const uint8_t* names_blob, const int64_t* name_offsets,
    const uint8_t* seqs_blob, const int64_t* seq_offsets,
    const uint8_t* quals_blob, int32_t num_reads, const int32_t* map_counts,
    const uint8_t* m_dir, const uint8_t* m_ed, const int32_t* m_sid,
    const int64_t* m_pos, const int32_t* m_end, int32_t error_threshold,
    uint8_t** out_buf, int64_t* out_len, int64_t* per_read_ends);
void fem_free(uint8_t* p);
}

namespace {

constexpr int kK = 12, kStep = 3, kE = 2, kA = 1, kL = 100;

int code_of(uint8_t c) {
  switch (c) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return 0;  // N -> A (src/utils.h:72-99)
  }
}

// xorshift so runs are deterministic across platforms.
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed * 2654435761u + 1) {}
  uint32_t next() {
    s ^= s << 13; s ^= s >> 7; s ^= s << 17;
    return (uint32_t)(s >> 32);
  }
};

struct World {
  std::string genome;          // one chromosome of ACGT chars
  std::vector<int64_t> ref_offsets{0};
  std::vector<int64_t> ref_lens;
  std::string ref_name = "seq0";
  std::vector<int64_t> name_offsets{0};
  std::vector<uint32_t> lookup;  // 4^k + 1 CSR
  std::vector<uint64_t> occ;     // sid<<32|pos, ascending per bucket
};

World build_world(int genome_len) {
  World w;
  Rng rng(7);
  w.genome.resize(genome_len);
  const char* bases = "ACGT";
  for (int i = 0; i < genome_len; ++i) w.genome[i] = bases[rng.next() & 3];
  w.ref_offsets.push_back(genome_len);
  w.ref_lens.push_back(genome_len);
  w.name_offsets.push_back((int64_t)w.ref_name.size());

  // Direct-address CSR: windows every kStep bases (index.c:57-98); one
  // counting pass then an in-order fill keeps per-bucket positions
  // ascending (single chromosome, scan order).
  const size_t buckets = (size_t)1 << (2 * kK);
  w.lookup.assign(buckets + 1, 0);
  auto hash_at = [&](int p) {
    uint32_t h = 0;
    for (int j = 0; j < kK; ++j) h = (h << 2) | code_of(w.genome[p + j]);
    return h;
  };
  std::vector<uint32_t> hashes;
  for (int p = 0; p + kK <= genome_len; p += kStep) hashes.push_back(hash_at(p));
  for (uint32_t h : hashes) w.lookup[h + 1]++;
  for (size_t i = 0; i < buckets; ++i) w.lookup[i + 1] += w.lookup[i];
  w.occ.resize(hashes.size());
  std::vector<uint32_t> cursor(w.lookup.begin(), w.lookup.end() - 1);
  for (size_t i = 0; i < hashes.size(); ++i) {
    uint64_t pos = (uint64_t)(i * kStep);
    w.occ[cursor[hashes[i]]++] = pos;  // sid 0: value is just the position
  }
  return w;
}

struct Batch {
  std::string names_blob, seqs_blob, quals_blob;
  std::vector<int64_t> name_offsets{0}, seq_offsets{0};
  int32_t n = 0;
  // emit-side mapping arrays (one mapping per read)
  std::vector<int32_t> map_counts;
  std::vector<uint8_t> m_dir, m_ed;
  std::vector<int32_t> m_sid, m_end;
  std::vector<int64_t> m_pos;
};

Batch make_batch(const World& w, int n_reads, uint64_t seed) {
  Batch b;
  Rng rng(seed);
  const int glen = (int)w.genome.size();
  for (int i = 0; i < n_reads; ++i) {
    int p = kE + (int)(rng.next() % (uint32_t)(glen - kL - 4 * kE));
    std::string seq = w.genome.substr(p, kL);
    int ed = (int)(rng.next() % (kE + 1));
    for (int m = 0; m < ed; ++m) {  // substitutions only: known true ED
      int off = 10 + (int)(rng.next() % (kL - 20));
      char cur = seq[off];
      char nxt = "ACGT"[(code_of(cur) + 1 + (rng.next() % 3)) & 3];
      if (nxt == cur) nxt = cur == 'A' ? 'C' : 'A';
      seq[off] = nxt;
    }
    char name[32];
    snprintf(name, sizeof name, "r%llu_%d", (unsigned long long)seed, i);
    b.names_blob += name;
    b.name_offsets.push_back((int64_t)b.names_blob.size());
    b.seqs_blob += seq;
    b.seq_offsets.push_back((int64_t)b.seqs_blob.size());
    b.quals_blob += std::string(kL, 'I');
    b.map_counts.push_back(1);
    b.m_dir.push_back(0);
    b.m_ed.push_back((uint8_t)ed);
    b.m_sid.push_back(0);
    b.m_pos.push_back(p - kE);          // band start (filter.c:141)
    b.m_end.push_back(kL - 1 + kE);     // end within band for substitutions
    b.n++;
  }
  return b;
}

std::string run_emit(const World& w, const Batch& b) {
  uint8_t* out = nullptr;
  int64_t len = 0;
  int rc = fem_emit_batch(
      (const uint8_t*)w.genome.data(), w.ref_offsets.data(),
      w.ref_lens.data(), (const uint8_t*)w.ref_name.data(),
      w.name_offsets.data(), 1, (const uint8_t*)b.names_blob.data(),
      b.name_offsets.data(), (const uint8_t*)b.seqs_blob.data(),
      b.seq_offsets.data(), (const uint8_t*)b.quals_blob.data(), b.n,
      b.map_counts.data(), b.m_dir.data(), b.m_ed.data(), b.m_sid.data(),
      b.m_pos.data(), b.m_end.data(), kE, &out, &len, nullptr);
  if (rc != 0) { fprintf(stderr, "emit rc=%d\n", rc); exit(2); }
  std::string s((const char*)out, (size_t)len);
  fem_free(out);
  return s;
}

void* make_mapper(const World& w) {
  void* h = fem_mapper_create(
      (const uint8_t*)w.genome.data(), w.ref_offsets.data(),
      (const uint8_t*)w.ref_name.data(), w.name_offsets.data(), 1,
      w.lookup.data(), w.occ.data(), w.occ.size(), kK, kStep, kE, kA);
  if (!h) { fprintf(stderr, "mapper_create failed\n"); exit(2); }
  return h;
}

uint64_t run_map(void* h, const Batch& b) {
  uint8_t* out = nullptr;
  int64_t len = 0;
  uint64_t stats[5] = {0, 0, 0, 0, 0};
  int rc = fem_mapper_map(h, (const uint8_t*)b.names_blob.data(),
                          b.name_offsets.data(),
                          (const uint8_t*)b.seqs_blob.data(),
                          b.seq_offsets.data(),
                          (const uint8_t*)b.quals_blob.data(), b.n, &out,
                          &len, stats);
  if (rc != 0) { fprintf(stderr, "map rc=%d\n", rc); exit(2); }
  fem_free(out);
  return stats[1];  // mapped reads
}

}  // namespace

int main() {
  World w = build_world(200000);

  // --- contract 1: concurrent fem_emit_batch (drain-thread pattern) ----
  const int kEmitThreads = 4, kEmitIters = 30;
  Batch shared_batch = make_batch(w, 64, 999);
  const std::string expect = run_emit(w, shared_batch);
  std::vector<std::thread> ts;
  std::vector<int> emit_ok(kEmitThreads, 0);
  for (int t = 0; t < kEmitThreads; ++t) {
    ts.emplace_back([&, t] {
      int ok = 0;
      for (int it = 0; it < kEmitIters; ++it) {
        Batch own = make_batch(w, 48, 1000 + t * 100 + it);
        run_emit(w, own);
        if (run_emit(w, shared_batch) == expect) ok++;  // determinism
      }
      emit_ok[t] = ok;
    });
  }
  for (auto& t : ts) t.join();
  ts.clear();
  for (int t = 0; t < kEmitThreads; ++t) {
    if (emit_ok[t] != kEmitIters) {
      fprintf(stderr, "emit thread %d: %d/%d deterministic\n", t, emit_ok[t],
              kEmitIters);
      return 3;
    }
  }

  // --- contract 2a: one mapper handle per thread, shared RO views ------
  const int kMapThreads = 3, kMapIters = 10;
  std::vector<uint64_t> mapped(kMapThreads, 0);
  for (int t = 0; t < kMapThreads; ++t) {
    ts.emplace_back([&, t] {
      void* h = make_mapper(w);
      for (int it = 0; it < kMapIters; ++it)
        mapped[t] += run_map(h, make_batch(w, 32, 5000 + t * 100 + it));
      fem_mapper_destroy(h);
    });
  }
  for (auto& t : ts) t.join();
  ts.clear();

  // --- contract 2b: SHARED handle serialized by a mutex (mapper.py) ----
  void* shared_h = make_mapper(w);
  std::mutex mu;
  std::vector<uint64_t> mapped2(kMapThreads, 0);
  for (int t = 0; t < kMapThreads; ++t) {
    ts.emplace_back([&, t] {
      for (int it = 0; it < kMapIters; ++it) {
        Batch b = make_batch(w, 32, 9000 + t * 100 + it);
        std::lock_guard<std::mutex> g(mu);
        mapped2[t] += run_map(shared_h, b);
      }
    });
  }
  for (auto& t : ts) t.join();
  fem_mapper_destroy(shared_h);

  uint64_t total = 0;
  for (auto v : mapped) total += v;
  for (auto v : mapped2) total += v;
  printf("tsan_stress ok: emit %dx%d deterministic, %llu reads mapped\n",
         kEmitThreads, kEmitIters, (unsigned long long)total);
  return 0;
}
