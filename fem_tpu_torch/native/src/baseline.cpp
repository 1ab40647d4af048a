// fem_baseline — standalone CPU all-mapping short-read mapper.
//
// Purpose: (a) a fast differential oracle for large-scale testing of the
// TPU engine (the original reference binary cannot be built here: its
// htslib submodule is not vendored), and (b) the measured CPU baseline for
// bench.py's vs_baseline ratio. The mapping core lives in mapper_core.h,
// shared with the engine's in-process fallback API (capi_mapper.cpp).
//
// Usage:
//   fem_baseline index <k> <step> <ref.fa> <out.index>
//   fem_baseline map -e E -a A -t T --ref R --index I --read1 Q -o OUT

#include <zlib.h>

#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "mapper_core.h"

using namespace femtpu;

namespace {

struct Sequences {
  std::vector<std::string> names;
  std::vector<std::string> seqs;
  std::vector<std::string> quals;  // empty for FASTA
};

class GzLineReader {
 public:
  explicit GzLineReader(const char* path) : f_(gzopen(path, "rb")) {
    if (!f_) {
      fprintf(stderr, "cannot open %s\n", path);
      exit(1);
    }
    buf_.resize(1 << 20);
  }
  ~GzLineReader() {
    if (f_) gzclose(f_);
  }
  bool getline(std::string& out) {
    out.clear();
    while (true) {
      if (pos_ >= len_) {
        len_ = gzread(f_, buf_.data(), (unsigned)buf_.size());
        pos_ = 0;
        if (len_ <= 0) return !out.empty();
      }
      char* nl = (char*)memchr(buf_.data() + pos_, '\n', len_ - pos_);
      if (nl) {
        size_t n = nl - (buf_.data() + pos_);
        out.append(buf_.data() + pos_, n);
        pos_ += n + 1;
        if (!out.empty() && out.back() == '\r') out.pop_back();
        return true;
      }
      out.append(buf_.data() + pos_, len_ - pos_);
      pos_ = len_;
    }
  }

 private:
  gzFile f_;
  std::vector<char> buf_;
  int pos_ = 0, len_ = 0;
};

void load_fasta(const char* path, Sequences& out) {
  GzLineReader r(path);
  std::string line;
  while (r.getline(line)) {
    if (line.empty()) continue;
    if (line[0] == '>') {
      size_t sp = line.find_first_of(" \t", 1);
      out.names.emplace_back(line.substr(
          1, sp == std::string::npos ? std::string::npos : sp - 1));
      out.seqs.emplace_back();
    } else if (!out.seqs.empty()) {
      out.seqs.back() += line;
    }
  }
}

class FastqStream {
 public:
  explicit FastqStream(const char* path) : r_(path) {}
  size_t next_batch(size_t max, Sequences& out) {
    out.names.clear();
    out.seqs.clear();
    out.quals.clear();
    std::string line;
    while (out.seqs.size() < max && r_.getline(line)) {
      if (line.empty()) continue;
      if (line[0] != '@') {
        fprintf(stderr, "malformed FASTQ header\n");
        exit(1);
      }
      size_t sp = line.find_first_of(" \t", 1);
      out.names.emplace_back(
          line.substr(1, sp == std::string::npos ? std::string::npos : sp - 1));
      std::string seq;
      while (r_.getline(line) && !line.empty() && line[0] != '+') seq += line;
      std::string qual;
      while (qual.size() < seq.size() && r_.getline(line)) qual += line;
      out.seqs.push_back(std::move(seq));
      out.quals.push_back(std::move(qual));
    }
    return out.seqs.size();
  }

 private:
  GzLineReader r_;
};

struct Index {
  int32_t k = 12;
  int32_t step = 3;
  std::vector<uint32_t> lookup;
  std::vector<uint64_t> occ;
};

inline uint32_t hash_at(const char* s, size_t pos, int k) {
  uint32_t h = 0;
  for (int i = 0; i < k; ++i) {
    uint8_t b = c2c((uint8_t)s[pos + i]);
    h = (h << 2) | (b < 4 ? b : 0);
  }
  return h & ((1u << (2 * k)) - 1);
}

void build_index(const Sequences& ref, int k, int step, Index& index) {
  index.k = k;
  index.step = step;
  size_t buckets = (size_t)1 << (2 * k);
  index.lookup.assign(buckets + 1, 0);
  for (auto& s : ref.seqs) {
    if ((int64_t)s.size() < k) continue;
    for (size_t p = 0; p + k - 1 < s.size(); p += step)
      ++index.lookup[hash_at(s.data(), p, k) + 1];
  }
  for (size_t i = 1; i <= buckets; ++i) index.lookup[i] += index.lookup[i - 1];
  index.occ.resize(index.lookup[buckets]);
  std::vector<uint32_t> cursor(index.lookup.begin(), index.lookup.end() - 1);
  for (size_t sid = 0; sid < ref.seqs.size(); ++sid) {
    const std::string& s = ref.seqs[sid];
    if ((int64_t)s.size() < k) continue;
    for (size_t p = 0; p + k - 1 < s.size(); p += step) {
      uint32_t h = hash_at(s.data(), p, k);
      index.occ[cursor[h]++] = ((uint64_t)sid << 32) | (uint32_t)p;
    }
  }
}

void save_index(const Index& index, const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) { fprintf(stderr, "cannot write %s\n", path); exit(1); }
  fwrite(&index.k, 4, 1, f);
  fwrite(&index.step, 4, 1, f);
  fwrite(index.lookup.data(), 4, index.lookup.size(), f);
  uint64_t n = index.occ.size();
  fwrite(&n, 8, 1, f);
  fwrite(index.occ.data(), 8, n, f);
  fclose(f);
}

void load_index(const char* path, Index& index) {
  FILE* f = fopen(path, "rb");
  if (!f) { fprintf(stderr, "cannot open %s\n", path); exit(1); }
  if (fread(&index.k, 4, 1, f) != 1 || fread(&index.step, 4, 1, f) != 1) {
    fprintf(stderr, "bad index header\n"); exit(1);
  }
  size_t buckets = (size_t)1 << (2 * index.k);
  index.lookup.resize(buckets + 1);
  if (fread(index.lookup.data(), 4, buckets + 1, f) != buckets + 1) {
    fprintf(stderr, "truncated lookup\n"); exit(1);
  }
  uint64_t n = 0;
  if (fread(&n, 8, 1, f) != 1) { fprintf(stderr, "bad occ size\n"); exit(1); }
  index.occ.resize(n);
  if (fread(index.occ.data(), 8, n, f) != n) {
    fprintf(stderr, "truncated occ\n"); exit(1);
  }
  fclose(f);
}

// Non-owning views over the loaded data (blob form for mapper_core).
struct RefStore {
  std::string blob, names;
  std::vector<int64_t> offsets, name_offsets;
  RefView view(const Sequences& ref) {
    offsets.assign(1, 0);
    name_offsets.assign(1, 0);
    for (auto& s : ref.seqs) {
      blob += s;
      offsets.push_back((int64_t)blob.size());
    }
    for (auto& n : ref.names) {
      names += n;
      name_offsets.push_back((int64_t)names.size());
    }
    RefView v;
    v.blob = (const uint8_t*)blob.data();
    v.offsets = offsets.data();
    v.names_blob = (const uint8_t*)names.data();
    v.name_offsets = name_offsets.data();
    v.n = (int32_t)ref.seqs.size();
    return v;
  }
};

int index_main(int argc, char** argv) {
  if (argc < 5) {
    fprintf(stderr, "Usage: fem_baseline index <k> <step> <ref> <out>\n");
    return 1;
  }
  int k = atoi(argv[1]), step = atoi(argv[2]);
  Sequences ref;
  load_fasta(argv[3], ref);
  Index index;
  build_index(ref, k, step, index);
  fprintf(stderr, "Collected %zu seeds.\n", index.occ.size());
  save_index(index, argv[4]);
  return 0;
}

int map_main(int argc, char** argv) {
  MapParams P;
  int threads = 1;
  const char* ref_path = nullptr;
  const char* index_path = nullptr;
  const char* reads_path = nullptr;
  const char* out_path = nullptr;
  for (int i = 1; i < argc; ++i) {
    std::string s = argv[i];
    auto next = [&]() { return argv[++i]; };
    if (s == "-e") P.e = atoi(next());
    else if (s == "-a") P.a = atoi(next());
    else if (s == "-t") threads = atoi(next());
    else if (s == "--ref") ref_path = next();
    else if (s == "--index") index_path = next();
    else if (s == "--read1") reads_path = next();
    else if (s == "-o") out_path = next();
  }
  if (!ref_path || !index_path || !reads_path || !out_path || P.e < 0 ||
      P.e > 7 || P.a < 0 || P.a > 2 || threads < 1) {
    fprintf(stderr, "bad args\n");
    return 1;
  }
  Sequences ref;
  load_fasta(ref_path, ref);
  Index index;
  load_index(index_path, index);
  RefStore store;
  RefView rv = store.view(ref);
  IndexView iv{index.k, index.step, index.lookup.data(), index.occ.data(),
               index.occ.size()};

  FILE* out = fopen(out_path, "wb");
  if (!out) { fprintf(stderr, "cannot write %s\n", out_path); return 1; }
  {
    std::string hdr;
    for (size_t i = 0; i < ref.names.size(); ++i)
      hdr += "@SQ\tSN:" + ref.names[i] +
             "\tLN:" + std::to_string(ref.seqs[i].size()) + "\n";
    fwrite(hdr.data(), 1, hdr.size(), out);
  }
  FastqStream reads(reads_path);
  MapStats total;
  const size_t kBatch = 10000;
  Sequences batch;
  while (reads.next_batch(kBatch, batch)) {
    size_t n = batch.seqs.size();
    int T = threads;
    std::vector<MapStats> st(T);
    std::vector<std::string> outs(T);
    std::vector<std::thread> pool;
    size_t per = (n + T - 1) / T;
    for (int t = 0; t < T; ++t) {
      pool.emplace_back([&, t]() {
        CpuMapper mapper(rv, iv, P);
        size_t lo = t * per, hi = std::min(n, lo + per);
        for (size_t i = lo; i < hi; ++i) {
          const std::string& q = batch.quals[i];
          std::string qfill;
          const uint8_t* qp;
          if (q.size() == batch.seqs[i].size()) {
            qp = (const uint8_t*)q.data();
          } else {
            qfill.assign(batch.seqs[i].size(), 'I');
            qp = (const uint8_t*)qfill.data();
          }
          mapper.map_read((const uint8_t*)batch.names[i].data(),
                          (int64_t)batch.names[i].size(),
                          (const uint8_t*)batch.seqs[i].data(),
                          (int64_t)batch.seqs[i].size(), qp, st[t], outs[t]);
        }
      });
    }
    for (auto& th : pool) th.join();
    for (int t = 0; t < T; ++t) {
      total += st[t];
      fwrite(outs[t].data(), 1, outs[t].size(), out);
    }
    if (batch.seqs.size() < kBatch) break;
  }
  fclose(out);
  fprintf(stderr, "The number of read: %" PRIu64 "\n", total.reads);
  fprintf(stderr, "The number of mapped read: %" PRIu64 "\n", total.mapped);
  fprintf(stderr,
          "The number of candidate before additional q-gram filter: %" PRIu64
          "\n",
          total.cand_pre);
  fprintf(stderr, "The number of candidate: %" PRIu64 "\n", total.cand);
  fprintf(stderr, "The number of mapping: %" PRIu64 "\n", total.mappings);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "Usage: fem_baseline <index|map> ...\n");
    return 1;
  }
  if (!strcmp(argv[1], "index")) return index_main(argc - 1, argv + 1);
  if (!strcmp(argv[1], "map")) return map_main(argc - 1, argv + 1);
  fprintf(stderr, "unknown command %s\n", argv[1]);
  return 1;
}
