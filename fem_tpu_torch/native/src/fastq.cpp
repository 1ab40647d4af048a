// Native FASTQ batch reader.
//
// Streaming, gzip-capable FASTQ parsing (the reference's kseq role,
// src/kseq.h:185-242 / src/sequence_batch.c:44-80) producing exactly the
// buffers the engine consumes: the packed (B, Lmax+4) uint8 device upload
// (2-bit-with-ambiguity codes + little-endian length) plus raw
// name/seq/qual blobs with offsets for SAM emission. One C call per
// 10k-read batch replaces per-record Python work.

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "align_core.h"

namespace {

struct FastqHandle {
  gzFile f = nullptr;
  std::vector<char> buf;
  int pos = 0, len = 0;
  bool eof = false;

  bool fill() {
    if (eof) return false;
    len = gzread(f, buf.data(), (unsigned)buf.size());
    pos = 0;
    if (len <= 0) {
      eof = true;
      return false;
    }
    return true;
  }
  // Reads one line into out (no newline); returns false on EOF with
  // nothing read.
  bool getline(std::string& out) {
    out.clear();
    while (true) {
      if (pos >= len && !fill()) return !out.empty();
      char* nl = (char*)memchr(buf.data() + pos, '\n', len - pos);
      if (nl) {
        size_t n = nl - (buf.data() + pos);
        out.append(buf.data() + pos, n);
        pos += (int)n + 1;
        if (!out.empty() && out.back() == '\r') out.pop_back();
        return true;
      }
      out.append(buf.data() + pos, len - pos);
      pos = len;
    }
  }
};

}  // namespace

extern "C" {

void* fem_fastq_open(const char* path) {
  auto* h = new FastqHandle();
  h->f = gzopen(path, "rb");
  if (!h->f) {
    delete h;
    return nullptr;
  }
  h->buf.resize(1 << 20);
  return h;
}

void fem_fastq_close(void* vh) {
  auto* h = (FastqHandle*)vh;
  if (h->f) gzclose(h->f);
  delete h;
}

// Parses up to max_reads records. Returns the number parsed (0 at EOF), or
//   -1 if a blob capacity was exceeded mid-batch,
//   -2 if a read exceeds max_len,
//   -3 on malformed input.
// On -1/-2 the stream position is NOT rewindable — callers treat these as
// fatal for the native path and re-run the file with the Python parser.
//
// codes: (max_reads, max_len+4) uint8 rows: encoded bases (pad value 4)
// followed by the LE32 read length. name_offsets/seq_offsets have
// max_reads+1 entries; the qual blob shares seq_offsets.
int64_t fem_fastq_next_batch(void* vh, int32_t max_reads, int32_t max_len,
                             uint8_t* codes, uint8_t* names_blob,
                             int64_t names_cap, int64_t* name_offsets,
                             uint8_t* seqs_blob, int64_t seqs_cap,
                             int64_t* seq_offsets, uint8_t* quals_blob) {
  auto* h = (FastqHandle*)vh;
  const int64_t row = (int64_t)max_len + 4;
  int32_t n = 0;
  int64_t npos = 0, spos = 0;
  name_offsets[0] = 0;
  seq_offsets[0] = 0;
  static thread_local std::string line, seq, qual;
  while (n < max_reads) {
    if (!h->getline(line)) break;
    if (line.empty()) continue;
    if (line[0] != '@') return -3;
    size_t sp = line.find_first_of(" \t", 1);
    size_t name_len = (sp == std::string::npos ? line.size() : sp) - 1;
    if (npos + (int64_t)name_len > names_cap) return -1;
    memcpy(names_blob + npos, line.data() + 1, name_len);

    seq.clear();
    while (h->getline(line)) {
      if (!line.empty() && line[0] == '+') break;
      seq += line;
    }
    qual.clear();
    while (qual.size() < seq.size() && h->getline(line)) qual += line;
    const int64_t L = (int64_t)seq.size();
    if (L > max_len) return -2;
    if (qual.size() != seq.size()) return -3;
    if (spos + L > seqs_cap) return -1;
    memcpy(seqs_blob + spos, seq.data(), L);
    memcpy(quals_blob + spos, qual.data(), L);

    uint8_t* crow = codes + (int64_t)n * row;
    for (int64_t i = 0; i < L; ++i) crow[i] = femtpu::c2c((uint8_t)seq[i]);
    memset(crow + L, 4, max_len - L);
    uint32_t len32 = (uint32_t)L;
    memcpy(crow + max_len, &len32, 4);

    npos += name_len;
    spos += L;
    ++n;
    name_offsets[n] = npos;
    seq_offsets[n] = spos;
  }
  return n;
}

}  // extern "C"
