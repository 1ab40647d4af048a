// In-process C API over the CPU mapping core (mapper_core.h): the
// engine's fast, exact fallback for reads that overflow the device
// pipeline's static capacities (the golden Python path remains the
// last-resort oracle). All buffers are caller-owned views; the Python
// wrapper keeps them alive for the handle's lifetime.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>

#include "mapper_core.h"

using namespace femtpu;

namespace {

struct MapperHandle {
  RefView ref;
  IndexView index;
  MapParams params;
  CpuMapper* mapper = nullptr;
};

}  // namespace

extern "C" {

void* fem_mapper_create(const uint8_t* ref_blob, const int64_t* ref_offsets,
                        const uint8_t* ref_names_blob,
                        const int64_t* ref_name_offsets, int32_t num_refs,
                        const uint32_t* lookup, const uint64_t* occ,
                        uint64_t occ_size, int32_t k, int32_t step,
                        int32_t e, int32_t a) {
  auto* h = new MapperHandle();
  h->ref = RefView{ref_blob, ref_offsets, ref_names_blob, ref_name_offsets,
                   num_refs};
  h->index = IndexView{k, step, lookup, occ, occ_size};
  h->params = MapParams{e, a};
  h->mapper = new CpuMapper(h->ref, h->index, h->params);
  return h;
}

void fem_mapper_destroy(void* vh) {
  auto* h = (MapperHandle*)vh;
  delete h->mapper;
  delete h;
}

// Maps a batch of reads; returns a malloc'd SAM blob (freed via fem_free
// from emit.cpp) and fills stats_out[5] with {reads, mapped, cand_pre,
// cand, mappings}. Returns 0 on success.
int fem_mapper_map(void* vh, const uint8_t* names_blob,
                   const int64_t* name_offsets, const uint8_t* seqs_blob,
                   const int64_t* seq_offsets, const uint8_t* quals_blob,
                   int32_t num_reads, uint8_t** out_buf, int64_t* out_len,
                   uint64_t stats_out[5]) {
  auto* h = (MapperHandle*)vh;
  std::string out;
  MapStats st;
  for (int32_t i = 0; i < num_reads; ++i) {
    h->mapper->map_read(
        names_blob + name_offsets[i], name_offsets[i + 1] - name_offsets[i],
        seqs_blob + seq_offsets[i], seq_offsets[i + 1] - seq_offsets[i],
        quals_blob + seq_offsets[i], st, out);
  }
  stats_out[0] = st.reads;
  stats_out[1] = st.mapped;
  stats_out[2] = st.cand_pre;
  stats_out[3] = st.cand;
  stats_out[4] = st.mappings;
  *out_len = (int64_t)out.size();
  *out_buf = (uint8_t*)malloc(out.size() ? out.size() : 1);
  if (!*out_buf) return 1;
  memcpy(*out_buf, out.data(), out.size());
  return 0;
}

}  // extern "C"
