// Native host-side data path: batch collation and const-len packing.
//
// A copy of the JAX package's collate.cpp (no framework in it). The
// tokenized corpus lives as one flat int32 token buffer plus row offsets,
// and these loops do the per-batch gather/pad/mask fills and the EOS-join
// packing without touching the Python interpreter, so the prefetch
// worker (data/prefetch.py) spends its time in C++ and not under the GIL
// that the training loop's thread needs.
//
// Exposed as plain C symbols; built with g++ at first use into build/
// and loaded from Python with ctypes (acco_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>

extern "C" {

// Fill input_ids/attention_mask/labels [n_idx, max_len] from the flat
// token buffer. Rows are truncated to max_len; the tail is pad_id with
// mask 0 and labels ignore_index.
void collate_batch(const int32_t* flat, const int64_t* offsets,
                   const int64_t* idx, int64_t n_idx, int64_t max_len,
                   int32_t pad_id, int32_t ignore_index, int32_t* input_ids,
                   int32_t* attention_mask, int32_t* labels) {
  for (int64_t r = 0; r < n_idx; ++r) {
    const int64_t row = idx[r];
    const int64_t start = offsets[row];
    int64_t len = offsets[row + 1] - start;
    if (len > max_len) len = max_len;
    int32_t* ids_out = input_ids + r * max_len;
    int32_t* am_out = attention_mask + r * max_len;
    int32_t* lab_out = labels + r * max_len;
    std::memcpy(ids_out, flat + start, len * sizeof(int32_t));
    std::memcpy(lab_out, flat + start, len * sizeof(int32_t));
    for (int64_t t = 0; t < len; ++t) am_out[t] = 1;
    for (int64_t t = len; t < max_len; ++t) {
      ids_out[t] = pad_id;
      am_out[t] = 0;
      lab_out[t] = ignore_index;
    }
  }
}

// EOS-join packing (the JAX package's data/tokenize.py pack_const_len):
// concatenate every row followed by eos, slice into ctx_len rows, drop
// the remainder. Returns the number of packed rows written.
// out must hold at least ((total_tokens + n_rows) / ctx_len) * ctx_len.
int64_t pack_const_len(const int32_t* flat, const int64_t* offsets,
                       int64_t n_rows, int64_t ctx_len, int32_t eos_id,
                       int32_t* out) {
  int64_t written = 0;  // tokens emitted into the packed stream
  const int64_t total = (offsets[n_rows] + n_rows) / ctx_len * ctx_len;
  for (int64_t row = 0; row < n_rows && written < total; ++row) {
    const int64_t start = offsets[row];
    const int64_t len = offsets[row + 1] - start;
    int64_t take = len;
    if (written + take > total) take = total - written;
    std::memcpy(out + written, flat + start, take * sizeof(int32_t));
    written += take;
    if (written < total) out[written++] = eos_id;
  }
  return written / ctx_len;
}

}  // extern "C"
