// Native window sweep: the host-side hot loop of the prepare pipeline
// (SURVEY.md section 4.1). Exactly mirrors sert_tpu_torch/data/windows.py:
//   - n_tok >= w: (n_tok - w) / stride + 1 windows of length w
//   - 0 < n_tok < w: ONE zero-padded window with explicit length
//   - output row order: window-major, entity-minor (row = win * n_ent + ent)
// Built as a plain C ABI shared library, loaded via ctypes
// (sert_tpu_torch/native/loader.py); the numpy implementation remains the
// reference and fallback. Parity is enforced by tests/test_native.py.
//
// Built at first use by loader.py (g++ -O3 -mtune=generic -shared -fPIC)

#include <cstdint>
#include <cstring>

extern "C" {

int64_t sert_window_count(int64_t n_tok, int64_t window, int64_t stride) {
  if (n_tok <= 0) return 0;
  if (n_tok < window) return 1;
  return (n_tok - window) / stride + 1;
}

// out_windows: [n_win * n_ent, window] int32 (caller-zeroed: padding stays 0)
// out_lengths: [n_win * n_ent]
// out_entities: [n_win * n_ent]
void sert_extract_windows(const int32_t* token_ids, int64_t n_tok,
                          const int32_t* entity_ids, int64_t n_ent,
                          int64_t window, int64_t stride,
                          int32_t* out_windows, int32_t* out_lengths,
                          int32_t* out_entities) {
  const int64_t n_win = sert_window_count(n_tok, window, stride);
  if (n_win == 0 || n_ent == 0) return;

  if (n_tok < window) {
    // single padded window replicated per entity
    for (int64_t e = 0; e < n_ent; ++e) {
      std::memcpy(out_windows + e * window, token_ids,
                  n_tok * sizeof(int32_t));
      out_lengths[e] = static_cast<int32_t>(n_tok);
      out_entities[e] = entity_ids[e];
    }
    return;
  }

  for (int64_t wi = 0; wi < n_win; ++wi) {
    const int32_t* src = token_ids + wi * stride;
    const int64_t row0 = wi * n_ent;
    for (int64_t e = 0; e < n_ent; ++e) {
      std::memcpy(out_windows + (row0 + e) * window, src,
                  window * sizeof(int32_t));
      out_lengths[row0 + e] = static_cast<int32_t>(window);
      out_entities[row0 + e] = entity_ids[e];
    }
  }
}

// Batched variant: sweep MANY documents in one call, avoiding per-doc
// Python/ctypes overhead. Documents are concatenated:
//   doc_offsets[i]..doc_offsets[i+1]  token range of doc i   (n_docs+1)
//   ent_offsets[i]..ent_offsets[i+1]  entity range of doc i  (n_docs+1)
// Caller sizes outputs with sert_batch_instance_count.
int64_t sert_batch_instance_count(const int64_t* doc_offsets,
                                  const int64_t* ent_offsets, int64_t n_docs,
                                  int64_t window, int64_t stride) {
  int64_t total = 0;
  for (int64_t i = 0; i < n_docs; ++i) {
    const int64_t n_tok = doc_offsets[i + 1] - doc_offsets[i];
    const int64_t n_ent = ent_offsets[i + 1] - ent_offsets[i];
    total += sert_window_count(n_tok, window, stride) * n_ent;
  }
  return total;
}

void sert_extract_windows_batch(const int32_t* tokens,
                                const int64_t* doc_offsets,
                                const int32_t* entities,
                                const int64_t* ent_offsets, int64_t n_docs,
                                int64_t window, int64_t stride,
                                int32_t* out_windows, int32_t* out_lengths,
                                int32_t* out_entities) {
  int64_t row = 0;
  for (int64_t i = 0; i < n_docs; ++i) {
    const int64_t n_tok = doc_offsets[i + 1] - doc_offsets[i];
    const int64_t n_ent = ent_offsets[i + 1] - ent_offsets[i];
    const int64_t n_rows =
        sert_window_count(n_tok, window, stride) * n_ent;
    if (n_rows == 0) continue;
    sert_extract_windows(tokens + doc_offsets[i], n_tok,
                         entities + ent_offsets[i], n_ent, window, stride,
                         out_windows + row * window, out_lengths + row,
                         out_entities + row);
    row += n_rows;
  }
}

}  // extern "C"
