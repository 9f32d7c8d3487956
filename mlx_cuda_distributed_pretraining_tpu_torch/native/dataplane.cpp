// Native data-plane: byte-level tokenization + fixed-shape sequence packing.
//
// The port's copy of the JAX package's native/dataplane.cpp (the same code).
// The device runs the model; the host's CPU-bound hot loop is corpus
// tokenization and packing, implemented here and exposed through ctypes
// (native/__init__.py) with byte-exact parity with the Python path
// (data/memory.py + data/packing.py).
//
// Semantics mirrored exactly (held by tests/test_torch_native.py):
//   per doc:  toks = [bos] + [b for b in utf8(text) if b < normal_vocab][:max_doc_tokens] + [eos]
//   chunking: if len > row_len: windows of row_len every (row_len - overlap)
//             over range(0, len - overlap)           (packing.py:chunk_tokens)
//   packing:  concatenate all chunks, cut into row_len rows, pad tail
//             (packing.py:pack_documents)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC into build/native/ (native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// Token count of one doc after byte filtering + truncation + BOS/EOS.
inline int64_t doc_tokens(const uint8_t* p, int64_t len, int32_t normal_vocab,
                          int64_t max_doc_tokens) {
  int64_t n;
  if (normal_vocab >= 256) {
    n = len;
  } else {
    n = 0;
    for (int64_t i = 0; i < len; ++i) n += (p[i] < normal_vocab);
  }
  return std::min(n, max_doc_tokens) + 2;
}

// Total stream length contributed by a doc of n tokens after chunking.
inline int64_t chunked_tokens(int64_t n, int64_t row_len, int64_t overlap) {
  if (n <= row_len) return n;
  int64_t step = std::max<int64_t>(1, row_len - overlap);
  int64_t total = 0;
  for (int64_t i = 0; i < n - overlap; i += step) total += std::min(row_len, n - i);
  return total;
}

}  // namespace

extern "C" {

// Exact number of stream tokens the fill call will produce BEFORE tail
// padding. Python uses this to allocate the output row array.
int64_t byte_pack_count(const uint8_t* data, const int64_t* offsets,
                        int64_t n_docs, int32_t normal_vocab,
                        int64_t max_doc_tokens, int64_t row_len,
                        int64_t overlap) {
  int64_t total = 0;
  for (int64_t d = 0; d < n_docs; ++d) {
    int64_t n = doc_tokens(data + offsets[d], offsets[d + 1] - offsets[d],
                           normal_vocab, max_doc_tokens);
    total += chunked_tokens(n, row_len, overlap);
  }
  return total;
}

// Tokenize + chunk + pack into `out` (capacity `out_capacity` int32 tokens).
// Returns tokens written including tail padding (a multiple of row_len),
// or -1 if capacity would be exceeded.
int64_t byte_pack_fill(const uint8_t* data, const int64_t* offsets,
                       int64_t n_docs, int32_t normal_vocab,
                       int64_t max_doc_tokens, int64_t row_len, int64_t overlap,
                       int32_t bos, int32_t eos, int32_t pad, int32_t* out,
                       int64_t out_capacity) {
  std::vector<int32_t> toks;
  int64_t pos = 0;
  for (int64_t d = 0; d < n_docs; ++d) {
    const uint8_t* p = data + offsets[d];
    int64_t len = offsets[d + 1] - offsets[d];
    toks.clear();
    toks.push_back(bos);
    for (int64_t i = 0; i < len && (int64_t)toks.size() - 1 < max_doc_tokens; ++i) {
      if (p[i] < normal_vocab) toks.push_back((int32_t)p[i]);
    }
    toks.push_back(eos);
    int64_t n = (int64_t)toks.size();
    if (n <= row_len) {
      if (pos + n > out_capacity) return -1;
      std::copy(toks.begin(), toks.end(), out + pos);
      pos += n;
    } else {
      int64_t step = std::max<int64_t>(1, row_len - overlap);
      for (int64_t i = 0; i < n - overlap; i += step) {
        int64_t c = std::min(row_len, n - i);
        if (pos + c > out_capacity) return -1;
        std::copy(toks.begin() + i, toks.begin() + i + c, out + pos);
        pos += c;
      }
    }
  }
  while (pos % row_len != 0) {
    if (pos >= out_capacity) return -1;
    out[pos++] = pad;
  }
  return pos;
}

}  // extern "C"
