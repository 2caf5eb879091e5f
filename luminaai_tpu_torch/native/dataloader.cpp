// Native batch packer for the memmap token store.
//
// Covers the data-path role the reference fills with C++/CUDA helpers
// (ref: Src/Main_Scripts/core/dataset.py memmap/Arrow fast path + vendored
// ColossalAI C++ kernels): the hot loop of training-input assembly. The
// Python side memory-maps a flat int32 token stream plus a document offset
// table; this library packs documents into fixed [batch, seq_len] rows.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).
//
// Packing semantics (greedy, order-preserving — matches the Python
// fallback packer bit-for-bit so tests can compare):
//   - documents are consumed in order starting at start_doc;
//   - a document is split across row boundaries (base-training style
//     contiguous stream) when split_docs != 0, else truncated to the row;
//   - rows are delimited with eos_id between documents when eos_id >= 0;
//   - remaining space is filled with pad_id and mask 0.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Returns the index of the first UNconsumed document (resume cursor), or -1
// on argument error. out/out_mask are [batch * seq_len], row-major.
long lumina_pack_batch(
    const int32_t* tokens,      // flat token stream
    const int64_t* doc_offsets, // n_docs+1 offsets into tokens
    long n_docs,
    long start_doc,
    long start_token,           // resume offset inside start_doc
    int32_t* out,
    int32_t* out_mask,
    long batch,
    long seq_len,
    int32_t pad_id,
    int32_t eos_id,             // -1: no separator
    int split_docs,             // 1: continue doc across rows
    long* out_token_cursor      // resume offset inside the returned doc
) {
    if (!tokens || !doc_offsets || !out || !out_mask || batch <= 0 ||
        seq_len <= 0 || start_doc < 0) {
        return -1;
    }
    long doc = start_doc;
    long tok_in_doc = start_token;
    const long total = batch * seq_len;
    for (long i = 0; i < total; ++i) {
        out[i] = pad_id;
        out_mask[i] = 0;
    }

    for (long row = 0; row < batch; ++row) {
        long col = 0;
        while (col < seq_len && doc < n_docs) {
            const int64_t beg = doc_offsets[doc] + tok_in_doc;
            const int64_t end = doc_offsets[doc + 1];
            const long avail = static_cast<long>(end - beg);
            if (avail <= 0) {
                ++doc;
                tok_in_doc = 0;
                continue;
            }
            const long room = seq_len - col;
            const long take = std::min(avail, room);
            std::memcpy(out + row * seq_len + col, tokens + beg,
                        static_cast<size_t>(take) * sizeof(int32_t));
            for (long k = 0; k < take; ++k) {
                out_mask[row * seq_len + col + k] = 1;
            }
            col += take;
            if (take == avail) {
                // Document finished: advance and add separator if it fits.
                ++doc;
                tok_in_doc = 0;
                if (eos_id >= 0 && col < seq_len) {
                    out[row * seq_len + col] = eos_id;
                    out_mask[row * seq_len + col] = 1;
                    ++col;
                }
            } else {
                tok_in_doc += take;
                if (!split_docs) {
                    // Truncate: drop the tail of this document.
                    ++doc;
                    tok_in_doc = 0;
                }
                break; // row is full (or truncation point)
            }
        }
        if (doc >= n_docs) break;
    }
    if (out_token_cursor) *out_token_cursor = tok_in_doc;
    return doc;
}

// Newline indexer for jsonl corpora: scans a byte buffer and writes the
// byte offset of each line start into out (capacity max_lines). Returns the
// number of line starts found, or -(needed) when capacity is too small so
// the caller can retry with an exact allocation. Lets the streaming dataset
// seek to record i of a multi-GB jsonl without a Python-side scan.
long lumina_index_lines(
    const char* buf, long n_bytes, int64_t* out, long max_lines
) {
    if (!buf || n_bytes < 0) return -1;
    long count = 0;
    long pos = 0;
    while (pos < n_bytes) {
        if (count < max_lines && out) out[count] = pos;
        ++count;
        const char* nl = static_cast<const char*>(
            memchr(buf + pos, '\n', static_cast<size_t>(n_bytes - pos)));
        if (!nl) break;
        pos = static_cast<long>(nl - buf) + 1;
    }
    if (count > max_lines) return -count;
    return count;
}

// FNV-1a 64-bit content hashes for document deduplication (the multi-source
// blender's dedup stage). One hash per [offsets[i], offsets[i+1]) slice.
void lumina_fnv1a64_batch(
    const char* buf, const int64_t* offsets, long n_docs, uint64_t* out
) {
    if (!buf || !offsets || !out) return;
    for (long d = 0; d < n_docs; ++d) {
        uint64_t h = 14695981039346656037ULL;
        for (int64_t i = offsets[d]; i < offsets[d + 1]; ++i) {
            h ^= static_cast<uint8_t>(buf[i]);
            h *= 1099511628211ULL;
        }
        out[d] = h;
    }
}

// Simple xorshift shuffle of an index array (deterministic per seed) so the
// epoch permutation can also live off the GIL for very large datasets.
void lumina_shuffle_indices(int64_t* idx, long n, uint64_t seed) {
    if (!idx || n <= 1) return;
    uint64_t s = seed ? seed : 0x9E3779B97F4A7C15ULL;
    for (long i = n - 1; i > 0; --i) {
        s ^= s << 13; s ^= s >> 7; s ^= s << 17;
        const long j = static_cast<long>(s % static_cast<uint64_t>(i + 1));
        std::swap(idx[i], idx[j]);
    }
}

}  // extern "C"
