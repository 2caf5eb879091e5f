// Byte-pair-encoding trainer: the merge loop, incremental-index variant.
//
// Role: the compute-heavy half of tokenizer training (data/bpe.py). The
// reference consumes pretrained tiktoken vocabularies only
// (ref Src/Main_Scripts/core/tokenizer.py:36); this framework trains its
// own vocab offline, and the naive Python merge loop is O(n_merges *
// corpus) — this implementation keeps a pair->count map plus a
// pair->words-containing index and updates both incrementally per merge,
// touching only affected words. Python fallback in data/bpe.py implements
// the identical algorithm (same deterministic tie-break: highest count,
// then smallest (a, b) pair), so outputs are bit-identical.
//
// C ABI (ctypes, see native/__init__.py):
//   bpe_train(word_data, word_offsets, word_counts, n_words,
//             n_merges, merges_out) -> n_produced
//   words are unique pretoken byte sequences (ids 0-255); counts are
//   their corpus frequencies; merge i creates token id 256+i.

#include <cstdint>
#include <cstring>
#include <map>
#include <unordered_map>
#include <unordered_set>
#include <utility>
#include <vector>

namespace {

using Pair = std::pair<int32_t, int32_t>;

struct PairHash {
  size_t operator()(const Pair& p) const {
    return (static_cast<size_t>(p.first) << 32) ^
           static_cast<uint32_t>(p.second);
  }
};

}  // namespace

extern "C" {

int32_t bpe_train(const int32_t* word_data, const int64_t* word_offsets,
                  const int64_t* word_counts, int32_t n_words,
                  int32_t n_merges, int32_t* merges_out) {
  // Working copy of every word's token sequence.
  std::vector<std::vector<int32_t>> words(n_words);
  for (int32_t w = 0; w < n_words; ++w) {
    words[w].assign(word_data + word_offsets[w], word_data + word_offsets[w + 1]);
  }

  std::unordered_map<Pair, int64_t, PairHash> pair_count;
  std::unordered_map<Pair, std::unordered_set<int32_t>, PairHash> pair_words;
  for (int32_t w = 0; w < n_words; ++w) {
    const auto& seq = words[w];
    for (size_t i = 0; i + 1 < seq.size(); ++i) {
      Pair p{seq[i], seq[i + 1]};
      pair_count[p] += word_counts[w];
      pair_words[p].insert(w);
    }
  }

  int32_t produced = 0;
  for (; produced < n_merges; ++produced) {
    // Deterministic argmax: highest count, tie-break smallest (a, b).
    Pair best{-1, -1};
    int64_t best_count = 0;
    for (const auto& kv : pair_count) {
      if (kv.second > best_count ||
          (kv.second == best_count && best_count > 0 && kv.first < best)) {
        best = kv.first;
        best_count = kv.second;
      }
    }
    if (best_count < 2) break;  // nothing left worth merging

    const int32_t new_id = 256 + produced;
    merges_out[2 * produced] = best.first;
    merges_out[2 * produced + 1] = best.second;

    // Rewrite only the words that contain the merged pair, updating the
    // index incrementally.
    auto affected_it = pair_words.find(best);
    std::vector<int32_t> affected(affected_it->second.begin(),
                                  affected_it->second.end());
    for (int32_t w : affected) {
      auto& seq = words[w];
      const int64_t cnt = word_counts[w];
      // Remove this word's contribution to all of its pairs.
      for (size_t i = 0; i + 1 < seq.size(); ++i) {
        Pair p{seq[i], seq[i + 1]};
        auto it = pair_count.find(p);
        if (it != pair_count.end() && (it->second -= cnt) <= 0)
          pair_count.erase(it);
        auto pw = pair_words.find(p);
        if (pw != pair_words.end()) pw->second.erase(w);
      }
      // Apply the merge within the word.
      std::vector<int32_t> out;
      out.reserve(seq.size());
      for (size_t i = 0; i < seq.size();) {
        if (i + 1 < seq.size() && seq[i] == best.first &&
            seq[i + 1] == best.second) {
          out.push_back(new_id);
          i += 2;
        } else {
          out.push_back(seq[i]);
          ++i;
        }
      }
      seq.swap(out);
      // Re-add contributions.
      for (size_t i = 0; i + 1 < seq.size(); ++i) {
        Pair p{seq[i], seq[i + 1]};
        pair_count[p] += cnt;
        pair_words[p].insert(w);
      }
    }
    pair_count.erase(best);
    pair_words.erase(best);
  }
  return produced;
}

}  // extern "C"
