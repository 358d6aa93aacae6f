// Native corpus-BLEU statistics over token-id sequences (a copy of the JAX
// package's native/bleu.cpp, kept with the port so that the port builds
// from its own sources).
//
// Computes, for n-gram orders 1..max_order, the corpus-level clipped match
// numerators and denominators plus the brevity-penalty length sums — the
// exact quantities nltk's corpus_bleu accumulates (the reference scores
// BLEU-1..4 with nltk on ~25k sentences per validation epoch; pure-Python
// Counter loops are the host bottleneck there).  The Python wrapper applies
// the nltk-quirk finalization (per-sentence denominator >= 1 is handled
// HERE; zero-precision -> DBL_MIN and the weighted exp-sum happen in Python).
//
// Exactness: n-grams (n<=8) are compared via 2x64-bit packed keys
// (two tokens per 32 bits), no lossy hashing.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Key {
  uint64_t a, b;
  bool operator==(const Key& o) const { return a == o.a && b == o.b; }
};

struct KeyHash {
  size_t operator()(const Key& k) const {
    uint64_t h = k.a * 0x9E3779B97F4A7C15ull;
    h ^= (k.b + 0x9E3779B97F4A7C15ull + (h << 6) + (h >> 2));
    return static_cast<size_t>(h ^ (h >> 29));
  }
};

inline Key make_key(const int32_t* toks, int n) {
  Key k{0, 0};
  for (int i = 0; i < n && i < 2; ++i)
    k.a |= (static_cast<uint64_t>(static_cast<uint32_t>(toks[i])) << (32 * i));
  for (int i = 2; i < n; ++i)
    k.b |= (static_cast<uint64_t>(static_cast<uint32_t>(toks[i])) << (32 * (i - 2)));
  // Disambiguate different n sharing the same packed prefix (e.g. [5] vs
  // [5, 0]): mix the order into the high bits of b.
  k.b ^= (static_cast<uint64_t>(n) << 56);
  return k;
}

using CountMap = std::unordered_map<Key, int64_t, KeyHash>;

void count_ngrams(const int32_t* toks, int64_t len, int n, CountMap& out) {
  out.clear();
  for (int64_t i = 0; i + n <= len; ++i) out[make_key(toks + i, n)] += 1;
}

}  // namespace

extern "C" {

// hyp_tokens/hyp_offsets: n_hyps sentences; hyp_offsets has n_hyps+1 entries.
// ref_tokens/ref_offsets: total_refs sentences (grouped per hypothesis, in
// order); ref_offsets has total_refs+1 entries; ref_counts[i] = number of
// references for hypothesis i.
// Outputs: numerators/denominators sized max_order; hyp_len/ref_len scalars.
void corpus_bleu_stats(const int32_t* hyp_tokens, const int64_t* hyp_offsets,
                       int64_t n_hyps, const int32_t* ref_tokens,
                       const int64_t* ref_offsets, const int64_t* ref_counts,
                       int max_order, int64_t* numerators,
                       int64_t* denominators, int64_t* hyp_len_out,
                       int64_t* ref_len_out) {
  for (int n = 0; n < max_order; ++n) numerators[n] = denominators[n] = 0;
  int64_t hyp_len_sum = 0, ref_len_sum = 0;

  CountMap hyp_counts, ref_counts_map, max_ref;
  int64_t ref_idx = 0;
  for (int64_t i = 0; i < n_hyps; ++i) {
    const int32_t* hyp = hyp_tokens + hyp_offsets[i];
    const int64_t hlen = hyp_offsets[i + 1] - hyp_offsets[i];
    const int64_t nrefs = ref_counts[i];

    // Brevity penalty: closest reference length (ties -> shorter).
    int64_t best_ref_len = 0;
    int64_t best_diff = INT64_MAX;
    for (int64_t r = 0; r < nrefs; ++r) {
      const int64_t rlen = ref_offsets[ref_idx + r + 1] - ref_offsets[ref_idx + r];
      const int64_t diff = rlen > hlen ? rlen - hlen : hlen - rlen;
      if (diff < best_diff || (diff == best_diff && rlen < best_ref_len)) {
        best_diff = diff;
        best_ref_len = rlen;
      }
    }
    hyp_len_sum += hlen;
    ref_len_sum += best_ref_len;

    for (int n = 1; n <= max_order; ++n) {
      count_ngrams(hyp, hlen, n, hyp_counts);
      // Max reference count per n-gram across this hypothesis' references.
      max_ref.clear();
      for (int64_t r = 0; r < nrefs; ++r) {
        const int32_t* ref = ref_tokens + ref_offsets[ref_idx + r];
        const int64_t rlen = ref_offsets[ref_idx + r + 1] - ref_offsets[ref_idx + r];
        count_ngrams(ref, rlen, n, ref_counts_map);
        for (const auto& kv : ref_counts_map) {
          auto it = max_ref.find(kv.first);
          if (it == max_ref.end())
            max_ref.emplace(kv.first, kv.second);
          else if (kv.second > it->second)
            it->second = kv.second;
        }
      }
      int64_t num = 0, den = 0;
      for (const auto& kv : hyp_counts) {
        den += kv.second;
        auto it = max_ref.find(kv.first);
        if (it != max_ref.end())
          num += kv.second < it->second ? kv.second : it->second;
      }
      numerators[n - 1] += num;
      // nltk clamps each sentence's denominator to >= 1.
      denominators[n - 1] += den > 0 ? den : 1;
    }
    ref_idx += nrefs;
  }
  *hyp_len_out = hyp_len_sum;
  *ref_len_out = ref_len_sum;
}

}  // extern "C"
