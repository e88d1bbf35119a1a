// Native dataset index builders.
//
// Capability parity with the reference's pybind11 module
// `megatron/data/helpers.cpp` (build_sample_idx :83, build_blending_indices
// :20): the O(total-tokens) loops that are too slow in Python for
// billion-token corpora.  Fresh implementation, exported with a C ABI and
// bound via ctypes (no pybind11 in the image).
//
// Build: `make` in this directory (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdio>
#include <random>
#include <utility>

namespace {

// Sentences longer than this make a document ineligible for span sampling
// (reference: helpers.cpp LONG_SENTENCE_LEN).
constexpr int32_t kLongSentenceLen = 512;

// Draw the target sample length: mostly max_length, occasionally (with
// probability 1/short_seq_ratio) a short length in [2, max_length].
inline int32_t target_len(int32_t short_seq_ratio, int32_t max_length,
                          std::mt19937& gen) {
  // separate draws: reusing one draw for decision AND length restricts
  // short lengths to multiples of gcd(ratio, max_length - 1)
  const uint32_t decide = gen();
  if (short_seq_ratio != 0 && (decide % short_seq_ratio) == 0) {
    return 2 + static_cast<int32_t>(gen() % (max_length - 1));
  }
  return max_length;
}

// Fisher-Yates shuffle of an int64 [n, width] row array.
inline void shuffle_rows(int64_t* maps, int64_t n, int width, uint64_t seed) {
  std::mt19937_64 gen(seed);
  for (int64_t i = n - 1; i > 0; --i) {
    const int64_t j = static_cast<int64_t>(gen() % (i + 1));
    for (int w = 0; w < width; ++w) {
      std::swap(maps[width * i + w], maps[width * j + w]);
    }
  }
}

}  // namespace

extern "C" {

// Map sample i -> (document-index position, token offset) pairs for packed
// GPT samples of exactly `seq_length` tokens (+1 for the shifted label),
// crossing document boundaries.  Output buffer sample_idx must hold
// 2*(num_samples+1) int64.
//
// sizes:    per-sequence token counts               [num_seqs]
// doc_idx:  epoch-shuffled document order           [num_docs_total]
//           (values index into sizes)
// Returns the number of samples written (== num_samples).
int64_t build_sample_idx(const int32_t* sizes,
                         const int64_t* doc_idx,
                         int64_t num_docs_total,
                         int32_t seq_length,
                         int64_t num_samples,
                         int64_t* sample_idx) {
  int64_t sample = 0;
  int64_t di = 0;       // position in doc_idx
  int64_t offset = 0;   // token offset within current document
  sample_idx[0] = 0;
  sample_idx[1] = 0;
  while (sample < num_samples) {
    // consume seq_length + 1 tokens (labels are inputs shifted by one)
    int64_t remaining = seq_length + 1;
    while (remaining > 0 && di < num_docs_total) {
      int64_t doc_len = sizes[doc_idx[di]] - offset;
      if (doc_len > remaining) {
        offset += remaining - 1;  // last token reused as next sample's first
        remaining = 0;
      } else {
        remaining -= doc_len;
        ++di;
        offset = 0;
        if (remaining == 0 && di <= num_docs_total) {
          // sample ended exactly at a document boundary; back up one token
          // so the next sample overlaps by one (label/input shift)
          --di;
          offset = sizes[doc_idx[di]] - 1;
        }
      }
    }
    ++sample;
    sample_idx[2 * sample] = di;
    sample_idx[2 * sample + 1] = offset;
    if (di >= num_docs_total && sample < num_samples) {
      return sample;  // ran out of tokens (caller sized num_samples wrong)
    }
  }
  return sample;
}

// Greedy proportional interleave of `num_datasets` datasets with the given
// weights over `size` output samples (reference: build_blending_indices).
// dataset_index: uint8[size] out; dataset_sample_index: int64[size] out.
void build_blending_indices(uint8_t* dataset_index,
                            int64_t* dataset_sample_index,
                            const double* weights,
                            int32_t num_datasets,
                            int64_t size,
                            int32_t verbose) {
  int64_t* current_samples = new int64_t[num_datasets]();
  for (int64_t i = 0; i < size; ++i) {
    // pick the dataset furthest behind its target fraction
    double max_error = -1.0;
    int32_t max_idx = 0;
    for (int32_t d = 0; d < num_datasets; ++d) {
      double error =
          weights[d] * static_cast<double>(i + 1) -
          static_cast<double>(current_samples[d]);
      if (error > max_error) {
        max_error = error;
        max_idx = d;
      }
    }
    dataset_index[i] = static_cast<uint8_t>(max_idx);
    dataset_sample_index[i] = current_samples[max_idx];
    ++current_samples[max_idx];
  }
  if (verbose) {
    std::fprintf(stderr, "blending indices built for %lld samples over %d datasets\n",
                 static_cast<long long>(size), num_datasets);
  }
  delete[] current_samples;
}

// Span-sampling map for BERT/T5-style datasets: rows of
// (start-sentence, end-sentence, target-seq-length) covering each document's
// sentences greedily until target length is reached (reference:
// helpers.cpp build_mapping_impl).  Two-call protocol: pass out == NULL to
// get the row count, allocate int64[3 * count], call again to fill; both
// passes replay the identical RNG stream.  The filled map is shuffled with
// seed + 1.  min_num_sent is 2 for next-sentence/SOP heads, else 1.
int64_t build_mapping(const int64_t* docs, int64_t num_docs_plus_one,
                      const int32_t* sizes,
                      int32_t num_epochs, int64_t max_num_samples,
                      int32_t max_seq_length, double short_seq_prob,
                      int32_t seed, int32_t min_num_sent,
                      int64_t* out) {
  const int64_t num_docs = num_docs_plus_one - 1;
  int32_t short_seq_ratio = 0;
  if (short_seq_prob > 0) {
    short_seq_ratio = static_cast<int32_t>(1.0 / short_seq_prob + 0.5);
  }
  std::mt19937 gen(seed);
  int64_t n = 0;
  for (int32_t epoch = 0; epoch < num_epochs && n < max_num_samples;
       ++epoch) {
    // no eligible document at all: stop instead of spinning through
    // ~2^31 default epochs (caller reports the empty mapping)
    if (epoch == 1 && n == 0) break;
    for (int64_t doc = 0; doc < num_docs; ++doc) {
      const int64_t first = docs[doc];
      const int64_t last = docs[doc + 1];
      int64_t remain = last - first;
      if (remain < min_num_sent) continue;
      bool has_long = false;
      for (int64_t s = first; s < last; ++s) {
        if (sizes[s] > kLongSentenceLen) { has_long = true; break; }
      }
      if (has_long) continue;
      int64_t start = first;
      int32_t seq_len = 0, num_sent = 0;
      int32_t target = target_len(short_seq_ratio, max_seq_length, gen);
      for (int64_t s = first; s < last; ++s) {
        seq_len += sizes[s];
        ++num_sent;
        --remain;
        // close a sample when long enough (keeping >1 sentence for the
        // rest of the doc) or at the end of the document
        if ((seq_len >= target && remain > 1 && num_sent >= min_num_sent) ||
            remain == 0) {
          if (out != nullptr) {
            out[3 * n] = start;
            out[3 * n + 1] = s + 1;
            out[3 * n + 2] = target;
          }
          ++n;
          start = s + 1;
          target = target_len(short_seq_ratio, max_seq_length, gen);
          seq_len = 0;
          num_sent = 0;
        }
      }
    }
  }
  if (out != nullptr) {
    shuffle_rows(out, n, 3, static_cast<uint64_t>(seed) + 1);
  }
  return n;
}

// Block map for ICT/REALM retrieval pretraining: rows of
// (start-sentence, end-sentence, document-index, block-id) where blocks are
// runs of whole sentences up to max_seq_length (reference:
// helpers.cpp build_blocks_mapping_impl).  Same two-call + RNG-replay
// protocol as build_mapping; title_sizes[doc] tokens are reserved out of the
// budget for the document title.
int64_t build_blocks_mapping(const int64_t* docs, int64_t num_docs_plus_one,
                             const int32_t* sizes,
                             const int32_t* title_sizes,
                             int32_t num_epochs, int64_t max_num_samples,
                             int32_t max_seq_length, int32_t seed,
                             int32_t use_one_sent_blocks,
                             int64_t* out) {
  const int64_t num_docs = num_docs_plus_one - 1;
  const int32_t min_num_sent = use_one_sent_blocks ? 1 : 2;
  int64_t n = 0;
  int64_t block_id = 0;  // unique across epochs (REALM retrieval key)
  for (int32_t epoch = 0; epoch < num_epochs && n < max_num_samples;
       ++epoch) {
    if (epoch == 1 && n == 0) break;
    for (int64_t doc = 0; doc < num_docs; ++doc) {
      const int64_t first = docs[doc];
      const int64_t last = docs[doc + 1];
      int64_t remain = last - first;
      if (remain < min_num_sent) continue;
      // budget after reserving the title tokens
      const int32_t budget = max_seq_length - title_sizes[doc];
      bool has_long = false;
      for (int64_t s = first; s < last; ++s) {
        if (sizes[s] > budget) { has_long = true; break; }
      }
      if (has_long) continue;
      int64_t start = first;
      int32_t seq_len = 0, num_sent = 0;
      for (int64_t s = first; s < last; ++s) {
        seq_len += sizes[s];
        ++num_sent;
        --remain;
        // remain >= min_num_sent keeps the document tail viable, so the
        // final (remain == 0) block always has >= min_num_sent sentences
        // (reference: build_blocks_mapping_impl emit condition)
        if ((seq_len + (remain > 0 ? sizes[s + 1] : 0) > budget &&
             num_sent >= min_num_sent && remain >= min_num_sent) ||
            remain == 0) {
          if (out != nullptr) {
            out[4 * n] = start;
            out[4 * n + 1] = s + 1;
            out[4 * n + 2] = doc;
            out[4 * n + 3] = block_id;
          }
          ++n;
          ++block_id;
          start = s + 1;
          seq_len = 0;
          num_sent = 0;
        }
      }
    }
  }
  if (out != nullptr) {
    shuffle_rows(out, n, 4, static_cast<uint64_t>(seed) + 1);
  }
  return n;
}

// Shuffle-invariant exact-epoch token count: sum of sizes over doc_idx.
int64_t total_tokens(const int32_t* sizes, const int64_t* doc_idx,
                     int64_t num_docs) {
  int64_t total = 0;
  for (int64_t i = 0; i < num_docs; ++i) total += sizes[doc_idx[i]];
  return total;
}

}  // extern "C"
