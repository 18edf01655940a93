// Native lattice builder + bit-packer.
//
// C++ twin of jlm/decoder/lattice.py (ref: JLM:decoder/decoder.py
// lattice construction, SURVEY.md §4.5) producing bit-for-bit the same
// packed int32 node tensor as pack_lattice_batch(build_lattice(...)).
// At streaming batch sizes the Python builder costs ~0.3 ms/sentence of
// host time per device call; this builder cuts the host share to ~µs so
// the chip, not the host, sets the throughput ceiling.
//
// Packing layout (must match engine.py): word | start<<17 | cand<<23 | 1<<29.
//
// Built with: g++ -O3 -shared -fPIC -std=c++17 lattice.cpp -o liblattice.so
// Loaded via ctypes (no pybind11 in the image).

#include <cstdint>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kWordBits = 17;
constexpr int kStartShift = 17;
constexpr int kCidxShift = 23;
constexpr int kMaskShift = 29;

struct Lexicon {
  // reading (UTF-32 string) -> word ids, frequency(id)-ascending order.
  std::unordered_map<std::u32string, std::vector<int32_t>> by_reading;
  int max_reading_len = 1;
};

}  // namespace

extern "C" {

// readings: concatenated UTF-32 codepoints; reading_offsets[n+1] delimits
// reading i; word_ids grouped per reading via id_offsets[n+1].
void* jlm_lexicon_create(const uint32_t* readings,
                         const int32_t* reading_offsets,
                         const int32_t* word_ids, const int32_t* id_offsets,
                         int32_t n_readings) {
  auto* lex = new Lexicon();
  for (int i = 0; i < n_readings; ++i) {
    std::u32string r(
        reinterpret_cast<const char32_t*>(readings) + reading_offsets[i],
        reinterpret_cast<const char32_t*>(readings) + reading_offsets[i + 1]);
    std::vector<int32_t> ids(word_ids + id_offsets[i],
                             word_ids + id_offsets[i + 1]);
    if ((int)r.size() > lex->max_reading_len)
      lex->max_reading_len = (int)r.size();
    lex->by_reading.emplace(std::move(r), std::move(ids));
  }
  return lex;
}

void jlm_lexicon_destroy(void* p) { delete static_cast<Lexicon*>(p); }

// Build ONE sentence's packed node tensor [T_max * N_max] (row-major) plus
// its lookahead-consistent cand indices.  kana: UTF-32 codepoints, length T.
// Returns the number of nodes DROPPED beyond the per-frame budget N_max
// (>= 0; 0 = lossless), or -1 if a lookahead row overflows C_max.  Drops
// must be surfaced, never swallowed: the reference's lattices are uncapped
// and a silent drop is a top-1 parity hazard (SURVEY.md §4.5).
int32_t jlm_build_packed(const void* lex_p, const uint32_t* kana, int32_t T,
                         int32_t T_max, int32_t N_max, int32_t C_max,
                         int32_t max_word_len, int32_t unk_id,
                         int32_t* out_packed) {
  const auto* lex = static_cast<const Lexicon*>(lex_p);
  const int M = std::min<int32_t>(max_word_len, lex->max_reading_len);

  for (int i = 0; i < T_max * N_max; ++i) out_packed[i] = 0;

  // frames[j] = (word, start) ending at j, start-ascending then dict order
  // (the construction loop appends in exactly that order; SURVEY.md §4.5).
  std::vector<std::vector<std::pair<int32_t, int32_t>>> frames(T + 1);
  std::u32string key;
  for (int i = 0; i < T; ++i) {
    bool len1_matched = false;
    for (int j = i + 1; j <= std::min<int>(i + M, T); ++j) {
      key.assign(reinterpret_cast<const char32_t*>(kana) + i,
                 reinterpret_cast<const char32_t*>(kana) + j);
      auto it = lex->by_reading.find(key);
      if (it != lex->by_reading.end()) {
        if (j == i + 1) len1_matched = true;
        for (int32_t wid : it->second) frames[j].push_back({wid, i});
      } else if (j == i + 1) {
        // single-kana <unk> fallback keeps the lattice connected
        frames[j].push_back({unk_id, i});
        len1_matched = true;
      }
      (void)len1_matched;
    }
  }

  // lookahead dedup per start position, first-appearance order over
  // j = 1..T and canonical node order within a frame (matches python).
  std::vector<std::unordered_map<int32_t, int32_t>> look(T + 1);
  int32_t dropped = 0;
  for (int j = 1; j <= T; ++j) {
    auto& fr = frames[j];
    int n = std::min<int>((int)fr.size(), N_max);
    dropped += (int32_t)fr.size() - n;
    for (int k = 0; k < n; ++k) {
      int32_t wid = fr[k].first, start = fr[k].second;
      auto& tbl = look[start];
      auto it = tbl.find(wid);
      int32_t cidx;
      if (it == tbl.end()) {
        cidx = (int32_t)tbl.size();
        if (cidx >= C_max) return -1;
        tbl.emplace(wid, cidx);
      } else {
        cidx = it->second;
      }
      out_packed[(j - 1) * N_max + k] =
          wid | (start << kStartShift) | (cidx << kCidxShift) |
          (1 << kMaskShift);
    }
  }
  return dropped;
}

}  // extern "C"
