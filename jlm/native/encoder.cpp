// Native corpus encoder: display/reading/POS token -> vocab id, streamed.
//
// Host-side hot loop of corpus prep (ref: JLM:data/data.py encode step —
// SURVEY.md §5.1 "encode corpus → int32 arrays"; the reference does this in
// a Python loop over the whole in-memory corpus).  This version encodes
// arbitrarily large corpora chunk-by-chunk: Python hands byte buffers that
// end on line boundaries, C++ does the tokenize + hash lookup + <eos>
// framing.  Must stay BIT-IDENTICAL to jlm.data.corpus.encode_corpus
// (pinned by tests/test_streaming.py):
//   - tokens are ASCII-whitespace separated; blank lines emit nothing;
//   - token -> key normalization mirrors parse_token(): >=2 slashes keeps
//     the raw string, 1 slash appends "/", 0 slashes maps s -> "s/s/";
//   - every non-empty line is terminated with eos_id;
//   - unknown keys map to unk_id.
#include <cstdint>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Encoder {
  std::vector<char> blob;  // owned copy of all vocab keys, concatenated
  std::unordered_map<std::string_view, int32_t> map;
  int32_t eos_id;
  int32_t unk_id;
};

inline bool is_sep(uint8_t c) { return c == ' ' || c == '\t' || c == '\r'; }

}  // namespace

extern "C" {

void* jlm_encoder_create(const uint8_t* blob, const int64_t* offsets,
                         int32_t n_keys, int32_t eos_id, int32_t unk_id) {
  auto* e = new Encoder();
  const int64_t total = offsets[n_keys];
  e->blob.assign(reinterpret_cast<const char*>(blob),
                 reinterpret_cast<const char*>(blob) + total);
  e->map.reserve(static_cast<size_t>(n_keys) * 2);
  for (int32_t i = 0; i < n_keys; ++i) {
    std::string_view k(e->blob.data() + offsets[i],
                       static_cast<size_t>(offsets[i + 1] - offsets[i]));
    e->map.emplace(k, i);
  }
  e->eos_id = eos_id;
  e->unk_id = unk_id;
  return e;
}

void jlm_encoder_destroy(void* h) { delete static_cast<Encoder*>(h); }

// Encode one chunk of complete lines; returns ids written, or -1 if `out`
// is too small (caller sizes cap >= chunk bytes + 1, which always fits).
int64_t jlm_encode_chunk(void* h, const uint8_t* text, int64_t len,
                         int32_t* out, int64_t cap) {
  auto* e = static_cast<Encoder*>(h);
  int64_t n = 0;
  int64_t i = 0;
  std::string keybuf;
  while (i < len) {
    bool any = false;
    while (i < len && text[i] != '\n') {
      while (i < len && is_sep(text[i])) ++i;
      const int64_t start = i;
      while (i < len && !is_sep(text[i]) && text[i] != '\n') ++i;
      if (i == start) continue;  // ran into the newline
      std::string_view tok(reinterpret_cast<const char*>(text) + start,
                           static_cast<size_t>(i - start));
      int slashes = 0;
      for (char c : tok)
        if (c == '/') ++slashes;
      int32_t id;
      if (slashes >= 2) {
        auto it = e->map.find(tok);
        id = it == e->map.end() ? e->unk_id : it->second;
      } else {
        keybuf.assign(tok.data(), tok.size());
        keybuf.push_back('/');
        if (slashes == 0) {
          keybuf.append(tok.data(), tok.size());
          keybuf.push_back('/');
        }
        auto it = e->map.find(std::string_view(keybuf));
        id = it == e->map.end() ? e->unk_id : it->second;
      }
      if (n >= cap) return -1;
      out[n++] = id;
      any = true;
    }
    if (i < len) ++i;  // consume '\n'
    if (any) {
      if (n >= cap) return -1;
      out[n++] = e->eos_id;
    }
  }
  return n;
}

}  // extern "C"
