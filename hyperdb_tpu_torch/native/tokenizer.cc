// Host-side native components for hyperdb_tpu_torch.
//
// Plays the role the reference delegates to native pip dependencies
// (HF Rust tokenizers for chunking, NumPy C loops for host-side filtering —
// SURVEY.md §2.3). Exposed through a minimal C ABI consumed via ctypes
// (hyperdb_tpu_torch/native/tokenizer.py).
//
// Built at first use, together with server.cc, into one shared library
// (hyperdb_tpu_torch/native/tokenizer.py:build).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

inline bool is_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}

}  // namespace

extern "C" {

// Tokenize UTF-8 text into whitespace-delimited words. Returns a single
// malloc'd buffer of '\n'-joined tokens; *out_len receives its byte length.
// Caller frees with hdb_free. Matches hyperdb_tpu_torch.core.chunker.WordTokenizer.
char* hdb_tokenize_words(const char* text, size_t len, size_t* out_len) {
  std::string out;
  out.reserve(len);
  size_t i = 0;
  bool first = true;
  while (i < len) {
    while (i < len && is_space(static_cast<unsigned char>(text[i]))) ++i;
    size_t start = i;
    while (i < len && !is_space(static_cast<unsigned char>(text[i]))) ++i;
    if (i > start) {
      if (!first) out.push_back('\n');
      out.append(text + start, i - start);
      first = false;
    }
  }
  *out_len = out.size();
  char* buf = static_cast<char*>(std::malloc(out.size() + 1));
  if (buf == nullptr) {
    *out_len = 0;
    return nullptr;
  }
  std::memcpy(buf, out.data(), out.size());
  buf[out.size()] = '\0';
  return buf;
}

// Lowercase + strip punctuation + tokenize: the sentence-filter tokenizer
// (reference hyperdb.py:1136-1141) for the host-side filter hot loop.
// ASCII-only contract: the Python binding routes any input containing a
// byte >= 0x80 to the Unicode-aware Python tokenizer (byte-level code can't
// lowercase 'É' or classify Unicode word characters correctly).
char* hdb_tokenize_filter(const char* text, size_t len, size_t* out_len) {
  std::string out;
  out.reserve(len);
  bool in_word = false;
  for (size_t i = 0; i < len; ++i) {
    unsigned char c = static_cast<unsigned char>(text[i]);
    bool word_char = (c >= '0' && c <= '9') || (c >= 'a' && c <= 'z') ||
                     (c >= 'A' && c <= 'Z') || c == '_' || c >= 0x80;
    bool punct = !word_char && c > ' ' && c < 0x80;
    if (word_char) {
      if (!in_word && !out.empty()) out.push_back('\n');
      out.push_back((c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32)
                                           : static_cast<char>(c));
      in_word = true;
    } else if (punct) {
      // ASCII punctuation is *removed*, not a word boundary — parity with
      // the reference's translate-then-\w+ tokenizer ("don't" -> "dont").
    } else {
      in_word = false;
    }
  }
  *out_len = out.size();
  char* buf = static_cast<char*>(std::malloc(out.size() + 1));
  if (buf == nullptr) {
    *out_len = 0;
    return nullptr;
  }
  std::memcpy(buf, out.data(), out.size());
  buf[out.size()] = '\0';
  return buf;
}

// Merge per-shard top-k results into global top-k (host-side fallback merge
// for multi-host deployments where the final merge happens off-device).
// scores: (n_shards * k) f32, ids: (n_shards * k) i64; outputs the k best
// into out_scores/out_ids (descending). Exact, stable on ties by lower id.
void hdb_merge_topk(const float* scores, const int64_t* ids, size_t total,
                    size_t k, float* out_scores, int64_t* out_ids) {
  // selection into a small heap-free insertion buffer (k is small).
  // Empty slots carry id INT64_MAX so a real entry — even one scoring
  // -inf (masked rows) — wins the tie against them and is inserted;
  // slots never filled are rewritten to the -1 sentinel afterwards.
  for (size_t j = 0; j < k; ++j) {
    out_scores[j] = -__builtin_inff();
    out_ids[j] = INT64_MAX;
  }
  for (size_t i = 0; i < total; ++i) {
    float sc = scores[i];
    int64_t id = ids[i];
    size_t pos = k;
    while (pos > 0 &&
           (sc > out_scores[pos - 1] ||
            (sc == out_scores[pos - 1] && id < out_ids[pos - 1]))) {
      --pos;
    }
    if (pos < k) {
      for (size_t shift = k - 1; shift > pos; --shift) {
        out_scores[shift] = out_scores[shift - 1];
        out_ids[shift] = out_ids[shift - 1];
      }
      out_scores[pos] = sc;
      out_ids[pos] = id;
    }
  }
  for (size_t j = 0; j < k; ++j) {
    if (out_ids[j] == INT64_MAX) out_ids[j] = -1;
  }
}

void hdb_free(void* ptr) { std::free(ptr); }

}  // extern "C"

// ---------------------------------------------------------------------------
// WordPiece encoder — the in-repo C++ replacement for the HF Rust
// tokenizers dependency (reference hyperdb.py:18,248; SURVEY.md §2.3).
// Greedy longest-match-first over a fixed vocab, identical semantics to
// hyperdb_tpu_torch/models/wordpiece.WordPieceTokenizer for ASCII input (the
// Python binding routes non-ASCII to the Python path, same contract as
// hdb_tokenize_filter).
// ---------------------------------------------------------------------------

#include <unordered_map>
#include <vector>

namespace {

struct WordPieceVocab {
  std::unordered_map<std::string, int32_t> token_to_id;
  std::unordered_map<std::string, std::vector<int32_t>> word_cache;
  size_t max_piece = 1;
  int32_t unk_id = 1;
};

// Pretokenize: lowercase words (\w+ = [a-z0-9_]) and single punctuation
// chars, matching the Python `\w+|[^\w\s]` pretokenizer on ASCII.
inline bool is_word_char(unsigned char c) {
  return (c >= '0' && c <= '9') || (c >= 'a' && c <= 'z') ||
         (c >= 'A' && c <= 'Z') || c == '_';
}

void wordpiece_word(WordPieceVocab* v, const std::string& word,
                    std::vector<int32_t>& out) {
  auto cached = v->word_cache.find(word);
  if (cached != v->word_cache.end()) {
    out.insert(out.end(), cached->second.begin(), cached->second.end());
    return;
  }
  std::vector<int32_t> ids;
  size_t start = 0;
  const size_t n = word.size();
  while (start < n) {
    size_t end = n < start + v->max_piece ? n : start + v->max_piece;
    int32_t piece_id = -1;
    while (end > start) {
      std::string piece = start > 0 ? "##" + word.substr(start, end - start)
                                    : word.substr(start, end - start);
      auto it = v->token_to_id.find(piece);
      if (it != v->token_to_id.end()) {
        piece_id = it->second;
        break;
      }
      --end;
    }
    if (piece_id < 0) {  // unsplittable word -> single [UNK]
      ids.assign(1, v->unk_id);
      break;
    }
    ids.push_back(piece_id);
    start = end;
  }
  if (v->word_cache.size() < 1000000) v->word_cache.emplace(word, ids);
  out.insert(out.end(), ids.begin(), ids.end());
}

}  // namespace

extern "C" {

// vocab_blob: '\n'-joined vocab tokens in id order. Returns opaque handle.
void* hdb_wordpiece_load(const char* vocab_blob, size_t len, int32_t unk_id) {
  auto* v = new WordPieceVocab();
  v->unk_id = unk_id;
  size_t start = 0;
  int32_t id = 0;
  for (size_t i = 0; i <= len; ++i) {
    if (i == len || vocab_blob[i] == '\n') {
      if (i > start) {
        std::string tok(vocab_blob + start, i - start);
        if (tok.size() > v->max_piece) v->max_piece = tok.size();
        v->token_to_id.emplace(std::move(tok), id);
      }
      ++id;
      start = i + 1;
    }
  }
  return v;
}

void hdb_wordpiece_free(void* handle) {
  delete static_cast<WordPieceVocab*>(handle);
}

// Encode one ASCII text: lowercase, pretokenize, greedy WordPiece. Writes at
// most max_out ids into out_ids; returns the number written (the text's
// full id count is min()'d into max_out — callers size max_out generously).
int64_t hdb_wordpiece_encode(void* handle, const char* text, size_t len,
                             int32_t* out_ids, int64_t max_out) {
  auto* v = static_cast<WordPieceVocab*>(handle);
  std::vector<int32_t> ids;
  ids.reserve(len / 4 + 4);
  std::string word;
  size_t i = 0;
  while (i < len) {
    unsigned char c = static_cast<unsigned char>(text[i]);
    if (is_word_char(c)) {
      word.clear();
      while (i < len && is_word_char(static_cast<unsigned char>(text[i]))) {
        unsigned char w = static_cast<unsigned char>(text[i]);
        word.push_back((w >= 'A' && w <= 'Z') ? static_cast<char>(w + 32)
                                              : static_cast<char>(w));
        ++i;
      }
      wordpiece_word(v, word, ids);
    } else if (!is_space(c)) {
      // single punctuation char token (Python's [^\w\s] also covers
      // control chars outside \s — they just resolve to [UNK])
      word.assign(1, static_cast<char>(c));
      wordpiece_word(v, word, ids);
      ++i;
    } else {
      ++i;  // whitespace
    }
  }
  int64_t count = static_cast<int64_t>(ids.size());
  if (count > max_out) count = max_out;
  for (int64_t j = 0; j < count; ++j) out_ids[j] = ids[j];
  return count;
}

}  // extern "C"
