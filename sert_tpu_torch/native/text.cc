// Native text pipeline: tokenizer + term counter + vocabulary encoder.
//
// Mirrors sert_tpu_torch/data/tokenize.py exactly:
//   - word spans match [A-Za-z0-9][A-Za-z0-9']*  (byte-wise; UTF-8
//     multi-byte sequences are >= 0x80 and act as separators, same as the
//     Python regex on such text)
//   - optional lowercasing, stopword filter (embedded list identical to
//     tokenize.py), minimum token length, pure-digit drop
// Two handle-based APIs over the C ABI (ctypes):
//   counter: vocabulary pass 1 (merged term counts, serialized as
//            "term\tcount\n" for Python to parse)
//   vocab:   pass 2 / query-time encode (term -> id hash lookup; OOV drops)
// Parity with the Python implementation is enforced in tests/test_native.py.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

const char* kStopwords[] = {
    "a", "about", "above", "after", "again", "against", "all", "am", "an",
    "and", "any", "are", "aren't", "as", "at", "be", "because", "been",
    "before", "being", "below", "between", "both", "but", "by", "can't",
    "cannot", "could", "couldn't", "did", "didn't", "do", "does", "doesn't",
    "doing", "don't", "down", "during", "each", "few", "for", "from",
    "further", "had", "hadn't", "has", "hasn't", "have", "haven't", "having",
    "he", "he'd", "he'll", "he's", "her", "here", "here's", "hers",
    "herself", "him", "himself", "his", "how", "how's", "i", "i'd", "i'll",
    "i'm", "i've", "if", "in", "into", "is", "isn't", "it", "it's", "its",
    "itself", "let's", "me", "more", "most", "mustn't", "my", "myself",
    "no", "nor", "not", "of", "off", "on", "once", "only", "or", "other",
    "ought", "our", "ours", "ourselves", "out", "over", "own", "same",
    "shan't", "she", "she'd", "she'll", "she's", "should", "shouldn't",
    "so", "some", "such", "than", "that", "that's", "the", "their",
    "theirs", "them", "themselves", "then", "there", "there's", "these",
    "they", "they'd", "they'll", "they're", "they've", "this", "those",
    "through", "to", "too", "under", "until", "up", "very", "was", "wasn't",
    "we", "we'd", "we'll", "we're", "we've", "were", "weren't", "what",
    "what's", "when", "when's", "where", "where's", "which", "while", "who",
    "who's", "whom", "why", "why's", "with", "won't", "would", "wouldn't",
    "you", "you'd", "you'll", "you're", "you've", "your", "yours",
    "yourself", "yourselves"};

const std::unordered_set<std::string>& stopword_set() {
  static const std::unordered_set<std::string>* s = [] {
    auto* set = new std::unordered_set<std::string>();
    for (const char* w : kStopwords) set->insert(w);
    return set;
  }();
  return *s;
}

inline bool is_word_start(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9');
}
inline bool is_word_char(unsigned char c) {
  return is_word_start(c) || c == '\'';
}
inline bool is_digit_str(const std::string& t) {
  for (char c : t)
    if (c < '0' || c > '9') return false;
  return !t.empty();
}

struct Options {
  bool lowercase;
  bool filter_stopwords;
  int64_t min_token_len;
  bool drop_numeric;
};

// Tokenize `text` byte-wise, calling fn(token) for each surviving token.
template <typename Fn>
void for_each_token(const char* text, int64_t len, const Options& opt,
                    Fn&& fn) {
  std::string tok;
  int64_t i = 0;
  while (i < len) {
    unsigned char c = static_cast<unsigned char>(text[i]);
    if (!is_word_start(c)) {
      ++i;
      continue;
    }
    tok.clear();
    while (i < len && is_word_char(static_cast<unsigned char>(text[i]))) {
      char ch = text[i];
      if (opt.lowercase && ch >= 'A' && ch <= 'Z') ch += 'a' - 'A';
      tok.push_back(ch);
      ++i;
    }
    if (static_cast<int64_t>(tok.size()) < opt.min_token_len) continue;
    if (opt.filter_stopwords && stopword_set().count(tok)) continue;
    if (opt.drop_numeric && is_digit_str(tok)) continue;
    fn(tok);
  }
}

struct Counter {
  Options opt;
  std::unordered_map<std::string, int64_t> counts;
  std::string serialized;  // filled by finalize
};

struct Vocab {
  std::unordered_map<std::string, int32_t> index;
  Options opt;
};

}  // namespace

extern "C" {

// ---------------- counter (vocabulary pass 1) ------------------------------

void* sert_counter_create(int lowercase, int filter_stopwords,
                          int64_t min_token_len, int drop_numeric) {
  auto* c = new Counter();
  c->opt = {lowercase != 0, filter_stopwords != 0, min_token_len,
            drop_numeric != 0};
  return c;
}

void sert_counter_add(void* handle, const char* text, int64_t len) {
  auto* c = static_cast<Counter*>(handle);
  for_each_token(text, len, c->opt,
                 [&](const std::string& t) { ++c->counts[t]; });
}

// Serializes "term\tcount\n" lines; returns total byte length.
int64_t sert_counter_serialize(void* handle) {
  auto* c = static_cast<Counter*>(handle);
  c->serialized.clear();
  for (const auto& kv : c->counts) {
    c->serialized += kv.first;
    c->serialized += '\t';
    c->serialized += std::to_string(kv.second);
    c->serialized += '\n';
  }
  return static_cast<int64_t>(c->serialized.size());
}

void sert_counter_copy(void* handle, char* out) {
  auto* c = static_cast<Counter*>(handle);
  std::memcpy(out, c->serialized.data(), c->serialized.size());
}

void sert_counter_free(void* handle) { delete static_cast<Counter*>(handle); }

// ---------------- vocab (pass 2 / query encode) -----------------------------

// terms: concatenated NUL-separated strings, n of them, ids 0..n-1.
void* sert_vocab_create(const char* terms, int64_t n, int lowercase,
                        int filter_stopwords, int64_t min_token_len,
                        int drop_numeric) {
  auto* v = new Vocab();
  v->opt = {lowercase != 0, filter_stopwords != 0, min_token_len,
            drop_numeric != 0};
  const char* p = terms;
  for (int64_t i = 0; i < n; ++i) {
    std::string t(p);
    p += t.size() + 1;
    v->index.emplace(std::move(t), static_cast<int32_t>(i));
  }
  return v;
}

// Tokenize + encode; writes up to `cap` ids, returns the count (callers size
// cap >= len since tokens can't outnumber bytes).
int64_t sert_vocab_encode(void* handle, const char* text, int64_t len,
                          int32_t* out, int64_t cap) {
  auto* v = static_cast<Vocab*>(handle);
  int64_t n = 0;
  for_each_token(text, len, v->opt, [&](const std::string& t) {
    if (n >= cap) return;
    auto it = v->index.find(t);
    if (it != v->index.end()) out[n++] = it->second;
  });
  return n;
}

void sert_vocab_free(void* handle) { delete static_cast<Vocab*>(handle); }

}  // extern "C"
