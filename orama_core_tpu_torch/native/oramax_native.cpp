// oramax_native: host-side hot loops in C++.
//
// The reference's engine host is Rust; here the engine host is Python with
// the string-processing hot paths (the reference's HOT loops:
// tokenization fields.rs:311-353, posting building, CSR packing for commit
// merges committed/string.rs:91-189) implemented natively and exposed
// through a C ABI for ctypes.
//
// Components:
//  - tokenizer: UTF-8 aware split on non-alphanumerics, lowercase,
//    Latin-1/Latin-Ext-A diacritics fold, English stop words, Porter stems
//    (same pipeline as nlp/tokenizer.py; EN-only fast path — other locales
//    fall back to Python).
//  - posting builder: accumulates (term, doc, positions) across documents
//    and packs the committed CSR layout (sorted terms, term_starts,
//    post_docs, post_tf, pos_starts, positions) in one pass.
//
// Build: see build.py (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// tokenizer
// ---------------------------------------------------------------------------

namespace {

// Latin-1 Supplement + Latin Extended-A diacritics fold (codepoints
// 0xC0-0x17F) to ASCII; mirrors Unicode NFKD + combining-strip for this
// range (the range the reference's lookup table covers).
char fold_latin(uint32_t cp) {
  static const struct { uint32_t lo, hi; char c; } ranges[] = {
      {0xC0, 0xC5, 'a'}, {0xC7, 0xC7, 'c'}, {0xC8, 0xCB, 'e'},
      {0xCC, 0xCF, 'i'}, {0xD1, 0xD1, 'n'}, {0xD2, 0xD6, 'o'},
      {0xD8, 0xD8, 'o'}, {0xD9, 0xDC, 'u'}, {0xDD, 0xDD, 'y'},
      {0xE0, 0xE5, 'a'}, {0xE7, 0xE7, 'c'}, {0xE8, 0xEB, 'e'},
      {0xEC, 0xEF, 'i'}, {0xF1, 0xF1, 'n'}, {0xF2, 0xF6, 'o'},
      {0xF8, 0xF8, 'o'}, {0xF9, 0xFC, 'u'}, {0xFD, 0xFD, 'y'},
      {0xFF, 0xFF, 'y'},
      {0x100, 0x105, 'a'}, {0x106, 0x10D, 'c'}, {0x10E, 0x111, 'd'},
      {0x112, 0x11B, 'e'}, {0x11C, 0x123, 'g'}, {0x124, 0x127, 'h'},
      {0x128, 0x131, 'i'}, {0x134, 0x135, 'j'}, {0x136, 0x138, 'k'},
      {0x139, 0x142, 'l'}, {0x143, 0x14B, 'n'}, {0x14C, 0x153, 'o'},
      {0x154, 0x159, 'r'}, {0x15A, 0x161, 's'}, {0x162, 0x167, 't'},
      {0x168, 0x173, 'u'}, {0x174, 0x175, 'w'}, {0x176, 0x178, 'y'},
      {0x179, 0x17E, 'z'},
  };
  for (auto& r : ranges)
    if (cp >= r.lo && cp <= r.hi) return r.c;
  return 0;
}

const std::unordered_set<std::string>& en_stop_words() {
  static const std::unordered_set<std::string> words = {
      "a","about","above","after","again","against","all","am","an","and",
      "any","are","aren","arent","as","at","be","because","been","before",
      "being","below","between","both","but","by","cant","cannot","could",
      "couldnt","did","didn","didnt","do","does","doesn","doesnt","doing",
      "don","dont","down","during","each","few","for","from","further",
      "had","hadn","hadnt","has","hasn","hasnt","have","haven","havent",
      "having","he","her","here","hers","herself","him","himself","his",
      "how","i","if","in","into","is","isn","isnt","it","its","itself",
      "just","me","more","most","mustn","mustnt","my","myself","no","nor",
      "not","now","of","off","on","once","only","or","other","ought","our",
      "ours","ourselves","out","over","own","same","shan","shant","she",
      "should","shouldn","shouldnt","so","some","such","than","that","the",
      "their","theirs","them","themselves","then","there","these","they",
      "this","those","through","to","too","under","until","up","very",
      "was","wasn","wasnt","we","were","weren","werent","what","when",
      "where","which","while","who","whom","why","will","with","won",
      "wont","would","wouldn","wouldnt","you","your","yours","yourself",
      "yourselves",
  };
  return words;
}

// ---- Porter stemmer (same algorithm as nlp/stemmer.py) --------------------

bool is_cons(const std::string& w, int i) {
  char c = w[i];
  if (c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u') return false;
  if (c == 'y') return i == 0 ? true : !is_cons(w, i - 1);
  return true;
}

int measure(const std::string& s) {
  int m = 0;
  bool prev_vowel = false;
  for (int i = 0; i < (int)s.size(); i++) {
    bool cons = is_cons(s, i);
    if (cons && prev_vowel) m++;
    prev_vowel = !cons;
  }
  return m;
}

bool has_vowel(const std::string& s) {
  for (int i = 0; i < (int)s.size(); i++)
    if (!is_cons(s, i)) return true;
  return false;
}

bool ends_double_cons(const std::string& w) {
  int n = w.size();
  return n >= 2 && w[n - 1] == w[n - 2] && is_cons(w, n - 1);
}

bool cvc(const std::string& w) {
  int n = w.size();
  if (n < 3) return false;
  char last = w[n - 1];
  return is_cons(w, n - 3) && !is_cons(w, n - 2) && is_cons(w, n - 1) &&
         last != 'w' && last != 'x' && last != 'y';
}

bool ends_with(const std::string& w, const char* suf) {
  size_t n = strlen(suf);
  return w.size() >= n && w.compare(w.size() - n, n, suf) == 0;
}

bool replace_suffix(std::string& w, const char* suf, const char* repl,
                    int min_m) {
  if (!ends_with(w, suf)) return false;
  std::string stem = w.substr(0, w.size() - strlen(suf));
  if (measure(stem) > min_m) w = stem + repl;
  return true;  // matched (even if not replaced), stop scanning
}

std::string porter_stem(std::string w) {
  if (w.size() <= 2) return w;

  // 1a
  if (ends_with(w, "sses")) w.resize(w.size() - 2);
  else if (ends_with(w, "ies")) w.resize(w.size() - 2);
  else if (ends_with(w, "ss")) {}
  else if (ends_with(w, "s")) w.resize(w.size() - 1);

  // 1b
  bool flag1b = false;
  if (ends_with(w, "eed")) {
    if (measure(w.substr(0, w.size() - 3)) > 0) w.resize(w.size() - 1);
  } else if (ends_with(w, "ed")) {
    std::string stem = w.substr(0, w.size() - 2);
    if (has_vowel(stem)) { w = stem; flag1b = true; }
  } else if (ends_with(w, "ing")) {
    std::string stem = w.substr(0, w.size() - 3);
    if (has_vowel(stem)) { w = stem; flag1b = true; }
  }
  if (flag1b) {
    if (ends_with(w, "at") || ends_with(w, "bl") || ends_with(w, "iz")) w += "e";
    else if (ends_double_cons(w) && !ends_with(w, "l") && !ends_with(w, "s") &&
             !ends_with(w, "z")) w.resize(w.size() - 1);
    else if (measure(w) == 1 && cvc(w)) w += "e";
  }

  // 1c
  if (ends_with(w, "y") && has_vowel(w.substr(0, w.size() - 1)))
    w[w.size() - 1] = 'i';

  // 2
  {
    static const char* pairs[][2] = {
        {"ational","ate"},{"tional","tion"},{"enci","ence"},{"anci","ance"},
        {"izer","ize"},{"abli","able"},{"alli","al"},{"entli","ent"},
        {"eli","e"},{"ousli","ous"},{"ization","ize"},{"ation","ate"},
        {"ator","ate"},{"alism","al"},{"iveness","ive"},{"fulness","ful"},
        {"ousness","ous"},{"aliti","al"},{"iviti","ive"},{"biliti","ble"},
    };
    for (auto& p : pairs)
      if (replace_suffix(w, p[0], p[1], 0)) break;
  }

  // 3
  {
    static const char* pairs[][2] = {
        {"icate","ic"},{"ative",""},{"alize","al"},{"iciti","ic"},
        {"ical","ic"},{"ful",""},{"ness",""},
    };
    for (auto& p : pairs)
      if (replace_suffix(w, p[0], p[1], 0)) break;
  }

  // 4
  {
    static const char* sufs[] = {
        "al","ance","ence","er","ic","able","ible","ant","ement","ment",
        "ent","ou","ism","ate","iti","ous","ive","ize",
    };
    bool matched = false;
    for (auto* s : sufs) {
      if (ends_with(w, s)) {
        std::string stem = w.substr(0, w.size() - strlen(s));
        if (measure(stem) > 1) w = stem;
        matched = true;
        break;
      }
    }
    if (!matched && ends_with(w, "ion")) {
      std::string stem = w.substr(0, w.size() - 3);
      if (measure(stem) > 1 && !stem.empty() &&
          (stem.back() == 's' || stem.back() == 't'))
        w = stem;
    }
  }

  // 5a
  if (ends_with(w, "e")) {
    std::string stem = w.substr(0, w.size() - 1);
    int m = measure(stem);
    if (m > 1 || (m == 1 && !cvc(stem))) w = stem;
  }
  // 5b
  if (measure(w) > 1 && ends_double_cons(w) && ends_with(w, "l"))
    w.resize(w.size() - 1);

  return w;
}

// UTF-8 decode next codepoint; returns bytes consumed (0 on invalid).
int utf8_next(const uint8_t* s, size_t len, uint32_t* cp) {
  if (len == 0) return 0;
  uint8_t b = s[0];
  if (b < 0x80) { *cp = b; return 1; }
  if ((b >> 5) == 0x6 && len >= 2) {
    *cp = ((b & 0x1F) << 6) | (s[1] & 0x3F);
    return 2;
  }
  if ((b >> 4) == 0xE && len >= 3) {
    *cp = ((b & 0x0F) << 12) | ((s[1] & 0x3F) << 6) | (s[2] & 0x3F);
    return 3;
  }
  if ((b >> 3) == 0x1E && len >= 4) {
    *cp = ((b & 0x07) << 18) | ((s[1] & 0x3F) << 12) | ((s[2] & 0x3F) << 6) |
          (s[3] & 0x3F);
    return 4;
  }
  *cp = 0xFFFD;
  return 1;
}

struct TokenizeResult {
  // Flat output: token bytes are concatenated; offsets[i]..offsets[i+1]
  // delimit token i; positions[i] is its word position; kinds[i] is 0 for
  // an original token, 1 for a stem (same position as its original).
  std::string bytes;
  std::vector<int32_t> offsets{0};
  std::vector<int32_t> positions;
  std::vector<uint8_t> kinds;
};

void emit(TokenizeResult* r, const std::string& tok, int pos, uint8_t kind) {
  r->bytes += tok;
  r->offsets.push_back((int32_t)r->bytes.size());
  r->positions.push_back(pos);
  r->kinds.push_back(kind);
}

}  // namespace

// Tokenize UTF-8 text (EN pipeline incl. Porter stems). Returns an opaque
// handle; read out with tokenize_result_* and free with tokenize_free.
void* oramax_tokenize(const uint8_t* text, int64_t len, int with_stems) {
  auto* res = new TokenizeResult();
  const auto& stop = en_stop_words();
  std::string cur;
  int pos = 0;
  size_t i = 0;
  auto flush = [&]() {
    if (cur.empty()) return;
    if (!stop.count(cur)) {
      emit(res, cur, pos, 0);
      if (with_stems) {
        std::string stem = porter_stem(cur);
        if (stem != cur) emit(res, stem, pos, 1);
      }
      pos++;
    }
    cur.clear();
  };
  while (i < (size_t)len) {
    uint32_t cp;
    int n = utf8_next(text + i, len - i, &cp);
    i += n;
    char out = 0;
    if ((cp >= 'a' && cp <= 'z') || (cp >= '0' && cp <= '9')) out = (char)cp;
    else if (cp >= 'A' && cp <= 'Z') out = (char)(cp - 'A' + 'a');
    else if (cp == '_') out = '_';
    else if (cp >= 0xC0 && cp <= 0x17F) out = fold_latin(cp);
    else if (cp > 0x17F) {
      // Non-latin word character: keep the raw codepoint bytes (no folding);
      // word chars per \w semantics. Treat everything >= 0x370 that is not
      // punctuation/space as a word char (approximation; CJK splitting is
      // handled by the Python layer which owns non-EN locales).
      if (cp >= 0x370) {
        char buf[4];
        int m = 0;
        if (cp < 0x800) {
          buf[m++] = (char)(0xC0 | (cp >> 6));
          buf[m++] = (char)(0x80 | (cp & 0x3F));
        } else if (cp < 0x10000) {
          buf[m++] = (char)(0xE0 | (cp >> 12));
          buf[m++] = (char)(0x80 | ((cp >> 6) & 0x3F));
          buf[m++] = (char)(0x80 | (cp & 0x3F));
        } else {
          buf[m++] = (char)(0xF0 | (cp >> 18));
          buf[m++] = (char)(0x80 | ((cp >> 12) & 0x3F));
          buf[m++] = (char)(0x80 | ((cp >> 6) & 0x3F));
          buf[m++] = (char)(0x80 | (cp & 0x3F));
        }
        cur.append(buf, m);
        continue;
      }
      flush();
      continue;
    }
    if (out) cur += out;
    else flush();
  }
  flush();
  return res;
}

int64_t oramax_tokenize_n_tokens(void* h) {
  return ((TokenizeResult*)h)->positions.size();
}
int64_t oramax_tokenize_bytes_len(void* h) {
  return ((TokenizeResult*)h)->bytes.size();
}
void oramax_tokenize_copy(void* h, uint8_t* bytes_out, int32_t* offsets_out,
                          int32_t* positions_out, uint8_t* kinds_out) {
  auto* r = (TokenizeResult*)h;
  memcpy(bytes_out, r->bytes.data(), r->bytes.size());
  memcpy(offsets_out, r->offsets.data(), r->offsets.size() * 4);
  memcpy(positions_out, r->positions.data(), r->positions.size() * 4);
  memcpy(kinds_out, r->kinds.data(), r->kinds.size());
}
void oramax_tokenize_free(void* h) { delete (TokenizeResult*)h; }

// ---------------------------------------------------------------------------
// whole-document indexing: tokenize+stem -> unique terms with position lists
// in one call (the per-token Python round trip dominates the write path)
// ---------------------------------------------------------------------------

namespace {

struct IndexDocResult {
  std::string term_bytes;
  std::vector<int32_t> term_offsets{0};
  std::vector<int32_t> pos_starts{0};
  std::vector<int32_t> positions;
  int32_t field_length = 0;
};

}  // namespace

void* oramax_index_doc(const uint8_t* text, int64_t len) {
  // Reuse the tokenizer, then group positions per unique term.
  auto* tok = (TokenizeResult*)oramax_tokenize(text, len, 1);
  auto* res = new IndexDocResult();
  std::unordered_map<std::string, std::vector<int32_t>> terms;
  size_t n = tok->positions.size();
  int32_t max_pos = -1;
  for (size_t i = 0; i < n; i++) {
    std::string t = tok->bytes.substr(
        tok->offsets[i], tok->offsets[i + 1] - tok->offsets[i]);
    terms[t].push_back(tok->positions[i]);
    if (tok->kinds[i] == 0 && tok->positions[i] > max_pos)
      max_pos = tok->positions[i];
  }
  oramax_tokenize_free(tok);
  res->field_length = max_pos + 1;
  // deterministic order (sorted) so op payloads are reproducible
  std::vector<const std::string*> keys;
  keys.reserve(terms.size());
  for (auto& kv : terms) keys.push_back(&kv.first);
  std::sort(keys.begin(), keys.end(),
            [](const std::string* a, const std::string* b) { return *a < *b; });
  for (auto* k : keys) {
    res->term_bytes += *k;
    res->term_offsets.push_back((int32_t)res->term_bytes.size());
    auto& poss = terms[*k];
    res->positions.insert(res->positions.end(), poss.begin(), poss.end());
    res->pos_starts.push_back((int32_t)res->positions.size());
  }
  return res;
}

void oramax_index_doc_sizes(void* h, int64_t* out4) {
  auto* r = (IndexDocResult*)h;
  out4[0] = (int64_t)(r->term_offsets.size() - 1);  // n unique terms
  out4[1] = (int64_t)r->term_bytes.size();
  out4[2] = (int64_t)r->positions.size();
  out4[3] = r->field_length;
}

void oramax_index_doc_copy(void* h, uint8_t* term_bytes, int32_t* term_offsets,
                           int32_t* pos_starts, int32_t* positions) {
  auto* r = (IndexDocResult*)h;
  memcpy(term_bytes, r->term_bytes.data(), r->term_bytes.size());
  memcpy(term_offsets, r->term_offsets.data(), r->term_offsets.size() * 4);
  memcpy(pos_starts, r->pos_starts.data(), r->pos_starts.size() * 4);
  memcpy(positions, r->positions.data(), r->positions.size() * 4);
}

void oramax_index_doc_free(void* h) { delete (IndexDocResult*)h; }

// ---------------------------------------------------------------------------
// batched whole-document indexing: N documents in ONE ctypes round trip.
// Per-call marshalling (handle + 4 output buffers per doc) dominated the
// ingest profile at ~80us/doc; the batch variant pays it once per batch.
// ---------------------------------------------------------------------------

namespace {

struct IndexDocsResult {
  std::string term_bytes;
  std::vector<int32_t> term_offsets{0};     // per term, across all docs
  std::vector<int32_t> pos_starts{0};       // per term
  std::vector<int32_t> positions;
  std::vector<int32_t> doc_term_starts{0};  // per doc: first term index
  std::vector<int32_t> field_lengths;       // per doc
};

}  // namespace

void* oramax_index_docs(const uint8_t* texts, const int64_t* offsets,
                        int64_t n_docs) {
  auto* out = new IndexDocsResult();
  for (int64_t d = 0; d < n_docs; d++) {
    auto* r = (IndexDocResult*)oramax_index_doc(texts + offsets[d],
                                                offsets[d + 1] - offsets[d]);
    out->term_bytes += r->term_bytes;
    int32_t base_tb = out->term_offsets.back();
    for (size_t i = 1; i < r->term_offsets.size(); i++)
      out->term_offsets.push_back(base_tb + r->term_offsets[i]);
    int32_t base_pos = out->pos_starts.back();
    for (size_t i = 1; i < r->pos_starts.size(); i++)
      out->pos_starts.push_back(base_pos + r->pos_starts[i]);
    out->positions.insert(out->positions.end(), r->positions.begin(),
                          r->positions.end());
    out->doc_term_starts.push_back((int32_t)(out->term_offsets.size() - 1));
    out->field_lengths.push_back(r->field_length);
    delete r;
  }
  return out;
}

void oramax_index_docs_sizes(void* h, int64_t* out4) {
  auto* r = (IndexDocsResult*)h;
  out4[0] = (int64_t)(r->term_offsets.size() - 1);  // total terms
  out4[1] = (int64_t)r->term_bytes.size();
  out4[2] = (int64_t)r->positions.size();
  out4[3] = (int64_t)r->field_lengths.size();  // n docs
}

void oramax_index_docs_copy(void* h, uint8_t* term_bytes,
                            int32_t* term_offsets, int32_t* pos_starts,
                            int32_t* positions, int32_t* doc_term_starts,
                            int32_t* field_lengths) {
  auto* r = (IndexDocsResult*)h;
  memcpy(term_bytes, r->term_bytes.data(), r->term_bytes.size());
  memcpy(term_offsets, r->term_offsets.data(), r->term_offsets.size() * 4);
  memcpy(pos_starts, r->pos_starts.data(), r->pos_starts.size() * 4);
  memcpy(positions, r->positions.data(), r->positions.size() * 4);
  memcpy(doc_term_starts, r->doc_term_starts.data(),
         r->doc_term_starts.size() * 4);
  memcpy(field_lengths, r->field_lengths.data(), r->field_lengths.size() * 4);
}

void oramax_index_docs_free(void* h) { delete (IndexDocsResult*)h; }

// ---------------------------------------------------------------------------
// posting builder: accumulate (term, doc, position) and pack CSR
// ---------------------------------------------------------------------------

namespace {

struct PostingBuilder {
  // term -> doc -> positions (std::map keeps terms sorted for free packing)
  std::map<std::string, std::map<int32_t, std::vector<int32_t>>> terms;
  std::unordered_map<int32_t, int32_t> doc_lens;
  int64_t total_len = 0;

  // packed output
  std::string packed_term_bytes;
  std::vector<int32_t> packed_term_offsets{0};
  std::vector<int64_t> term_starts{0};
  std::vector<int32_t> post_docs;
  std::vector<float> post_tf;
  std::vector<int64_t> pos_starts{0};
  std::vector<int32_t> positions;
};

}  // namespace

void* oramax_builder_new() { return new PostingBuilder(); }
void oramax_builder_free(void* h) { delete (PostingBuilder*)h; }

// Insert one document's terms: flat (term bytes + offsets) with parallel
// positions; terms may repeat (same term, several positions).
void oramax_builder_insert(void* h, int32_t doc_id, int32_t field_len,
                           const uint8_t* term_bytes,
                           const int32_t* term_offsets, int32_t n_terms,
                           const int32_t* positions) {
  auto* b = (PostingBuilder*)h;
  auto it = b->doc_lens.find(doc_id);
  if (it == b->doc_lens.end()) {
    b->doc_lens[doc_id] = field_len;
    b->total_len += field_len;
  }
  for (int32_t i = 0; i < n_terms; i++) {
    std::string term((const char*)term_bytes + term_offsets[i],
                     term_offsets[i + 1] - term_offsets[i]);
    b->terms[term][doc_id].push_back(positions[i]);
  }
}

int64_t oramax_builder_n_docs(void* h) {
  return ((PostingBuilder*)h)->doc_lens.size();
}
int64_t oramax_builder_total_len(void* h) {
  return ((PostingBuilder*)h)->total_len;
}

// Pack into CSR. Returns n_terms; sizes readable afterwards.
int64_t oramax_builder_pack(void* h) {
  auto* b = (PostingBuilder*)h;
  b->packed_term_bytes.clear();
  b->packed_term_offsets.assign(1, 0);
  b->term_starts.assign(1, 0);
  b->post_docs.clear();
  b->post_tf.clear();
  b->pos_starts.assign(1, 0);
  b->positions.clear();
  for (auto& [term, docs] : b->terms) {
    b->packed_term_bytes += term;
    b->packed_term_offsets.push_back((int32_t)b->packed_term_bytes.size());
    for (auto& [doc, poss] : docs) {
      b->post_docs.push_back(doc);
      b->post_tf.push_back((float)poss.size());
      std::sort(poss.begin(), poss.end());
      b->positions.insert(b->positions.end(), poss.begin(), poss.end());
      b->pos_starts.push_back((int64_t)b->positions.size());
    }
    b->term_starts.push_back((int64_t)b->post_docs.size());
  }
  return (int64_t)b->terms.size();
}

int64_t oramax_builder_packed_sizes(void* h, int64_t* out5) {
  auto* b = (PostingBuilder*)h;
  out5[0] = (int64_t)b->packed_term_bytes.size();
  out5[1] = (int64_t)b->post_docs.size();
  out5[2] = (int64_t)b->positions.size();
  out5[3] = (int64_t)b->terms.size();
  out5[4] = b->total_len;
  return 0;
}

void oramax_builder_packed_copy(void* h, uint8_t* term_bytes,
                                int32_t* term_offsets, int64_t* term_starts,
                                int32_t* post_docs, float* post_tf,
                                int64_t* pos_starts, int32_t* positions) {
  auto* b = (PostingBuilder*)h;
  memcpy(term_bytes, b->packed_term_bytes.data(), b->packed_term_bytes.size());
  memcpy(term_offsets, b->packed_term_offsets.data(),
         b->packed_term_offsets.size() * 4);
  memcpy(term_starts, b->term_starts.data(), b->term_starts.size() * 8);
  memcpy(post_docs, b->post_docs.data(), b->post_docs.size() * 4);
  memcpy(post_tf, b->post_tf.data(), b->post_tf.size() * 4);
  memcpy(pos_starts, b->pos_starts.data(), b->pos_starts.size() * 8);
  memcpy(positions, b->positions.data(), b->positions.size() * 4);
}

}  // extern "C"
