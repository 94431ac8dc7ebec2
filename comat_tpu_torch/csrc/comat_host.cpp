// comat_host: the port's native host runtime, a plain C interface for
// ctypes (comat_tpu_torch/native_host.py), built by g++ at first use
// (comat_tpu_torch/ops/_build.py `build_host`).
//
//   1. Latent store: a pool of reader threads that read .npy files in the
//      background, each read a ticket (`ch_store_prefetch` hands out the
//      tickets of a batch, `ch_store_fetch` waits for one and describes
//      it, `ch_store_take` copies it out). The store only reads: which file
//      a prompt draws, and its layout, are the caller's (Python draws with
//      the same random.Random as training/data.py's GanLatentStore and
//      transposes an NCHW file as it does).
//   2. CLIP byte-level BPE: vocab.json + merges.txt, batch encoding into
//      int32 rows with BOS, EOS, truncation and padding as
//      text/tokenizer.py's CLIPBPETokenizer. The text arrives cleaned and
//      lower-cased by the caller (the same function the Python tokenizer
//      runs); the pretokenizer splits it on UTF-8 code points with the
//      classes of that tokenizer's `_CLIP_PAT` under Python's `re`
//      (unicode_classes.inc, generated from unicodedata).
//
// Every call that can fail returns nonzero (or null) and writes a message
// into the caller's buffer.

#include <algorithm>
#include <climits>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fstream>
#include <map>
#include <mutex>
#include <set>
#include <sstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

void set_error(char* err, int cap, const std::string& msg) {
  if (err == nullptr || cap <= 0) return;
  const size_t n = std::min(msg.size(), static_cast<size_t>(cap - 1));
  std::memcpy(err, msg.data(), n);
  err[n] = '\0';
}

// ---------------------------------------------------------------------
// 1. Latent store
// ---------------------------------------------------------------------

struct NpyBlob {
  std::string descr;
  bool fortran = false;
  std::vector<int64_t> shape;
  std::vector<char> data;
  std::string error;  // empty when the read succeeded
};

// The item size of a numpy descr such as '<f4', '|u1', '>i8', '<c8'.
bool descr_itemsize(const std::string& descr, int64_t* size) {
  if (descr.size() < 3 || std::string("<>|=").find(descr[0]) == std::string::npos) return false;
  if (std::string("fiucb").find(descr[1]) == std::string::npos) return false;
  for (size_t i = 2; i < descr.size(); ++i)
    if (descr[i] < '0' || descr[i] > '9') return false;
  *size = std::stoll(descr.substr(2));
  return *size > 0;
}

// The value of `key` in the header's dict literal, as its raw text up to
// the next top-level ',' or '}'.
bool header_field(const std::string& header, const std::string& key, std::string* value) {
  const size_t k = header.find("'" + key + "'");
  if (k == std::string::npos) return false;
  size_t i = header.find(':', k);
  if (i == std::string::npos) return false;
  ++i;
  while (i < header.size() && header[i] == ' ') ++i;
  size_t j = i;
  int depth = 0;
  for (; j < header.size(); ++j) {
    const char c = header[j];
    if (c == '(' || c == '[') ++depth;
    if (c == ')' || c == ']') --depth;
    if (depth == 0 && (c == ',' || c == '}')) break;
  }
  *value = header.substr(i, j - i);
  return true;
}

void read_npy(const std::string& path, NpyBlob* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) {
    out->error = path + ": cannot open";
    return;
  }
  char magic[6];
  unsigned char ver[2];
  f.read(magic, 6);
  f.read(reinterpret_cast<char*>(ver), 2);
  if (!f || std::memcmp(magic, "\x93NUMPY", 6) != 0) {
    out->error = path + ": not a .npy file";
    return;
  }
  uint32_t hlen = 0;
  if (ver[0] == 1) {
    unsigned char h[2];
    f.read(reinterpret_cast<char*>(h), 2);
    hlen = h[0] | (h[1] << 8);
  } else if (ver[0] == 2 || ver[0] == 3) {
    unsigned char h[4];
    f.read(reinterpret_cast<char*>(h), 4);
    hlen = h[0] | (h[1] << 8) | (h[2] << 16) | (static_cast<uint32_t>(h[3]) << 24);
  } else {
    out->error = path + ": .npy version " + std::to_string(ver[0]) + " unknown";
    return;
  }
  std::string header(hlen, '\0');
  f.read(&header[0], hlen);
  if (!f) {
    out->error = path + ": truncated header";
    return;
  }
  std::string descr, fortran, shape;
  if (!header_field(header, "descr", &descr) || !header_field(header, "fortran_order", &fortran) ||
      !header_field(header, "shape", &shape)) {
    out->error = path + ": header without descr, fortran_order or shape: " + header;
    return;
  }
  if (descr.size() < 2 || descr.front() != '\'' || descr.back() != '\'') {
    out->error = path + ": structured dtype " + descr + " not supported";
    return;
  }
  out->descr = descr.substr(1, descr.size() - 2);
  int64_t itemsize = 0;
  if (!descr_itemsize(out->descr, &itemsize)) {
    out->error = path + ": dtype " + out->descr + " not supported";
    return;
  }
  out->fortran = fortran == "True";
  int64_t count = 1;
  std::string dims = shape.substr(1, shape.size() - 2);  // inside the parentheses
  std::stringstream ss(dims);
  std::string tok;
  while (std::getline(ss, tok, ',')) {
    if (tok.find_first_of("0123456789") == std::string::npos) continue;
    const int64_t d = std::stoll(tok);
    out->shape.push_back(d);
    count *= d;
  }
  out->data.resize(static_cast<size_t>(count * itemsize));
  f.read(out->data.data(), static_cast<std::streamsize>(out->data.size()));
  if (!f) {
    out->error = path + ": truncated data (" + std::to_string(out->data.size()) + " bytes expected)";
    out->data.clear();
  }
}

struct LatentStore {
  std::vector<std::thread> workers;
  std::deque<std::pair<int64_t, std::string>> queue;  // ticket, path
  std::map<int64_t, NpyBlob> done;
  std::set<int64_t> pending;  // handed out, not yet taken or dropped
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  bool stop = false;
  int64_t next_ticket = 0;

  explicit LatentStore(int n_threads) {
    for (int i = 0; i < n_threads; ++i) workers.emplace_back([this] { worker_loop(); });
  }
  ~LatentStore() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
  }

  void worker_loop() {
    for (;;) {
      std::pair<int64_t, std::string> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [this] { return stop || !queue.empty(); });
        if (queue.empty()) return;
        job = std::move(queue.front());
        queue.pop_front();
      }
      NpyBlob blob;
      read_npy(job.second, &blob);
      {
        std::lock_guard<std::mutex> lk(mu);
        done[job.first] = std::move(blob);
      }
      cv_done.notify_all();
    }
  }

  int64_t submit(const std::string& path) {
    int64_t t;
    {
      std::lock_guard<std::mutex> lk(mu);
      t = next_ticket++;
      queue.emplace_back(t, path);
      pending.insert(t);
    }
    cv_work.notify_one();
    return t;
  }
};

}  // namespace

extern "C" {

void* ch_store_open(int n_threads, char* err, int err_cap) {
  if (n_threads <= 0) {
    set_error(err, err_cap, "n_threads must be positive, got " + std::to_string(n_threads));
    return nullptr;
  }
  return new LatentStore(n_threads);
}

// Queue reads of n files; their tickets go to tickets_out (n).
void ch_store_prefetch(void* h, const char** paths, int n, int64_t* tickets_out) {
  auto* s = static_cast<LatentStore*>(h);
  for (int i = 0; i < n; ++i) tickets_out[i] = s->submit(paths[i]);
}

// Waits for the read of `ticket` and describes it: the dtype's descr
// (NUL-terminated, into descr of descr_cap bytes), Fortran order, ndim,
// the shape (into shape of shape_cap), the data's bytes. Returns 0, or -1
// with a message (a failed read is dropped).
int ch_store_fetch(void* h, int64_t ticket, char* descr, int descr_cap, int* fortran, int* ndim,
                   int64_t* shape, int shape_cap, int64_t* nbytes, char* err, int err_cap) {
  auto* s = static_cast<LatentStore*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  if (s->pending.count(ticket) == 0) {
    set_error(err, err_cap, "ticket " + std::to_string(ticket) + " is not pending");
    return -1;
  }
  s->cv_done.wait(lk, [&] { return s->done.count(ticket) > 0; });
  NpyBlob& b = s->done[ticket];
  if (!b.error.empty()) {
    set_error(err, err_cap, b.error);
    s->done.erase(ticket);
    s->pending.erase(ticket);
    return -1;
  }
  if (static_cast<int>(b.descr.size()) >= descr_cap || static_cast<int>(b.shape.size()) > shape_cap) {
    set_error(err, err_cap, "descr or shape larger than the caller's buffers");
    s->done.erase(ticket);
    s->pending.erase(ticket);
    return -1;
  }
  std::memcpy(descr, b.descr.c_str(), b.descr.size() + 1);
  *fortran = b.fortran ? 1 : 0;
  *ndim = static_cast<int>(b.shape.size());
  for (size_t i = 0; i < b.shape.size(); ++i) shape[i] = b.shape[i];
  *nbytes = static_cast<int64_t>(b.data.size());
  return 0;
}

// Copies a fetched ticket's data (nbytes, as ch_store_fetch gave it) to
// out and drops it. Returns 0, or -1 with a message.
int ch_store_take(void* h, int64_t ticket, void* out, int64_t nbytes, char* err, int err_cap) {
  auto* s = static_cast<LatentStore*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  auto it = s->done.find(ticket);
  if (it == s->done.end()) {
    set_error(err, err_cap, "ticket " + std::to_string(ticket) + " is not fetched");
    return -1;
  }
  if (static_cast<int64_t>(it->second.data.size()) != nbytes) {
    set_error(err, err_cap, "ticket " + std::to_string(ticket) + " holds " +
                                std::to_string(it->second.data.size()) + " bytes, not " +
                                std::to_string(nbytes));
    return -1;
  }
  std::memcpy(out, it->second.data.data(), static_cast<size_t>(nbytes));
  s->done.erase(it);
  s->pending.erase(ticket);
  return 0;
}

// Finishes the queued reads, stops the threads and frees the store.
void ch_store_close(void* h) { delete static_cast<LatentStore*>(h); }

}  // extern "C"

// ---------------------------------------------------------------------
// 2. CLIP byte-level BPE
// ---------------------------------------------------------------------

namespace {

struct UnicodeRange {
  uint32_t first, last;
  int cls;
};
struct CaseVariant {
  char letter;
  uint32_t cp;
};

#include "unicode_classes.inc"

constexpr int kLetter = 1, kSkip = 2;

int char_class(uint32_t cp) {
  const UnicodeRange* end = kClassRanges + sizeof(kClassRanges) / sizeof(kClassRanges[0]);
  const UnicodeRange* r = std::upper_bound(
      kClassRanges, end, cp, [](uint32_t v, const UnicodeRange& u) { return v < u.first; });
  if (r == kClassRanges) return 0;
  --r;
  return cp <= r->last ? r->cls : 0;
}

// cp matches the ASCII lowercase `letter` under re.IGNORECASE
bool ci_letter(uint32_t cp, char letter) {
  if (cp == static_cast<uint32_t>(letter)) return true;
  for (const auto& v : kCaseVariants)
    if (v.letter == letter && v.cp == cp) return true;
  return false;
}

// UTF-8 -> code points with the byte offset of each (offsets has one
// more entry, the end); false on malformed input.
bool decode_utf8(const std::string& s, std::vector<uint32_t>* cps, std::vector<size_t>* offsets) {
  for (size_t i = 0; i < s.size();) {
    const unsigned char c = s[i];
    int len;
    uint32_t cp;
    if (c < 0x80) {
      len = 1;
      cp = c;
    } else if ((c & 0xE0) == 0xC0) {
      len = 2;
      cp = c & 0x1F;
    } else if ((c & 0xF0) == 0xE0) {
      len = 3;
      cp = c & 0x0F;
    } else if ((c & 0xF8) == 0xF0) {
      len = 4;
      cp = c & 0x07;
    } else {
      return false;
    }
    if (i + len > s.size()) return false;
    for (int k = 1; k < len; ++k) {
      const unsigned char d = s[i + k];
      if ((d & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (d & 0x3F);
    }
    offsets->push_back(i);
    cps->push_back(cp);
    i += len;
  }
  offsets->push_back(s.size());
  return true;
}

void append_utf8(uint32_t cp, std::string* out) {
  if (cp < 0x80) {
    *out += static_cast<char>(cp);
  } else if (cp < 0x800) {
    *out += static_cast<char>(0xC0 | (cp >> 6));
    *out += static_cast<char>(0x80 | (cp & 0x3F));
  } else if (cp < 0x10000) {
    *out += static_cast<char>(0xE0 | (cp >> 12));
    *out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
    *out += static_cast<char>(0x80 | (cp & 0x3F));
  } else {
    *out += static_cast<char>(0xF0 | (cp >> 18));
    *out += static_cast<char>(0x80 | ((cp >> 12) & 0x3F));
    *out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
    *out += static_cast<char>(0x80 | (cp & 0x3F));
  }
}

// `_CLIP_PAT.findall(text)`: the alternatives in the pattern's order at
// each position, a position no alternative matches skipped. Returns the
// tokens as byte ranges [begin, end) of text.
bool pretokenize(const std::string& text, std::vector<std::pair<size_t, size_t>>* tokens) {
  std::vector<uint32_t> cp;
  std::vector<size_t> off;
  if (!decode_utf8(text, &cp, &off)) return false;
  const size_t n = cp.size();
  auto matches = [&](size_t i, const char* word) {  // ASCII word, letters case-insensitively
    const size_t len = std::strlen(word);
    if (i + len > n) return false;
    for (size_t k = 0; k < len; ++k) {
      const char w = word[k];
      const bool ok = (w >= 'a' && w <= 'z') ? ci_letter(cp[i + k], w) : cp[i + k] == static_cast<uint32_t>(w);
      if (!ok) return false;
    }
    return true;
  };
  static const char* kSpecial[] = {"<|startoftext|>", "<|endoftext|>"};
  static const char* kContractions[] = {"'s", "'t", "'re", "'ve", "'m", "'ll", "'d"};
  auto is_punct = [&](uint32_t c) { return c != '\'' && !(c >= '0' && c <= '9') && char_class(c) == 0; };
  size_t i = 0;
  while (i < n) {
    size_t len = 0;
    for (const char* w : kSpecial)
      if (matches(i, w)) {
        len = std::strlen(w);
        break;
      }
    if (len == 0 && cp[i] == '\'') {
      for (const char* w : kContractions)
        if (matches(i, w)) {
          len = std::strlen(w);
          break;
        }
      if (len == 0) len = 1;  // a lone "'": the pattern's last alternative
    }
    if (len == 0 && char_class(cp[i]) == kLetter) {
      while (i + len < n && char_class(cp[i + len]) == kLetter) ++len;
    }
    if (len == 0 && cp[i] >= '0' && cp[i] <= '9') len = 1;
    if (len == 0 && is_punct(cp[i])) {
      while (i + len < n && is_punct(cp[i + len])) ++len;
    }
    if (len == 0) {  // whitespace, a non-ASCII decimal digit, "_"
      ++i;
      continue;
    }
    tokens->emplace_back(off[i], off[i + len]);
    i += len;
  }
  return true;
}

struct BPETokenizer {
  std::unordered_map<std::string, int> vocab;
  std::unordered_map<std::string, int> merge_rank;  // "a b" -> rank
  std::string byte_enc[256];                         // byte -> its symbol, UTF-8
  std::unordered_map<std::string, std::vector<int>> cache;  // word -> ids
  std::mutex mu;  // one encode at a time: the cache is shared
  int bos = 49406, eos = 49407;
};

void build_byte_encoder(BPETokenizer* t) {
  std::vector<int> bs;
  for (int b = '!'; b <= '~'; ++b) bs.push_back(b);
  for (int b = 0xA1; b <= 0xAC; ++b) bs.push_back(b);
  for (int b = 0xAE; b <= 0xFF; ++b) bs.push_back(b);
  std::vector<int> cs(bs);
  int extra = 0;
  for (int b = 0; b < 256; ++b) {
    if (std::find(bs.begin(), bs.end(), b) == bs.end()) {
      bs.push_back(b);
      cs.push_back(256 + extra++);
    }
  }
  for (size_t i = 0; i < bs.size(); ++i) {
    t->byte_enc[bs[i]].clear();
    append_utf8(static_cast<uint32_t>(cs[i]), &t->byte_enc[bs[i]]);
  }
}

std::vector<std::string> utf8_chars(const std::string& s) {
  std::vector<std::string> out;
  for (size_t i = 0; i < s.size();) {
    const unsigned char c = s[i];
    const size_t len = (c < 0x80) ? 1 : (c < 0xE0) ? 2 : (c < 0xF0) ? 3 : 4;
    out.push_back(s.substr(i, len));
    i += len;
  }
  return out;
}

// The ids of one pretokenized word (its bytes already mapped to symbols);
// false with `missing` set if a merged piece is not in the vocabulary.
bool bpe_word(BPETokenizer* t, const std::string& mapped, std::vector<int>* ids,
              std::string* missing) {
  auto hit = t->cache.find(mapped);
  if (hit != t->cache.end()) {
    ids->insert(ids->end(), hit->second.begin(), hit->second.end());
    return true;
  }
  std::vector<std::string> word = utf8_chars(mapped);
  word.back() += "</w>";
  while (word.size() > 1) {
    int best = INT_MAX;
    size_t at = 0;
    for (size_t i = 0; i + 1 < word.size(); ++i) {
      auto it = t->merge_rank.find(word[i] + " " + word[i + 1]);
      if (it != t->merge_rank.end() && it->second < best) {
        best = it->second;
        at = i;
      }
    }
    if (best == INT_MAX) break;
    const std::string a = word[at], b = word[at + 1];
    std::vector<std::string> merged;
    for (size_t i = 0; i < word.size();) {
      if (i + 1 < word.size() && word[i] == a && word[i + 1] == b) {
        merged.push_back(a + b);
        i += 2;
      } else {
        merged.push_back(word[i++]);
      }
    }
    word = std::move(merged);
  }
  std::vector<int> out;
  for (const auto& w : word) {
    auto it = t->vocab.find(w);
    if (it == t->vocab.end()) {
      *missing = w;
      return false;
    }
    out.push_back(it->second);
  }
  t->cache.emplace(mapped, out);
  ids->insert(ids->end(), out.begin(), out.end());
  return true;
}

// A JSON string starting at s[i] == '"'; i ends after the closing quote.
bool json_string(const std::string& s, size_t* i, std::string* out) {
  if (*i >= s.size() || s[*i] != '"') return false;
  ++*i;
  out->clear();
  while (*i < s.size()) {
    const char c = s[(*i)++];
    if (c == '"') return true;
    if (c != '\\') {
      *out += c;
      continue;
    }
    if (*i >= s.size()) return false;
    const char e = s[(*i)++];
    switch (e) {
      case '"': *out += '"'; break;
      case '\\': *out += '\\'; break;
      case '/': *out += '/'; break;
      case 'b': *out += '\b'; break;
      case 'f': *out += '\f'; break;
      case 'n': *out += '\n'; break;
      case 'r': *out += '\r'; break;
      case 't': *out += '\t'; break;
      case 'u': {
        auto hex4 = [&](uint32_t* v) {
          if (*i + 4 > s.size()) return false;
          *v = static_cast<uint32_t>(std::stoul(s.substr(*i, 4), nullptr, 16));
          *i += 4;
          return true;
        };
        uint32_t cp;
        if (!hex4(&cp)) return false;
        if (cp >= 0xD800 && cp <= 0xDBFF && *i + 6 <= s.size() && s[*i] == '\\' && s[*i + 1] == 'u') {
          *i += 2;
          uint32_t lo;
          if (!hex4(&lo)) return false;
          cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
        }
        append_utf8(cp, out);
        break;
      }
      default: return false;
    }
  }
  return false;
}

bool parse_vocab(const std::string& v, BPETokenizer* t, std::string* why) {
  size_t i = 0;
  auto ws = [&] {
    while (i < v.size() && std::strchr(" \t\r\n", v[i]) != nullptr && v[i] != '\0') ++i;
  };
  ws();
  if (i >= v.size() || v[i] != '{') {
    *why = "vocab.json is not a JSON object";
    return false;
  }
  ++i;
  ws();
  if (i < v.size() && v[i] == '}') return true;
  for (;;) {
    std::string key;
    ws();
    if (!json_string(v, &i, &key)) {
      *why = "vocab.json: bad key near byte " + std::to_string(i);
      return false;
    }
    ws();
    if (i >= v.size() || v[i] != ':') {
      *why = "vocab.json: ':' expected near byte " + std::to_string(i);
      return false;
    }
    ++i;
    ws();
    size_t j = i;
    if (j < v.size() && v[j] == '-') ++j;
    while (j < v.size() && v[j] >= '0' && v[j] <= '9') ++j;
    if (j == i) {
      *why = "vocab.json: integer id expected for \"" + key + "\"";
      return false;
    }
    t->vocab[key] = std::stoi(v.substr(i, j - i));
    i = j;
    ws();
    if (i < v.size() && v[i] == ',') {
      ++i;
      continue;
    }
    if (i < v.size() && v[i] == '}') return true;
    *why = "vocab.json: ',' or '}' expected near byte " + std::to_string(i);
    return false;
  }
}

std::string strip(const std::string& s) {
  const char* space = " \t\n\v\f\r";
  const size_t a = s.find_first_not_of(space);
  if (a == std::string::npos) return "";
  return s.substr(a, s.find_last_not_of(space) - a + 1);
}

}  // namespace

extern "C" {

void* ch_bpe_load(const char* vocab_json_path, const char* merges_path, char* err, int err_cap) {
  auto* t = new BPETokenizer();
  build_byte_encoder(t);
  std::ifstream vf(vocab_json_path, std::ios::binary);
  if (!vf) {
    set_error(err, err_cap, std::string(vocab_json_path) + ": cannot open");
    delete t;
    return nullptr;
  }
  std::stringstream buf;
  buf << vf.rdbuf();
  std::string why;
  if (!parse_vocab(buf.str(), t, &why)) {
    set_error(err, err_cap, std::string(vocab_json_path) + ": " + why);
    delete t;
    return nullptr;
  }
  if (t->vocab.count("<|startoftext|>")) t->bos = t->vocab["<|startoftext|>"];
  if (t->vocab.count("<|endoftext|>")) t->eos = t->vocab["<|endoftext|>"];
  std::ifstream mf(merges_path, std::ios::binary);
  if (!mf) {
    set_error(err, err_cap, std::string(merges_path) + ": cannot open");
    delete t;
    return nullptr;
  }
  std::string line;
  int rank = 0;
  for (int lineno = 0; std::getline(mf, line); ++lineno) {
    line = strip(line);
    if ((lineno == 0 && line.rfind("#", 0) == 0) || line.empty()) continue;
    std::stringstream parts(line);
    std::string a, b, more;
    if (!(parts >> a >> b) || (parts >> more)) {
      set_error(err, err_cap, std::string(merges_path) + ": line " + std::to_string(lineno + 1) +
                                  " is not two symbols: " + line);
      delete t;
      return nullptr;
    }
    t->merge_rank[a + " " + b] = rank++;
  }
  return t;
}

int ch_bpe_bos(void* h) { return static_cast<BPETokenizer*>(h)->bos; }
int ch_bpe_eos(void* h) { return static_cast<BPETokenizer*>(h)->eos; }

// Encode n cleaned, lower-cased UTF-8 texts (lengths in bytes) into out (n x max_len int32):
// BOS, the tokens, EOS; truncated to max_len with EOS last; padded with
// pad_id. eos_out (n) gets each row's EOS position. Returns 0, or -1 with
// a message.
int ch_bpe_encode_batch(void* h, const char** texts, const int64_t* lengths, int n, int max_len,
                        int pad_id, int32_t* out, int32_t* eos_out, char* err, int err_cap) {
  auto* t = static_cast<BPETokenizer*>(h);
  if (max_len < 2) {
    set_error(err, err_cap, "max_length must be at least 2");
    return -1;
  }
  std::lock_guard<std::mutex> lk(t->mu);
  for (int r = 0; r < n; ++r) {
    const std::string text(texts[r], static_cast<size_t>(lengths[r]));
    std::vector<std::pair<size_t, size_t>> tokens;
    if (!pretokenize(text, &tokens)) {
      set_error(err, err_cap, "text " + std::to_string(r) + " is not valid UTF-8");
      return -1;
    }
    std::vector<int> ids{t->bos};
    for (const auto& tok : tokens) {
      std::string mapped;
      for (size_t k = tok.first; k < tok.second; ++k)
        mapped += t->byte_enc[static_cast<unsigned char>(text[k])];
      std::string missing;
      if (!bpe_word(t, mapped, &ids, &missing)) {
        set_error(err, err_cap, "text " + std::to_string(r) + ": piece '" + missing +
                                    "' is not in the vocabulary");
        return -1;
      }
    }
    ids.push_back(t->eos);
    if (static_cast<int>(ids.size()) > max_len) {
      ids.resize(max_len);
      ids.back() = t->eos;
    }
    eos_out[r] = static_cast<int32_t>(ids.size()) - 1;
    for (int c = 0; c < max_len; ++c)
      out[static_cast<int64_t>(r) * max_len + c] = c < static_cast<int>(ids.size()) ? ids[c] : pad_id;
  }
  return 0;
}

// The pretokenizer alone, for tests: the tokens of `text` (length bytes)
// as byte offsets, [begin, end) of token k at bounds[2k], bounds[2k + 1]
// (room for cap tokens). Returns the number of tokens, or -1 with a
// message (malformed UTF-8, or too many tokens).
int64_t ch_pretokenize(const char* text, int64_t length, int64_t* bounds, int64_t cap, char* err,
                       int err_cap) {
  std::vector<std::pair<size_t, size_t>> tokens;
  if (!pretokenize(std::string(text, static_cast<size_t>(length)), &tokens)) {
    set_error(err, err_cap, "text is not valid UTF-8");
    return -1;
  }
  if (static_cast<int64_t>(tokens.size()) > cap) {
    set_error(err, err_cap, "more than " + std::to_string(cap) + " tokens");
    return -1;
  }
  for (size_t k = 0; k < tokens.size(); ++k) {
    bounds[2 * k] = static_cast<int64_t>(tokens[k].first);
    bounds[2 * k + 1] = static_cast<int64_t>(tokens[k].second);
  }
  return static_cast<int64_t>(tokens.size());
}

const char* ch_unicode_version() { return kUnicodeVersion; }

void ch_bpe_free(void* h) { delete static_cast<BPETokenizer*>(h); }

}  // extern "C"
