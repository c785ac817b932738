// Native SentencePiece-BPE encoder core.
//
// The reference's tokenizer hot path is the C++ `sentencepiece` library behind
// HF LlamaTokenizer (reference models/visualcla/modeling_utils.py:94).  This is
// our equivalent native core: SP-compatible BPE encoding with byte fallback,
// exposed through a C ABI consumed via ctypes (visualcla_tpu/text/native_tok.py).
// Semantics are defined by the pure-Python executable spec in
// visualcla_tpu/text/sp_bpe.py and locked by differential tests.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC sptok.cpp -o libsptok.so

#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kTypeNormal = 1;
constexpr int kTypeByte = 6;

struct Model {
  std::vector<std::string> pieces;
  std::vector<float> scores;
  std::vector<uint8_t> types;
  std::unordered_map<std::string_view, int32_t> piece_to_id;  // views into pieces
  int32_t unk_id = 0;
  bool add_dummy_prefix = true;
  bool remove_extra_whitespaces = false;
  bool escape_whitespaces = true;
  int32_t byte_to_id[256];
  bool has_byte_fallback = false;
};

// UTF-8 char length from the lead byte (invalid bytes -> 1, treated as a unit).
inline int utf8_len(unsigned char b) {
  if (b < 0x80) return 1;
  if ((b >> 5) == 0x6) return 2;
  if ((b >> 4) == 0xE) return 3;
  if ((b >> 3) == 0x1E) return 4;
  return 1;
}

const char kWsPiece[] = "\xe2\x96\x81";  // ▁

std::string normalize(const Model& m, std::string_view text, bool dummy_prefix) {
  std::string s;
  if (m.remove_extra_whitespaces) {
    // collapse runs of ' ' and trim (python spec: " ".join(filter(split(' '))))
    std::string collapsed;
    size_t i = 0;
    bool in_word = false;
    for (char c : text) {
      if (c == ' ') {
        in_word = false;
      } else {
        if (!in_word && !collapsed.empty()) collapsed += ' ';
        in_word = true;
        collapsed += c;
      }
    }
    s = std::move(collapsed);
  } else {
    s.assign(text.data(), text.size());
  }
  if (dummy_prefix && m.add_dummy_prefix && !s.empty()) s.insert(s.begin(), ' ');
  if (m.escape_whitespaces) {
    std::string escaped;
    escaped.reserve(s.size() * 2);
    for (char c : s) {
      if (c == ' ')
        escaped += kWsPiece;
      else
        escaped += c;
    }
    s = std::move(escaped);
  }
  return s;
}

struct Sym {
  int32_t start, end;   // byte span in the normalized string
  int32_t prev, next;   // linked list
  bool alive;
  uint32_t version;
};

struct Cand {
  float score;
  int32_t left;         // index of the left symbol
  int32_t start_byte;   // tie-break: leftmost wins
  uint32_t vl, vr;      // versions of (left, right) at push time
};

struct CandCmp {
  bool operator()(const Cand& a, const Cand& b) const {
    if (a.score != b.score) return a.score < b.score;      // max-heap on score
    return a.start_byte > b.start_byte;                    // then leftmost
  }
};

void emit_piece(const Model& m, std::string_view piece,
                std::vector<int32_t>* out) {
  auto it = m.piece_to_id.find(piece);
  if (it != m.piece_to_id.end() && m.types[it->second] != 3 &&
      m.types[it->second] != 5) {
    out->push_back(it->second);
    return;
  }
  if (m.has_byte_fallback) {
    for (unsigned char b : piece) out->push_back(m.byte_to_id[b]);
  } else {
    out->push_back(m.unk_id);
  }
}

void encode_bpe(const Model& m, const std::string& norm,
                std::vector<int32_t>* out) {
  const int32_t nb = static_cast<int32_t>(norm.size());
  if (nb == 0) return;
  std::vector<Sym> syms;
  syms.reserve(nb);
  for (int32_t i = 0; i < nb;) {
    int l = utf8_len(static_cast<unsigned char>(norm[i]));
    if (i + l > nb) l = 1;
    Sym s;
    s.start = i;
    s.end = i + l;
    s.prev = static_cast<int32_t>(syms.size()) - 1;
    s.next = static_cast<int32_t>(syms.size()) + 1;
    s.alive = true;
    s.version = 0;
    syms.push_back(s);
    i += l;
  }
  const int32_t n = static_cast<int32_t>(syms.size());

  auto pair_score = [&](int32_t i, float* score) -> bool {
    int32_t j = syms[i].next;
    if (j >= n) return false;
    std::string_view piece(norm.data() + syms[i].start,
                           syms[j].end - syms[i].start);
    auto it = m.piece_to_id.find(piece);
    if (it == m.piece_to_id.end() || m.types[it->second] != kTypeNormal)
      return false;
    *score = m.scores[it->second];
    return true;
  };

  std::priority_queue<Cand, std::vector<Cand>, CandCmp> heap;
  auto maybe_push = [&](int32_t i) {
    float sc;
    if (i >= 0 && i < n && syms[i].alive && pair_score(i, &sc)) {
      heap.push({sc, i, syms[i].start, syms[i].version,
                 syms[syms[i].next].version});
    }
  };
  for (int32_t i = 0; i + 1 < n; ++i) maybe_push(i);

  while (!heap.empty()) {
    Cand c = heap.top();
    heap.pop();
    int32_t i = c.left;
    if (!syms[i].alive || syms[i].version != c.vl) continue;
    int32_t j = syms[i].next;
    if (j >= n || !syms[j].alive || syms[j].version != c.vr) continue;
    float sc;
    if (!pair_score(i, &sc) || sc != c.score || syms[i].start != c.start_byte)
      continue;
    // merge j into i
    syms[i].end = syms[j].end;
    syms[j].alive = false;
    syms[i].next = syms[j].next;
    if (syms[j].next < n) syms[syms[j].next].prev = i;
    syms[i].version++;
    maybe_push(syms[i].prev);
    maybe_push(i);
  }

  for (int32_t i = 0; i < n; i = syms[i].next) {
    if (!syms[i].alive) {  // only possible via stale next pointers; skip
      ++i;
      continue;
    }
    std::string_view piece(norm.data() + syms[i].start,
                           syms[i].end - syms[i].start);
    emit_piece(m, piece, out);
  }
}

}  // namespace

extern "C" {

void* sptok_create(const char* pieces_blob, const int32_t* piece_lens,
                   const float* scores, const uint8_t* types, int32_t n_pieces,
                   int32_t unk_id, int32_t add_dummy_prefix,
                   int32_t remove_extra_ws, int32_t escape_ws) {
  auto* m = new Model();
  m->pieces.reserve(n_pieces);
  size_t off = 0;
  for (int32_t i = 0; i < n_pieces; ++i) {
    m->pieces.emplace_back(pieces_blob + off, piece_lens[i]);
    off += piece_lens[i];
  }
  m->scores.assign(scores, scores + n_pieces);
  m->types.assign(types, types + n_pieces);
  m->unk_id = unk_id;
  m->add_dummy_prefix = add_dummy_prefix != 0;
  m->remove_extra_whitespaces = remove_extra_ws != 0;
  m->escape_whitespaces = escape_ws != 0;
  m->piece_to_id.reserve(n_pieces * 2);
  for (int32_t i = 0; i < n_pieces; ++i)
    m->piece_to_id.emplace(std::string_view(m->pieces[i]), i);
  for (int i = 0; i < 256; ++i) m->byte_to_id[i] = -1;
  for (int32_t i = 0; i < n_pieces; ++i) {
    if (m->types[i] == kTypeByte && m->pieces[i].size() == 6) {
      int b = std::stoi(m->pieces[i].substr(3, 2), nullptr, 16);
      m->byte_to_id[b] = i;
      m->has_byte_fallback = true;
    }
  }
  return m;
}

void sptok_free(void* h) { delete static_cast<Model*>(h); }

// Returns the number of ids written (or -needed if out buffer is too small).
int32_t sptok_encode(void* h, const char* text, int32_t text_len,
                     int32_t dummy_prefix, int32_t* out_ids, int32_t max_out) {
  auto* m = static_cast<Model*>(h);
  std::string norm =
      normalize(*m, std::string_view(text, text_len), dummy_prefix != 0);
  std::vector<int32_t> ids;
  ids.reserve(norm.size());
  encode_bpe(*m, norm, &ids);
  if (static_cast<int32_t>(ids.size()) > max_out)
    return -static_cast<int32_t>(ids.size());
  std::memcpy(out_ids, ids.data(), ids.size() * sizeof(int32_t));
  return static_cast<int32_t>(ids.size());
}

}  // extern "C"
