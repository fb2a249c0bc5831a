// Native SentencePiece-unigram Viterbi engine.
//
// The reference's T5 tokenizer wraps the sentencepiece C++ library
// (flux/tokenizers.py:122-185); our from-scratch Python port
// (tokenizers/sentencepiece_unigram.py) keeps the wire-format parsing and
// normalization in Python and moves the O(n * max_piece_len) Viterbi hot
// loop here. Semantics are a statement-by-statement mirror of
// SentencePieceUnigramTokenizer._segment: double-precision DP, strict-`>`
// relaxation with ascending start order (same tie-breaks), per-codepoint
// unknown fallback at -100.0 with byte pieces (or unk id).
//
// C ABI (ctypes-friendly), no external dependencies:
//   fgt_spm_create / fgt_spm_destroy
//   fgt_spm_add_piece(handle, utf8, score, id)
//   fgt_spm_add_byte(handle, byte_val, id)
//   fgt_spm_set_unk(handle, id)
//   fgt_spm_encode(handle, utf8_normalized, out_ids, max_out) -> n or -1
//
// Built at first use by tokenizers/native.py, with clip_bpe.cpp, into one
// library under csrc/build/.

#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct SpmEngine {
    std::unordered_map<std::string, std::pair<double, int32_t>> pieces;
    int32_t byte_ids[256];
    bool has_bytes = false;
    int32_t unk = 2;
    size_t max_piece_cp = 1;  // longest piece in CODEPOINTS (Python len())

    SpmEngine() { std::memset(byte_ids, 0xFF, sizeof(byte_ids)); }
};

// byte offsets of each codepoint boundary, plus the end offset
std::vector<size_t> cp_offsets(const std::string& s) {
    std::vector<size_t> off;
    size_t i = 0;
    while (i < s.size()) {
        off.push_back(i);
        unsigned char c = s[i];
        size_t len = 1;
        if ((c & 0xF8) == 0xF0) len = 4;
        else if ((c & 0xF0) == 0xE0) len = 3;
        else if ((c & 0xE0) == 0xC0) len = 2;
        i += len;
    }
    off.push_back(s.size());
    return off;
}

size_t cp_len(const std::string& s) {
    size_t n = 0, i = 0;
    while (i < s.size()) {
        unsigned char c = s[i];
        size_t len = 1;
        if ((c & 0xF8) == 0xF0) len = 4;
        else if ((c & 0xF0) == 0xE0) len = 3;
        else if ((c & 0xE0) == 0xC0) len = 2;
        i += len;
        ++n;
    }
    return n;
}

}  // namespace

extern "C" {

void* fgt_spm_create() { return new SpmEngine(); }

void fgt_spm_destroy(void* h) { delete static_cast<SpmEngine*>(h); }

void fgt_spm_add_piece(void* h, const char* piece, double score, int32_t id) {
    auto* eng = static_cast<SpmEngine*>(h);
    std::string p(piece);
    eng->pieces.emplace(p, std::make_pair(score, id));
    size_t n = cp_len(p);
    if (n > eng->max_piece_cp) eng->max_piece_cp = n;
}

void fgt_spm_add_byte(void* h, int32_t byte_val, int32_t id) {
    auto* eng = static_cast<SpmEngine*>(h);
    if (byte_val >= 0 && byte_val < 256) {
        eng->byte_ids[byte_val] = id;
        eng->has_bytes = true;
    }
}

void fgt_spm_set_unk(void* h, int32_t id) {
    static_cast<SpmEngine*>(h)->unk = id;
}

// text: the NORMALIZED string (caller does NFKC + dummy prefix + U+2581).
// Returns ids written, or -1 on overflow.
int32_t fgt_spm_encode(void* h, const char* text_c, int32_t* out,
                       int32_t max_out) {
    auto* eng = static_cast<SpmEngine*>(h);
    const std::string text(text_c);
    const std::vector<size_t> off = cp_offsets(text);
    const size_t n = off.size() - 1;  // codepoints
    if (n == 0) return 0;

    const double NEG = -std::numeric_limits<double>::infinity();
    std::vector<double> best(n + 1, NEG);
    // back[end] = (start, piece_id or -1 for unk-char)
    std::vector<std::pair<size_t, int32_t>> back(n + 1, {0, -1});
    best[0] = 0.0;
    const size_t max_len = eng->max_piece_cp;

    std::string cand;
    for (size_t end = 1; end <= n; ++end) {
        size_t lo = end > max_len ? end - max_len : 0;
        for (size_t start = lo; start < end; ++start) {
            if (best[start] == NEG) continue;
            cand.assign(text, off[start], off[end] - off[start]);
            auto it = eng->pieces.find(cand);
            if (it != eng->pieces.end()) {
                double s = best[start] + it->second.first;
                if (s > best[end]) {
                    best[end] = s;
                    back[end] = {start, it->second.second};
                }
            }
        }
        if (best[end] == NEG) {
            best[end] = best[end - 1] - 100.0;
            back[end] = {end - 1, -1};
        }
    }

    // backtrack (reversed), then reverse once at the end — identical to the
    // Python implementation's append-then-reverse
    std::vector<int32_t> rev;
    size_t pos = n;
    while (pos > 0) {
        size_t start = back[pos].first;
        int32_t pid = back[pos].second;
        if (pid >= 0) {
            rev.push_back(pid);
        } else {
            // unknown codepoint: byte pieces reversed, or unk
            if (eng->has_bytes) {
                for (size_t b = off[pos]; b > off[start]; --b) {
                    int32_t bid = eng->byte_ids[(unsigned char)text[b - 1]];
                    rev.push_back(bid >= 0 ? bid : eng->unk);
                }
            } else {
                rev.push_back(eng->unk);
            }
        }
        pos = start;
    }
    if (static_cast<int32_t>(rev.size()) > max_out) return -1;
    int32_t m = static_cast<int32_t>(rev.size());
    for (int32_t i = 0; i < m; ++i) out[i] = rev[m - 1 - i];
    return m;
}

}  // extern "C"
