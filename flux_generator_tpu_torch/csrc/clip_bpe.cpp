// Native CLIP BPE merge engine.
//
// The reference ships one native component (a Metal kernel); our runtime's
// native piece is the tokenizer hot loop: the pairwise BPE merge is O(w^2)
// per word in Python and dominates prompt-encoding time for long prompts.
// Unicode regex word-splitting stays in Python (the `regex` module is
// already native); this engine handles vocab lookup + the merge loop.
//
// C ABI (ctypes-friendly), no external dependencies:
//   fgt_bpe_create / fgt_bpe_destroy
//   fgt_bpe_add_token(handle, utf8, id)
//   fgt_bpe_add_merge(handle, a, b, rank)
//   fgt_bpe_encode_word(handle, word, out_ids, max_out) -> n or -1
//
// Built at first use by tokenizers/native.py (g++ -O2 -shared -fPIC, with
// spm_unigram.cpp, into one library under csrc/build/).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
    size_t operator()(const std::pair<std::string, std::string>& p) const {
        std::hash<std::string> h;
        return h(p.first) * 1000003u ^ h(p.second);
    }
};

struct BpeEngine {
    std::unordered_map<std::string, int32_t> vocab;
    std::unordered_map<std::pair<std::string, std::string>, int32_t, PairHash> ranks;
    int32_t unk = -1;
};

// split a UTF-8 string into codepoint-sized chunks
std::vector<std::string> utf8_chars(const std::string& s) {
    std::vector<std::string> out;
    size_t i = 0;
    while (i < s.size()) {
        size_t len = 1;
        unsigned char c = s[i];
        if ((c & 0xF8) == 0xF0) len = 4;
        else if ((c & 0xF0) == 0xE0) len = 3;
        else if ((c & 0xE0) == 0xC0) len = 2;
        out.push_back(s.substr(i, len));
        i += len;
    }
    return out;
}

}  // namespace

extern "C" {

void* fgt_bpe_create() { return new BpeEngine(); }

void fgt_bpe_destroy(void* h) { delete static_cast<BpeEngine*>(h); }

void fgt_bpe_add_token(void* h, const char* tok, int32_t id) {
    static_cast<BpeEngine*>(h)->vocab.emplace(tok, id);
}

void fgt_bpe_set_unk(void* h, int32_t id) {
    static_cast<BpeEngine*>(h)->unk = id;
}

void fgt_bpe_add_merge(void* h, const char* a, const char* b, int32_t rank) {
    static_cast<BpeEngine*>(h)->ranks.emplace(std::make_pair(std::string(a), std::string(b)), rank);
}

// word: UTF-8, already lowercased + byte-encoded by the caller.
// Returns number of ids written, or -1 on overflow.
int32_t fgt_bpe_encode_word(void* h, const char* word_c, int32_t* out, int32_t max_out) {
    auto* eng = static_cast<BpeEngine*>(h);
    std::string word(word_c);
    if (word.empty()) return 0;

    // initial units: chars, last char gets </w>
    std::vector<std::string> parts = utf8_chars(word);
    parts.back() += "</w>";

    // greedy lowest-rank merge loop (flux/tokenizers.py:52-77 semantics)
    while (parts.size() > 1) {
        int32_t best_rank = INT32_MAX;
        size_t best_i = 0;
        for (size_t i = 0; i + 1 < parts.size(); ++i) {
            auto it = eng->ranks.find({parts[i], parts[i + 1]});
            if (it != eng->ranks.end() && it->second < best_rank) {
                best_rank = it->second;
                best_i = i;
            }
        }
        if (best_rank == INT32_MAX) break;
        // merge ALL occurrences of the best pair, left to right
        std::vector<std::string> merged;
        merged.reserve(parts.size());
        const std::string a = parts[best_i], b = parts[best_i + 1];
        for (size_t i = 0; i < parts.size();) {
            if (i + 1 < parts.size() && parts[i] == a && parts[i + 1] == b) {
                merged.push_back(a + b);
                i += 2;
            } else {
                merged.push_back(parts[i]);
                i += 1;
            }
        }
        parts.swap(merged);
    }

    if (static_cast<int32_t>(parts.size()) > max_out) return -1;
    int32_t n = 0;
    for (const auto& p : parts) {
        auto it = eng->vocab.find(p);
        out[n++] = (it != eng->vocab.end()) ? it->second : eng->unk;
    }
    return n;
}

}  // extern "C"
