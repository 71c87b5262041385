// Fast n-gram tokenizer + per-document counter for the TF-IDF stack.
//
// The port's copy of pecos_tpu/core/tokenizer.cpp, with its token rule and
// its FNV-1a 64 hashes kept as they are, so a vocabulary written by either
// package vectorizes alike in the other; its threads are std::threads
// (parallel.h) in place of OpenMP.  It tokenizes
// lowercased UTF-8 text, enumerates word / char / char_wb n-grams, hashes
// each n-gram and counts occurrences per document.  Everything after
// counting (df pruning, idf weights, vocabulary ordering, CSR assembly) stays
// vectorized numpy on the Python side
// (pecos_tpu_torch/utils/featurization/text/vectorizers.py), so the C ABI
// only moves flat arrays.
//
// Performance notes: per-document counts use a power-of-two open-addressing
// scratch table (reset by generation stamp, zero allocation per doc);
// documents shard across OpenMP threads with per-thread output buffers
// stitched in order afterwards. First-occurrence n-gram strings (train only)
// are collected per thread and deduplicated globally in a final pass.
//
// Token rules (the plain Python version in vectorizers.py follows them):
// - word analyzer: tokens are maximal runs of [A-Za-z0-9_] and non-ASCII
//   codepoints (every multi-byte codepoint is a word character, so non-ASCII
//   punctuation such as an em dash joins the words around it), n-grams
//   joined with ' '.
// - char analyzer: n-grams over the document's codepoints.
// - char_wb: words padded with one space each side, char n-grams per word.
// - truncate: word/char_wb keep the first `truncate` tokens, char keeps the
//   first `truncate` codepoints.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "parallel.h"

namespace {

static inline uint64_t fnv1a_str(const char* data, size_t len) {
    uint64_t h = 0xcbf29ce484222325ULL;
    for (size_t i = 0; i < len; ++i) {
        h ^= (unsigned char)data[i];
        h *= 0x100000001b3ULL;
    }
    return h ? h : 1ULL;
}

static inline int cp_len(unsigned char b) {
    if (b < 0x80) return 1;
    if ((b >> 5) == 0x6) return 2;
    if ((b >> 4) == 0xe) return 3;
    if ((b >> 3) == 0x1e) return 4;
    return 1;  // invalid byte: treat as one unit
}

static inline bool is_word_byte_start(const char* s, size_t i) {
    unsigned char b = (unsigned char)s[i];
    if (b >= 0x80) return true;  // non-ASCII: treat as word char (~ \w)
    return (b >= 'a' && b <= 'z') || (b >= 'A' && b <= 'Z') || (b >= '0' && b <= '9') ||
           b == '_';
}

// generation-stamped open-addressing counter: clear is O(1) per document
struct ScratchCounter {
    std::vector<uint64_t> keys;
    std::vector<int32_t> vals;
    std::vector<uint32_t> gen;
    std::vector<uint32_t> slots_used;  // slots touched this generation
    uint32_t cur_gen = 0;
    uint64_t mask = 0;

    void reset_capacity(size_t want) {
        size_t cap = 64;
        while (cap < want * 2) cap <<= 1;
        if (cap > keys.size()) {
            keys.assign(cap, 0);
            vals.assign(cap, 0);
            gen.assign(cap, 0);
            mask = cap - 1;
        }
    }

    void new_doc(size_t expected) {
        reset_capacity(expected < 32 ? 32 : expected);
        ++cur_gen;
        slots_used.clear();
    }

    // returns true on first occurrence in this document
    bool add(uint64_t h) {
        uint64_t i = h & mask;
        for (;;) {
            if (gen[i] != cur_gen) {
                gen[i] = cur_gen;
                keys[i] = h;
                vals[i] = 1;
                slots_used.push_back((uint32_t)i);
                if (slots_used.size() * 2 > mask) grow();
                return true;
            }
            if (keys[i] == h) {
                ++vals[i];
                return false;
            }
            i = (i + 1) & mask;
        }
    }

    void grow() {
        std::vector<uint32_t> old = slots_used;
        std::vector<uint64_t> ok(old.size());
        std::vector<int32_t> ov(old.size());
        for (size_t j = 0; j < old.size(); ++j) {
            ok[j] = keys[old[j]];
            ov[j] = vals[old[j]];
        }
        size_t cap = (mask + 1) * 2;
        keys.assign(cap, 0);
        vals.assign(cap, 0);
        gen.assign(cap, 0);
        mask = cap - 1;
        slots_used.clear();
        for (size_t j = 0; j < ok.size(); ++j) {
            uint64_t i = ok[j] & mask;
            while (gen[i] == cur_gen) i = (i + 1) & mask;
            gen[i] = cur_gen;
            keys[i] = ok[j];
            vals[i] = ov[j];
            slots_used.push_back((uint32_t)i);
        }
    }
};

// append-only open-addressing string set (per thread)
struct StringSet {
    std::vector<uint64_t> keys;
    uint64_t mask = 0;
    size_t n = 0;
    std::string blob;
    std::vector<int64_t> offsets{0};
    std::vector<uint64_t> hashes;
    std::vector<int64_t> dfs;  // document frequency per stored token

    std::vector<uint32_t> vals;

    StringSet() {
        keys.assign(1 << 12, 0);
        vals.assign(1 << 12, 0);
        mask = (1 << 12) - 1;
    }

    void maybe_grow() {
        if (n * 2 <= mask) return;
        size_t cap = (mask + 1) * 2;
        std::vector<uint64_t> nk(cap, 0);
        std::vector<uint32_t> nv(cap, 0);
        uint64_t nm = cap - 1;
        for (size_t j = 0; j <= mask; ++j) {
            uint64_t k = keys[j];
            if (!k) continue;
            uint64_t i = k & nm;
            while (nk[i]) i = (i + 1) & nm;
            nk[i] = k;
            nv[i] = vals[j];
        }
        keys.swap(nk);
        vals.swap(nv);
        mask = nm;
    }

    // returns the stored index of h, inserting (with df 0) when new.
    // vals[slot] maps the open-addressing slot to the storage index.
    size_t add(uint64_t h, const char* s, size_t len) {
        uint64_t i = h & mask;
        for (;;) {
            if (!keys[i]) {
                keys[i] = h;
                vals[i] = (uint32_t)hashes.size();
                ++n;
                blob.append(s, len);
                offsets.push_back((int64_t)blob.size());
                hashes.push_back(h);
                dfs.push_back(0);
                size_t ret = hashes.size() - 1;
                maybe_grow();
                return ret;
            }
            if (keys[i] == h) return (size_t)vals[i];
            i = (i + 1) & mask;
        }
    }

    bool contains(uint64_t h) const {
        uint64_t i = h & mask;
        for (;;) {
            if (!keys[i]) return false;
            if (keys[i] == h) return true;
            i = (i + 1) & mask;
        }
    }
};

struct ThreadOut {
    std::vector<int64_t> doc_counts_len;  // per local doc: number of pairs
    std::vector<uint64_t> hashes;
    std::vector<int32_t> counts;
    StringSet strings;
};

struct TokResult {
    std::vector<int64_t> doc_indptr;
    std::vector<uint64_t> hashes;
    std::vector<int32_t> counts;
    std::string str_blob;
    std::vector<int64_t> str_offsets{0};
    std::vector<uint64_t> str_hashes;
    std::vector<int64_t> str_dfs;
};

struct DocEmitter {
    ScratchCounter counter;
    StringSet* strings;  // nullptr when strings not wanted
    const char* doc_base = nullptr;

    inline void emit(const char* s, size_t len) {
        uint64_t h = fnv1a_str(s, len);
        bool first_in_doc = counter.add(h);
        if (strings && first_in_doc) {
            size_t ix = strings->add(h, s, len);
            strings->dfs[ix]++;
        }
    }
};

static void split_words(const char* s, int64_t len, int64_t truncate,
                        std::vector<std::pair<int64_t, int64_t>>& words) {
    words.clear();
    int64_t i = 0;
    while (i < len) {
        if (is_word_byte_start(s, i)) {
            int64_t start = i;
            while (i < len && is_word_byte_start(s, i)) i += cp_len((unsigned char)s[i]);
            words.emplace_back(start, i - start);
            if (truncate > 0 && (int64_t)words.size() >= truncate) return;
        } else {
            i += cp_len((unsigned char)s[i]);
        }
    }
}

static void split_cps(const char* s, int64_t len, int64_t truncate, std::vector<int64_t>& cps) {
    cps.clear();
    int64_t i = 0;
    while (i < len) {
        cps.push_back(i);
        if (truncate > 0 && (int64_t)cps.size() > truncate) break;
        i += cp_len((unsigned char)s[i]);
    }
    if (truncate > 0 && (int64_t)cps.size() > truncate) {
        cps.resize(truncate);
        cps.push_back(std::min(i, len));
    } else {
        cps.push_back(len);
    }
}

static void char_ngrams_of(const char* s, const std::vector<int64_t>& cps, int lo, int hi,
                           DocEmitter& em) {
    int64_t n_cp = (int64_t)cps.size() - 1;
    for (int n = lo; n <= hi; ++n) {
        for (int64_t i = 0; i + n <= n_cp; ++i) {
            em.emit(s + cps[i], (size_t)(cps[i + n] - cps[i]));
        }
    }
}

static void process_doc(const char* s, int64_t len, int analyzer, int lo, int hi,
                        int64_t truncate, DocEmitter& em,
                        std::vector<std::pair<int64_t, int64_t>>& words,
                        std::vector<int64_t>& cps, std::string& join_buf) {
    em.counter.new_doc((size_t)(len + 16));
    if (analyzer == 0) {
        split_words(s, len, truncate, words);
        int64_t n_tok = (int64_t)words.size();
        for (int n = lo; n <= hi; ++n) {
            for (int64_t i = 0; i + n <= n_tok; ++i) {
                if (n == 1) {
                    em.emit(s + words[i].first, (size_t)words[i].second);
                } else {
                    join_buf.clear();
                    for (int j = 0; j < n; ++j) {
                        if (j) join_buf.push_back(' ');
                        join_buf.append(s + words[i + j].first, (size_t)words[i + j].second);
                    }
                    em.emit(join_buf.data(), join_buf.size());
                }
            }
        }
    } else if (analyzer == 1) {
        split_cps(s, len, truncate, cps);
        char_ngrams_of(s, cps, lo, hi, em);
    } else {
        split_words(s, len, truncate, words);
        for (auto& w : words) {
            join_buf.clear();
            join_buf.push_back(' ');
            join_buf.append(s + w.first, (size_t)w.second);
            join_buf.push_back(' ');
            cps.clear();
            int64_t i = 0, blen = (int64_t)join_buf.size();
            while (i < blen) {
                cps.push_back(i);
                i += cp_len((unsigned char)join_buf[i]);
            }
            cps.push_back(blen);
            char_ngrams_of(join_buf.data(), cps, lo, hi, em);
        }
    }
}

}  // namespace

extern "C" {

// analyzer: 0 = word, 1 = char, 2 = char_wb
void* tok_count(const char* blob, const int64_t* offsets, int64_t n_docs, int analyzer,
                int lo, int hi, int64_t truncate, int want_strings) {
    int n_threads = n_docs < 256 ? 1 : host_threads(-1);
    std::vector<ThreadOut> outs(n_threads);
    int64_t per = (n_docs + n_threads - 1) / n_threads;

    parallel_for(n_threads, n_threads, [&](int64_t t) {
        ThreadOut& out = outs[t];
        DocEmitter em;
        em.strings = want_strings ? &out.strings : nullptr;
        std::vector<std::pair<int64_t, int64_t>> words;
        std::vector<int64_t> cps;
        std::string join_buf;
        int64_t d0 = t * per, d1 = std::min(n_docs, (t + 1) * per);
        for (int64_t d = d0; d < d1; ++d) {
            process_doc(blob + offsets[d], offsets[d + 1] - offsets[d], analyzer, lo, hi,
                        truncate, em, words, cps, join_buf);
            for (uint32_t slot : em.counter.slots_used) {
                out.hashes.push_back(em.counter.keys[slot]);
                out.counts.push_back(em.counter.vals[slot]);
            }
            out.doc_counts_len.push_back((int64_t)em.counter.slots_used.size());
        }
    }, 1);

    // stitch per-thread buffers in document order
    TokResult* r = new TokResult();
    size_t total = 0;
    for (auto& o : outs) total += o.hashes.size();
    r->hashes.reserve(total);
    r->counts.reserve(total);
    r->doc_indptr.reserve(n_docs + 1);
    r->doc_indptr.push_back(0);
    for (auto& o : outs) {
        r->hashes.insert(r->hashes.end(), o.hashes.begin(), o.hashes.end());
        r->counts.insert(r->counts.end(), o.counts.begin(), o.counts.end());
        for (int64_t c : o.doc_counts_len) r->doc_indptr.push_back(r->doc_indptr.back() + c);
    }
    if (want_strings) {
        // global first-occurrence dedup across threads
        StringSet global;
        for (auto& o : outs) {
            StringSet& s = o.strings;
            for (size_t j = 0; j < s.hashes.size(); ++j) {
                size_t gix = global.add(s.hashes[j], s.blob.data() + s.offsets[j],
                                        (size_t)(s.offsets[j + 1] - s.offsets[j]));
                global.dfs[gix] += s.dfs[j];
            }
        }
        r->str_blob.swap(global.blob);
        r->str_offsets.swap(global.offsets);
        r->str_hashes.swap(global.hashes);
        r->str_dfs.swap(global.dfs);
    }
    return r;
}

int64_t tok_nnz(void* handle) { return (int64_t)((TokResult*)handle)->hashes.size(); }
int64_t tok_n_unique(void* handle) { return (int64_t)((TokResult*)handle)->str_hashes.size(); }
int64_t tok_str_blob_size(void* handle) { return (int64_t)((TokResult*)handle)->str_blob.size(); }

void tok_fill(void* handle, int64_t* doc_indptr, uint64_t* hashes, int32_t* counts) {
    TokResult* r = (TokResult*)handle;
    std::memcpy(doc_indptr, r->doc_indptr.data(), r->doc_indptr.size() * sizeof(int64_t));
    if (!r->hashes.empty()) {
        std::memcpy(hashes, r->hashes.data(), r->hashes.size() * sizeof(uint64_t));
        std::memcpy(counts, r->counts.data(), r->counts.size() * sizeof(int32_t));
    }
}

void tok_fill_strings(void* handle, char* blob, int64_t* str_offsets, uint64_t* str_hashes,
                      int64_t* str_dfs) {
    TokResult* r = (TokResult*)handle;
    if (!r->str_blob.empty()) std::memcpy(blob, r->str_blob.data(), r->str_blob.size());
    std::memcpy(str_offsets, r->str_offsets.data(), r->str_offsets.size() * sizeof(int64_t));
    if (!r->str_hashes.empty()) {
        std::memcpy(str_hashes, r->str_hashes.data(), r->str_hashes.size() * sizeof(uint64_t));
        std::memcpy(str_dfs, r->str_dfs.data(), r->str_dfs.size() * sizeof(int64_t));
    }
}

void tok_free(void* handle) { delete (TokResult*)handle; }

// hash a batch of strings with the tokenizer's FNV-1a (vocab reload path)
void tok_hash_strings(const char* blob, const int64_t* offsets, int64_t n, uint64_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = fnv1a_str(blob + offsets[i], (size_t)(offsets[i + 1] - offsets[i]));
    }
}

// byte-lexicographic argsort of packed strings (vocabulary column ordering).
// Replaces a numpy pipeline that materialized ~1 GB of temporaries — on the
// target VMs first-touch page faults make that the single hottest phase of
// TF-IDF train; here the only allocation is the caller-provided order array.
// order receives a permutation of [0, n): position j of the sorted sequence
// is the token at idx[order[j]]
void tok_sort_order(const char* blob, const int64_t* offsets, const int64_t* idx,
                    int64_t n, int64_t* order) {
    // 8-byte big-endian prefix keys resolve nearly all comparisons without
    // touching the string bytes again (memcmp order == big-endian uint64
    // order for zero-padded prefixes; zero pad sorts shorter strings first)
    std::vector<uint64_t> pref((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
        int64_t a = idx[i];
        size_t la = (size_t)(offsets[a + 1] - offsets[a]);
        const unsigned char* s = (const unsigned char*)blob + offsets[a];
        uint64_t p = 0;
        size_t m = la < 8 ? la : 8;
        for (size_t j = 0; j < m; ++j) p |= (uint64_t)s[j] << (56 - 8 * j);
        pref[(size_t)i] = p;
    }
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::sort(order, order + n, [&](int64_t oa, int64_t ob) {
        if (pref[(size_t)oa] != pref[(size_t)ob]) return pref[(size_t)oa] < pref[(size_t)ob];
        int64_t a = idx[oa], b = idx[ob];
        size_t la = (size_t)(offsets[a + 1] - offsets[a]);
        size_t lb = (size_t)(offsets[b + 1] - offsets[b]);
        if (la <= 8 || lb <= 8) return la < lb;  // equal prefixes cover one string fully
        int c = std::memcmp(blob + offsets[a] + 8, blob + offsets[b] + 8,
                            (la < lb ? la : lb) - 8);
        if (c) return c < 0;
        return la < lb;
    });
}

// open-addressing hash->value lookup table for predict-time vocab mapping
// (built once per loaded model).
struct TokLookup {
    std::vector<uint64_t> keys;
    std::vector<int64_t> vals;
    uint64_t mask;
};

void* tok_lookup_build(const uint64_t* hashes, int64_t n) {
    size_t cap = 1;
    while ((int64_t)cap < n * 2) cap <<= 1;
    TokLookup* t = new TokLookup();
    t->keys.assign(cap, 0);
    t->vals.assign(cap, -1);
    t->mask = cap - 1;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t h = hashes[i];
        uint64_t j = h & t->mask;
        while (t->keys[j] && t->keys[j] != h) j = (j + 1) & t->mask;
        t->keys[j] = h;
        t->vals[j] = i;
    }
    return t;
}

// cols_out[i] = value for queries[i], or -1 when absent
void tok_lookup(void* handle, const uint64_t* queries, int64_t nq, int64_t* cols_out) {
    TokLookup* t = (TokLookup*)handle;
    const uint64_t* keys = t->keys.data();
    const int64_t* vals = t->vals.data();
    uint64_t mask = t->mask;
    for (int64_t i = 0; i < nq; ++i) {
        uint64_t h = queries[i];
        uint64_t j = h & mask;
        while (keys[j] && keys[j] != h) j = (j + 1) & mask;
        cols_out[i] = keys[j] ? vals[j] : -1;
    }
}

void tok_lookup_free(void* handle) { delete (TokLookup*)handle; }

}  // extern "C"
