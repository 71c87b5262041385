// Memory-mapped key-value and tabular stores.
//
// The port's copy of pecos_tpu/core/mmap_store.cpp: the byte layout below
// (header, magic, kinds, hashes) is the one on-disk format of both packages,
// so a store written by either opens in the other.  Batch reads run on
// std::threads (parallel.h) in place of OpenMP.
//
// Native equivalents of the reference's mmap subsystem
// (pecos/core/utils/mmap_util.hpp, mmap_hashmap.hpp, mmap_valstore.hpp):
// single-file serialized stores that load either eagerly (MAP_POPULATE) or
// lazily, exposed through a C ABI consumed from Python via ctypes.
//
// Design notes (fresh implementation, not a translation):
// - hashmaps are open-addressing with linear probing, power-of-two capacity,
//   64-bit hashes (splitmix64 for ints, FNV-1a for strings).  The on-disk
//   image IS the runtime layout: loading is one mmap + header validation.
// - str2int stores keys as (offset, len) into an append-only blob so lookups
//   never allocate.
// - Float32Store / BytesStore are row-major tables with O(1) row addressing;
//   batch getters fan out with OpenMP.
//
// File layout: [Header][buckets...][payload blob]

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include "parallel.h"

namespace {

constexpr uint64_t MAGIC = 0x7065636f73747075ULL;  // "pecostpu"
constexpr uint64_t EMPTY_KEY = 0xffffffffffffffffULL;

static inline uint64_t splitmix64(uint64_t x) {
    x += 0x9e3779b97f4a7c15ULL;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
    return x ^ (x >> 31);
}

static inline uint64_t fnv1a(const char* data, uint64_t len) {
    uint64_t h = 0xcbf29ce484222325ULL;
    for (uint64_t i = 0; i < len; ++i) {
        h ^= (unsigned char)data[i];
        h *= 0x100000001b3ULL;
    }
    return h ? h : 1ULL;
}

struct Header {
    uint64_t magic;
    uint64_t kind;       // 1 = i2i map, 2 = s2i map, 3 = f32 store, 4 = bytes store,
                         // 5 = fixed-len str2int map
    uint64_t size;       // number of entries / rows
    uint64_t capacity;   // bucket count (maps) or cols (f32 store)
    uint64_t blob_bytes; // payload size after buckets (kind 5: capacity*key_len)
};

struct I2IBucket {
    uint64_t key;  // EMPTY_KEY when empty
    int64_t val;
};

struct S2IBucket {
    uint64_t hash;     // 0 when empty
    uint64_t key_off;
    uint64_t key_len;
    int64_t val;
};

struct MmapRegion {
    void* addr = nullptr;
    size_t bytes = 0;
    ~MmapRegion() {
        if (addr) munmap(addr, bytes);
    }
};

// ---------------------------------------------------------------------------
// Int -> Int map
// ---------------------------------------------------------------------------
struct I2IMap {
    std::vector<I2IBucket> own_buckets;  // build mode
    I2IBucket* buckets = nullptr;        // view (own or mmap)
    uint64_t capacity = 0;
    uint64_t size = 0;
    MmapRegion region;

    void init(uint64_t cap_hint) {
        capacity = 16;
        while (capacity < cap_hint * 2) capacity <<= 1;
        own_buckets.assign(capacity, I2IBucket{EMPTY_KEY, 0});
        buckets = own_buckets.data();
        size = 0;
    }

    void grow() {
        std::vector<I2IBucket> old;
        old.swap(own_buckets);
        uint64_t old_cap = capacity;
        capacity <<= 1;
        own_buckets.assign(capacity, I2IBucket{EMPTY_KEY, 0});
        buckets = own_buckets.data();
        size = 0;
        for (uint64_t i = 0; i < old_cap; ++i)
            if (old[i].key != EMPTY_KEY) insert(old[i].key, old[i].val);
    }

    void insert(uint64_t key, int64_t val) {
        if ((size + 1) * 10 >= capacity * 9) grow();
        uint64_t mask = capacity - 1;
        uint64_t i = splitmix64(key) & mask;
        while (true) {
            if (buckets[i].key == EMPTY_KEY) {
                buckets[i] = I2IBucket{key, val};
                ++size;
                return;
            }
            if (buckets[i].key == key) {
                buckets[i].val = val;
                return;
            }
            i = (i + 1) & mask;
        }
    }

    int64_t get(uint64_t key, int64_t dflt) const {
        uint64_t mask = capacity - 1;
        uint64_t i = splitmix64(key) & mask;
        while (true) {
            if (buckets[i].key == EMPTY_KEY) return dflt;
            if (buckets[i].key == key) return buckets[i].val;
            i = (i + 1) & mask;
        }
    }
};

// ---------------------------------------------------------------------------
// Str -> Int map
// ---------------------------------------------------------------------------
struct S2IMap {
    std::vector<S2IBucket> own_buckets;
    std::vector<char> own_blob;
    S2IBucket* buckets = nullptr;
    const char* blob = nullptr;
    uint64_t capacity = 0;
    uint64_t size = 0;
    uint64_t blob_bytes = 0;
    MmapRegion region;

    void init(uint64_t cap_hint) {
        capacity = 16;
        while (capacity < cap_hint * 2) capacity <<= 1;
        own_buckets.assign(capacity, S2IBucket{0, 0, 0, 0});
        buckets = own_buckets.data();
        own_blob.clear();
        blob = nullptr;
        size = 0;
        blob_bytes = 0;
    }

    bool eq(const S2IBucket& b, const char* key, uint64_t len) const {
        const char* base = own_blob.empty() ? blob : own_blob.data();
        return b.key_len == len && std::memcmp(base + b.key_off, key, len) == 0;
    }

    void grow() {
        std::vector<S2IBucket> old;
        old.swap(own_buckets);
        uint64_t old_cap = capacity;
        capacity <<= 1;
        own_buckets.assign(capacity, S2IBucket{0, 0, 0, 0});
        buckets = own_buckets.data();
        uint64_t mask = capacity - 1;
        for (uint64_t i = 0; i < old_cap; ++i) {
            if (!old[i].hash) continue;
            uint64_t j = old[i].hash & mask;
            while (buckets[j].hash) j = (j + 1) & mask;
            buckets[j] = old[i];
        }
    }

    void insert(const char* key, uint64_t len, int64_t val) {
        if ((size + 1) * 10 >= capacity * 9) grow();
        uint64_t h = fnv1a(key, len);
        uint64_t mask = capacity - 1;
        uint64_t i = h & mask;
        while (true) {
            if (!buckets[i].hash) {
                uint64_t off = own_blob.size();
                own_blob.insert(own_blob.end(), key, key + len);
                blob_bytes = own_blob.size();
                buckets[i] = S2IBucket{h, off, len, val};
                ++size;
                return;
            }
            if (buckets[i].hash == h && eq(buckets[i], key, len)) {
                buckets[i].val = val;
                return;
            }
            i = (i + 1) & mask;
        }
    }

    int64_t get(const char* key, uint64_t len, int64_t dflt) const {
        uint64_t h = fnv1a(key, len);
        uint64_t mask = capacity - 1;
        uint64_t i = h & mask;
        while (true) {
            if (!buckets[i].hash) return dflt;
            if (buckets[i].hash == h && eq(buckets[i], key, len)) return buckets[i].val;
            i = (i + 1) & mask;
        }
    }
};

// ---------------------------------------------------------------------------
// Fixed-length Str -> Int map
// ---------------------------------------------------------------------------
// All keys share one compile-time-unknown but per-map-constant byte length
// (e.g. 10-byte item ids).  Keys live inline in a dense (capacity x key_len)
// array parallel to the {hash, val} buckets: a lookup is one hash probe plus
// one fixed-size memcmp at a computed offset -- no (offset, len) indirection
// into a blob like the generic S2IMap.  Mirrors the role of the reference's
// fixed-size-string hashmap (pecos/core/utils/mmap_hashmap.hpp:234,443).
struct FS2IMap {
    std::vector<I2IBucket> own_buckets;  // key field holds the hash (0 = empty)
    std::vector<char> own_keys;          // capacity * key_len, zero padded
    I2IBucket* buckets = nullptr;
    const char* keys = nullptr;
    uint64_t capacity = 0;
    uint64_t size = 0;
    uint64_t key_len = 0;
    MmapRegion region;

    void init(uint64_t cap_hint, uint64_t klen) {
        key_len = klen;
        capacity = 16;
        while (capacity < cap_hint * 2) capacity <<= 1;
        own_buckets.assign(capacity, I2IBucket{0, 0});
        own_keys.assign(capacity * key_len, 0);
        buckets = own_buckets.data();
        keys = own_keys.data();
        size = 0;
    }

    void grow() {
        std::vector<I2IBucket> oldb;
        std::vector<char> oldk;
        oldb.swap(own_buckets);
        oldk.swap(own_keys);
        uint64_t old_cap = capacity;
        capacity <<= 1;
        own_buckets.assign(capacity, I2IBucket{0, 0});
        own_keys.assign(capacity * key_len, 0);
        buckets = own_buckets.data();
        keys = own_keys.data();
        uint64_t mask = capacity - 1;
        for (uint64_t i = 0; i < old_cap; ++i) {
            if (!oldb[i].key) continue;
            uint64_t j = oldb[i].key & mask;
            while (buckets[j].key) j = (j + 1) & mask;
            buckets[j] = oldb[i];
            std::memcpy(own_keys.data() + j * key_len, oldk.data() + i * key_len, key_len);
        }
    }

    void insert(const char* key, int64_t val) {
        if ((size + 1) * 10 >= capacity * 9) grow();
        uint64_t h = fnv1a(key, key_len);
        uint64_t mask = capacity - 1;
        uint64_t i = h & mask;
        while (true) {
            if (!buckets[i].key) {
                buckets[i] = I2IBucket{h, val};
                std::memcpy(own_keys.data() + i * key_len, key, key_len);
                ++size;
                return;
            }
            if (buckets[i].key == h && std::memcmp(keys + i * key_len, key, key_len) == 0) {
                buckets[i].val = val;
                return;
            }
            i = (i + 1) & mask;
        }
    }

    int64_t get(const char* key, int64_t dflt) const {
        uint64_t h = fnv1a(key, key_len);
        uint64_t mask = capacity - 1;
        uint64_t i = h & mask;
        while (true) {
            if (!buckets[i].key) return dflt;
            if (buckets[i].key == h && std::memcmp(keys + i * key_len, key, key_len) == 0)
                return buckets[i].val;
            i = (i + 1) & mask;
        }
    }
};

// ---------------------------------------------------------------------------
// common save / load
// ---------------------------------------------------------------------------
static bool write_file(const char* path, const Header& h, const void* buckets,
                       size_t bucket_bytes, const void* blob, size_t blob_bytes) {
    FILE* f = fopen(path, "wb");
    if (!f) return false;
    bool ok = fwrite(&h, sizeof(h), 1, f) == 1;
    if (ok && bucket_bytes) ok = fwrite(buckets, 1, bucket_bytes, f) == bucket_bytes;
    if (ok && blob_bytes) ok = fwrite(blob, 1, blob_bytes, f) == blob_bytes;
    fclose(f);
    return ok;
}

static void* map_file(const char* path, size_t* out_bytes, bool lazy) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        return nullptr;
    }
    int flags = MAP_SHARED;
#ifdef MAP_POPULATE
    if (!lazy) flags |= MAP_POPULATE;
#endif
    void* addr = mmap(nullptr, st.st_size, PROT_READ, flags, fd, 0);
    close(fd);
    if (addr == MAP_FAILED) return nullptr;
    *out_bytes = st.st_size;
    return addr;
}

}  // namespace

extern "C" {

// ---- int2int ---------------------------------------------------------------
void* mhm_i2i_new(uint64_t cap_hint) {
    auto* m = new I2IMap();
    m->init(cap_hint ? cap_hint : 16);
    return m;
}
void mhm_i2i_free(void* p) { delete static_cast<I2IMap*>(p); }
void mhm_i2i_insert(void* p, uint64_t key, int64_t val) {
    static_cast<I2IMap*>(p)->insert(key, val);
}
int64_t mhm_i2i_get(void* p, uint64_t key, int64_t dflt) {
    return static_cast<I2IMap*>(p)->get(key, dflt);
}
uint64_t mhm_i2i_size(void* p) { return static_cast<I2IMap*>(p)->size; }

void mhm_i2i_batch_get(void* p, uint64_t n, const uint64_t* keys, int64_t dflt,
                       int64_t* out, int threads) {
    auto* m = static_cast<I2IMap*>(p);
    parallel_for((int64_t)n, threads, [&](int64_t i) { out[i] = m->get(keys[i], dflt); });
}

int mhm_i2i_save(void* p, const char* path) {
    auto* m = static_cast<I2IMap*>(p);
    Header h{MAGIC, 1, m->size, m->capacity, 0};
    return write_file(path, h, m->buckets, m->capacity * sizeof(I2IBucket), nullptr, 0) ? 0 : 1;
}

void* mhm_i2i_load(const char* path, int lazy) {
    size_t bytes = 0;
    void* addr = map_file(path, &bytes, lazy != 0);
    if (!addr) return nullptr;
    auto* h = static_cast<Header*>(addr);
    if (h->magic != MAGIC || h->kind != 1) {
        munmap(addr, bytes);
        return nullptr;
    }
    auto* m = new I2IMap();
    m->region.addr = addr;
    m->region.bytes = bytes;
    m->buckets = reinterpret_cast<I2IBucket*>(static_cast<char*>(addr) + sizeof(Header));
    m->capacity = h->capacity;
    m->size = h->size;
    return m;
}

// ---- str2int ---------------------------------------------------------------
void* mhm_s2i_new(uint64_t cap_hint) {
    auto* m = new S2IMap();
    m->init(cap_hint ? cap_hint : 16);
    return m;
}
void mhm_s2i_free(void* p) { delete static_cast<S2IMap*>(p); }
void mhm_s2i_insert(void* p, const char* key, uint64_t len, int64_t val) {
    static_cast<S2IMap*>(p)->insert(key, len, val);
}
int64_t mhm_s2i_get(void* p, const char* key, uint64_t len, int64_t dflt) {
    return static_cast<S2IMap*>(p)->get(key, len, dflt);
}
uint64_t mhm_s2i_size(void* p) { return static_cast<S2IMap*>(p)->size; }

void mhm_s2i_batch_get(void* p, uint64_t n, const char* const* keys, const uint64_t* lens,
                       int64_t dflt, int64_t* out, int threads) {
    auto* m = static_cast<S2IMap*>(p);
    parallel_for((int64_t)n, threads, [&](int64_t i) { out[i] = m->get(keys[i], lens[i], dflt); });
}

int mhm_s2i_save(void* p, const char* path) {
    auto* m = static_cast<S2IMap*>(p);
    const char* blob = m->own_blob.empty() ? m->blob : m->own_blob.data();
    Header h{MAGIC, 2, m->size, m->capacity, m->blob_bytes};
    return write_file(path, h, m->buckets, m->capacity * sizeof(S2IBucket), blob, m->blob_bytes)
               ? 0
               : 1;
}

void* mhm_s2i_load(const char* path, int lazy) {
    size_t bytes = 0;
    void* addr = map_file(path, &bytes, lazy != 0);
    if (!addr) return nullptr;
    auto* h = static_cast<Header*>(addr);
    if (h->magic != MAGIC || h->kind != 2) {
        munmap(addr, bytes);
        return nullptr;
    }
    auto* m = new S2IMap();
    m->region.addr = addr;
    m->region.bytes = bytes;
    char* base = static_cast<char*>(addr) + sizeof(Header);
    m->buckets = reinterpret_cast<S2IBucket*>(base);
    m->capacity = h->capacity;
    m->size = h->size;
    m->blob = base + h->capacity * sizeof(S2IBucket);
    m->blob_bytes = h->blob_bytes;
    return m;
}

// ---- fixed-len str2int -------------------------------------------------------
void* mhm_fs2i_new(uint64_t cap_hint, uint64_t key_len) {
    if (!key_len) return nullptr;
    auto* m = new FS2IMap();
    m->init(cap_hint ? cap_hint : 16, key_len);
    return m;
}
void mhm_fs2i_free(void* p) { delete static_cast<FS2IMap*>(p); }
void mhm_fs2i_insert(void* p, const char* key, int64_t val) {
    static_cast<FS2IMap*>(p)->insert(key, val);
}
int64_t mhm_fs2i_get(void* p, const char* key, int64_t dflt) {
    return static_cast<FS2IMap*>(p)->get(key, dflt);
}
uint64_t mhm_fs2i_size(void* p) { return static_cast<FS2IMap*>(p)->size; }
uint64_t mhm_fs2i_key_len(void* p) { return static_cast<FS2IMap*>(p)->key_len; }

// keys laid out back to back, n * key_len bytes
void mhm_fs2i_batch_get(void* p, uint64_t n, const char* keys, int64_t dflt, int64_t* out,
                        int threads) {
    auto* m = static_cast<FS2IMap*>(p);
    parallel_for((int64_t)n, threads, [&](int64_t i) { out[i] = m->get(keys + i * m->key_len, dflt); });
}

int mhm_fs2i_save(void* p, const char* path) {
    auto* m = static_cast<FS2IMap*>(p);
    const char* keys = m->own_keys.empty() ? m->keys : m->own_keys.data();
    Header h{MAGIC, 5, m->size, m->capacity, m->capacity * m->key_len};
    return write_file(path, h, m->buckets, m->capacity * sizeof(I2IBucket), keys, h.blob_bytes)
               ? 0
               : 1;
}

void* mhm_fs2i_load(const char* path, int lazy) {
    size_t bytes = 0;
    void* addr = map_file(path, &bytes, lazy != 0);
    if (!addr) return nullptr;
    auto* h = static_cast<Header*>(addr);
    if (h->magic != MAGIC || h->kind != 5 || !h->capacity || h->blob_bytes % h->capacity) {
        munmap(addr, bytes);
        return nullptr;
    }
    auto* m = new FS2IMap();
    m->region.addr = addr;
    m->region.bytes = bytes;
    char* base = static_cast<char*>(addr) + sizeof(Header);
    m->buckets = reinterpret_cast<I2IBucket*>(base);
    m->capacity = h->capacity;
    m->size = h->size;
    m->key_len = h->blob_bytes / h->capacity;
    m->keys = base + h->capacity * sizeof(I2IBucket);
    return m;
}

// ---- Float32Store ----------------------------------------------------------
struct F32Store {
    std::vector<float> own;
    const float* data = nullptr;
    uint64_t rows = 0, cols = 0;
    MmapRegion region;
};

void* mvs_f32_new(uint64_t rows, uint64_t cols, const float* data) {
    auto* s = new F32Store();
    s->rows = rows;
    s->cols = cols;
    s->own.assign(data, data + rows * cols);
    s->data = s->own.data();
    return s;
}
void mvs_f32_free(void* p) { delete static_cast<F32Store*>(p); }
uint64_t mvs_f32_rows(void* p) { return static_cast<F32Store*>(p)->rows; }
uint64_t mvs_f32_cols(void* p) { return static_cast<F32Store*>(p)->cols; }

void mvs_f32_batch_get(void* p, uint64_t n, const uint64_t* row_ids, const uint64_t* col_ids,
                       float* out, int threads) {
    auto* s = static_cast<F32Store*>(p);
    parallel_for((int64_t)n, threads, [&](int64_t i) { out[i] = s->data[row_ids[i] * s->cols + col_ids[i]]; });
}

void mvs_f32_get_rows(void* p, uint64_t n, const uint64_t* row_ids, float* out, int threads) {
    auto* s = static_cast<F32Store*>(p);
    parallel_for((int64_t)n, threads, [&](int64_t i) {
        std::memcpy(out + i * s->cols, s->data + row_ids[i] * s->cols, s->cols * sizeof(float));
    });
}

int mvs_f32_save(void* p, const char* path) {
    auto* s = static_cast<F32Store*>(p);
    Header h{MAGIC, 3, s->rows, s->cols, s->rows * s->cols * sizeof(float)};
    return write_file(path, h, nullptr, 0, s->data, h.blob_bytes) ? 0 : 1;
}

void* mvs_f32_load(const char* path, int lazy) {
    size_t bytes = 0;
    void* addr = map_file(path, &bytes, lazy != 0);
    if (!addr) return nullptr;
    auto* h = static_cast<Header*>(addr);
    if (h->magic != MAGIC || h->kind != 3) {
        munmap(addr, bytes);
        return nullptr;
    }
    auto* s = new F32Store();
    s->region.addr = addr;
    s->region.bytes = bytes;
    s->rows = h->size;
    s->cols = h->capacity;
    s->data = reinterpret_cast<const float*>(static_cast<char*>(addr) + sizeof(Header));
    return s;
}

// ---- BytesStore (variable-length strings) -----------------------------------
struct BytesStore {
    std::vector<uint64_t> own_offsets;  // size rows+1
    std::vector<char> own_blob;
    const uint64_t* offsets = nullptr;
    const char* blob = nullptr;
    uint64_t rows = 0;
    MmapRegion region;
};

void* mvs_bytes_new(uint64_t rows, const char* const* strs, const uint64_t* lens) {
    auto* s = new BytesStore();
    s->rows = rows;
    s->own_offsets.resize(rows + 1);
    s->own_offsets[0] = 0;
    for (uint64_t i = 0; i < rows; ++i) {
        s->own_blob.insert(s->own_blob.end(), strs[i], strs[i] + lens[i]);
        s->own_offsets[i + 1] = s->own_blob.size();
    }
    s->offsets = s->own_offsets.data();
    s->blob = s->own_blob.data();
    return s;
}
void mvs_bytes_free(void* p) { delete static_cast<BytesStore*>(p); }
uint64_t mvs_bytes_rows(void* p) { return static_cast<BytesStore*>(p)->rows; }

void mvs_bytes_batch_get(void* p, uint64_t n, const uint64_t* row_ids, char* out,
                         uint64_t trunc_len, uint64_t* out_lens, int threads) {
    auto* s = static_cast<BytesStore*>(p);
    parallel_for((int64_t)n, threads, [&](int64_t i) {
        uint64_t r = row_ids[i];
        uint64_t len = s->offsets[r + 1] - s->offsets[r];
        if (len > trunc_len) len = trunc_len;
        std::memcpy(out + i * trunc_len, s->blob + s->offsets[r], len);
        out_lens[i] = len;
    });
}

int mvs_bytes_save(void* p, const char* path) {
    auto* s = static_cast<BytesStore*>(p);
    uint64_t blob_bytes = s->offsets[s->rows];
    Header h{MAGIC, 4, s->rows, 0, blob_bytes};
    FILE* f = fopen(path, "wb");
    if (!f) return 1;
    bool ok = fwrite(&h, sizeof(h), 1, f) == 1;
    if (ok) ok = fwrite(s->offsets, sizeof(uint64_t), s->rows + 1, f) == s->rows + 1;
    if (ok && blob_bytes) ok = fwrite(s->blob, 1, blob_bytes, f) == blob_bytes;
    fclose(f);
    return ok ? 0 : 1;
}

void* mvs_bytes_load(const char* path, int lazy) {
    size_t bytes = 0;
    void* addr = map_file(path, &bytes, lazy != 0);
    if (!addr) return nullptr;
    auto* h = static_cast<Header*>(addr);
    if (h->magic != MAGIC || h->kind != 4) {
        munmap(addr, bytes);
        return nullptr;
    }
    auto* s = new BytesStore();
    s->region.addr = addr;
    s->region.bytes = bytes;
    s->rows = h->size;
    char* base = static_cast<char*>(addr) + sizeof(Header);
    s->offsets = reinterpret_cast<const uint64_t*>(base);
    s->blob = base + (s->rows + 1) * sizeof(uint64_t);
    return s;
}

}  // extern "C"
