// Native host runtime for wukong-tpu: the performance-critical host-side
// paths that the reference also implements natively (C++11, header-only
// core/loader + core/store build machinery).
//
// Exposed via a C ABI consumed through ctypes (no pybind11 in this image):
//   - parse_id_triples: mmap'd "s\tp\to\n" text -> int64 triple columns
//     (replaces the reference's istream loop, base_loader.hpp:97-163, at
//     memory bandwidth instead of numpy's loadtxt)
//   - build_bucket_table: 8-way bucketized hash-table placement for device
//     segments (the host half of gstore.hpp:789-856 insert_key, vectorized
//     build in device_store.py — this is its native fast path)
//   - sort_triples_pso / sort_triples_pos: 3-key LSD radix sort of triple
//     arrays (the loader's sorted-run preparation, base_loader.hpp sorts)
//
// Build: cc -O3 -shared -fPIC wukong_native.cpp -o libwukong_native.so

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <sys/mman.h>
#include <sys/stat.h>
#include <fcntl.h>
#include <unistd.h>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// ID-triple text parsing
// ---------------------------------------------------------------------------

// Parse a whitespace-separated id-triple text file into three int64 columns.
// Returns the number of triples parsed, or -1 on open/map failure.
// Caller provides capacity (rows) in *cap; if the file holds more triples
// than cap, returns the required count WITHOUT writing beyond cap.
long parse_id_triples(const char *path, int64_t *s, int64_t *p, int64_t *o,
                      long cap) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return -1; }
    size_t len = (size_t)st.st_size;
    if (len == 0) { close(fd); return 0; }
    const char *buf =
        (const char *)mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (buf == MAP_FAILED) return -1;

    long n = 0;
    size_t i = 0;
    int64_t vals[3];
    bool malformed = false;
    while (i < len) {
        // parse exactly one line; newline never acts as an in-row separator
        // (a truncated 2-number line must NOT steal the next line's value —
        // that would silently shift every following triple by one column)
        int col = 0;
        bool junk = false;
        while (i < len && buf[i] != '\n') {
            if (buf[i] == ' ' || buf[i] == '\t' || buf[i] == '\r') {
                i++;
                continue;
            }
            if (buf[i] >= '0' && buf[i] <= '9') {
                int64_t v = 0;
                while (i < len && buf[i] >= '0' && buf[i] <= '9') {
                    v = v * 10 + (buf[i] - '0');
                    i++;
                }
                if (col < 3) vals[col] = v;
                col++;
            } else {
                junk = true;
                i++;
            }
        }
        if (i < len) i++;  // consume '\n'
        if (col == 3 && !junk) {
            if (n < cap) { s[n] = vals[0]; p[n] = vals[1]; o[n] = vals[2]; }
            n++;
        } else if (col != 0 || junk) {
            malformed = true;  // ragged/garbage line -> error like loadtxt
        }
    }
    munmap((void *)buf, len);
    if (malformed) return -2;
    return n;
}

// ---------------------------------------------------------------------------
// Bucketized hash-table build (8-way, Knuth multiplicative hashing) — must
// stay bit-identical to device_store.build_hash_table's placement policy
// ---------------------------------------------------------------------------

static const uint32_t HASH_MULT = 2654435761u;
static const int BUCKET = 8;

// keys: sorted unique int64 ids [K]; offsets int64 [K+1].
// out arrays (int32): bkey/bstart/bdeg of size num_buckets*8 (bkey pre-filled
// by caller is NOT required; this function initializes).
// Returns max probe rounds used, or -1 if it failed to converge.
int build_bucket_table(const int64_t *keys, const int64_t *offsets, long K,
                       long num_buckets, int32_t *bkey, int32_t *bstart,
                       int32_t *bdeg) {
    const uint32_t bmask = (uint32_t)(num_buckets - 1);
    for (long i = 0; i < num_buckets * BUCKET; i++) {
        bkey[i] = -1;
        bstart[i] = 0;
        bdeg[i] = 0;
    }
    if (K == 0) return 1;
    std::vector<uint8_t> used((size_t)num_buckets, 0);
    std::vector<long> pending((size_t)K);
    for (long i = 0; i < K; i++) pending[(size_t)i] = i;
    int round_ = 0;
    while (!pending.empty()) {
        std::vector<long> next;
        next.reserve(pending.size() / 4);
        for (long idx : pending) {
            uint32_t hb = ((uint32_t)(uint64_t)keys[idx] * HASH_MULT) & bmask;
            uint32_t b = (hb + (uint32_t)round_) & bmask;
            uint8_t &u = used[b];
            if (u < BUCKET) {
                long slot = (long)b * BUCKET + u;
                bkey[slot] = (int32_t)keys[idx];
                bstart[slot] = (int32_t)offsets[idx];
                bdeg[slot] = (int32_t)(offsets[idx + 1] - offsets[idx]);
                u++;
            } else {
                next.push_back(idx);
            }
        }
        pending.swap(next);
        round_++;
        if (round_ > num_buckets) return -1;
    }
    return round_ > 0 ? round_ : 1;
}

// ---------------------------------------------------------------------------
// Radix sort of triples by (p, s, o) or (p, o, s) — the loader's sorted runs
// ---------------------------------------------------------------------------

}  // extern "C" (templates need C++ linkage; the exported sort entry
   //              points reopen the C block below)

// One template at both widths. K = key dtype, I = permutation-index dtype:
// (int64, long) is the general path; (int32, int32) is the billion-triple
// diet — the int64 path costs ~60 GB of transients at LUBM-10240 (three
// int64 upcasts of the int32 columns + an int64 perm + two long[n] scratch
// vectors) while the int32 instantiation reads the columns in place and
// keeps perm/scratch at int32, ~4x less. Keys must be non-negative (the
// store's check_vid_range contract: ids < 2^31), so the unsigned digit
// extraction below agrees with signed order at both widths; the int32
// index form additionally needs n < 2^31.
template <typename K, typename I>
static void radix_pass(const K *key, const I *in, I *out, long n, int shift) {
    long counts[65536] = {0};
    for (long i = 0; i < n; i++)
        counts[((uint64_t)key[in[i]] >> shift) & 0xFFFF]++;
    long pos = 0;
    long starts[65536];
    for (int b = 0; b < 65536; b++) { starts[b] = pos; pos += counts[b]; }
    for (long i = 0; i < n; i++)
        out[starts[((uint64_t)key[in[i]] >> shift) & 0xFFFF]++] = in[i];
}

template <typename K>
static int bits_needed(const K *a, long n) {
    K mx = 0;
    for (long i = 0; i < n; i++)
        if (a[i] > mx) mx = a[i];
    int b = 0;
    while (mx > 0) { b++; mx >>= 1; }
    // round up to a whole 16-bit pass
    return ((b + 15) / 16) * 16;
}

// Stable sort permutation for triples by (primary, secondary, tertiary).
// LSD passes sized by each column's actual bit width (predicate ids fit one
// pass; vids typically two or three).
template <typename K, typename I>
static void sort_triples_impl(const K *tertiary, const K *secondary,
                              const K *primary, long n, I *perm_out) {
    std::vector<I> tmp((size_t)n);
    for (long i = 0; i < n; i++) perm_out[i] = (I)i;
    const K *keys[3] = {tertiary, secondary, primary};
    for (int k = 0; k < 3; k++) {
        int bits = bits_needed(keys[k], n);
        for (int shift = 0; shift < bits; shift += 16) {
            radix_pass(keys[k], perm_out, tmp.data(), n, shift);
            std::memcpy(perm_out, tmp.data(), (size_t)n * sizeof(I));
        }
    }
}

extern "C" {

void sort_triples(const int64_t *tertiary, const int64_t *secondary,
                  const int64_t *primary, long n, int64_t *perm_out) {
    sort_triples_impl(tertiary, secondary, primary, n, perm_out);
}

void sort_triples32(const int32_t *tertiary, const int32_t *secondary,
                    const int32_t *primary, long n, int32_t *perm_out) {
    sort_triples_impl(tertiary, secondary, primary, n, perm_out);
}

}  // extern "C"
