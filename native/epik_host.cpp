// EPIK native host library.
//
// C++ implementations of the host-side runtime around the device compute path:
//   1. a buffered FASTA batch reader       (re-provides i2l::io::batch_fasta,
//      reference: epik/src/epik/main.cpp:332-358)
//   2. a k-mer window tokenizer with the one-ambiguity policy
//      (re-provides i2l::to_kmers<one_ambiguity_policy>,
//      reference: epik/src/epik/place.cpp:294-314)
//   3. a faithful scalar placer -- the reference algorithm
//      (reference: epik/src/epik/place.cpp:320-440) in single-thread C++,
//      used as the self-measured performance baseline (the reference binary
//      itself cannot be built here: its i2l submodule is empty) and as a
//      third implementation for differential testing.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (epik_tpu/native.py); all buffers are caller-owned numpy arrays except
// where a result struct is returned and released with eh_free.
//
// Build: built on first use by epik_tpu/native.py into build/
//   (g++ -O3 -std=c++17 -shared -fPIC -fopenmp native/epik_host.cpp)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#define EH_API extern "C" __attribute__((visibility("default")))

// ---------------------------------------------------------------------------
// 1. FASTA batch reader
// ---------------------------------------------------------------------------

namespace {

struct FastaReader {
    FILE* f = nullptr;
    long batch_size = 0;
    long bytes_read = 0;
    std::string pending_header;
    bool have_pending = false;
    bool eof = false;

    // per-batch arenas (stable until the next next_batch call)
    std::string seq_buf;
    std::string hdr_buf;
    std::vector<int64_t> seq_off;  // n+1
    std::vector<int64_t> hdr_off;  // n+1
};

}  // namespace

EH_API void* eh_fasta_open(const char* path, long batch_size) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    auto* r = new FastaReader();
    r->f = f;
    r->batch_size = batch_size;
    return r;
}

EH_API void eh_fasta_close(void* handle) {
    auto* r = static_cast<FastaReader*>(handle);
    if (r) {
        if (r->f) std::fclose(r->f);
        delete r;
    }
}

EH_API long eh_fasta_bytes_read(void* handle) {
    return static_cast<FastaReader*>(handle)->bytes_read;
}

// Reads up to batch_size records. Returns the record count (0 at EOF) and
// exposes arena pointers valid until the next call.
EH_API long eh_fasta_next(void* handle, const char** seq_buf,
                          const int64_t** seq_off, const char** hdr_buf,
                          const int64_t** hdr_off) {
    auto* r = static_cast<FastaReader*>(handle);
    r->seq_buf.clear();
    r->hdr_buf.clear();
    r->seq_off.assign(1, 0);
    r->hdr_off.assign(1, 0);
    long n = 0;
    if (!r->eof) {
        std::string header = r->have_pending ? r->pending_header : std::string();
        bool have_header = r->have_pending;
        r->have_pending = false;

        auto emit = [&]() {
            r->hdr_buf += header;
            r->hdr_off.push_back((int64_t)r->hdr_buf.size());
            r->seq_off.push_back((int64_t)r->seq_buf.size());
            ++n;
        };

        char* line = nullptr;
        size_t cap = 0;
        ssize_t len;
        while ((len = getline(&line, &cap, r->f)) != -1) {
            r->bytes_read += len;
            // rstrip
            while (len > 0 && (line[len - 1] == '\n' || line[len - 1] == '\r' ||
                               line[len - 1] == ' ' || line[len - 1] == '\t'))
                --len;
            if (len == 0) continue;
            if (line[0] == '>') {
                if (have_header) {
                    emit();
                    if (n >= r->batch_size) {
                        r->pending_header.assign(line + 1, len - 1);
                        r->have_pending = true;
                        break;
                    }
                }
                header.assign(line + 1, len - 1);
                have_header = true;
            } else if (have_header) {
                r->seq_buf.append(line, len);
            }
        }
        if (len == -1) {
            if (have_header) emit();
            r->eof = true;
        }
        std::free(line);
    }
    *seq_buf = r->seq_buf.data();
    *seq_off = r->seq_off.data();
    *hdr_buf = r->hdr_buf.data();
    *hdr_off = r->hdr_off.data();
    return n;
}

// ---------------------------------------------------------------------------
// 2. Batch tokenizer (one-ambiguity policy)
// ---------------------------------------------------------------------------

namespace {

constexpr uint8_t kInvalid = 0xFF;
constexpr uint8_t kAmbigBase = 0x80;

struct TokenResult {
    std::vector<uint64_t> exact_keys;
    std::vector<int32_t> exact_read;
    std::vector<uint64_t> amb_keys;
    std::vector<int32_t> amb_read;
    std::vector<int32_t> amb_order;
};

}  // namespace

// Tokenize a batch given concatenated sequence bytes + offsets.
//   char_code: uint8[256] alphabet table (see epik_tpu/core/alphabet.py)
//   exp_table: uint8[n_sym * max_fan], exp_len: uint8[n_sym]
// Returns an opaque result released with eh_tokens_free; array pointers and
// lengths are fetched with eh_tokens_get.
EH_API void* eh_tokenize(const uint8_t* buf, const int64_t* offsets,
                         long n_reads, int k, int sigma,
                         const uint8_t* char_code, const uint8_t* exp_table,
                         const uint8_t* exp_len, int max_fan) {
    auto* res = new TokenResult();
    std::vector<uint64_t> mult((size_t)k);
    mult[k - 1] = 1;
    for (int j = k - 2; j >= 0; --j) mult[j] = mult[j + 1] * (uint64_t)sigma;

    for (long r = 0; r < n_reads; ++r) {
        const uint8_t* s = buf + offsets[r];
        const int64_t L = offsets[r + 1] - offsets[r];
        if (L < k) continue;
        int32_t order = 0;
        // rolling window state: counts of ambiguous/invalid chars in window
        int amb_in_win = 0, inv_in_win = 0;
        std::vector<uint8_t> codes((size_t)L);
        for (int64_t i = 0; i < L; ++i) codes[i] = char_code[s[i]];
        for (int64_t w = 0; w <= L - k; ++w) {
            if (w == 0) {
                for (int j = 0; j < k; ++j) {
                    uint8_t c = codes[j];
                    if (c == kInvalid) ++inv_in_win;
                    else if (c >= kAmbigBase) ++amb_in_win;
                }
            } else {
                uint8_t out = codes[w - 1], in = codes[w + k - 1];
                if (out == kInvalid) --inv_in_win;
                else if (out >= kAmbigBase) --amb_in_win;
                if (in == kInvalid) ++inv_in_win;
                else if (in >= kAmbigBase) ++amb_in_win;
            }
            if (inv_in_win > 0 || amb_in_win > 1) continue;
            if (amb_in_win == 0) {
                uint64_t key = 0;
                for (int j = 0; j < k; ++j) key = key * sigma + codes[w + j];
                res->exact_keys.push_back(key);
                res->exact_read.push_back((int32_t)r);
            } else {
                // exactly one ambiguous position: expand
                uint64_t base = 0;
                int amb_pos = -1;
                uint8_t sym = 0;
                for (int j = 0; j < k; ++j) {
                    uint8_t c = codes[w + j];
                    if (c >= kAmbigBase) {
                        amb_pos = j;
                        sym = (uint8_t)(c - kAmbigBase);
                        base = base * sigma;  // digit 0, patched below
                    } else {
                        base = base * sigma + c;
                    }
                }
                const int fan = exp_len[sym];
                for (int e = 0; e < fan; ++e) {
                    uint64_t code = exp_table[sym * max_fan + e];
                    res->amb_keys.push_back(base + code * mult[amb_pos]);
                    res->amb_read.push_back((int32_t)r);
                    res->amb_order.push_back(order++);
                }
            }
        }
    }
    return res;
}

EH_API void eh_tokens_sizes(void* h, int64_t* n_exact, int64_t* n_amb) {
    auto* res = static_cast<TokenResult*>(h);
    *n_exact = (int64_t)res->exact_keys.size();
    *n_amb = (int64_t)res->amb_keys.size();
}

EH_API void eh_tokens_fill(void* h, uint64_t* exact_keys, int32_t* exact_read,
                           uint64_t* amb_keys, int32_t* amb_read,
                           int32_t* amb_order) {
    auto* res = static_cast<TokenResult*>(h);
    auto cpy = [](auto& v, auto* dst) {
        if (!v.empty()) std::memcpy(dst, v.data(), v.size() * sizeof(v[0]));
    };
    cpy(res->exact_keys, exact_keys);
    cpy(res->exact_read, exact_read);
    cpy(res->amb_keys, amb_keys);
    cpy(res->amb_read, amb_read);
    cpy(res->amb_order, amb_order);
}

EH_API void eh_tokens_free(void* h) { delete static_cast<TokenResult*>(h); }

// Packed read-buffer staging for the device-tokenize fast path: one pass
// over the raw sequence bytes fills the (R_pad, Lmax/4 + Lmax/8 + 2) uint8
// buffer consumed by engine/placer.py::device_tokenize_packed -- 2-bit
// codes, bad-bits (little-endian, 1 bit/char), uint16 length -- and flags
// reads containing ambiguity codes (0x80 <= code < 0xFF).  Equivalent to
// the numpy pack_reads + char_code gather + amb scan (measured 29.5 ms per
// 8192x150bp batch on the 2-core host; this pass runs in ~2 ms and
// releases the GIL under ctypes).  Padding chars (beyond each read's
// length, and whole padding rows) take char_code[0] like the numpy path's
// zero-filled matrix -- an invalid code, so their windows stay masked.
EH_API void eh_pack_reads(const uint8_t* flat, const int64_t* offsets,
                          long n_reads, const uint8_t* char_code,
                          long Lmax, long R_pad, uint8_t* out,
                          uint8_t* amb_flags) {
    const long L4 = Lmax / 4, L8 = Lmax / 8;
    const long stride = L4 + L8 + 2;
    std::memset(out, 0, (size_t)R_pad * stride);
    const uint8_t pad_code = char_code[0];
    const uint8_t pad_bad = (uint8_t)(pad_code >= 4);
    for (long r = 0; r < n_reads; ++r) {
        const uint8_t* seq = flat + offsets[r];
        const long len = (long)(offsets[r + 1] - offsets[r]);
        uint8_t* row = out + (size_t)r * stride;
        uint8_t* bb = row + L4;
        uint8_t amb = 0;
        for (long j = 0; j < len; ++j) {
            const uint8_t code = char_code[seq[j]];
            if (code < 4) {
                row[j >> 2] |= (uint8_t)(code << ((j & 3) * 2));
            } else {
                bb[j >> 3] |= (uint8_t)(1u << (j & 7));
                amb |= (uint8_t)(code >= kAmbigBase && code != kInvalid);
            }
        }
        if (pad_bad)
            for (long j = len; j < Lmax; ++j)
                bb[j >> 3] |= (uint8_t)(1u << (j & 7));
        row[L4 + L8] = (uint8_t)(len & 0xFF);
        row[L4 + L8 + 1] = (uint8_t)((len >> 8) & 0xFF);
        amb_flags[r] = amb;
    }
    if (pad_bad)
        for (long r = n_reads; r < R_pad; ++r)
            std::memset(out + (size_t)r * stride + L4, 0xFF, (size_t)L8);
}

// ---------------------------------------------------------------------------
// 3. Faithful scalar placer (baseline + third differential implementation)
// ---------------------------------------------------------------------------

namespace {

// Open-addressing hash map key -> row, mirroring the container role of the
// reference's phylo_kmer_db hash map (SURVEY.md section 2.9).
struct ScalarDB {
    std::vector<uint64_t> slots_key;  // power-of-two table, EMPTY = ~0ull
    std::vector<int64_t> slots_row;
    uint64_t mask = 0;
    const int64_t* row_off = nullptr;
    const uint32_t* branches = nullptr;
    const float* scores = nullptr;
    int64_t n_branches = 0;
    int k = 0;
    float threshold = 0, log_threshold = 0;
};

static inline uint64_t mix64(uint64_t x) {
    x ^= x >> 33;
    x *= 0xFF51AFD7ED558CCDull;
    x ^= x >> 33;
    x *= 0xC4CEB9FE1A85EC53ull;
    x ^= x >> 33;
    return x;
}

}  // namespace

EH_API void* eh_scalar_db_new(const uint64_t* keys, int64_t n_keys,
                              const int64_t* row_off, const uint32_t* branches,
                              const float* scores, int64_t n_branches, int k,
                              float threshold) {
    auto* db = new ScalarDB();
    uint64_t cap = 16;
    while (cap < (uint64_t)n_keys * 2) cap <<= 1;
    db->slots_key.assign(cap, ~0ull);
    db->slots_row.assign(cap, -1);
    db->mask = cap - 1;
    for (int64_t i = 0; i < n_keys; ++i) {
        uint64_t h = mix64(keys[i]) & db->mask;
        while (db->slots_key[h] != ~0ull) h = (h + 1) & db->mask;
        db->slots_key[h] = keys[i];
        db->slots_row[h] = i;
    }
    db->row_off = row_off;
    db->branches = branches;
    db->scores = scores;
    db->n_branches = n_branches;
    db->k = k;
    db->threshold = threshold;
    db->log_threshold = std::log10(threshold);
    return db;
}

EH_API void eh_scalar_db_free(void* h) { delete static_cast<ScalarDB*>(h); }

static inline int64_t db_find(const ScalarDB* db, uint64_t key) {
    uint64_t h = mix64(key) & db->mask;
    while (true) {
        if (db->slots_key[h] == key) return db->slots_row[h];
        if (db->slots_key[h] == ~0ull) return -1;
        h = (h + 1) & db->mask;
    }
}

namespace {

// Scores reads [r0, r1) given the stream offsets where read r0's exact /
// ambiguous segments begin.  Shared worker for the single-thread entry
// point and the OpenMP one (reference: the loop body of place.cpp:218-229;
// each thread carries its own scratch, the DB is read-only).
void place_scalar_range(const ScalarDB* db, long r0, long r1,
                        const uint64_t* m_per_read, const uint64_t* exact_keys,
                        const int32_t* exact_read, int64_t n_exact,
                        const uint64_t* amb_keys, const int32_t* amb_read,
                        int64_t n_amb, int64_t ei, int64_t ai, int K,
                        int32_t* out_edges, float* out_scores,
                        int64_t* out_counts, int32_t* out_n,
                        double* out_sum) {
    const int64_t B = db->n_branches;
    std::vector<float> S((size_t)B, 0.f), S_amb((size_t)B, 0.f);
    std::vector<int64_t> C((size_t)B, 0), C_amb((size_t)B, 0);
    std::vector<int32_t> edges;

    for (long r = r0; r < r1; ++r) {
        // reset touched entries only (reference: place.cpp:335-342, quirk Q11)
        for (int32_t e : edges) {
            S[e] = 0.f;
            S_amb[e] = 0.f;
            C[e] = 0;
            C_amb[e] = 0;
        }
        edges.clear();

        // exact accumulation (place.cpp:349-371)
        for (; ei < n_exact && exact_read[ei] == r; ++ei) {
            int64_t row = db_find(db, exact_keys[ei]);
            if (row < 0) continue;
            for (int64_t p = db->row_off[row]; p < db->row_off[row + 1]; ++p) {
                uint32_t b = db->branches[p];
                if (C[b] == 0) edges.push_back((int32_t)b);
                ++C[b];
                S[b] += db->scores[p];
            }
        }
        // ambiguous accumulation (place.cpp:373-415, quirks Q6/Q7)
        std::vector<int32_t> l_amb;
        for (; ai < n_amb && amb_read[ai] == r; ++ai) {
            int64_t row = db_find(db, amb_keys[ai]);
            if (row < 0) continue;
            l_amb.clear();
            for (int64_t p = db->row_off[row]; p < db->row_off[row + 1]; ++p) {
                uint32_t b = db->branches[p];
                if (C_amb[b] == 0) l_amb.push_back((int32_t)b);
                ++C_amb[b];
                S_amb[b] += (float)std::pow(10.0, (double)db->scores[p]);
            }
            const float w_size = (float)db->k;
            for (int32_t b : l_amb) {
                float avg = (S_amb[b] + (float)(db->k - C_amb[b]) * db->threshold) / w_size;
                if (C[b] == 0) edges.push_back(b);
                ++C[b];
                S[b] += avg;
            }
        }
        // correction (place.cpp:417-422) with size_t wraparound semantics
        const uint64_t m = m_per_read[r];
        for (int32_t e : edges) {
            uint64_t diff = m - (uint64_t)C[e];
            S[e] += (float)diff * db->log_threshold;
            S[e] /= (float)db->k;
        }
        // LWR numerator sum over ALL touched branches in touch order
        // (reference: place.cpp:164-184 sum_placed; double pow like the
        // oracle) -- the host adds the not-placed term and normalizes
        double sum_placed = 0.0;
        for (int32_t e : edges) sum_placed += std::pow(10.0, (double)S[e]);
        out_sum[r] = sum_placed;
        // top-K by score (partial_sort desc, place.cpp:153-156)
        std::vector<int32_t> order(edges);
        const size_t keep = std::min((size_t)K, order.size());
        std::partial_sort(order.begin(), order.begin() + keep, order.end(),
                          [&](int32_t a, int32_t b) { return S[a] > S[b]; });
        out_n[r] = (int32_t)edges.size();
        for (size_t j = 0; j < (size_t)K; ++j) {
            if (j < keep) {
                out_edges[r * K + j] = order[j];
                out_scores[r * K + j] = S[order[j]];
                out_counts[r * K + j] = C[order[j]];
            } else {
                out_edges[r * K + j] = -1;
                out_scores[r * K + j] = 0.f;
                out_counts[r * K + j] = 0;
            }
        }
    }
}

}  // namespace

// Place a batch, writing top-K (edge, score, count) per read.
// Inputs are the tokenizer outputs for the batch plus per-read m (size_t
// semantics as uint64). Outputs: out_edges/out_scores/out_counts[(read,K)],
// out_n[read] = number of touched branches (0 => caller fabricates the
// fallback, quirk Q2).
EH_API void eh_place_scalar(void* dbh, long n_reads, const uint64_t* m_per_read,
                            const uint64_t* exact_keys, const int32_t* exact_read,
                            int64_t n_exact, const uint64_t* amb_keys,
                            const int32_t* amb_read, const int32_t* amb_order,
                            int64_t n_amb, int K, int32_t* out_edges,
                            float* out_scores, int64_t* out_counts,
                            int32_t* out_n, double* out_sum) {
    (void)amb_order;  // stream is already in processing order per read
    place_scalar_range(static_cast<ScalarDB*>(dbh), 0, n_reads, m_per_read,
                       exact_keys, exact_read, n_exact, amb_keys, amb_read,
                       n_amb, 0, 0, K, out_edges, out_scores, out_counts,
                       out_n, out_sum);
}

// OpenMP variant: reads are split into contiguous chunks, one per thread,
// each with its own scratch vectors -- mirroring the reference's
// `-j/--threads` placement loop (reference: epik/src/epik/place.cpp:218-229,
// `#pragma omp parallel for schedule(dynamic)` over read chunks with
// thread-local score maps).  Chunk boundaries in the exact/ambiguous token
// streams come from one linear prepass (streams are sorted by read id).
EH_API void eh_place_scalar_mt(void* dbh, long n_reads,
                               const uint64_t* m_per_read,
                               const uint64_t* exact_keys,
                               const int32_t* exact_read, int64_t n_exact,
                               const uint64_t* amb_keys,
                               const int32_t* amb_read,
                               const int32_t* amb_order, int64_t n_amb,
                               int K, int n_threads, int32_t* out_edges,
                               float* out_scores, int64_t* out_counts,
                               int32_t* out_n, double* out_sum) {
    if (n_threads <= 1 || n_reads < 2) {
        eh_place_scalar(dbh, n_reads, m_per_read, exact_keys, exact_read,
                        n_exact, amb_keys, amb_read, amb_order, n_amb, K,
                        out_edges, out_scores, out_counts, out_n, out_sum);
        return;
    }
    auto* db = static_cast<ScalarDB*>(dbh);
    const long n_chunks = std::min<long>(n_threads, n_reads);
    // chunk c owns reads [r_lo[c], r_lo[c+1]); stream offsets found by the
    // monotone read-id streams (binary search per boundary)
    std::vector<long> r_lo((size_t)n_chunks + 1);
    std::vector<int64_t> e_lo((size_t)n_chunks + 1), a_lo((size_t)n_chunks + 1);
    for (long c = 0; c <= n_chunks; ++c) {
        const long r = (long)((int64_t)n_reads * c / n_chunks);
        r_lo[c] = r;
        e_lo[c] = std::lower_bound(exact_read, exact_read + n_exact, (int32_t)r)
                  - exact_read;
        a_lo[c] = std::lower_bound(amb_read, amb_read + n_amb, (int32_t)r)
                  - amb_read;
    }
#pragma omp parallel for num_threads((int)n_chunks) schedule(static, 1)
    for (long c = 0; c < n_chunks; ++c) {
        place_scalar_range(db, r_lo[c], r_lo[c + 1], m_per_read, exact_keys,
                           exact_read, n_exact, amb_keys, amb_read, n_amb,
                           e_lo[c], a_lo[c], K, out_edges, out_scores,
                           out_counts, out_n, out_sum);
    }
}

// ---------------------------------------------------------------------------
// 4. jplace batch row formatter
// ---------------------------------------------------------------------------
//
// Serializes one batch of placements straight from the packed result arrays
// into jplace v3 text, byte-identical to the Python writer
// (epik_tpu/io/jplace.py; reference: epik/src/epik/jplace.cpp:21-38,121-158).
// Python object construction + per-value formatting cost ~37+35 ms per
// 2000-read batch; this does the whole batch in one C call.

#include <charconv>

namespace {

// rapidjson-compatible double formatting (mirrors io/jplace.py::
// format_double; reference: rapidjson Writer::Double via jplace.cpp:127-135):
// shortest round-trip digits, then rapidjson's Prettify cutover -- fixed
// notation when the decimal-point position kk is in (-6, 21], else
// exponential with an unpadded exponent.
char* fmt_double(double x, char* o) {
    if (std::isnan(x)) { std::memcpy(o, "NaN", 3); return o + 3; }
    if (std::isinf(x)) {
        if (x < 0) { std::memcpy(o, "-Infinity", 9); return o + 9; }
        std::memcpy(o, "Infinity", 8); return o + 8;
    }
    char buf[48];
    auto res = std::to_chars(buf, buf + sizeof buf, x,
                             std::chars_format::scientific);
    const char* p = buf;
    bool neg = false;
    if (*p == '-') { neg = true; ++p; }
    char digits[40];
    int nd = 0;
    for (; p < res.ptr && *p != 'e'; ++p)
        if (*p != '.') digits[nd++] = *p;
    int exp10 = 0;
    bool eneg = false;
    ++p;  // 'e'
    if (p < res.ptr && (*p == '-' || *p == '+')) eneg = (*p++ == '-');
    for (; p < res.ptr; ++p) exp10 = exp10 * 10 + (*p - '0');
    if (eneg) exp10 = -exp10;
    while (nd > 1 && digits[nd - 1] == '0') --nd;  // 0e+00 -> "0"
    if (neg) *o++ = '-';
    if (nd == 1 && digits[0] == '0') { std::memcpy(o, "0.0", 3); return o + 3; }
    const int kk = exp10 + 1;  // value = 0.<digits> * 10**kk
    if (0 < kk && kk <= 21) {
        if (nd <= kk) {  // 1234000.0
            std::memcpy(o, digits, nd); o += nd;
            for (int i = nd; i < kk; ++i) *o++ = '0';
            *o++ = '.'; *o++ = '0';
        } else {  // 123.4
            std::memcpy(o, digits, kk); o += kk;
            *o++ = '.';
            std::memcpy(o, digits + kk, nd - kk); o += nd - kk;
        }
    } else if (-6 < kk && kk <= 0) {  // 0.0001234
        *o++ = '0'; *o++ = '.';
        for (int i = 0; i < -kk; ++i) *o++ = '0';
        std::memcpy(o, digits, nd); o += nd;
    } else {  // d.ddd e kk-1, exponent unpadded
        *o++ = digits[0];
        if (nd > 1) { *o++ = '.'; std::memcpy(o, digits + 1, nd - 1); o += nd - 1; }
        *o++ = 'e';
        int e = kk - 1;
        if (e < 0) { *o++ = '-'; e = -e; }
        char tmp[8];
        int nt = 0;
        do { tmp[nt++] = (char)('0' + e % 10); e /= 10; } while (e);
        while (nt) *o++ = tmp[--nt];
    }
    return o;
}

char* fmt_i32(int32_t v, char* o) {
    auto res = std::to_chars(o, o + 12, v);
    return res.ptr;
}

}  // namespace

// Returns bytes written, or -1 if out_cap is insufficient (caller retries
// with a larger buffer).  nm_buf holds the batch's pre-escaped JSON header
// tokens (including quotes) back to back; nm_off[t]..nm_off[t+1] delimit
// token t; read i owns nm_cnt[i] consecutive tokens.  first_placement: no
// leading comma before the batch's first object.
EH_API int64_t eh_format_jplace(long R, int K, const int32_t* ids,
                                const float* scores, const double* wr,
                                const double* dist, const double* pend,
                                const uint8_t* keep, const char* nm_buf,
                                const int64_t* nm_off, const int32_t* nm_cnt,
                                int first_placement, char* out,
                                int64_t out_cap) {
    char* o = out;
    char* const end = out + out_cap;
    int64_t tok = 0;
    for (long r = 0; r < R; ++r) {
        // worst case per row ~120 bytes, plus object framing and nm tokens
        int64_t need = 96 + (int64_t)K * 128;
        for (int32_t h = 0; h < nm_cnt[r]; ++h)
            need += (nm_off[tok + h + 1] - nm_off[tok + h]) + 28;
        if (end - o < need) return -1;

        if (!first_placement) *o++ = ',';
        first_placement = 0;
        std::memcpy(o, "\n        {\n            \"p\": [", 29); o += 29;
        const long base = r * K;
        bool any = false;
        for (int j = 0; j < K; ++j) {
            if (!keep[base + j]) continue;
            if (any) *o++ = ',';
            any = true;
            std::memcpy(o, "\n                [", 18); o += 18;
            o = fmt_i32(ids[base + j], o);
            *o++ = ','; *o++ = ' ';
            o = fmt_double((double)scores[base + j], o);
            *o++ = ','; *o++ = ' ';
            o = fmt_double(wr[base + j], o);
            *o++ = ','; *o++ = ' ';
            o = fmt_double(dist[base + j], o);
            *o++ = ','; *o++ = ' ';
            o = fmt_double(pend[base + j], o);
            *o++ = ']';
        }
        if (any) { std::memcpy(o, "\n            ],\n", 16); o += 16; }
        else { std::memcpy(o, "],\n", 3); o += 3; }
        std::memcpy(o, "            \"nm\": [", 19); o += 19;
        for (int32_t h = 0; h < nm_cnt[r]; ++h, ++tok) {
            if (h) *o++ = ',';
            std::memcpy(o, "\n                [", 18); o += 18;
            const int64_t len = nm_off[tok + 1] - nm_off[tok];
            std::memcpy(o, nm_buf + nm_off[tok], (size_t)len); o += len;
            std::memcpy(o, ", 1]", 4); o += 4;
        }
        if (nm_cnt[r]) { std::memcpy(o, "\n            ]\n", 15); o += 15; }
        else { std::memcpy(o, "]\n", 2); o += 2; }
        std::memcpy(o, "        }", 9); o += 9;
    }
    return o - out;
}

// ---------------------------------------------------------------------------
// 5. .ipk record scanner
// ---------------------------------------------------------------------------
// The k-mer section of an .ipk archive is a sequence of variable-length
// records [u64 key | size_t count | count x (u32 branch, f32 score)]
// (reconstructed layout; reference load: epik/src/epik/main.cpp:277 via the
// empty i2l submodule -- see epik_tpu/io/ipk_boost.py).  Record boundaries
// depend on every preceding count, so parsing is inherently sequential; this
// walk runs at memcpy speed where the Python per-record loop costs ~1 us
// per k-mer (minutes on a 10^8-entry database).

// Pass 1: walk n records starting at byte `start`; fill keys[n] and lens[n].
// Returns the end offset on success, or -(pos + 1) on truncation /
// implausible count at byte pos.  sw = sizeof(size_t) in the writing build
// (8 on 64-bit, 4 on 32-bit archives); head_pad = extra bytes between the
// count and the payload (the Boost collection item_version word under the
// vecver/umap layout hypotheses -- io/ipk_boost.py::_trace_fields).
EH_API int64_t eh_ipk_scan(const uint8_t* data, int64_t len, int64_t start,
                           int64_t n, int sw, int head_pad, uint64_t* keys,
                           int64_t* lens) {
    int64_t pos = start;
    const int64_t head = 8 + sw + head_pad;
    for (int64_t i = 0; i < n; ++i) {
        if (pos + head > len) return -(pos + 1);
        uint64_t key, cnt = 0;
        std::memcpy(&key, data + pos, 8);
        std::memcpy(&cnt, data + pos + 8, (size_t)sw);  // little-endian host
        if (cnt > (uint64_t)1 << 32) return -(pos + 1);
        const int64_t body = (int64_t)cnt * 8;
        if (pos + head + body > len) return -(pos + 1);
        keys[i] = key;
        lens[i] = (int64_t)cnt;
        pos += head + body;
    }
    return pos;
}

// Pass 2: same walk, copying the posting payloads into branches[] /
// scores[] (total sizes known from pass 1).  Returns the end offset, or
// -(pos + 1) on truncation.
EH_API int64_t eh_ipk_extract(const uint8_t* data, int64_t len, int64_t start,
                              int64_t n, int sw, int head_pad,
                              uint32_t* branches, float* scores) {
    int64_t pos = start;
    const int64_t head = 8 + sw + head_pad;
    int64_t out = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (pos + head > len) return -(pos + 1);
        uint64_t cnt = 0;
        std::memcpy(&cnt, data + pos + 8, (size_t)sw);
        const int64_t body = (int64_t)cnt * 8;
        if (cnt > (uint64_t)1 << 32 || pos + head + body > len)
            return -(pos + 1);
        const uint8_t* rec = data + pos + head;
        for (uint64_t j = 0; j < cnt; ++j) {
            std::memcpy(branches + out, rec + j * 8, 4);
            std::memcpy(scores + out, rec + j * 8 + 4, 4);
            ++out;
        }
        pos += head + body;
    }
    return pos;
}
