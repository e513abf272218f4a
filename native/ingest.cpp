// hammlet_tpu native ingest: fast value parsing + streaming Haar maxlet
// transform + breakpoint weights.
//
// This is the host-side, I/O-bound part of the pipeline (the role the
// reference implements as C++ streaming in src/wavelet.hpp:98-188 and
// src/main.cpp:261-318; this file is an independent implementation of the
// same math). Exposed as a C ABI for ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libhammlet_ingest.so ingest.cpp -lz

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <zlib.h>

namespace {

const float kInf = std::numeric_limits<float>::infinity();
const float kSqrt2Half = (float)(std::sqrt(2.0) / 2.0);

// Parse whitespace-separated floats from a buffer. Returns count parsed.
size_t parse_buffer(const char* p, const char* end, std::vector<float>& out) {
    size_t n0 = out.size();
    while (p < end) {
        while (p < end && std::isspace((unsigned char)*p)) ++p;
        if (p >= end) break;
        char* next = nullptr;
        float v = strtof(p, &next);
        if (next == p) break;  // unparseable tail
        out.push_back(v);
        p = next;
    }
    return out.size() - n0;
}

bool read_file_raw(const char* path, std::vector<char>& buf) {
    size_t len = std::strlen(path);
    if (len > 3 && std::strcmp(path + len - 3, ".gz") == 0) {
        gzFile f = gzopen(path, "rb");
        if (!f) return false;
        char chunk[1 << 20];
        int n;
        while ((n = gzread(f, chunk, sizeof(chunk))) > 0)
            buf.insert(buf.end(), chunk, chunk + n);
        gzclose(f);
        return true;
    }
    int fd = open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        return false;
    }
    buf.resize((size_t)st.st_size);
    ssize_t off = 0;
    while (off < st.st_size) {
        ssize_t r = read(fd, buf.data() + off, st.st_size - off);
        if (r <= 0) break;
        off += r;
    }
    close(fd);
    return off == st.st_size;
}

// Sequential token stream over a (possibly gzipped) text file. Tokens are
// whitespace-separated; the stream keeps a token cursor and supports
// forward skips at scan speed and rewinds by reopening the decompressor.
// This is the bounded-memory ingest path (the reference streams its whole
// ingest from an istream the same way, src/wavelet.hpp:131): a provider
// asks for token ranges and never more than one chunk is resident.
struct TokenStream {
    bool is_gz = false;
    gzFile gz = nullptr;
    FILE* f = nullptr;
    std::vector<char> buf;
    size_t pos = 0, len = 0;
    bool eof = false;
    int64_t cursor = 0;  // tokens fully consumed

    bool open(const char* path) {
        size_t n = std::strlen(path);
        is_gz = n > 3 && std::strcmp(path + n - 3, ".gz") == 0;
        if (is_gz) {
            gz = gzopen(path, "rb");
            if (gz) gzbuffer(gz, 1 << 20);
            return gz != nullptr;
        }
        f = std::fopen(path, "rb");
        return f != nullptr;
    }
    void close() {
        if (gz) gzclose(gz);
        if (f) std::fclose(f);
        gz = nullptr;
        f = nullptr;
    }
    void rewind() {
        if (is_gz)
            gzrewind(gz);
        else
            std::fseek(f, 0, SEEK_SET);
        pos = len = 0;
        eof = false;
        cursor = 0;
    }
    bool fill() {
        if (pos < len) return true;
        if (eof) return false;
        if (buf.empty()) buf.resize(1 << 20);
        long n = is_gz ? gzread(gz, buf.data(), (unsigned)buf.size())
                       : (long)std::fread(buf.data(), 1, buf.size(), f);
        if (n <= 0) {
            eof = true;
            return false;
        }
        pos = 0;
        len = (size_t)n;
        return true;
    }
    // Advance past one token. If tmp != nullptr, collect its bytes (up to
    // 63) for parsing. Returns false at EOF before any token byte.
    bool next_token(char* tmp) {
        while (true) {  // skip whitespace, spanning refills
            if (!fill()) return false;
            while (pos < len && std::isspace((unsigned char)buf[pos])) ++pos;
            if (pos < len) break;
        }
        size_t k = 0;
        while (true) {  // collect token bytes, spanning refills
            while (pos < len && !std::isspace((unsigned char)buf[pos])) {
                if (tmp && k < 63) tmp[k++] = buf[pos];
                ++pos;
            }
            if (pos < len || !fill()) break;
        }
        if (tmp) tmp[k] = '\0';
        ++cursor;
        return true;
    }
};

}  // namespace

extern "C" {

// ---- streaming token-range API (bounded-memory ingest) -------------------

void* hammlet_stream_open(const char* path) {
    TokenStream* s = new TokenStream();
    if (!s->open(path)) {
        delete s;
        return nullptr;
    }
    return s;
}

void hammlet_stream_close(void* h) {
    TokenStream* s = (TokenStream*)h;
    if (!s) return;
    s->close();
    delete s;
}

// Parse tokens [skip_to, skip_to + n) of the stream into out. Backward
// requests rewind (gz: one full re-decompression to the target — callers
// read mostly ascending so this is rare); forward gaps are skipped at scan
// speed without float parsing. Returns the number of tokens parsed (< n
// only at EOF), or -1 on error.
int64_t hammlet_stream_read(void* h, int64_t skip_to, int64_t n, float* out) {
    TokenStream* s = (TokenStream*)h;
    if (!s) return -1;
    if (skip_to < s->cursor) s->rewind();
    while (s->cursor < skip_to)
        if (!s->next_token(nullptr)) return 0;
    char tmp[64];
    int64_t parsed = 0;
    while (parsed < n) {
        if (!s->next_token(tmp)) break;
        out[parsed++] = strtof(tmp, nullptr);
    }
    return parsed;
}

// ---- record-stream CSV formatting (the hot output path) -------------------
//
// Formatting ~capacity integers per recorded sweep in Python costs more
// than the whole device Gibbs sweep with all record streams enabled; these
// two batch formatters produce the
// reference's CSV bytes (Records.hpp:155-235) for a whole scan chunk of
// recorded sweeps in one call.

// R lines, line j = tab-joined vals[j, :ns[j]] + '\n'. Returns bytes
// written, or -1 if out is too small (callers size it as 12*total+R+1).
int64_t hammlet_format_int_lines(const int32_t* vals, const int64_t* ns,
                                 int64_t R, int64_t cap, char* out,
                                 int64_t outcap) {
    char* p = out;
    char* end = out + outcap;
    for (int64_t j = 0; j < R; ++j) {
        const int32_t* row = vals + j * cap;
        for (int64_t i = 0; i < ns[j]; ++i) {
            if (end - p < 13) return -1;
            if (i) *p++ = '\t';
            p += std::snprintf(p, 12, "%d", row[i]);
        }
        if (p >= end) return -1;
        *p++ = '\n';
    }
    return p - out;
}

// R lines of run-length "SIZE:STATE" tokens: adjacent equal-state blocks
// merge into one segment (Records.hpp:167-188). nsegs[j] receives the
// segment count per line. Returns bytes written or -1 if out is too small.
int64_t hammlet_format_rle_lines(const int32_t* states, const int32_t* sizes,
                                 const int64_t* ns, int64_t R, int64_t cap,
                                 char* out, int64_t outcap, int64_t* nsegs) {
    char* p = out;
    char* end = out + outcap;
    for (int64_t j = 0; j < R; ++j) {
        const int32_t* st = states + j * cap;
        const int32_t* sz = sizes + j * cap;
        int64_t nseg = 0;
        int64_t i = 0;
        while (i < ns[j]) {
            long long run = sz[i];
            int32_t s = st[i];
            ++i;
            while (i < ns[j] && st[i] == s) {
                run += sz[i];
                ++i;
            }
            if (end - p < 26) return -1;
            if (nseg) *p++ = '\t';
            p += std::snprintf(p, 25, "%lld:%d", run, s);
            ++nseg;
        }
        if (p >= end) return -1;
        *p++ = '\n';
        if (nsegs) nsegs[j] = nseg;
    }
    return p - out;
}

// Reassemble per-(sweep, shard) block rows into global block order,
// reconstructing block sizes from the static candidate arrays (the batch
// form of the drain reconstruction: a sweep's shard-j boundary positions
// are pos[j][i] + j*T_local for every i with rank[j][i] < nb, ascending,
// and the global sizes are the diffs of the concatenated starts with a
// final T sentinel — which merges blocks spanning shard edges exactly as
// the device does). The single-device drain is the P = 1, T_local = T
// case.
//
// z: (R, P, cap) int32 per-shard states, valid in slots [0, nbs[r][j]);
// nbs: (R, P) int64; pos: (P, cap+1) int32 ascending local candidate
// positions (sentinel last); rank: (P, cap) int32 weight rank per
// candidate. Outputs: states/sizes (R, maxn) int32 zero-padded, ns (R,)
// int64 row totals. Positions are widened to int64 internally so
// multi-Gbp global coordinates cannot wrap. Returns 0, or -1 if a row
// exceeds maxn.
int hammlet_reassemble_blocks(const int32_t* z, const int64_t* nbs,
                              const int32_t* pos, const int32_t* rank,
                              int64_t R, int64_t P, int64_t cap, int64_t T,
                              int64_t T_local, int64_t maxn, int32_t* states,
                              int32_t* sizes, int64_t* ns) {
    std::vector<int64_t> starts((size_t)maxn);
    for (int64_t r = 0; r < R; ++r) {
        int32_t* st_out = states + r * maxn;
        int32_t* sz_out = sizes + r * maxn;
        int64_t n = 0;
        for (int64_t j = 0; j < P; ++j) {
            int64_t nb = nbs[r * P + j];
            if (nb <= 0) continue;
            const int32_t* zrow = z + (r * P + j) * cap;
            const int32_t* prow = pos + j * (cap + 1);
            const int32_t* rrow = rank + j * cap;
            const int64_t base = j * T_local;
            int64_t taken = 0;
            for (int64_t i = 0; i < cap && taken < nb; ++i) {
                if (rrow[i] < nb) {
                    if (n >= maxn) return -1;
                    starts[n] = base + prow[i];
                    st_out[n] = zrow[taken];
                    ++n;
                    ++taken;
                }
            }
        }
        ns[r] = n;
        for (int64_t i = 0; i < n; ++i) {
            int64_t end = (i + 1 < n) ? starts[i + 1] : T;
            sz_out[i] = (int32_t)(end - starts[i]);
        }
        for (int64_t i = n; i < maxn; ++i) {
            st_out[i] = 0;
            sz_out[i] = 0;
        }
    }
    return 0;
}

// Count whitespace-separated tokens in a (possibly gzipped) file without
// materializing anything. Returns -1 on error.
int64_t hammlet_count_values(const char* path) {
    TokenStream s;
    if (!s.open(path)) return -1;
    while (s.next_token(nullptr)) {
    }
    int64_t n = s.cursor;
    s.close();
    return n;
}

// Parse a (possibly gzipped) text file of whitespace-separated floats.
// Returns a malloc'd array in *out (caller frees via hammlet_free) and the
// count; returns 0 on success.
int hammlet_parse_file(const char* path, float** out, int64_t* count) {
    std::vector<char> buf;
    if (!read_file_raw(path, buf)) return 1;
    std::vector<float> vals;
    vals.reserve(buf.size() / 8 + 16);
    parse_buffer(buf.data(), buf.data() + buf.size(), vals);
    float* arr = (float*)std::malloc(vals.size() * sizeof(float));
    if (!arr && !vals.empty()) return 2;
    std::memcpy(arr, vals.data(), vals.size() * sizeof(float));
    *out = arr;
    *count = (int64_t)vals.size();
    return 0;
}

void hammlet_free(void* p) { std::free(p); }

// Streaming maxlet transform. data: T*dim floats (dimension-major per
// position); coeffs: T floats out. coeffs[t] = max across dims of the
// normalized absolute Haar detail coefficient of the wavelet whose central
// discontinuity is t (level = ctz(t)+1); positions with incomplete support
// and position 0 hold +inf. O(T) time, O(dim log T) extra space.
void hammlet_maxlet(const float* data, int64_t T, int64_t dim, float* coeffs) {
    std::vector<float> stack;
    stack.reserve((size_t)dim * 64);
    for (int64_t i = 0; i < T; ++i) {
        coeffs[i] = kInf;
        for (int64_t d = 0; d < dim; ++d) stack.push_back(data[i * dim + d]);
        uint64_t j = (uint64_t)i;
        uint64_t m = 1;
        float norm = kSqrt2Half;
        while (j & m) {
            size_t L = stack.size() - 2 * (size_t)dim;
            size_t R = stack.size() - (size_t)dim;
            float maxc = 0.0f;
            for (int64_t d = 0; d < dim; ++d) {
                float c = norm * std::fabs(stack[L + d] - stack[R + d]);
                if (c > maxc) maxc = c;
                stack[L + d] += stack[R + d];
            }
            stack.resize(stack.size() - (size_t)dim);
            coeffs[j] = maxc;
            j -= m;
            m <<= 1;
            norm *= kSqrt2Half;
        }
    }
    if (T > 0) coeffs[0] = kInf;
}

// In-place breakpoint weights from maxlet coefficients: top-down dyadic
// max-propagation of each wavelet's coefficient onto its support edges.
void hammlet_breakpoint_weights(float* w, int64_t T) {
    if (T <= 0) return;
    uint64_t p = 1;
    while ((int64_t)p < T) p <<= 1;
    for (uint64_t interval = p >> 1; interval >= 1; interval >>= 1) {
        for (uint64_t idx = interval; (int64_t)idx < T; idx += 2 * interval) {
            uint64_t L = idx - interval;
            uint64_t R = idx + interval;
            if ((int64_t)R < T) {
                if (w[idx] > w[R]) w[R] = w[idx];
            } else {
                w[L] = kInf;
                w[idx] = kInf;
            }
            if (w[idx] > w[L]) w[L] = w[idx];
        }
        if (interval == 1) break;
    }
}

// Noise sigma estimate: mean of odd-index coefficients / sqrt(2/pi).
double hammlet_noise_std(const float* coeffs, int64_t T) {
    double s = 0.0;
    int64_t n = 0;
    for (int64_t i = 1; i < T; i += 2) {
        s += coeffs[i];
        ++n;
    }
    if (n == 0) return 0.0;
    return (s / n) / 0.797884560802865355879892119868763736951717262329869315331;
}

// Cell-structured prefix sums: R (float32, (T+1)*dim*2) in-cell reverse
// cumsums of (x, x^2) accumulated in double, and q2 (double,
// (n_cells+1)*dim*2) inclusive cell prefixes with the final entry
// duplicated. cell = 1 << cell_bits.
void hammlet_prefix_stats(const float* data, int64_t T, int64_t dim,
                          int cell_bits, float* r, double* q2) {
    const int64_t cell = (int64_t)1 << cell_bits;
    const int64_t n_cells = (T + cell - 1) / cell;
    std::vector<double> acc(2 * (size_t)dim);
    std::vector<double> cell_prefix(2 * (size_t)dim, 0.0);
    // zero R tail row
    for (int64_t d = 0; d < dim * 2; ++d) r[T * dim * 2 + d] = 0.0f;
    for (int64_t c = n_cells - 1; c >= 0; --c) {
        // reverse cumsum within the cell
        std::fill(acc.begin(), acc.end(), 0.0);
        int64_t hi = std::min((c + 1) * cell, T);
        for (int64_t t = hi - 1; t >= c * cell; --t) {
            for (int64_t d = 0; d < dim; ++d) {
                double x = (double)data[t * dim + d];
                acc[2 * d] += x;
                acc[2 * d + 1] += x * x;
                r[(t * dim + d) * 2] = (float)acc[2 * d];
                r[(t * dim + d) * 2 + 1] = (float)acc[2 * d + 1];
            }
        }
    }
    // q2: inclusive prefixes over cell totals (recomputed forward)
    for (int64_t c = 0; c < n_cells; ++c) {
        int64_t lo = c * cell, hi = std::min((c + 1) * cell, T);
        for (int64_t t = lo; t < hi; ++t) {
            for (int64_t d = 0; d < dim; ++d) {
                double x = (double)data[t * dim + d];
                cell_prefix[2 * d] += x;
                cell_prefix[2 * d + 1] += x * x;
            }
        }
        for (int64_t d = 0; d < dim * 2; ++d)
            q2[c * dim * 2 + d] = cell_prefix[d];
    }
    for (int64_t d = 0; d < dim * 2; ++d)
        q2[n_cells * dim * 2 + d] = cell_prefix[d];
}

}  // extern "C"
