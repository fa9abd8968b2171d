// The PyTorch port's copy of native/psq_io.cpp (pandaseq_tpu_torch/io/native.py builds it).
// pandaseq_tpu native host IO: paired FASTQ decoding straight into the
// batch tensors the TPU pipeline consumes.
//
// TPU-native equivalent of the reference's L1/L2 C stack (linebuf.c,
// fileio.c, fastq.c, seqid.c): instead of handing one read pair at a time
// to a per-pair assembler, it fills [batch, stride] int8 nt/qual arrays
// (plus lengths and canonical id strings) for the batched device step.
// Grammar and quirks are kept bit-compatible:
//   * nt table lookup on (ch & 0x1F), decode stops at max_len
//     (fastq.c:61-66)
//   * TOINDEX qual clamp incl. the above-range quirk (fastq.c:44)
//   * '+' separator check distinguishing READLEN vs BADSEQ (fastq.c:72-81)
//   * qual/seq length equality, zero-length NODATA skip (fastq.c:94-100)
//   * persistent per-stream decode buffers: bytes past the current length
//     keep the previous record's content (fastq.c:33-36; the PEAR
//     algorithm reads this stale data, algo_pear.c:52-54)
//   * id pairing + direction check (fastq.c:127-148), 4 header dialects
//     (seqid.c:157-284), CASAVA 1.7 => PHRED+33 assumed
// Compression: magic-byte sniff, zlib for gz/plain, libbz2 for bz2
// (fileio.c:60-98).
//
// Exposed as a plain C ABI consumed through ctypes (io/native.py).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <omp.h>
#include <zlib.h>

// libbz2 prototypes (dev header not installed; ABI of libbz2.so.1)
extern "C" {
typedef void BZFILE;
BZFILE *BZ2_bzdopen(int fd, const char *mode);
int BZ2_bzread(BZFILE *b, void *buf, int len);
int BZ2_bzclose_(BZFILE *b);
void BZ2_bzclose(BZFILE *b);
}

namespace {

constexpr int MAX_LEN = 450;      // configure.ac:8
constexpr int PHREDMAX = 46;      // prob.h:22
constexpr int TAG_LEN = 50;       // pandaseq-common.h:45
constexpr int FIELD_LEN = 100;

// IUPAC tables indexed by (ch & 0x1F) (nt.c:46-114)
int8_t IUPAC_FWD[32];
int8_t IUPAC_REV[32];

struct InitTables {
    InitTables() {
        memset(IUPAC_FWD, 0, sizeof IUPAC_FWD);
        memset(IUPAC_REV, 0, sizeof IUPAC_REV);
        const struct { char c; int fwd; } t[] = {
            {'A', 1},  {'C', 2},  {'G', 4},  {'T', 8},  {'U', 8},
            {'M', 3},  {'R', 5},  {'W', 9},  {'S', 6},  {'Y', 10},
            {'K', 12}, {'V', 7},  {'H', 11}, {'D', 13}, {'B', 14},
            {'N', 15}, {'X', 15},
        };
        auto comp = [](int b) {  // complement of the 4-bit code (nt.c:27)
            int r = 0;
            if (b & 1) r |= 8;   // A -> T
            if (b & 8) r |= 1;   // T -> A
            if (b & 2) r |= 4;   // C -> G
            if (b & 4) r |= 2;   // G -> C
            return r;
        };
        for (auto &e : t) {
            IUPAC_FWD[e.c & 0x1F] = (int8_t) e.fwd;
            IUPAC_REV[e.c & 0x1F] = (int8_t) comp(e.fwd);
        }
    }
} init_tables_;

// ---------------------------------------------------------------------
// Buffered reader over gz / bz2 / plain with CR-stripping line scanner
// (linebuf.c:57-89)
// ---------------------------------------------------------------------
#if defined(__x86_64__)
#include <immintrin.h>
static inline __mmask64 nl_tailmask64(int rem) {  // rem in [1, 64]
    return ~0ULL >> (64 - rem);
}
// newline scan over [pos, end) of a block arena: '\0'-terminate lines
// in place (CR stripped), push line-start offsets. One 64-byte compare
// per block instead of one memchr call per ~250-byte line.
__attribute__((target("avx512bw")))
static void scan_newlines_avx512(char *base, size_t pos, size_t end,
                                 std::vector<size_t> &q, size_t &lstart) {
    const __m512i nl = _mm512_set1_epi8('\n');
    for (size_t j = pos; j < end; j += 64) {
        int rem = end - j >= 64 ? 64 : (int) (end - j);
        __mmask64 m = rem == 64 ? ~0ULL : nl_tailmask64(rem);
        __mmask64 hits = _mm512_mask_cmpeq_epi8_mask(
            m, _mm512_maskz_loadu_epi8(m, base + j), nl);
        while (hits) {
            size_t i = j + (size_t) __builtin_ctzll(hits);
            hits &= hits - 1;
            if (i > lstart && base[i - 1] == '\r') base[i - 1] = '\0';
            base[i] = '\0';
            q.push_back(lstart);
            lstart = i + 1;
        }
    }
}
static const bool NL_HAVE_AVX512 = __builtin_cpu_supports("avx512bw");
#else
static void scan_newlines_avx512(char *, size_t, size_t,
                                 std::vector<size_t> &, size_t &) {}
static const bool NL_HAVE_AVX512 = false;
#endif

struct Stream {
    gzFile gz = nullptr;
    BZFILE *bz = nullptr;
    FILE *plain = nullptr;
    bool eof = false;
    std::string line;
    // Block-scan line reader: chunks are read straight into `ar` and
    // newline offsets recorded in one memchr pass (lines are
    // '\0'-terminated in place, CR stripped), instead of copying every
    // line out of a small buffer. Offsets index `ar`, so refill
    // reallocation keeps them valid; consumers resolve pointers only
    // after collection. `release_consumed()` compacts once the caller
    // no longer holds offsets (start of a batch iteration / next_line).
    std::vector<char> ar;
    std::vector<size_t> q;  // offsets of scanned lines, FIFO
    size_t qh = 0;          // next unconsumed index into q
    size_t lstart = 0;      // start of the unterminated partial line
    static const size_t CHUNK = 1 << 18;

    bool open(const char *path) {
        FILE *probe = fopen(path, "rb");
        if (!probe) return false;
        unsigned char magic[3] = {0, 0, 0};
        size_t got = fread(magic, 1, 3, probe);
        fclose(probe);
        if (got >= 3 && magic[0] == 'B' && magic[1] == 'Z') {
            FILE *f = fopen(path, "rb");
            if (!f) return false;
            bz = BZ2_bzdopen(fileno(f), "rb");
            return bz != nullptr;
        }
        if (got >= 2 && magic[0] == 0x1f && magic[1] == 0x8b) {
            gz = gzopen(path, "rb");
            if (gz) gzbuffer(gz, 1 << 17);
            return gz != nullptr;
        }
        // plain file: read(2) straight into the scan arena — gzread's
        // transparent mode costs an extra internal buffer + copy
        plain = fopen(path, "rb");
        if (plain) setvbuf(plain, nullptr, _IONBF, 0);
        return plain != nullptr;
    }
    int raw_read(char *dst, int n) {
        if (plain) return (int) fread(dst, 1, (size_t) n, plain);
        if (gz) return gzread(gz, dst, n);
        if (bz) {
            int r = BZ2_bzread(bz, dst, n);
            return r < 0 ? 0 : r;
        }
        return 0;
    }
    // drop consumed lines from the front of `ar` — only while the
    // caller holds no offsets (batch-iteration start / next_line)
    void release_consumed() {
        if (qh == 0) return;
        size_t keep = qh < q.size() ? q[qh] : lstart;
        size_t tail = ar.size() - keep;
        if (tail) memmove(ar.data(), ar.data() + keep, tail);
        ar.resize(tail);
        q.erase(q.begin(), q.begin() + qh);
        for (size_t &o : q) o -= keep;
        qh = 0;
        lstart -= keep;
    }

    // read one chunk and scan it for newlines; false if EOF with no
    // new complete line staged
    bool refill() {
        if (eof) return false;
        size_t old = ar.size();
        ar.resize(old + CHUNK);
        int got = raw_read(ar.data() + old, (int) CHUNK);
        if (got <= 0) {
            ar.resize(old);
            eof = true;
            // unterminated final line (linebuf.c: emitted as-is)
            if (lstart < ar.size()) {
                if (ar.back() == '\r') ar.back() = '\0';
                else ar.push_back('\0');
                q.push_back(lstart);
                lstart = ar.size();
                return true;
            }
            return false;
        }
        ar.resize(old + got);
        char *base = ar.data();
        if (NL_HAVE_AVX512) {
            scan_newlines_avx512(base, old, ar.size(), q, lstart);
            return true;
        }
        size_t pos = old;
        for (;;) {
            char *nl = (char *) memchr(base + pos, '\n',
                                       ar.size() - pos);
            if (nl == nullptr) break;
            size_t i = (size_t) (nl - base);
            if (i > lstart && base[i - 1] == '\r') base[i - 1] = '\0';
            base[i] = '\0';
            q.push_back(lstart);
            lstart = i + 1;
            pos = i + 1;
        }
        return true;
    }

    // offset of the next line in `ar` ('\0'-terminated, CR stripped),
    // SIZE_MAX at EOF. Offsets stay valid until release_consumed().
    size_t next_line_off() {
        while (qh >= q.size())
            if (!refill()) return SIZE_MAX;
        return q[qh++];
    }

    // next line without trailing \n / \r\n; nullptr at EOF. The
    // returned pointer is valid until the next call (copied out, same
    // contract as the linebuf.c scanner).
    const char *next_line() {
        release_consumed();
        size_t off = next_line_off();
        if (off == SIZE_MAX) return nullptr;
        line.assign(ar.data() + off);
        return line.c_str();
    }
    void close() {
        if (gz) gzclose(gz);
        if (bz) BZ2_bzclose(bz);
        if (plain) fclose(plain);
        gz = nullptr;
        bz = nullptr;
        plain = nullptr;
    }
};

// ---------------------------------------------------------------------
// Sequence id parsing (seqid.c:143-285)
// ---------------------------------------------------------------------
struct SeqId {
    char instrument[FIELD_LEN + 4];
    char run[FIELD_LEN + 4];
    char flowcell[FIELD_LEN + 4];
    int lane = 0, tile = 0, x = 0, y = 0;
    char tag[TAG_LEN + 4];

    void clear() {
        instrument[0] = run[0] = flowcell[0] = tag[0] = '\0';
        lane = tile = x = y = 0;
    }
    bool equal(const SeqId &o) const {
        return lane == o.lane && tile == o.tile && x == o.x && y == o.y &&
               !strcmp(instrument, o.instrument) && !strcmp(run, o.run) &&
               !strcmp(flowcell, o.flowcell) && !strcmp(tag, o.tag);
    }
    int print(char *dst, int cap) const {  // panda_seqid_xprint format
        // worst case 3*(FIELD_LEN+1) + 4*11 + TAG_LEN + 7 seps + nul
        // = 405 bytes; hand-rolled because snprintf costs ~0.5 us and
        // runs once per record in the phase-2 hot loop
        if (cap < 3 * (FIELD_LEN + 2) + 4 * 12 + TAG_LEN + 8)
            return snprintf(dst, cap, "%s:%s:%s:%d:%d:%d:%d:%s",
                            instrument, run, flowcell, lane, tile, x, y,
                            tag);
        char *p = dst;
        auto put_s = [&p](const char *s) {
            while (*s) *p++ = *s++;
        };
        auto put_u = [&p](unsigned v) {
            char tmp[12];
            int n = 0;
            do {
                tmp[n++] = (char) ('0' + v % 10);
                v /= 10;
            } while (v);
            while (n) *p++ = tmp[--n];
        };
        put_s(instrument);
        *p++ = ':';
        put_s(run);
        *p++ = ':';
        put_s(flowcell);
        *p++ = ':';
        put_u((unsigned) lane);
        *p++ = ':';
        put_u((unsigned) tile);
        *p++ = ':';
        put_u((unsigned) x);
        *p++ = ':';
        put_u((unsigned) y);
        *p++ = ':';
        put_s(tag);
        *p = '\0';
        return (int) (p - dst);
    }
};

inline bool is_sep(char c) {
    return c == ':' || c == '#' || c == '/' || c == ' ';
}

struct Cursor {
    const char *p;
    bool parse_int(int *out) {
        if (*p == '\0') return false;
        int v = 0;
        for (; *p != '\0' && !is_sep(*p); p++) {
            if (*p < '0' || *p > '9') return false;
            v = 10 * v + (*p - '0');
        }
        *out = v;
        return true;
    }
    bool parse_str(char *dst, size_t cap) {
        if (*p == '\0') return false;
        size_t n = 0;
        for (; *p != '\0' && !is_sep(*p); p++) {
            if (n > cap) return false;
            dst[n++] = *p;
        }
        dst[n] = '\0';
        return true;
    }
    bool push() {
        if (*p == '\0') return false;
        p++;
        return true;
    }
};

// policy: 0 = optional, 1 = absent, 2 = present (matches io/fastq.py)
enum Policy { TAG_OPTIONAL = 0, TAG_ABSENT = 1, TAG_PRESENT = 2 };

int seqid_parse(SeqId *id, const char *input, int policy,
                bool *has_direction, bool *casava17) {
    id->clear();
    *has_direction = true;
    *casava17 = false;
    Cursor c{input};
    size_t len = strlen(input);
    int value;

    if (len > 3 && (input[0] == 'E' || input[0] == 'S') &&
        input[1] == 'R' && input[2] == 'R') {
        // Short Read Archive (seqid.c:157-172)
        *has_direction = false;
        c.p += 3;
        // PARSE_SRA_INT: digits until '.' or ' '
        int v = 0;
        for (; *c.p != '\0' && *c.p != '.' && *c.p != ' '; c.p++) {
            if (*c.p < '0' || *c.p > '9') return 0;
            v = 10 * v + (*c.p - '0');
        }
        if (!c.push()) return 0;
        snprintf(id->instrument, sizeof id->instrument, "%cRR%d", input[0],
                 v);
        v = 0;
        for (; *c.p != '\0' && *c.p != '.' && *c.p != ' '; c.p++) {
            if (*c.p < '0' || *c.p > '9') return 0;
            v = 10 * v + (*c.p - '0');
        }
        if (!c.push()) return 0;
        id->lane = v;
        if (!c.push()) return 0;
        return 1;
    }
    if (strchr(input, '/') != nullptr) {
        // CASAVA 1.4-1.6 or converted 1.7 (seqid.c:174-238)
        size_t colon_count = 0;
        for (const char *q = input; *q != '\0' && *q != '#'; q++)
            if (*q == ':') colon_count++;
        if (colon_count == 6) {
            if (!c.parse_str(id->instrument, FIELD_LEN) || !c.push())
                return 0;
            if (!c.parse_str(id->run, FIELD_LEN) || !c.push()) return 0;
            if (!c.parse_str(id->flowcell, FIELD_LEN) || !c.push())
                return 0;
        } else {
            if (!c.parse_str(id->instrument, FIELD_LEN) || !c.push())
                return 0;
        }
        if (!c.parse_int(&id->lane) || !c.push()) return 0;
        if (!c.parse_int(&id->tile) || !c.push()) return 0;
        if (!c.parse_int(&id->x) || !c.push()) return 0;
        if (!c.parse_int(&id->y) || !c.push()) return 0;
        if (*(c.p - 1) == '#') {
            size_t n = 0;
            for (; *c.p != '\0' && !is_sep(*c.p); c.p++) {
                if (n >= TAG_LEN) return 0;
                id->tag[n++] = *c.p;
            }
            id->tag[n] = '\0';
            if (!c.push()) return 0;
        }
        if (policy != TAG_OPTIONAL &&
            policy != (id->tag[0] == '\0' ? TAG_ABSENT : TAG_PRESENT))
            return 0;
        if (!c.parse_int(&value)) return 0;
        return value;
    }
    // CASAVA 1.7+ (seqid.c:240-284)
    *casava17 = true;
    if (!c.parse_str(id->instrument, FIELD_LEN) || !c.push()) return 0;
    if (!c.parse_str(id->run, FIELD_LEN) || !c.push()) return 0;
    if (!c.parse_str(id->flowcell, FIELD_LEN) || !c.push()) return 0;
    if (!c.parse_int(&id->lane) || !c.push()) return 0;
    if (!c.parse_int(&id->tile) || !c.push()) return 0;
    if (!c.parse_int(&id->x) || !c.push()) return 0;
    if (!c.parse_int(&id->y) || !c.push()) return 0;
    int mate;
    if (!c.parse_int(&mate) || !c.push()) return 0;
    if (*c.p == '\0') return 0;  // filtered chunk must exist
    while (*c.p != '\0' && !is_sep(*c.p)) c.p++;
    if (!c.push()) return 0;
    if (!c.parse_int(&value) || !c.push()) return 0;  // control bits
    size_t n = 0;
    for (; *c.p != '\0' && !is_sep(*c.p); c.p++) {
        if (n >= TAG_LEN) return 0;
        id->tag[n++] = *c.p;
    }
    id->tag[n] = '\0';
    if (policy != TAG_OPTIONAL &&
        policy != (id->tag[0] == '\0' ? TAG_ABSENT : TAG_PRESENT))
        return 0;
    return mate;
}

// ---------------------------------------------------------------------
// Paired reader
// ---------------------------------------------------------------------
const char NT_ASCII[17] = "NACMGRSVTWYHKDBN";

// one record's pre-collected line offsets (SIZE_MAX = missing)
struct RecLines {
    size_t f[4], rv[4], ix[4];
};

// one record's parallel-parse outcome
struct RecOut {
    int status = 0;  // 0 ok, 1 NODATA skip, 2 clean EOF, <0: -ErrCode
    int fl = 0, rl = 0;
    bool seen64 = false;   // seen_under_64 contributions, stage-ordered
    bool reached = false;  // got past id/seq parsing (non_empty)
};

struct PairReader {
    Stream fwd, rev, idx;
    bool has_index = false;
    int qualmin = 33;
    int policy = TAG_PRESENT;
    // persistent decode buffers (fastq.c:33-36)
    int8_t fwd_nt[MAX_LEN], fwd_q[MAX_LEN];
    int8_t rev_nt[MAX_LEN], rev_q[MAX_LEN];
    bool seen_under_64 = false;
    bool non_empty = false;
    int error = 0;  // error codes below
    // scratch reused across next_batch_parallel calls (fresh per-batch
    // vectors mean an mmap/munmap + page-fault cycle each time); line
    // text lives in each Stream's block-scanned arena
    std::vector<RecLines> lines;
    std::vector<RecOut> recs;
    // skip-mode raw-qual staging (psq_skip_batch): per-record raw
    // forward/reverse quality bytes so phase 3 can maintain the
    // persistent buffers without any row writes
    std::vector<int8_t> skip_q;

    PairReader() {
        memset(fwd_nt, 0, sizeof fwd_nt);
        memset(fwd_q, 0, sizeof fwd_q);
        memset(rev_nt, 0, sizeof rev_nt);
        memset(rev_q, 0, sizeof rev_q);
    }
};

enum ErrCode {
    ERR_NONE = 0,
    ERR_EOF = 1,
    ERR_BADID = 2,
    ERR_NOTPAIRED = 3,
    ERR_BADNT = 4,
    ERR_BADSEQ = 5,
    ERR_READLEN = 6,
    ERR_NOQUAL = 7,
};

inline int toindex(int v, int qualmin) {  // fastq.c:44
    if (v < qualmin) return 0;
    return (v > qualmin + PHREDMAX ? PHREDMAX : v) - qualmin;
}

// ---------------------------------------------------------------------
// SIMD record decode (SSE4.1, runtime-dispatched). Integer-only — no
// effect on the f64-exactness story. Each helper reproduces the scalar
// loop's semantics bit-for-bit and falls back to it for tails and
// rare cases (invalid chars, qualmin+PHREDMAX overflow).
// ---------------------------------------------------------------------
#if defined(__x86_64__)
#include <immintrin.h>

static const bool HAVE_SSE41 = __builtin_cpu_supports("sse4.1");

// 32-entry byte LUT over (c & 0x1F) for 16 chars: entries 0-15 from
// t0, 16-31 from t1, using pshufb's bit7-zeroing for the select
__attribute__((target("ssse3")))
static inline __m128i lut32_lookup(__m128i chars, __m128i t0, __m128i t1) {
    __m128i idx = _mm_and_si128(chars, _mm_set1_epi8(0x1F));
    __m128i hi = _mm_and_si128(idx, _mm_set1_epi8(0x10));
    __m128i sel_lo = _mm_or_si128(idx, _mm_slli_epi16(hi, 3));
    __m128i sel_hi = _mm_sub_epi8(idx, _mm_set1_epi8(16));
    return _mm_or_si128(_mm_shuffle_epi8(t0, sel_lo),
                        _mm_shuffle_epi8(t1, sel_hi));
}

// nt-decode `len` chars (len <= max_len, all-valid expected); returns
// false if any char maps to code 0 (caller reruns the scalar loop for
// the exact first-error semantics)
__attribute__((target("sse4.1")))
static bool decode_nt_simd(const char *in, int len, const int8_t *table,
                           int8_t *out) {
    __m128i t0 = _mm_loadu_si128((const __m128i *) table);
    __m128i t1 = _mm_loadu_si128((const __m128i *) (table + 16));
    __m128i any_zero = _mm_setzero_si128();
    int j = 0;
    for (; j + 16 <= len; j += 16) {
        __m128i v = _mm_loadu_si128((const __m128i *) (in + j));
        __m128i code = lut32_lookup(v, t0, t1);
        any_zero = _mm_or_si128(
            any_zero, _mm_cmpeq_epi8(code, _mm_setzero_si128()));
        _mm_storeu_si128((__m128i *) (out + j), code);
    }
    if (_mm_movemask_epi8(any_zero)) return false;
    for (; j < len; j++) {
        int8_t code = table[in[j] & 0x1F];
        if (code == 0) return false;
        out[j] = code;
    }
    return true;
}

// quality line: out[j] = toindex((unsigned char) in[j], qualmin) for
// j < wlen, and seen64 |= (signed char) in[j] < 64 over ALL len chars
// (fastq.c checks every byte of the line, fastq.c:96-101)
__attribute__((target("sse4.1")))
static void decode_q_simd(const char *in, int len, int wlen, int qualmin,
                          int8_t *out, bool *seen_under_64) {
    __m128i qm = _mm_set1_epi8((char) qualmin);
    __m128i cap1 = _mm_set1_epi8((char) (qualmin + PHREDMAX + 1));
    __m128i pmax = _mm_set1_epi8((char) PHREDMAX);
    __m128i s64 = _mm_setzero_si128();
    __m128i c64 = _mm_set1_epi8(64);
    int j = 0;
    for (; j + 16 <= wlen; j += 16) {
        __m128i v = _mm_loadu_si128((const __m128i *) (in + j));
        s64 = _mm_or_si128(s64, _mm_cmplt_epi8(v, c64));
        // v > qualmin+PHREDMAX  (unsigned)
        __m128i over = _mm_cmpeq_epi8(_mm_max_epu8(v, cap1), v);
        __m128i sel = _mm_blendv_epi8(v, pmax, over);
        __m128i res = _mm_sub_epi8(sel, qm);
        // zero where v < qualmin (unsigned)
        __m128i ge = _mm_cmpeq_epi8(_mm_max_epu8(v, qm), v);
        _mm_storeu_si128((__m128i *) (out + j), _mm_and_si128(res, ge));
    }
    bool seen = _mm_movemask_epi8(s64) != 0;
    for (; j < wlen; j++) {
        if (in[j] < 64) seen = true;
        out[j] = (int8_t) toindex((unsigned char) in[j], qualmin);
    }
    for (; j < len; j++)
        if (in[j] < 64) seen = true;
    if (seen) *seen_under_64 = true;
}

// dst[j] = src[len-1-j] for j in [0, len)
__attribute__((target("ssse3")))
static void reverse_bytes_simd(const int8_t *src, int len, int8_t *dst) {
    const __m128i rev = _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
                                     11, 12, 13, 14, 15);
    int j = 0;
    for (; j + 16 <= len; j += 16) {
        __m128i v = _mm_loadu_si128(
            (const __m128i *) (src + len - 16 - j));
        _mm_storeu_si128((__m128i *) (dst + j),
                         _mm_shuffle_epi8(v, rev));
    }
    for (; j < len; j++) dst[j] = src[len - 1 - j];
}

// pp[j] = (fp[j] & 0x0F) | ((rp[j] & 0x0F) << 4)
__attribute__((target("sse2")))
static void pack_nibbles_simd(const int8_t *fp, const int8_t *rp, int len,
                              int8_t *pp) {
    const __m128i lo = _mm_set1_epi8(0x0F);
    int j = 0;
    for (; j + 16 <= len; j += 16) {
        __m128i f = _mm_and_si128(
            _mm_loadu_si128((const __m128i *) (fp + j)), lo);
        __m128i r = _mm_and_si128(
            _mm_loadu_si128((const __m128i *) (rp + j)), lo);
        __m128i hi = _mm_and_si128(_mm_slli_epi16(r, 4),
                                   _mm_set1_epi8((char) 0xF0));
        _mm_storeu_si128((__m128i *) (pp + j), _mm_or_si128(f, hi));
    }
    for (; j < len; j++)
        pp[j] = (int8_t) ((fp[j] & 0x0F) | ((rp[j] & 0x0F) << 4));
}
// ---- AVX-512 twins (64 bytes/iteration; VBMI vpermb turns the
// 32-entry LUT into one instruction; masked loads/stores handle tails
// without scalar epilogues). Same bit-exact semantics as the SSE
// versions; dispatched at runtime.
static const bool HAVE_AVX512 = __builtin_cpu_supports("avx512bw") &&
                                __builtin_cpu_supports("avx512vbmi");

static inline __mmask64 tailmask64(int rem) {  // rem in [1, 64]
    return ~0ULL >> (64 - rem);
}

__attribute__((target("avx512bw,avx512vbmi")))
static bool decode_nt_avx512(const char *in, int len, const int8_t *table,
                             int8_t *out) {
    // only indices 0-31 are ever selected (idx = c & 0x1F), so the
    // upper 32 LUT bytes are a don't-care duplicate
    const __m512i tbl = _mm512_broadcast_i64x4(
        _mm256_loadu_si256((const __m256i *) table));
    const __m512i m1f = _mm512_set1_epi8(0x1F);
    __mmask64 anyz = 0;
    for (int j = 0; j < len; j += 64) {
        __mmask64 m = j + 64 <= len ? ~0ULL : tailmask64(len - j);
        __m512i v = _mm512_maskz_loadu_epi8(m, in + j);
        __m512i code = _mm512_permutexvar_epi8(
            _mm512_and_si512(v, m1f), tbl);
        anyz |= _mm512_mask_cmpeq_epi8_mask(m, code,
                                            _mm512_setzero_si512());
        _mm512_mask_storeu_epi8(out + j, m, code);
    }
    return anyz == 0;
}

__attribute__((target("avx512bw")))
static void decode_q_avx512(const char *in, int len, int wlen, int qualmin,
                            int8_t *out, bool *seen_under_64) {
    const __m512i qm = _mm512_set1_epi8((char) qualmin);
    const __m512i cap1 = _mm512_set1_epi8((char) (qualmin + PHREDMAX + 1));
    const __m512i pmax = _mm512_set1_epi8((char) PHREDMAX);
    const __m512i c64 = _mm512_set1_epi8(64);
    __mmask64 s64 = 0;
    for (int j = 0; j < wlen; j += 64) {
        __mmask64 m = j + 64 <= wlen ? ~0ULL : tailmask64(wlen - j);
        __m512i v = _mm512_maskz_loadu_epi8(m, in + j);
        s64 |= _mm512_mask_cmplt_epi8_mask(m, v, c64);
        // v > qualmin+PHREDMAX (unsigned)
        __mmask64 over = _mm512_cmpeq_epi8_mask(_mm512_max_epu8(v, cap1),
                                                v);
        __m512i res = _mm512_sub_epi8(
            _mm512_mask_mov_epi8(v, over, pmax), qm);
        // zero where v < qualmin (unsigned)
        __mmask64 ge = _mm512_cmpeq_epi8_mask(_mm512_max_epu8(v, qm), v);
        _mm512_mask_storeu_epi8(out + j, m, _mm512_maskz_mov_epi8(ge, res));
    }
    bool seen = s64 != 0;
    for (int j = wlen; j < len; j++)  // qual line longer than max_len
        if (in[j] < 64) seen = true;
    if (seen) *seen_under_64 = true;
}

__attribute__((target("avx512bw,avx512vbmi")))
static void reverse_bytes_avx512(const int8_t *src, int len, int8_t *dst) {
    // iota[i] = i; rev[i] = 63 - i
    const __m512i iota = _mm512_set_epi8(
        63, 62, 61, 60, 59, 58, 57, 56, 55, 54, 53, 52, 51, 50, 49, 48,
        47, 46, 45, 44, 43, 42, 41, 40, 39, 38, 37, 36, 35, 34, 33, 32,
        31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17, 16,
        15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0);
    const __m512i rev = _mm512_sub_epi8(_mm512_set1_epi8(63), iota);
    int j = 0;
    for (; j + 64 <= len; j += 64) {
        __m512i v = _mm512_loadu_si512(
            (const void *) (src + len - 64 - j));
        _mm512_storeu_si512((void *) (dst + j),
                            _mm512_permutexvar_epi8(rev, v));
    }
    int rem = len - j;
    if (rem) {
        // remaining src bytes are [0, rem): masked-load them and
        // permute with idx[i] = rem-1-i (negative indices wrap but
        // those lanes are masked out of the store)
        __mmask64 m = tailmask64(rem);
        __m512i v = _mm512_maskz_loadu_epi8(m, src);
        __m512i idx = _mm512_sub_epi8(
            _mm512_set1_epi8((char) (rem - 1)), iota);
        _mm512_mask_storeu_epi8(dst + j, m,
                                _mm512_permutexvar_epi8(idx, v));
    }
}

__attribute__((target("avx512bw")))
static void pack_nibbles_avx512(const int8_t *fp, const int8_t *rp,
                                int len, int8_t *pp) {
    const __m512i lo = _mm512_set1_epi8(0x0F);
    const __m512i hi_m = _mm512_set1_epi8((char) 0xF0);
    for (int j = 0; j < len; j += 64) {
        __mmask64 m = j + 64 <= len ? ~0ULL : tailmask64(len - j);
        __m512i f = _mm512_and_si512(_mm512_maskz_loadu_epi8(m, fp + j),
                                     lo);
        __m512i r = _mm512_maskz_loadu_epi8(m, rp + j);
        __m512i hi = _mm512_and_si512(_mm512_slli_epi16(r, 4), hi_m);
        _mm512_mask_storeu_epi8(pp + j, m, _mm512_or_si512(f, hi));
    }
}
#else
static const bool HAVE_SSE41 = false;
static const bool HAVE_AVX512 = false;
static bool decode_nt_simd(const char *, int, const int8_t *, int8_t *) {
    return false;
}
static void decode_q_simd(const char *, int, int, int, int8_t *, bool *) {}
static void reverse_bytes_simd(const int8_t *, int, int8_t *) {}
static void pack_nibbles_simd(const int8_t *, const int8_t *, int,
                              int8_t *) {}
static bool decode_nt_avx512(const char *, int, const int8_t *, int8_t *) {
    return false;
}
static void decode_q_avx512(const char *, int, int, int, int8_t *, bool *) {}
static void reverse_bytes_avx512(const int8_t *, int, int8_t *) {}
static void pack_nibbles_avx512(const int8_t *, const int8_t *, int,
                                int8_t *) {}
#endif

// runtime-dispatched entry points (SIMD bodies require SSSE3+)
static inline void reverse_bytes(const int8_t *src, int len, int8_t *dst) {
    if (HAVE_AVX512) {
        reverse_bytes_avx512(src, len, dst);
        return;
    }
    if (HAVE_SSE41) {
        reverse_bytes_simd(src, len, dst);
        return;
    }
    for (int j = 0; j < len; j++) dst[j] = src[len - 1 - j];
}
static inline void pack_nibbles(const int8_t *fp, const int8_t *rp,
                                int len, int8_t *pp) {
    if (HAVE_AVX512) {
        pack_nibbles_avx512(fp, rp, len, pp);
        return;
    }
    if (HAVE_SSE41) {
        pack_nibbles_simd(fp, rp, len, pp);
        return;
    }
    for (int j = 0; j < len; j++)
        pp[j] = (int8_t) ((fp[j] & 0x0F) | ((rp[j] & 0x0F) << 4));
}

// read_seq (fastq.c:45-104); returns length or -error
int read_seq(Stream &s, const int8_t *table, int8_t *nt_buf, int8_t *q_buf,
             int max_len, int qualmin, bool *seen_under_64) {
    const char *input = s.next_line();
    if (input == nullptr) return -ERR_EOF;
    int pos = 0;
    for (; *input != '\0' && pos < max_len; input++) {
        int8_t code = table[*input & 0x1F];
        if (code == 0) return -ERR_BADNT;
        nt_buf[pos++] = code;
    }
    input = s.next_line();
    if (input == nullptr) return -ERR_EOF;
    if (*input != '+')
        return table[*input & 0x1F] != 0 ? -ERR_READLEN : -ERR_BADSEQ;
    input = s.next_line();
    if (input == nullptr) return -ERR_EOF;
    int qpos = 0;
    for (; *input != '\0'; input++) {
        if (*input < 64) *seen_under_64 = true;
        if (qpos < max_len) q_buf[qpos] = (int8_t) toindex(
            (unsigned char) *input, qualmin);
        qpos++;
    }
    if (qpos != pos) return -ERR_NOQUAL;
    return pos;  // pos == 0 -> NODATA handled by caller
}

// SIMD twin of parse_seq_lines below; returns PSL_FALLBACK when the
// scalar loop must run (no SSE4.1, or an invalid seq char whose exact
// first-error semantics the scalar path owns)
constexpr int PSL_FALLBACK = INT32_MIN;
static int parse_seq_lines_fast(const char *seq_line,
                                const char *plus_line,
                                const char *qual_line,
                                const int8_t *table, int8_t *nt_buf,
                                int8_t *q_buf, int max_len, int qualmin,
                                bool *seen_under_64) {
    if (!HAVE_SSE41 && !HAVE_AVX512) return PSL_FALLBACK;
    if (seq_line == nullptr) return -ERR_EOF;
    int slen = (int) strlen(seq_line);
    int pos = slen < max_len ? slen : max_len;
    bool ok = HAVE_AVX512 ? decode_nt_avx512(seq_line, pos, table, nt_buf)
                          : decode_nt_simd(seq_line, pos, table, nt_buf);
    if (!ok) return PSL_FALLBACK;
    if (plus_line == nullptr) return -ERR_EOF;
    if (*plus_line != '+')
        return table[*plus_line & 0x1F] != 0 ? -ERR_READLEN
                                             : -ERR_BADSEQ;
    if (qual_line == nullptr) return -ERR_EOF;
    long qlen = (long) strlen(qual_line);
    int wlen = qlen < (long) max_len ? (int) qlen : max_len;
    if (HAVE_AVX512)
        decode_q_avx512(qual_line, (int) qlen, wlen, qualmin, q_buf,
                        seen_under_64);
    else
        decode_q_simd(qual_line, (int) qlen, wlen, qualmin, q_buf,
                      seen_under_64);
    if (qlen != (long) pos) return -ERR_NOQUAL;
    return pos;
}

// read_seq on pre-collected lines (nullptr = stream ended before that
// line) — bitwise the same state machine, decoding into caller-local
// natural-order buffers so records can parse in parallel.
int parse_seq_lines(const char *seq_line, const char *plus_line,
                    const char *qual_line, const int8_t *table,
                    int8_t *nt_buf, int8_t *q_buf, int max_len,
                    int qualmin, bool *seen_under_64) {
    int fast = parse_seq_lines_fast(seq_line, plus_line, qual_line,
                                    table, nt_buf, q_buf, max_len,
                                    qualmin, seen_under_64);
    if (fast != PSL_FALLBACK) return fast;
    const char *input = seq_line;
    if (input == nullptr) return -ERR_EOF;
    int pos = 0;
    for (; *input != '\0' && pos < max_len; input++) {
        int8_t code = table[*input & 0x1F];
        if (code == 0) return -ERR_BADNT;
        nt_buf[pos++] = code;
    }
    input = plus_line;
    if (input == nullptr) return -ERR_EOF;
    if (*input != '+')
        return table[*input & 0x1F] != 0 ? -ERR_READLEN : -ERR_BADSEQ;
    input = qual_line;
    if (input == nullptr) return -ERR_EOF;
    int qpos = 0;
    for (; *input != '\0'; input++) {
        if (*input < 64) *seen_under_64 = true;
        if (qpos < max_len) q_buf[qpos] = (int8_t) toindex(
            (unsigned char) *input, qualmin);
        qpos++;
    }
    if (qpos != pos) return -ERR_NOQUAL;
    return pos;
}

// Parallel batched decode for the rev_layout path: phase 1 collects
// raw lines serially (the streams are sequential), phase 2 parses and
// writes provisional rows in parallel (records are independent —
// OpenMP), phase 3 walks records in order to apply the sequential
// semantics: first-error termination, stream flags, NODATA row
// compaction, and the persistent-quality-buffer stale tails
// (fastq.c:33-36 — the PEAR quirk reads quality bytes past the read
// length from whatever the previous records left there).
//
// SKIP MODE (fwd_nt == nullptr): advance the stream by exactly one
// batch's worth of emitted records while writing NO output rows — the
// mux decode-skip (mux.c:132-161 serializes only the hand-off; a host
// sharing a stream must not pay full decode for batches it does not
// claim). Everything that affects a LATER batch's bytes or the stream
// verdict is still maintained exactly: id pairing / BADID / BADNT /
// NOTPAIRED errors fire at the same record, NODATA records are skipped
// without counting, seen_under_64 / non_empty flags accrue, and the
// persistent quality buffers receive every record's raw quals (the
// stale-tail PEAR quirk) via a raw-qual staging arena. Skipped: nt
// decode row writes, reversal, nibble packing, id formatting, row
// compaction — the expensive half of phase 2/3.
long next_batch_parallel(PairReader *r, long batch, long stride,
                         int8_t *fwd_nt, int8_t *fwd_q, int8_t *rev_nt,
                         int8_t *rev_q, int32_t *flen, int32_t *rlen,
                         char *ids, long id_stride, int8_t *nt_pack) {
    static const bool prof = getenv("PSQ_DECODE_PROFILE") != nullptr;
    double p1 = 0, p2 = 0, p3 = 0, t;
    long n = 0;
    const bool skip = fwd_nt == nullptr;
    if (skip && r->skip_q.size() < (size_t) batch * 2 * MAX_LEN)
        r->skip_q.resize((size_t) batch * 2 * MAX_LEN);
    int8_t *skq = skip ? r->skip_q.data() : nullptr;
    std::vector<RecLines> &lines = r->lines;
    std::vector<RecOut> &recs = r->recs;
    while (n < batch && !r->error) {
        long want = batch - n;
        lines.clear();
        // prior iteration's offsets are dead: compact the stream arenas
        r->fwd.release_consumed();
        r->rev.release_consumed();
        if (r->has_index) r->idx.release_consumed();
        // ---- phase 1: serial line collection, pulling in the exact
        // order the sequential reader consumes (fwd id, rev id, fwd
        // seq/+/qual, rev seq/+/qual, index quartet) and stopping at
        // the first EOF so leftover lines stay unconsumed for the next
        // call — the post-truncation behavior (clean stop vs BADID on
        // a leftover seq line) must match the one-record-at-a-time
        // reference reader byte-for-byte. Offsets index each stream's
        // own block-scanned arena (no per-line copies).
        if (prof) t = omp_get_wtime();
        lines.reserve((size_t) want);
        for (long k = 0; k < want; k++) {
            // bulk fast path: whole records already scanned into the
            // arenas need no per-line calls (and no refill can fire,
            // so assignment order is free); a 256 KB refill stages
            // ~1000 lines, so this covers nearly every record
            size_t af = (r->fwd.q.size() - r->fwd.qh) / 4;
            size_t av = (r->rev.q.size() - r->rev.qh) / 4;
            size_t nb = af < av ? af : av;
            if (r->has_index) {
                size_t ai = (r->idx.q.size() - r->idx.qh) / 4;
                if (ai < nb) nb = ai;
            }
            if (nb > (size_t) (want - k)) nb = (size_t) (want - k);
            if (nb > 0) {
                const size_t *fq_ = r->fwd.q.data() + r->fwd.qh;
                const size_t *rq_ = r->rev.q.data() + r->rev.qh;
                const size_t *iq_ = r->has_index
                    ? r->idx.q.data() + r->idx.qh : nullptr;
                for (size_t u = 0; u < nb; u++) {
                    RecLines RL;
                    for (int t2 = 0; t2 < 4; t2++) {
                        RL.f[t2] = fq_[4 * u + t2];
                        RL.rv[t2] = rq_[4 * u + t2];
                        RL.ix[t2] = iq_ ? iq_[4 * u + t2] : SIZE_MAX;
                    }
                    lines.push_back(RL);
                }
                r->fwd.qh += 4 * nb;
                r->rev.qh += 4 * nb;
                if (r->has_index) r->idx.qh += 4 * nb;
                k += (long) nb - 1;
                continue;
            }
            RecLines RL;
            for (int t2 = 0; t2 < 4; t2++)
                RL.f[t2] = RL.rv[t2] = RL.ix[t2] = SIZE_MAX;
            bool short_rec = false;
            auto pull = [&](Stream &s, size_t &slot) {
                if (short_rec) return;
                slot = s.next_line_off();
                if (slot == SIZE_MAX) short_rec = true;
            };
            pull(r->fwd, RL.f[0]);
            if (RL.f[0] == SIZE_MAX) break;  // clean EOF before record
            pull(r->rev, RL.rv[0]);
            for (int t2 = 1; t2 < 4; t2++) pull(r->fwd, RL.f[t2]);
            for (int t2 = 1; t2 < 4; t2++) pull(r->rev, RL.rv[t2]);
            if (r->has_index)
                for (int t2 = 0; t2 < 4; t2++) pull(r->idx, RL.ix[t2]);
            lines.push_back(RL);
            if (short_rec) break;  // some stream ended mid-record
        }
        long nrec = (long) lines.size();
        if (nrec == 0) break;
        if (prof) { p1 += omp_get_wtime() - t; t = omp_get_wtime(); }
        recs.assign(nrec, RecOut());
        // resolved only after collection: refills may realloc
        const char *FA = r->fwd.ar.data();
        const char *RA = r->rev.ar.data();
        const char *XA = r->has_index ? r->idx.ar.data() : nullptr;
        // ---- phase 2: parallel parse + provisional row writes
#pragma omp parallel for schedule(static) if (nrec > 32)
        for (long k = 0; k < nrec; k++) {
            RecOut &o = recs[k];
            const RecLines &RL = lines[k];
            long row = n + k;
            auto LF = [&](size_t off) -> const char * {
                return off == SIZE_MAX ? nullptr : FA + off;
            };
            auto LR = [&](size_t off) -> const char * {
                return off == SIZE_MAX ? nullptr : RA + off;
            };
            auto LI = [&](size_t off) -> const char * {
                return off == SIZE_MAX ? nullptr : XA + off;
            };
            SeqId fid, rid;
            bool fdk, rdk, f17, r17;
            int fdir = seqid_parse(&fid, LF(RL.f[0]) + 1, r->policy,
                                   &fdk, &f17);
            if (fdir == 0) {
                o.status = -ERR_BADID;
                continue;
            }
            const char *rid_line = LR(RL.rv[0]);
            if (rid_line == nullptr) {
                o.status = 2;  // clean EOF mid-record (fastq.c caller)
                continue;
            }
            int rdir = seqid_parse(&rid, rid_line + 1, r->policy, &rdk,
                                   &r17);
            if (rdir == 0) {
                o.status = -ERR_BADID;
                continue;
            }
            if (!fid.equal(rid) || (fdk && rdir == fdir)) {
                o.status = -ERR_NOTPAIRED;
                continue;
            }
            if (f17) o.seen64 = true;
            int8_t fnt[MAX_LEN], fq[MAX_LEN], rnt[MAX_LEN], rq[MAX_LEN];
            int fl = parse_seq_lines(LF(RL.f[1]), LF(RL.f[2]),
                                     LF(RL.f[3]), IUPAC_FWD, fnt, fq,
                                     MAX_LEN, r->qualmin, &o.seen64);
            if (fl < 0) {
                o.status = fl;
                continue;
            }
            int rl = parse_seq_lines(LR(RL.rv[1]), LR(RL.rv[2]),
                                     LR(RL.rv[3]), IUPAC_REV, rnt, rq,
                                     MAX_LEN, r->qualmin, &o.seen64);
            if (rl < 0) {
                o.status = rl;
                continue;
            }
            if (r->has_index) {  // barcode read -> tag (fastq.c:159-188)
                const char *iline = LI(RL.ix[0]);
                if (iline == nullptr) {
                    o.status = 2;
                    continue;
                }
                SeqId iid;
                bool idk, i17;
                int idir = seqid_parse(&iid, iline + 1, r->policy, &idk,
                                       &i17);
                if (idir == 0) {
                    o.status = -ERR_BADID;
                    continue;
                }
                if (!fid.equal(iid)) {
                    o.status = -ERR_NOTPAIRED;
                    continue;
                }
                int8_t tnt[TAG_LEN], tq[TAG_LEN];
                int tl = parse_seq_lines(LI(RL.ix[1]), LI(RL.ix[2]),
                                         LI(RL.ix[3]), IUPAC_FWD, tnt,
                                         tq, TAG_LEN - 1, r->qualmin,
                                         &o.seen64);
                if (tl < 0) {
                    o.status = tl;
                    continue;
                }
                for (int t = 0; t < tl; t++)
                    fid.tag[t] = NT_ASCII[tnt[t] & 0x0F];
                fid.tag[tl] = 0;
            }
            o.reached = true;
            if (skip) {
                // skip mode: stage ONLY the raw quals for the
                // sequential persistent-buffer replay in phase 3
                o.status = fl == 0 ? 1 : 0;
                o.fl = fl;
                o.rl = rl;
                memcpy(skq + (size_t) row * 2 * MAX_LEN, fq, fl);
                memcpy(skq + (size_t) row * 2 * MAX_LEN + MAX_LEN, rq,
                       rl);
                continue;
            }
            if (fl == 0) {
                // NODATA: skip record (fastq.c:191) — but the serial
                // reader has already decoded the quals into the
                // persistent buffers by this point, so stage this
                // record's qual rows too; phase 3 applies them to
                // r->fwd_q/rev_q without emitting the row
                o.status = 1;
                o.fl = fl;
                o.rl = rl;
                reverse_bytes(fq, fl, fwd_q + row * stride);
                reverse_bytes(rq, rl, rev_q + row * stride);
                continue;
            }
            o.status = 0;
            o.fl = fl;
            o.rl = rl;
            // reversed left-aligned rows; quality tails [len, MAX_LEN)
            // are filled from the persistent buffers in phase 3
            int8_t *dst = fwd_nt + row * stride;
            reverse_bytes(fnt, fl, dst);
            memset(dst + fl, 0, stride - fl);
            dst = fwd_q + row * stride;
            reverse_bytes(fq, fl, dst);
            memset(dst + MAX_LEN, 0, stride - MAX_LEN);
            dst = rev_nt + row * stride;
            reverse_bytes(rnt, rl, dst);
            memset(dst + rl, 0, stride - rl);
            dst = rev_q + row * stride;
            reverse_bytes(rq, rl, dst);
            memset(dst + MAX_LEN, 0, stride - MAX_LEN);
            if (nt_pack != nullptr) {
                const int8_t *fp = fwd_nt + row * stride;
                const int8_t *rp = rev_nt + row * stride;
                int8_t *pp = nt_pack + row * stride;
                int mx = fl > rl ? fl : rl;
                pack_nibbles(fp, rp, mx, pp);
                memset(pp + mx, 0, stride - mx);
            }
            flen[row] = fl;
            rlen[row] = rl;
            fid.print(ids + row * id_stride, (int) id_stride);
        }
        if (prof) { p2 += omp_get_wtime() - t; t = omp_get_wtime(); }
        // ---- phase 3: sequential semantics in record order
        long emitted = 0;
        bool stop = false;
        for (long k = 0; k < nrec; k++) {
            RecOut &o = recs[k];
            if (o.seen64) r->seen_under_64 = true;
            if (o.reached) r->non_empty = true;
            if (o.status == 2) {
                stop = true;
                break;
            }
            if (o.status < 0) {
                r->error = -o.status;
                stop = true;
                break;
            }
            if (skip) {
                // persistent-buffer replay from the raw staging arena;
                // no rows exist. NODATA records update buffers but do
                // not count as emitted (fastq.c:45-104,191).
                const int8_t *sf = skq + (size_t) (n + k) * 2 * MAX_LEN;
                memcpy(r->fwd_q, sf, o.fl);
                memcpy(r->rev_q, sf + MAX_LEN, o.rl);
                if (o.status == 0) emitted++;
                continue;
            }
            if (o.status == 1) {
                // NODATA: the record still updates the persistent
                // quality buffers (the serial path's read_seq ran
                // before the skip, fastq.c:45-104,191) — raw order
                // from the staged reversed rows; no row emitted
                reverse_bytes(fwd_q + (n + k) * stride, o.fl, r->fwd_q);
                reverse_bytes(rev_q + (n + k) * stride, o.rl, r->rev_q);
                continue;
            }
            long src = n + k, dst_row = n + emitted;
            int8_t *fqrow = fwd_q + src * stride;
            memcpy(fqrow + o.fl, r->fwd_q + o.fl, MAX_LEN - o.fl);
            reverse_bytes(fqrow, o.fl, r->fwd_q);
            int8_t *rqrow = rev_q + src * stride;
            memcpy(rqrow + o.rl, r->rev_q + o.rl, MAX_LEN - o.rl);
            reverse_bytes(rqrow, o.rl, r->rev_q);
            if (dst_row != src) {  // compact over skipped records
                memcpy(fwd_nt + dst_row * stride, fwd_nt + src * stride,
                       stride);
                memcpy(fwd_q + dst_row * stride, fqrow, stride);
                memcpy(rev_nt + dst_row * stride, rev_nt + src * stride,
                       stride);
                memcpy(rev_q + dst_row * stride, rqrow, stride);
                if (nt_pack != nullptr)
                    memcpy(nt_pack + dst_row * stride,
                           nt_pack + src * stride, stride);
                flen[dst_row] = flen[src];
                rlen[dst_row] = rlen[src];
                memcpy(ids + dst_row * id_stride, ids + src * id_stride,
                       id_stride);
            }
            emitted++;
        }
        if (prof) p3 += omp_get_wtime() - t;
        n += emitted;
        if (stop || nrec < want) break;  // error / EOF reached
    }
    if (prof && n)
        fprintf(stderr, "[decode] n=%ld p1=%.2fms p2=%.2fms p3=%.2fms\n",
                n, p1 * 1e3, p2 * 1e3, p3 * 1e3);
    return n;
}

}  // namespace

extern "C" {

void *psq_open_pair(const char *fwd_path, const char *rev_path, int qualmin,
                    int policy, const char *index_path) {
    PairReader *r = new PairReader();
    r->qualmin = qualmin;
    r->policy = policy;
    if (!r->fwd.open(fwd_path) || !r->rev.open(rev_path)) {
        delete r;
        return nullptr;
    }
    if (index_path != nullptr && index_path[0] != 0) {
        if (!r->idx.open(index_path)) {
            delete r;
            return nullptr;
        }
        r->has_index = true;
    }
    return r;
}

// Fill up to `batch` pairs. Arrays are [batch, stride] int8 (stride >=
// MAX_LEN); ids is [batch, id_stride] bytes receiving the canonical
// "instrument:run:flowcell:lane:tile:x:y:tag" string. Returns the number
// of pairs produced; sets *error when the stream terminated on a
// malformed record (treated as end-of-stream, assembler.c:356-358).
//
// With rev_layout != 0 the nt/qual rows are written REVERSED and
// left-aligned (row position j holds base len-1-j) — the frame layout
// the v2 device kernel consumes directly (ops/fused2.py). The nt tail
// past the read is zeroed; the QUAL tail keeps the persistent-buffer
// bytes raw (indices >= len), preserving the stale-read PEAR quirk
// (fastq.c:33-36, algo_pear.c:52-54).
// nt_pack (optional, rev_layout only): [batch, stride] bytes carrying
// both reads' 4-bit codes nibble-packed (fwd | rev << 4) — the device
// upload plane (ops/fused2.py ships nt codes at 0.5 byte/base/read).
long psq_next_batch(void *handle, long batch, long stride, int8_t *fwd_nt,
                    int8_t *fwd_q, int8_t *rev_nt, int8_t *rev_q,
                    int32_t *flen, int32_t *rlen, char *ids,
                    long id_stride, int32_t *error, int rev_layout,
                    int8_t *nt_pack) {
    PairReader *r = (PairReader *) handle;
    long n = 0;
    *error = r->error;
    if (r->error) return 0;
    if (rev_layout) {  // production path: OpenMP record-parallel decode
        n = next_batch_parallel(r, batch, stride, fwd_nt, fwd_q, rev_nt,
                                rev_q, flen, rlen, ids, id_stride,
                                nt_pack);
        *error = r->error;
        return n;
    }
    while (n < batch) {
        const char *line = r->fwd.next_line();
        if (line == nullptr) break;  // clean EOF
        SeqId fid, rid;
        bool fdir_known, rdir_known, f17, r17;
        int fdir = seqid_parse(&fid, line + 1, r->policy, &fdir_known,
                               &f17);
        if (fdir == 0) {
            r->error = ERR_BADID;
            break;
        }
        line = r->rev.next_line();
        if (line == nullptr) break;
        int rdir = seqid_parse(&rid, line + 1, r->policy, &rdir_known,
                               &r17);
        if (rdir == 0) {
            r->error = ERR_BADID;
            break;
        }
        if (!fid.equal(rid) || (fdir_known && rdir == fdir)) {
            r->error = ERR_NOTPAIRED;
            break;
        }
        if (f17) r->seen_under_64 = true;
        int fl = read_seq(r->fwd, IUPAC_FWD, r->fwd_nt, r->fwd_q, MAX_LEN,
                          r->qualmin, &r->seen_under_64);
        if (fl < 0) {
            r->error = -fl;
            break;
        }
        int rl = read_seq(r->rev, IUPAC_REV, r->rev_nt, r->rev_q, MAX_LEN,
                          r->qualmin, &r->seen_under_64);
        if (rl < 0) {
            r->error = -rl;
            break;
        }
        if (r->has_index) {  // barcode read becomes the tag (fastq.c:159-188)
            const char *iline = r->idx.next_line();
            if (iline == nullptr) break;
            SeqId iid;
            bool idir_known, i17;
            int idir = seqid_parse(&iid, iline + 1, r->policy, &idir_known,
                                   &i17);
            if (idir == 0) {
                r->error = ERR_BADID;
                break;
            }
            if (!fid.equal(iid)) {
                r->error = ERR_NOTPAIRED;
                break;
            }
            int8_t tag_nt[TAG_LEN], tag_q[TAG_LEN];
            int tl = read_seq(r->idx, IUPAC_FWD, tag_nt, tag_q, TAG_LEN - 1,
                              r->qualmin, &r->seen_under_64);
            if (tl < 0) {
                r->error = -tl;
                break;
            }
            for (int t = 0; t < tl; t++)
                fid.tag[t] = NT_ASCII[tag_nt[t] & 0x0F];
            fid.tag[tl] = 0;
        }
        r->non_empty = true;
        if (fl == 0) continue;  // NODATA: skip record (fastq.c:191)

        {
            int8_t *dst = fwd_nt + n * stride;
            memcpy(dst, r->fwd_nt, MAX_LEN);
            memset(dst + MAX_LEN, 0, stride - MAX_LEN);
            dst = fwd_q + n * stride;
            memcpy(dst, r->fwd_q, MAX_LEN);
            memset(dst + MAX_LEN, 0, stride - MAX_LEN);
            dst = rev_nt + n * stride;
            memcpy(dst, r->rev_nt, MAX_LEN);
            memset(dst + MAX_LEN, 0, stride - MAX_LEN);
            dst = rev_q + n * stride;
            memcpy(dst, r->rev_q, MAX_LEN);
            memset(dst + MAX_LEN, 0, stride - MAX_LEN);
        }
        flen[n] = fl;
        rlen[n] = rl;
        fid.print(ids + n * id_stride, (int) id_stride);
        n++;
    }
    *error = r->error;
    return n;
}

// Advance the stream by one batch's worth of emitted records without
// writing any rows (skip mode of next_batch_parallel) — the mux
// decode-skip for batches another host claimed. Returns the number of
// records a full decode would have emitted; stream errors, flags and
// the persistent quality buffers advance exactly as a full decode.
long psq_skip_batch(void *handle, long batch, int32_t *error) {
    PairReader *r = (PairReader *) handle;
    *error = r->error;
    if (r->error) return 0;
    long n = next_batch_parallel(r, batch, 0, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, nullptr, nullptr, 0,
                                 nullptr);
    *error = r->error;
    return n;
}

int psq_stream_flags(void *handle) {
    PairReader *r = (PairReader *) handle;
    return (r->seen_under_64 ? 1 : 0) | (r->non_empty ? 2 : 0);
}

void psq_close(void *handle) {
    PairReader *r = (PairReader *) handle;
    r->fwd.close();
    r->rev.close();
    r->idx.close();
    delete r;
}

// Exact mean-quality finalization (assembler.c:161-244): per merged base
// the device ships pidx = case*2209 + fq*47 + rq (case|quals provenance);
// the per-algorithm f64 table ptbl maps pidx -> log p. The C reference
// accumulates three region sums (forward copy, overlap, reverse copy) in
// position order and computes (f + r + o) / (len + 1) — reproduced here
// bit-for-bit in one pass, replacing three [B, L2] float64 cumsums.
void psq_quality(const int32_t *seq, long B, long L2, const double *ptbl,
                 const int32_t *seq_len, double *quality) {
    for (long b = 0; b < B; b++) {
        const int32_t *row = seq + b * L2;
        double fsum = 0.0, osum = 0.0, rsum = 0.0;
        for (long j = 0; j < L2; j++) {
            int32_t pidx = row[j] & 0xFFFF;
            int cse = pidx / 2209;
            double p = ptbl[pidx];
            if (cse == 1) fsum += p;
            else if (cse == 2) rsum += p;
            else if (cse >= 3) osum += p;
        }
        quality[b] = (fsum + rsum + osum) / (double) (seq_len[b] + 1);
    }
}

// Primer-location accumulation (offset.c:70-88 hot loop): A[b, s] sums
// the per-base alignment contributions of a primer starting at s, in
// ascending primer-position order — the same f64 accumulation order as
// the reference's circular buffer (and the numpy slice-add fallback).
void psq_primer_align(const int8_t *nt, const double *p, const double *np_,
                      long B, long S, const int8_t *primer, long plen,
                      double *A) {
    for (long b = 0; b < B; b++) {
        const int8_t *ntr = nt + b * S;
        const double *pr = p + b * S;
        const double *npr = np_ + b * S;
        double *Ar = A + b * S;
        for (long s = 0; s < S; s++) Ar[s] = 0.0;
        for (long x = 0; x < plen; x++) {
            int px = primer[x] & 0x0F;
            if (px == 0x0F) continue;  // N contributes nothing
            long W = S - x;
            for (long s = 0; s < W; s++) {
                Ar[s] += (ntr[s + x] & px) ? pr[s + x] : npr[s + x];
            }
        }
    }
}

// Fixed 6-decimal "%f" for v in [0, 1] (the ";quality" suffix,
// output.c:85-126): exact round-to-nearest-even of v*10^6 computed in
// 128-bit integer arithmetic — byte-identical to glibc printf's
// correctly-rounded conversion for this range, ~10x cheaper than
// sprintf in the per-record emit loop. Anything outside [0, 1]
// (never produced by exp(mean log-prob), but kept safe) falls back.
static inline int fmt_f6(char *dst, double v) {
    if (!(v >= 0.0) || v > 1.0) return sprintf(dst, "%f", v);
    uint64_t q;
    if (v == 0.0) {
        q = 0;
    } else {
        int e;
        double f = frexp(v, &e);               // v = f * 2^e, f in [.5,1)
        uint64_t M = (uint64_t) ldexp(f, 53);  // v = M * 2^(e-53)
        int s = 53 - e - 6;  // v*10^6 = (M * 5^6) >> s  (s >= 46 here)
        unsigned __int128 num = (unsigned __int128) M * 15625u;
        if (s >= 128) {
            q = 0;  // num < 2^78 <= 2^(s-1): rounds to zero
        } else {
            unsigned __int128 half = (unsigned __int128) 1 << (s - 1);
            unsigned __int128 rem =
                num & ((((unsigned __int128) 1) << s) - 1);
            q = (uint64_t) (num >> s);
            if (rem > half || (rem == half && (q & 1))) q++;
        }
    }
    uint32_t fp = (uint32_t) (q % 1000000u);
    char *w = dst;
    *w++ = (char) ('0' + (uint32_t) (q / 1000000u));  // 0 or 1
    *w++ = '.';
    for (int k = 5; k >= 0; k--) {
        w[k] = (char) ('0' + fp % 10u);
        fp /= 10u;
    }
    w += 6;
    *w = '\0';
    return (int) (w - dst);
}

// test hook: lets pytest brute-compare fmt_f6 against printf "%f"
void psq_fmt_f6_test(const double *v, long n, char *out, long stride) {
    for (long i = 0; i < n; i++) fmt_f6(out + i * stride, v[i]);
}

// Emit-only pass over arrays produced by psq_finalize(fmt=0): builds
// the FASTA (fmt 1) / FASTQ (fmt 2) payload for rows with emit_mask
// set, in batch order (output.c:85-126). Used by the batched module
// fast path, where python computes the module verdict masks between
// reconstruction and emission. Returns payload length or -1 on
// overflow.
long psq_emit(const uint8_t *ascii, const int16_t *pidx,
              const int32_t *seq_len, const double *quality,
              const uint8_t *emit_mask, long B, long L2cap,
              const char *ids, long id_stride, const uint8_t *phtbl,
              int fmt, uint8_t *payload, long payload_cap) {
    long plen_out = 0;
    for (long b = 0; b < B; b++) {
        if (!emit_mask[b]) continue;
        long n = seq_len[b];
        if (n == 0) continue;  // counted, no bytes (output.c:89-91)
        const char *sid = ids + b * id_stride;
        long sidlen = (long) strlen(sid);
        long need = 1 + sidlen + 1 + 32 + 1 + n + 1
            + (fmt == 2 ? n + 3 : 0);
        if (plen_out + need > payload_cap) return -1;
        uint8_t *w = payload + plen_out;
        *w++ = fmt == 2 ? '@' : '>';
        memcpy(w, sid, sidlen);
        w += sidlen;
        *w++ = ';';
        w += fmt_f6((char *) w, exp(quality[b]));
        *w++ = '\n';
        memcpy(w, ascii + b * L2cap, n);
        w += n;
        if (fmt == 2) {
            *w++ = '\n'; *w++ = '+'; *w++ = '\n';
            const int16_t *pr = pidx + b * L2cap;
            for (long j = 0; j < n; j++)
                *w++ = phtbl[(uint16_t) pr[j]];
        }
        *w++ = '\n';
        plen_out = w - payload;
    }
    return plen_out;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Host finalization v2 (select + reconstruct + quality + emit).
//
// The v2 device kernel (ops/fused2.py) ships only a top-SL shortlist of
// overlap offsets with their exact integer match/mismatch counts; the
// host re-derives every f64 decision the reference makes
// (assembler.c:120-143 selection, 145-248 reconstruction) from those
// integers and the reads it already holds, then emits output bytes —
// the entire O(L) tail of the pipeline in one native pass per batch.
//
// Frames arrive REVERSED and left-aligned (see psq_next_batch): raw
// base x of the forward read lives at row index flen-1-x; the stale
// persistent-buffer qual bytes live raw at indices >= len (PEAR reads
// them, algo_pear.c:52-54).
// ---------------------------------------------------------------------

namespace {

enum AlgoId {
    ALGO_COUNTS = 0,  // simple_bayesian / uparse shape
    ALGO_EA = 1,
    ALGO_FLASH = 2,
    ALGO_STITCH = 3,
    ALGO_PEAR = 4,
    ALGO_RDP = 5,
};

enum CodeId {
    CODE_OK = 0,
    CODE_BADR = 1,
    CODE_MODULE = 2,
    CODE_NOFP = 3,
    CODE_NORP = 4,
    CODE_NOALGN = 5,
    CODE_LOWQ = 6,
};

struct Frames {
    const int8_t *fnt, *fq, *rnt, *rq;
    int flen, rlen;
    // raw-order accessors (x = raw base index)
    inline int fwd_nt(int x) const { return fnt[flen - 1 - x] & 0x0F; }
    inline int rev_nt(int x) const { return rnt[rlen - 1 - x] & 0x0F; }
    inline int fwd_q(int x) const {
        // stale persistent-buffer content lives raw at >= flen
        return x < flen ? fq[flen - 1 - x] : fq[x];
    }
    inline int rev_q(int x) const {
        return x < rlen ? rq[rlen - 1 - x] : rq[x];
    }
};

inline int clamp46(int q) { return q < 0 ? 0 : (q > 46 ? 46 : q); }

// exact f64 overlap score from integer counts (count-based algorithms;
// formulas term-for-term from algo_simple_bayes.c:45-65,
// algo_ea_util.c:49-55, algo_flash.c:52-61, algo_stitch.c:35-56)
double score_from_counts(int algo, double pmatch, double pmismatch,
                         double qual_nn, int flen, int rlen, int o,
                         long m, long mm) {
    long vlo = o - flen > 0 ? o - flen : 0;
    long vhi = o < rlen ? o : rlen;
    long valid = vhi - vlo > 0 ? vhi - vlo : 0;
    long unk = valid - m - mm;
    switch (algo) {
    case ALGO_EA: {
        double bad = (double) (mm + unk);
        if (valid == 0) return HUGE_VAL;  // IEEE x/0 (algo_ea_util.c:55)
        return log((bad * bad + 1.0) / (double) valid);
    }
    case ALGO_FLASH: {
        if (valid == 0) return -2.0;
        long ratio = (mm + unk) / valid;  // size_t division quirk
        return ratio > 0 ? log((double) ratio) : -HUGE_VAL;
    }
    case ALGO_STITCH: {
        uint64_t s = (uint64_t) (int64_t) (m - mm);  // uint64 wrap
        double val = (double) s / (double) (flen + rlen);
        return val > 0 ? log(val) : -HUGE_VAL;
    }
    default: {  // simple_bayesian / uparse
        long nn_count = (o >= flen && o >= rlen)
            ? unk : (long) flen + rlen - 2 * o + unk;
        return qual_nn * (double) nn_count + (double) m * pmatch
            + (double) mm * pmismatch;
    }
    }
}

// exact integer (match, mismatch) counts for one overlap — the host
// twin of the device count planes (ops/fused2.py:plane_counts): N on
// either side excludes the position from both counts (-> unk)
#if defined(__x86_64__)
// lane masks for monotone thresholds: EDGE_FROM[k] sets lanes [k,16),
// EDGE_TO[k] sets lanes [0,k)
static uint8_t EDGE_FROM[17][16], EDGE_TO[17][16];
static struct InitEdges {
    InitEdges() {
        for (int k = 0; k <= 16; k++)
            for (int j = 0; j < 16; j++) {
                EDGE_FROM[k][j] = j >= k ? 0xFF : 0;
                EDGE_TO[k][j] = j < k ? 0xFF : 0;
            }
    }
} init_edges_;

// SIMD body of the overlap-merge reconstruction (assembler.c:180-228)
// for the hole-free prefix [0, n) of the overlap: computes pidx/asc
// planes and the integer degen/mismatch tallies 16 lanes at a time.
// The f64 probability sum is NOT done here — the caller gathers
// ptbl[pidx[i]] serially in ascending order afterwards, so the
// summation order (and every rounding step) stays the reference's.
__attribute__((target("sse4.1")))
static void overlap_merge_simd(
    const int8_t *fnt, const int8_t *fq, const int8_t *rnt,
    const int8_t *rq, long n, long a0 /* fnt/fq idx at i=0, desc */,
    long c0 /* rnt/rq idx at i=0, asc */, long t1 /* i>=t1: fmask */,
    long t2 /* i<=t2: rmask */, int16_t *pidx, uint8_t *asc,
    long &degen, long &ovl_mm, const char *NT_A,
    const int *POPCNT4_) {
    const __m128i low4 = _mm_set1_epi8(0x0F);
    const __m128i rev = _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
                                     11, 12, 13, 14, 15);
    __m128i nta = _mm_loadu_si128((const __m128i *) NT_A);
    int8_t pc4[16];
    for (int j = 0; j < 16; j++) pc4[j] = (int8_t) POPCNT4_[j];
    __m128i pop4 = _mm_loadu_si128((const __m128i *) pc4);
    __m128i acc_d = _mm_setzero_si128(), acc_mm = _mm_setzero_si128();
    long i = 0;
    for (; i + 16 <= n; i += 16) {
        // forward frame reads descend from a0-i; reverse reads ascend
        __m128i fload = _mm_loadu_si128(
            (const __m128i *) (fnt + (a0 - i - 15)));
        __m128i f = _mm_and_si128(_mm_shuffle_epi8(fload, rev), low4);
        __m128i fqv = _mm_shuffle_epi8(
            _mm_loadu_si128((const __m128i *) (fq + (a0 - i - 15))),
            rev);
        __m128i r = _mm_and_si128(
            _mm_loadu_si128((const __m128i *) (rnt + c0 + i)), low4);
        __m128i rqv = _mm_loadu_si128(
            (const __m128i *) (rq + c0 + i));
        __m128i fr = _mm_and_si128(f, r);
        __m128i ismatch = _mm_xor_si128(
            _mm_cmpeq_epi8(fr, _mm_setzero_si128()),
            _mm_set1_epi8((char) 0xFF));
        long kf = t1 - i;
        kf = kf < 0 ? 0 : (kf > 16 ? 16 : kf);
        __m128i fmask = _mm_loadu_si128(
            (const __m128i *) EDGE_FROM[kf]);
        long kr = t2 + 1 - i;
        kr = kr < 0 ? 0 : (kr > 16 ? 16 : kr);
        __m128i rmask = _mm_loadu_si128((const __m128i *) EDGE_TO[kr]);
        // cse: 5 both masked, 6 fwd, 7 rev, else match?3:4
        __m128i cse = _mm_blendv_epi8(_mm_set1_epi8(4),
                                      _mm_set1_epi8(3), ismatch);
        cse = _mm_blendv_epi8(cse, _mm_set1_epi8(7), rmask);
        cse = _mm_blendv_epi8(cse, _mm_set1_epi8(6), fmask);
        cse = _mm_blendv_epi8(cse, _mm_set1_epi8(5),
                              _mm_and_si128(fmask, rmask));
        // nt4: match ? f&r : (fq < rq ? r : f)   (raw-q compare)
        __m128i pick_r = _mm_cmplt_epi8(fqv, rqv);
        __m128i nt4 = _mm_blendv_epi8(_mm_blendv_epi8(f, r, pick_r),
                                      fr, ismatch);
        // clamp46 on quals (already 0..46 from decode; guard anyway)
        __m128i c46 = _mm_set1_epi8(46);
        __m128i fqc = _mm_min_epi8(_mm_max_epi8(fqv,
                                                _mm_setzero_si128()),
                                   c46);
        __m128i rqc = _mm_min_epi8(_mm_max_epi8(rqv,
                                                _mm_setzero_si128()),
                                   c46);
        // pi = cse*2209 + fqc*47 + rqc  (fits int16)
        __m128i z = _mm_setzero_si128();
        __m128i cse_lo = _mm_unpacklo_epi8(cse, z);
        __m128i cse_hi = _mm_unpackhi_epi8(cse, z);
        __m128i fq_lo = _mm_unpacklo_epi8(fqc, z);
        __m128i fq_hi = _mm_unpackhi_epi8(fqc, z);
        __m128i rq_lo = _mm_unpacklo_epi8(rqc, z);
        __m128i rq_hi = _mm_unpackhi_epi8(rqc, z);
        __m128i pi_lo = _mm_add_epi16(
            _mm_add_epi16(
                _mm_mullo_epi16(cse_lo, _mm_set1_epi16(2209)),
                _mm_mullo_epi16(fq_lo, _mm_set1_epi16(47))),
            rq_lo);
        __m128i pi_hi = _mm_add_epi16(
            _mm_add_epi16(
                _mm_mullo_epi16(cse_hi, _mm_set1_epi16(2209)),
                _mm_mullo_epi16(fq_hi, _mm_set1_epi16(47))),
            rq_hi);
        _mm_storeu_si128((__m128i *) (pidx + i), pi_lo);
        _mm_storeu_si128((__m128i *) (pidx + i + 8), pi_hi);
        _mm_storeu_si128((__m128i *) (asc + i),
                         _mm_shuffle_epi8(nta, nt4));
        // degen: POPCNT4[nt4] != 1 ; mismatches: !ismatch
        __m128i isdeg = _mm_xor_si128(
            _mm_cmpeq_epi8(_mm_shuffle_epi8(pop4, nt4),
                           _mm_set1_epi8(1)),
            _mm_set1_epi8((char) 0xFF));
        acc_d = _mm_sub_epi8(acc_d, isdeg);
        acc_mm = _mm_sub_epi8(
            acc_mm, _mm_xor_si128(ismatch, _mm_set1_epi8((char) 0xFF)));
        // 8-bit accumulators saturate after 255 blocks; n <= 2*MAX_LEN
        // = 900 -> at most 57 blocks, safe
    }
    __m128i z = _mm_setzero_si128();
    __m128i sd = _mm_sad_epu8(acc_d, z);
    __m128i sm = _mm_sad_epu8(acc_mm, z);
    degen += _mm_extract_epi16(sd, 0) + _mm_extract_epi16(sd, 4);
    ovl_mm += _mm_extract_epi16(sm, 0) + _mm_extract_epi16(sm, 4);
    // scalar tail for the remaining [i, n)
    for (; i < n; i++) {
        int f = fnt[a0 - i] & 0x0F;
        int r = rnt[c0 + i] & 0x0F;
        bool ismatch = (f & r) != 0;
        if (!ismatch) ovl_mm++;
        bool fmask = i >= t1;
        bool rmask = i <= t2;
        int fqr = fq[a0 - i], rqr = rq[c0 + i];
        int fqc = fqr < 0 ? 0 : (fqr > 46 ? 46 : fqr);
        int rqc = rqr < 0 ? 0 : (rqr > 46 ? 46 : rqr);
        int cse;
        if (fmask && rmask) cse = 5;
        else if (fmask) cse = 6;
        else if (rmask) cse = 7;
        else cse = ismatch ? 3 : 4;
        int nt4 = ismatch ? (f & r) : (fqr < rqr ? r : f);
        pidx[i] = (int16_t) (cse * 2209 + fqc * 47 + rqc);
        asc[i] = (uint8_t) NT_A[nt4];
        if (POPCNT4_[nt4] != 1) degen++;
    }
}

// SIMD body of the unpaired copy regions (assembler.c:162-173 forward,
// :231-243 reverse): pidx = pbase + q*qmul, ascii from the 16-entry NT
// LUT, degen tally. Frame reads either descend from a0 (rev_src, the
// forward frame) or ascend from a0. The f64 sum is gathered serially
// by the caller in ascending order, as in the overlap merge.
__attribute__((target("sse4.1")))
static void unpaired_copy_simd(
    const int8_t *nt, const int8_t *q, long n, bool rev_src, long a0,
    int pbase, int qmul, int16_t *pidx, uint8_t *asc, long &degen,
    const char *NT_A, const int *POPCNT4_) {
    const __m128i low4 = _mm_set1_epi8(0x0F);
    const __m128i rev = _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
                                     11, 12, 13, 14, 15);
    __m128i nta = _mm_loadu_si128((const __m128i *) NT_A);
    int8_t pc4[16];
    for (int j = 0; j < 16; j++) pc4[j] = (int8_t) POPCNT4_[j];
    __m128i pop4 = _mm_loadu_si128((const __m128i *) pc4);
    __m128i acc_d = _mm_setzero_si128();
    const __m128i c46 = _mm_set1_epi8(46);
    long i = 0;
    for (; i + 16 <= n; i += 16) {
        __m128i bits, qv;
        if (rev_src) {
            bits = _mm_shuffle_epi8(
                _mm_loadu_si128((const __m128i *) (nt + a0 - i - 15)),
                rev);
            qv = _mm_shuffle_epi8(
                _mm_loadu_si128((const __m128i *) (q + a0 - i - 15)),
                rev);
        } else {
            bits = _mm_loadu_si128((const __m128i *) (nt + a0 + i));
            qv = _mm_loadu_si128((const __m128i *) (q + a0 + i));
        }
        bits = _mm_and_si128(bits, low4);
        __m128i qc = _mm_min_epi8(
            _mm_max_epi8(qv, _mm_setzero_si128()), c46);
        __m128i z = _mm_setzero_si128();
        __m128i q_lo = _mm_unpacklo_epi8(qc, z);
        __m128i q_hi = _mm_unpackhi_epi8(qc, z);
        __m128i pb = _mm_set1_epi16((int16_t) pbase);
        __m128i qm = _mm_set1_epi16((int16_t) qmul);
        _mm_storeu_si128((__m128i *) (pidx + i),
                         _mm_add_epi16(pb, _mm_mullo_epi16(q_lo, qm)));
        _mm_storeu_si128((__m128i *) (pidx + i + 8),
                         _mm_add_epi16(pb, _mm_mullo_epi16(q_hi, qm)));
        _mm_storeu_si128((__m128i *) (asc + i),
                         _mm_shuffle_epi8(nta, bits));
        __m128i isdeg = _mm_xor_si128(
            _mm_cmpeq_epi8(_mm_shuffle_epi8(pop4, bits),
                           _mm_set1_epi8(1)),
            _mm_set1_epi8((char) 0xFF));
        acc_d = _mm_sub_epi8(acc_d, isdeg);
    }
    __m128i z = _mm_setzero_si128();
    __m128i sd = _mm_sad_epu8(acc_d, z);
    degen += _mm_extract_epi16(sd, 0) + _mm_extract_epi16(sd, 4);
    for (; i < n; i++) {
        int bits = (rev_src ? nt[a0 - i] : nt[a0 + i]) & 0x0F;
        int qr = rev_src ? q[a0 - i] : q[a0 + i];
        int qc = qr < 0 ? 0 : (qr > 46 ? 46 : qr);
        pidx[i] = (int16_t) (pbase + qc * qmul);
        asc[i] = (uint8_t) NT_A[bits];
        if (POPCNT4_[bits] != 1) degen++;
    }
}

// integer-only SIMD match/N tally: in frame coordinates the loop reads
// fnt[o-1-i] (descending) against rnt[i] (ascending), so one operand
// loads reversed. Counts are exact integers — no effect on the f64
// scoring story.
__attribute__((target("sse4.1")))
static void count_pair_simd(const int8_t *fnt, const int8_t *rnt, int o,
                            int lo, int hi, long &mx_out, long &nn_out) {
    const __m128i low4 = _mm_set1_epi8(0x0F);
    const __m128i nnv = _mm_set1_epi8(0x0F);
    const __m128i rev = _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
                                     11, 12, 13, 14, 15);
    __m128i acc_m = _mm_setzero_si128(), acc_n = _mm_setzero_si128();
    int i = lo;
    for (; i + 16 <= hi; i += 16) {
        __m128i rv = _mm_and_si128(
            _mm_loadu_si128((const __m128i *) (rnt + i)), low4);
        __m128i fr = _mm_loadu_si128(
            (const __m128i *) (fnt + (o - i - 16)));
        __m128i fv = _mm_and_si128(_mm_shuffle_epi8(fr, rev), low4);
        __m128i isn = _mm_or_si128(_mm_cmpeq_epi8(fv, nnv),
                                   _mm_cmpeq_epi8(rv, nnv));
        __m128i nomatch = _mm_cmpeq_epi8(_mm_and_si128(fv, rv),
                                         _mm_setzero_si128());
        __m128i match = _mm_andnot_si128(
            _mm_or_si128(nomatch, isn), _mm_set1_epi8((char) 0xFF));
        acc_m = _mm_sub_epi8(acc_m, match);  // 0xFF lane adds 1
        acc_n = _mm_sub_epi8(acc_n, isn);
    }
    __m128i z = _mm_setzero_si128();
    __m128i sm = _mm_sad_epu8(acc_m, z);
    __m128i sn = _mm_sad_epu8(acc_n, z);
    long mx = _mm_extract_epi16(sm, 0) + _mm_extract_epi16(sm, 4);
    long nn = _mm_extract_epi16(sn, 0) + _mm_extract_epi16(sn, 4);
    for (; i < hi; i++) {
        int f = fnt[o - 1 - i] & 0x0F;
        int r = rnt[i] & 0x0F;
        int isn = (f == 0x0F) | (r == 0x0F);
        mx += (((f & r) != 0) & !isn);
        nn += isn;
    }
    mx_out = mx;
    nn_out = nn;
}
#endif

inline void count_pair(const Frames &F, int o, long &m, long &mm) {
    // valid i: findex in [0, flen) and rindex in [0, rlen) reduce to
    // i in [max(0, o-flen), min(o, rlen)); branchless tallies (the
    // match/mismatch branch mispredicts ~half the time on real reads)
    int lo = o - F.flen > 0 ? o - F.flen : 0;
    int hi = o < F.rlen ? o : F.rlen;
    long mx = 0, nn = 0;
#if defined(__x86_64__)
    // frame coords: fwd_nt(flen+i-o) == fnt[o-1-i], rev_nt(rlen-i-1)
    // == rnt[i]; all indices in-bounds by the lo/hi construction
    if (HAVE_SSE41 && hi - lo >= 16) {
        count_pair_simd(F.fnt, F.rnt, o, lo, hi, mx, nn);
        m += mx;
        mm += (hi > lo ? hi - lo : 0) - mx - nn;
        return;
    }
#endif
    for (int i = lo; i < hi; i++) {
        int f = F.fwd_nt(F.flen + i - o);
        int r = F.rev_nt(F.rlen - i - 1);
        int isn = (f == 0x0F) | (r == 0x0F);
        mx += (((f & r) != 0) & !isn);
        nn += isn;
    }
    m += mx;
    mm += (hi > lo ? hi - lo : 0) - mx - nn;
}

// exact sequential f64 LUT sum (pear: algo_pear.c:44-58 incl. the
// both-quals-from-fwd quirk; rdp_mle: algo_rdp_mle.c:58-72)
double score_lut(int algo, const Frames &F, int o, const double *lut_m,
                 const double *lut_mm, double nn_term, double qual_nn) {
    (void) qual_nn;
    double prob = 0.0;
    // same tight bounds as count_pair; the f64 adds stay in ascending
    // i order (the summation order IS the reference's), only the
    // guards and the match/mismatch table pick are branchless
    int lo = o - F.flen > 0 ? o - F.flen : 0;
    int hi = o < F.rlen ? o : F.rlen;
    for (int i = lo; i < hi; i++) {
        int findex = F.flen + i - o;
        int rindex = F.rlen - i - 1;
        int f = F.fwd_nt(findex);
        int r = F.rev_nt(rindex);
        const double *tbl = ((f & r) != 0) ? lut_m : lut_mm;
        if (algo == ALGO_PEAR) {
            int isn = (f == 0x0F) | (r == 0x0F);
            int qa = clamp46(F.fwd_q(findex));
            int qb = clamp46(F.fwd_q(rindex));  // fwd buffer quirk
            prob += isn ? nn_term : tbl[qa * 47 + qb];
        } else {  // rdp_mle: no N special case
            int qa = clamp46(F.fwd_q(findex));
            int qb = clamp46(F.rev_q(rindex));
            // per-element (LUT - qual_nn), algo_rdp_mle.c:64-71 — the
            // caller bakes the subtraction into the tables it passes
            prob += tbl[qa * 47 + qb];
        }
    }
    return prob;
}

}  // namespace

extern "C" {

// Primer location (offset.c:47-90) over a batch of REVERSED frames.
// probs/notprobs are per-QUAL tables (QUAL_SCORE / QUAL_SCORE_ERR);
// the A[s] alignment sums accumulate in ascending primer order — the
// same f64 order as the reference's circular buffer — and the
// check-index scan reproduces computeoffset()'s semantics including
// the exp()/penalty comparison done in full double precision.
// rev_scan scans the sequence back-to-front (offset.c's reverse mode,
// used by pandaseq-hang, hang.c:39-72): raw position seq_len-1-i is
// frame row i, so the reverse scan reads the REVERSED frame forward.
void psq_compute_offsets(const int8_t *nt, const int8_t *q,
                         const int32_t *len, long B, long stride,
                         const int8_t *primer, long plen,
                         double threshold, double penalty,
                         const double *qual_score,
                         const double *qual_score_err, int64_t *out,
                         int rev_scan) {
    double bestpr0 = exp((double) plen * threshold);
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
    double *A = (double *) malloc(sizeof(double) * (size_t) stride);
    // per-read scan-order staging: pr[k]/npr[k] are the match /
    // mismatch log-probs of the base the scan visits k-th, nt4s[k] its
    // code — so the x loop below is branch-predictable vectorizable
    // selects + shifted adds, in the SAME x-ascending f64 summation
    // order as the reference's circular buffer (offset.c:70-88)
    double *pr = (double *) malloc(sizeof(double) * (size_t) stride);
    double *npr = (double *) malloc(sizeof(double) * (size_t) stride);
    int *nt4s = (int *) malloc(sizeof(int) * (size_t) stride);
    // a primer has only a handful of distinct 4-bit codes; V[c][k] is
    // the value primer code c contributes at scan position k, built
    // once per (read, code) so the per-primer-position pass is a pure
    // shifted vector add (auto-vectorizes; selects run D*S not P*S)
    double *V = (double *) malloc(sizeof(double) * 16 * (size_t) stride);
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
    for (long b = 0; b < B; b++) {
        int S = len[b];
        if (plen > S) { out[b] = 0; continue; }
        const int8_t *ntr = nt + b * stride;
        const int8_t *qr = q + b * stride;
        for (int k = 0; k < S; k++) {
            int idx = rev_scan ? k : S - 1 - k;
            int qq = clamp46(qr[idx]);
            pr[k] = qual_score[qq];
            npr[k] = qual_score_err[qq];
            nt4s[k] = ntr[idx] & 0x0F;
        }
        // A[s] = alignment sum for primer start s (raw coords), bases
        // ascending; raw x reads reversed row S-1-x
        for (int s = 0; s < S; s++) A[s] = 0.0;
        int built = 0;
        for (int x = 0; x < plen; x++) {
            int px = primer[x] & 0x0F;
            if (px == 0x0F) continue;  // N contributes nothing
            double *v = V + px * stride;
            if (!(built & (1 << px))) {
                // branchless bitwise select (match/mismatch is ~random
                // per base, so a ternary mispredicts constantly)
                const uint64_t *prb = (const uint64_t *) pr;
                const uint64_t *nprb = (const uint64_t *) npr;
                uint64_t *vb = (uint64_t *) v;
                for (int k = 0; k < S; k++) {
                    uint64_t m = (uint64_t) 0
                        - (uint64_t) ((nt4s[k] & px) != 0);
                    vb[k] = (prb[k] & m) | (nprb[k] & ~m);
                }
                built |= 1 << px;
            }
            const double *vx = v + x;
            int n = S - x;
            for (int s = 0; s < n; s++)
                A[s] += vx[s];
        }
        double bestpr = bestpr0;
        long bestindex = 0;
        if (penalty == 0.0) {
            // exp() is monotone non-decreasing, so the reference's
            // per-index `exp(A/(i+1)) > bestpr` (offset.c:80-86) only
            // needs the exp when the log-domain score makes a new
            // running max: for r <= best_r, exp(r) <= exp(best_r) <=
            // bestpr already. Tracking best_r alongside bestpr keeps
            // the exact f64 comparison semantics (including the case
            // where two distinct r round to the same exp value) while
            // cutting S exp() calls to ~log(S). Indices < plen score
            // 0.0 - 0*penalty = 0, never above exp(plen*threshold) >= 0.
            double best_r = -INFINITY;
            for (int index = (int) plen; index < S; index++) {
                double r = A[index - (int) plen] / (double) (index + 1);
                if (r > best_r) {
                    double e = exp(r);
                    if (e > bestpr) {
                        bestpr = e;
                        bestindex = index + 1;
                    }
                    best_r = r;
                }
            }
        } else {
            for (int index = 0; index < S; index++) {
                int start = index - (int) plen;
                double last_pr;
                if (start < 0) {
                    // circular-buffer slot still -INFINITY: only penalty
                    last_pr = 0.0 - (double) index * penalty;
                } else {
                    last_pr = exp(A[start] / (double) (index + 1))
                        - (double) index * penalty;
                }
                if (last_pr > bestpr) {
                    bestpr = last_pr;
                    bestindex = index + 1;
                }
            }
        }
        out[b] = bestindex;
    }
    free(A);
    free(pr);
    free(npr);
    free(nt4s);
    free(V);
    }
}

// 2-bit k-mer codes (misc.h:41): T=3, G=2, C=1, everything else
// (A/N/degenerate/pad) = 0 — shared by the upload packers and the
// host candidate-mask twin so they can never desynchronize.
static const int8_t K2[16] = {0, 0, 1, 0, 2, 0, 0, 0,
                              3, 0, 0, 0, 0, 0, 0, 0};

#if defined(__x86_64__)
// per-row prep for the candidate-mask twin: cf/cr = 2-bit codes of the
// low nibbles, nf/nr = (nibble != 0x0F) as 0/1 — one vpermb + one
// compare per 64 positions instead of 4 scalar stores per position
__attribute__((target("avx512bw,avx512vbmi")))
static void prep_codes_avx512(const int8_t *fr, const int8_t *rr, int n,
                              int8_t *cf, int8_t *cr, uint8_t *nf,
                              uint8_t *nr) {
    const __m512i k2 = _mm512_broadcast_i32x4(
        _mm_loadu_si128((const __m128i *) K2));
    const __m512i mlo = _mm512_set1_epi8(0x0F);
    const __m512i one = _mm512_set1_epi8(1);
    for (int p = 0; p < n; p += 64) {
        __mmask64 m = p + 64 <= n ? ~0ULL : tailmask64(n - p);
        __m512i f = _mm512_and_si512(_mm512_maskz_loadu_epi8(m, fr + p),
                                     mlo);
        __m512i r = _mm512_and_si512(_mm512_maskz_loadu_epi8(m, rr + p),
                                     mlo);
        _mm512_mask_storeu_epi8(cf + p, m,
                                _mm512_permutexvar_epi8(f, k2));
        _mm512_mask_storeu_epi8(cr + p, m,
                                _mm512_permutexvar_epi8(r, k2));
        _mm512_mask_storeu_epi8(
            nf + p, m, _mm512_maskz_mov_epi8(
                _mm512_cmpneq_epi8_mask(f, mlo), one));
        _mm512_mask_storeu_epi8(
            nr + p, m, _mm512_maskz_mov_epi8(
                _mm512_cmpneq_epi8_mask(r, mlo), one));
    }
}
#else
static void prep_codes_avx512(const int8_t *, const int8_t *, int,
                              int8_t *, int8_t *, uint8_t *, uint8_t *) {}
#endif

// Exact candidate bitmask for selected rows — the host-side twin of
// the device k-mer candidate search (ops/fused2.py:kmer_frames_codes +
// plane_cand; reference semantics assembler.c:91-118, misc.h:32-45).
// Used for rows whose reads contain N: the 4-bit packed upload drops
// the N planes, so the device computes those rows' masks as if N were
// A; this recomputes them exactly. Frames are REVERSED left-aligned
// rows (frame j' = base flen-1-j'); bit o-1 of out (O/32-word rows,
// matching pack_bits16) is set iff some stored forward k-mer at frame
// j' equals an emitted reverse k-mer at frame i with o = j'+i+1.
// faithful != 0 reproduces the reference's kmerseen table LITERALLY,
// including its hardcoded-for-num_kmers==2 occupancy check
// `kmerseen[(KMER << 1) + j]` against stores at
// `kmerseen[KMER * num_kmers + j]` (assembler.c:94-99): for -k >= 3
// the check reads other k-mers' slots (in bounds, deterministic), so
// k-mers get dropped/overwritten in a pattern the spec-style rank
// logic cannot express. (-k 1 makes the same check read PAST the
// table — real UB — and is not reproducible; see PARITY.md.)
void psq_cand_mask(const int8_t *fr_nt, const int8_t *rr_nt,
                   const int32_t *flen_a, const int32_t *rlen_a,
                   long stride, const int64_t *rows, long nrows,
                   int num_kmers, long O, int32_t *out, int faithful) {
    const long W = O / 32;
    const int KM = 8;
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
    // kmerseen twin: per-kmer emission count + first num_kmers stored
    // frame positions (in RAW ascending order = frame descending),
    // epoch-versioned so each row costs O(L), not O(4^8). thread_local
    // so repeat calls skip the ~0.4 MB/thread allocation + zeroing.
    static thread_local std::vector<uint32_t> epoch;
    static thread_local std::vector<uint16_t> cnt;
    static thread_local std::vector<int16_t> stored;
    static thread_local std::vector<int8_t> cf, cr;
    static thread_local std::vector<uint8_t> nf, nr;
    static thread_local uint32_t ep = 0;
    if (epoch.size() < (size_t) (1 << 16)) {
        epoch.assign(1 << 16, 0);
        cnt.assign(1 << 16, 0);
        ep = 0;
    }
    size_t need = (size_t) (1 << 16) * (num_kmers > 0 ? num_kmers : 1);
    if (stored.size() < need) stored.resize(need);
    static thread_local std::vector<uint16_t> tab;
    static thread_local std::vector<size_t> touched;
    // the faithful check indexes up to (0xFFFF<<1)+num_kmers-1; pad so
    // a (disallowed, python-side-guarded) num_kmers<2 call can't read
    // past our own vector
    size_t tneed = need > (size_t) 131072 + num_kmers
        ? need : (size_t) 131072 + num_kmers;
    if (faithful && tab.size() < tneed) tab.assign(tneed, 0);
    if (cf.size() < (size_t) stride) {
        cf.resize(stride); cr.resize(stride);
        nf.resize(stride); nr.resize(stride);
    }
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
    for (long ri = 0; ri < nrows; ri++) {
        long b = rows[ri];
        int32_t *obits = out + ri * W;
        memset(obits, 0, (size_t) W * 4);
        if (num_kmers <= 0) continue;  // -k 0: no candidates
        ep++;
        int FL = flen_a[b], RL = rlen_a[b];
        const int8_t *fr = fr_nt + b * stride;
        const int8_t *rr = rr_nt + b * stride;
        if (HAVE_AVX512) {
            prep_codes_avx512(fr, rr, (int) stride, cf.data(), cr.data(),
                              nf.data(), nr.data());
        } else {
            for (int p = 0; p < stride; p++) {
                int f = fr[p] & 0x0F, r = rr[p] & 0x0F;
                cf[p] = K2[f];
                cr[p] = K2[r];
                nf[p] = f != 0x0F;  // pads (0) read as non-N
                nr[p] = r != 0x0F;
            }
        }
        // forward: emit at frame j' when j' <= FL-9 and the 9-window
        // j'..j'+8 is non-N; visit j' DESCENDING (raw ascending) so
        // "first num_kmers in raw order" is a running count
        int jmax = FL - 9;
        if (jmax >= 0) {
            int run = 0;  // consecutive non-N at j' and above
            // seed run for positions > jmax (window extends to j'+8)
            for (int p = (jmax + KM < stride ? jmax + KM : stride - 1);
                 p > jmax; p--)
                run = nf[p] ? run + 1 : 0;
            // rolling window kv(j) = sum_t cf[j+t] << 2t, maintained
            // with one shift+or as j descends; seed the t=1..7 terms
            int kvr = 0;
            for (int t = KM - 1; t >= 1; t--)
                kvr = (kvr << 2) | (int) cf[jmax + t];
            for (int j = jmax; j >= 0; j--) {
                run = nf[j] ? run + 1 : 0;
                int kv = ((kvr << 2) | (int) cf[j]) & 0xFFFF;
                kvr = kv;
                if (run < KM + 1) continue;
                if (faithful) {
                    // literal store: occupancy judged at (kv<<1)+j2
                    // (the reference's bug), store at kv*num_kmers+j2
                    int j2;
                    for (j2 = 0; j2 < num_kmers
                         && tab[((size_t) kv << 1) + j2] != 0; j2++) ;
                    if (j2 < num_kmers) {  // else: LOST_KMER
                        size_t si = (size_t) kv * num_kmers + j2;
                        if (tab[si] == 0) touched.push_back(si);
                        // KMER_POSITION: raw fp = FL-1-j (>= 8, so
                        // nonzero in the emptiness-by-zero scheme)
                        tab[si] = (uint16_t) (FL - 1 - j);
                    }
                    continue;
                }
                if (epoch[kv] != ep) {
                    epoch[kv] = ep;
                    cnt[kv] = 0;
                }
                if (cnt[kv] < num_kmers)
                    stored[(size_t) kv * num_kmers + cnt[kv]] =
                        (int16_t) j;
                cnt[kv]++;
            }
        }
        // reverse: emit at frame i when i >= 8, i < RL, window i-8..i
        // non-N; probe stored forward positions
        int run = 0;
        int ihi = RL < stride ? RL : stride;
        // rolling kv(i) = sum_t cr[i-t] << 2t as i ascends
        int kvr2 = 0;
        for (int i = 0; i < ihi; i++) {
            run = nr[i] ? run + 1 : 0;
            int kv = ((kvr2 << 2) | (int) cr[i]) & 0xFFFF;
            kvr2 = kv;
            if (i < KM || run < KM + 1) continue;
            if (faithful) {
                for (int s = 0; s < num_kmers; s++) {
                    uint16_t fp = tab[(size_t) kv * num_kmers + s];
                    if (fp == 0) break;  // probe stops at first empty
                    long d = (long) (FL - 1 - (int) fp) + i;
                    if (d >= 0 && d < O)
                        obits[d >> 5] |= (int32_t) (1u << (d & 31));
                }
                continue;
            }
            if (epoch[kv] != ep) continue;
            int ns = cnt[kv] < num_kmers ? cnt[kv] : num_kmers;
            for (int s = 0; s < ns; s++) {
                long d = (long) stored[(size_t) kv * num_kmers + s] + i;
                if (d < O)
                    obits[d >> 5] |= (int32_t) (1u << (d & 31));
            }
        }
        if (faithful) {
            for (size_t si : touched) tab[si] = 0;
            touched.clear();
        }
    }
    }
}

// pear_test verdicts (plugin_pear_test.c:18-41) for n selected rows.
// T is the lazily-built cumulative binomial table T[i, l] (stride
// Tstride doubles per row) whose rows [min o, max hi) the caller has
// populated; o/mm/hi are per-row overlap, overlap mismatches and
// min(flen, rlen). Verdict: cutoff > 1 - product^2 with
// product = prod_{i=o}^{hi-1} T[i, clamp(ceil((oes-beta*i)/
// (alpha-beta))-1, 0, i)], the exact f64 ascending-i product of the
// plugin loop. Factors live in [0, 1] (up to f64 rounding), so once
// the running product falls a safe margin below sqrt(1-cutoff) the
// verdict is reject no matter what follows — the loop exits early
// without changing any result.
void psq_pear_test(const double *T, long Tstride, const int64_t *o,
                   const int64_t *mm, const int64_t *hi, long n,
                   double alpha, double beta, double cutoff,
                   uint8_t *out) {
    // early-exit bound: final <= running * (1 + k*eps)^rest; margin
    // 1e-9 dwarfs that growth for any rest <= 2*MAX_LEN
    double lim = (cutoff < 1.0) ? sqrt(1.0 - cutoff) * (1.0 - 1e-9)
                                : -1.0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long r = 0; r < n; r++) {
        double oes = alpha * (double) (o[r] - mm[r])
            + beta * (double) mm[r];
        double product = 1.0;
        for (int64_t i = o[r]; i < hi[r]; i++) {
            double lf = ceil((oes - beta * (double) i)
                             / (alpha - beta));
            int64_t l = (int64_t) lf - 1;
            if (l < 0) l = 0;
            if (l > i) l = i;
            product *= T[i * Tstride + l];
            if (product < lim) break;
        }
        out[r] = cutoff > 1.0 - product * product;
    }
}

// 4-bit packed upload: [fwd2 | rev2] 2-bit k-mer code planes only
// (128 B/pair at Lb=256) — the N planes stay home; hasN[b] flags rows
// containing any N so the caller can recompute their candidate masks
// exactly with psq_cand_mask (the device treats N as A for them).
void psq_pack4(const int8_t *nt_pack, long B, long stride, long Lb,
               int8_t *out, uint8_t *hasN) {
    long q = Lb / 4, W = 2 * q;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (long b = 0; b < B; b++) {
        const uint8_t *src = (const uint8_t *) nt_pack + b * stride;
        uint8_t *dst = (uint8_t *) out + b * W;
        memset(dst, 0, (size_t) W);
        uint8_t *f2 = dst, *r2 = dst + q;
        uint8_t any15 = 0;
        for (int t = 0; t < 4; t++) {
            const uint8_t *s = src + t * q;
            for (long k = 0; k < q; k++) {
                uint8_t v = s[k];
                f2[k] |= (uint8_t) (K2[v & 0x0F] << (2 * t));
                r2[k] |= (uint8_t) (K2[v >> 4] << (2 * t));
                any15 |= (uint8_t) (((v & 0x0F) == 0x0F)
                                    | ((v >> 4) == 0x0F));
            }
        }
        hasN[b] = any15;
    }
}

// Batch finalization. plane is the device shortlist [B, W] int32 with
// W = 2*SL + 4 (see ops/fused2.py). fmt: 0 = arrays only (general
// path), 1 = FASTA payload, 2 = FASTQ payload. Returns payload length
// (0 when fmt == 0), or -1 if payload_cap would overflow.
long psq_finalize(
    const int8_t *fr_nt, const int8_t *fr_q, const int8_t *rr_nt,
    const int8_t *rr_q, const int32_t *flen_a, const int32_t *rlen_a,
    const int32_t *fo_a, const int32_t *ro_a, const uint8_t *skip,
    long B, long stride, const int32_t *plane, long W, long SL,
    int plane_kind,
    const uint8_t *fb_mask, const int32_t *fb_besto,
    const uint8_t *fb_aligned, const double *fb_best,
    int algo_id, double pmatch, double pmismatch, double qual_nn,
    double nn_term, const double *lut_m, const double *lut_mm,
    int minoverlap, int maxoverlap_cfg, double threshold,
    const double *ptbl, const uint8_t *phtbl,
    int fmt, const char *ids, long id_stride,
    uint8_t *codes, int32_t *osc, double *oqual, double *obest,
    uint8_t *ascii_out, int16_t *pidx_out, long L2cap,
    uint8_t *payload, long payload_cap,
    int64_t *counters, int64_t *hist, long hist_cap) {
    // counters layout: [ok, lowq, noalgn, badread, nofp, norp, slow]
    // the per-pair shortlist staging below uses fixed 32-entry stack
    // buffers (long oo/mv/mmv[32]); reject a wider shortlist outright
    // rather than overflow them (BatchAssembler.SL is 8 today and
    // asserts the same bound on the Python side)
    if (SL > 32)
        return -1;
    long plen_out = 0;
    const char NT_A[17] = "NACMGRSVTWYHKDBN";
    static const int POPCNT4[16] = {0, 1, 1, 2, 1, 2, 2, 3,
                                    1, 2, 2, 3, 2, 3, 3, 4};
    // counter/hist bumps are atomic: both the fmt==0 and the fmt>0
    // driver loops below run the pair bodies OpenMP-parallel
    auto bump = [](int64_t &x) {
#ifdef _OPENMP
#pragma omp atomic
#endif
        x++;
    };
    // per-pair body; returns payload bytes written (fmt > 0) or 0;
    // -1 on payload overflow.
    auto do_pair = [&](long b, uint8_t *pay, long pay_cap) -> long {
        int16_t pidx_buf_local[2 * MAX_LEN + 8];
        uint8_t ascii_buf_local[2 * MAX_LEN + 8];
        int32_t *oscr = osc + b * 6;
        oscr[0] = 0; oscr[1] = 0; oscr[2] = 0; oscr[3] = 0;
        oscr[4] = 0; oscr[5] = 0;
        oqual[b] = 0.0;
        obest[b] = 0.0;
        int sk = skip[b];
        if (sk) {
            switch (sk) {
            case 1: case 3:
                codes[b] = CODE_BADR;
                if (fmt) bump(counters[3]);
                break;
            case 2: codes[b] = CODE_MODULE; break;
            case 4:
                codes[b] = CODE_NOFP;
                if (fmt) bump(counters[4]);
                break;
            case 5:
                codes[b] = CODE_NORP;
                if (fmt) bump(counters[5]);
                break;
            default:
                codes[b] = CODE_NOALGN;  // negs (assembler.c:124,150)
                if (fmt) bump(counters[2]);
                break;
            }
            return 0;
        }
        Frames F{fr_nt + b * stride, fr_q + b * stride,
                 rr_nt + b * stride, rr_q + b * stride,
                 flen_a[b], rlen_a[b]};
        int fo = fo_a[b], ro = ro_a[b];
        const int32_t *row = plane + b * W;
        long maxo = (long) F.flen + F.rlen - minoverlap - fo - ro - 1;
        if (maxoverlap_cfg == 0) {
            // REPLACE, not min: the reference discards the
            // offset-derived bound when maxoverlap is 0
            // (assembler.c:78-82) — deep primer offsets still score
            // large overlaps and then fail the post-align len check
            maxo = F.flen < F.rlen ? F.flen : F.rlen;
        } else if (maxo > maxoverlap_cfg) {
            maxo = maxoverlap_cfg;
        }
        // plane_kind 1: candidate bitmask (W 32-bit words over offsets
        // 1..32W; ops/fused2.py:assemble_candidates_nt) — apply the
        // range rules + ALL_BITS_IF_NONE here (assembler.c:42,84-118)
        long cand_hi = maxo < W * 32 ? maxo : W * 32;
        long cand_lo = minoverlap > 1 ? minoverlap : 1;
        auto cand = [&](long o) {
            long k = o - 1;
            return ((((uint32_t) row[k >> 5]) >> (k & 31)) & 1) != 0;
        };
        bool cand_any = false;
        long examined;
        if (plane_kind == 1) {
            examined = 0;
            for (long o = cand_lo; o <= cand_hi; o++)
                if (cand(o)) { cand_any = true; examined++; }
            if (!cand_any)
                examined = cand_hi - cand_lo + 1 > 0
                    ? cand_hi - cand_lo + 1 : 0;
        } else {
            examined = row[2 * SL + 1];
        }
        // slow: every overlap in range examined (assembler.c:136)
        bool slow = examined == maxo - minoverlap + 1;
        if (slow) {
            oscr[5] |= 2;
            if (fmt) bump(counters[6]);
        }
        oscr[4] = (int32_t) examined;

        // ---- selection: exact f64 first-strict-max over the
        // shortlist, ascending o (assembler.c:125-134) ----
        double floorv = qual_nn * (double) (F.flen + F.rlen);
        double best = floorv;
        long besto = -1;
        if (fb_mask[b]) {
            if (fb_aligned[b]) {
                besto = fb_besto[b];
                best = fb_best[b];
            }
        } else if (plane_kind == 1) {
            // exact f64 first-strict-max over the candidate offsets,
            // ascending o — the reference loop itself
            // (assembler.c:125-134), no shortlist/band indirection
            for (long o = cand_lo; o <= cand_hi; o++) {
                if (cand_any && !cand(o)) continue;
                double pr;
                if (algo_id == ALGO_PEAR || algo_id == ALGO_RDP) {
                    pr = score_lut(algo_id, F, (int) o, lut_m,
                                   lut_mm, nn_term, qual_nn);
                } else {
                    long m = 0, mm = 0;
                    count_pair(F, (int) o, m, mm);
                    pr = score_from_counts(algo_id, pmatch, pmismatch,
                                           qual_nn, F.flen, F.rlen,
                                           (int) o, m, mm);
                }
                if (pr > best) {
                    best = pr;
                    besto = o;
                }
            }
        } else {
            // collect (o, m, mm), sort ascending o (<= SL entries)
            int n = 0;
            long oo[32], mv[32], mmv[32];
            for (long s = 0; s < SL; s++) {
                int32_t p = row[s];
                if (p == 0) continue;
                oo[n] = p & 0x3FF;
                mv[n] = (p >> 10) & 0x3FF;
                mmv[n] = (p >> 20) & 0x3FF;
                n++;
            }
            for (int i2 = 1; i2 < n; i2++) {  // insertion sort by o
                long ko = oo[i2], km = mv[i2], km2 = mmv[i2];
                int j2 = i2 - 1;
                while (j2 >= 0 && oo[j2] > ko) {
                    oo[j2 + 1] = oo[j2]; mv[j2 + 1] = mv[j2];
                    mmv[j2 + 1] = mmv[j2]; j2--;
                }
                oo[j2 + 1] = ko; mv[j2 + 1] = km; mmv[j2 + 1] = km2;
            }
            for (int s = 0; s < n; s++) {
                double pr;
                if (algo_id == ALGO_PEAR || algo_id == ALGO_RDP)
                    pr = score_lut(algo_id, F, (int) oo[s], lut_m,
                                   lut_mm, nn_term, qual_nn);
                else
                    pr = score_from_counts(algo_id, pmatch, pmismatch,
                                           qual_nn, F.flen, F.rlen,
                                           (int) oo[s], mv[s], mmv[s]);
                if (pr > best && oo[s] >= minoverlap) {
                    best = pr;
                    besto = oo[s];
                }
            }
        }
        // BESTOLP is logged for every align-attempted pair BEFORE the
        // bestoverlap == -1 / length-check returns (assembler.c:139),
        // so the scored bit + best overlap (may be -1) are recorded
        // here, not after the early-outs
        oscr[0] = (int32_t) besto;
        oscr[5] |= 1;  // scored (align ran; BESTOLP line due)
        if (besto == -1) {
            codes[b] = CODE_NOALGN;
            if (fmt) bump(counters[2]);
            return 0;
        }
        long length = (long) F.flen - fo - besto + F.rlen - ro + 1;
        if (length <= 0 || length > 2 * MAX_LEN) {
            // NEGS / OOM both surface as NOALGN (assembler.c:293-299)
            codes[b] = CODE_NOALGN;
            if (fmt) bump(counters[2]);
            return 0;
        }
        obest[b] = best;

        // ---- reconstruction (assembler.c:145-248) ----
        long df = F.flen - fo - besto;
        long dr = F.rlen - ro - besto;
        long veez_df = df > 0 ? df : 0;
        long wedge_df = df < 0 ? df : 0;
        long wedge_dr = dr < 0 ? dr : 0;
        long seq_len = length - 1;
        int16_t *pidx = pidx_out ? pidx_out + b * L2cap : pidx_buf_local;
        uint8_t *asc = ascii_out ? ascii_out + b * L2cap
                                 : ascii_buf_local;
        long degen = 0, ovl_mm = 0;
        double fsum = 0.0, osum = 0.0, rsum = 0.0;
        // unpaired forward copy (assembler.c:162-173)
#if defined(__x86_64__)
        if (HAVE_SSE41 && veez_df >= 16) {
            unpaired_copy_simd(F.fnt, F.fq, veez_df, true,
                               (long) F.flen - 1 - fo, 2209, 47, pidx,
                               asc, degen, NT_A, POPCNT4);
            for (long i = 0; i < veez_df; i++)
                fsum += ptbl[pidx[i]];
        } else
#endif
        for (long i = 0; i < veez_df; i++) {
            long findex = i + fo;
            int fbits = F.fwd_nt((int) findex);
            int fq = clamp46(F.fwd_q((int) findex));
            pidx[i] = (int16_t) (1 * 2209 + fq * 47);
            asc[i] = (uint8_t) NT_A[fbits];
            fsum += ptbl[1 * 2209 + fq * 47];
            if (POPCNT4[fbits] != 1) degen++;
        }
        // B-cliff unmasked lengths (assembler.c:176-177); reversed
        // frame: trailing q==2 run is a LEADING run here
        int uf = F.flen, ur = F.rlen;
        {
            const int8_t *p = F.fq;
            int k = 0;
            while (uf > 0 && p[k] == 2) { uf--; k++; }
            const int8_t *p2 = F.rq;
            k = 0;
            while (ur > 0 && p2[k] == 2) { ur--; k++; }
        }
        // overlap merge (assembler.c:180-228). The hole-free prefix
        // (holes — out-of-frame indices — only appear at the tail, as
        // both hole conditions are monotone in i) runs SIMD; the f64
        // osum is then gathered serially in the same ascending order,
        // so every rounding step matches the scalar loop. The scalar
        // loop below finishes from i0 (tail + non-SSE fallback).
        long ovl_n = besto + wedge_df + wedge_dr;
        long i0 = 0;
#if defined(__x86_64__)
        if (HAVE_SSE41) {
            long holefree = ovl_n;
            long fx = (long) F.flen - fo - veez_df;   // i>=fx: fwd OOB
            long rx = (long) F.rlen + wedge_df;       // i>=rx: rev OOB
            if (fx < holefree) holefree = fx;
            if (rx < holefree) holefree = rx;
            if (holefree >= 16) {
                overlap_merge_simd(
                    F.fnt, F.fq, F.rnt, F.rq, holefree,
                    (long) F.flen - 1 - fo - veez_df, -wedge_df,
                    (long) uf - fo - veez_df,
                    (long) F.rlen - 1 + wedge_df - (long) ur,
                    pidx + veez_df, asc + veez_df, degen, ovl_mm,
                    NT_A, POPCNT4);
                for (long i = 0; i < holefree; i++)
                    osum += ptbl[pidx[veez_df + i]];
                i0 = holefree;
            }
        }
#endif
        for (long i = i0; i < ovl_n; i++) {
            long index = veez_df + i;
            long findex = fo + veez_df + i;
            long rindex = F.rlen - i - 1 + wedge_df;
            if (index < 0 || findex < 0 || rindex < 0
                || findex >= F.flen || rindex >= F.rlen) {
                // hole: nt 0 ('N'), p 0.0, no quality contribution
                pidx[index] = 0;
                asc[index] = (uint8_t) NT_A[0];
                continue;
            }
            int f = F.fwd_nt((int) findex);
            int r = F.rev_nt((int) rindex);
            bool ismatch = (f & r) != 0;
            if (!ismatch) ovl_mm++;
            bool fmask = findex >= uf;
            bool rmask = rindex >= ur;
            int fq = clamp46(F.fwd_q((int) findex));
            int rq = clamp46(F.rev_q((int) rindex));
            int cse;
            if (fmask && rmask) cse = 5;
            else if (fmask) cse = 6;
            else if (rmask) cse = 7;
            else cse = ismatch ? 3 : 4;
            int nt4 = ismatch
                ? (f & r)
                : (F.fwd_q((int) findex) < F.rev_q((int) rindex) ? r
                                                                 : f);
            int pi = cse * 2209 + fq * 47 + rq;
            pidx[index] = (int16_t) pi;
            asc[index] = (uint8_t) NT_A[nt4];
            osum += ptbl[pi];
            if (POPCNT4[nt4] != 1) degen++;
        }
        // unpaired reverse copy (assembler.c:231-243)
        long dr_n = dr > 0 ? dr : 0;
#if defined(__x86_64__)
        if (HAVE_SSE41 && dr_n >= 16) {
            unpaired_copy_simd(F.rnt, F.rq, dr_n, false, besto,
                               2 * 2209, 1, pidx + df + besto,
                               asc + df + besto, degen, NT_A, POPCNT4);
            for (long i = 0; i < dr_n; i++)
                rsum += ptbl[pidx[df + besto + i]];
        } else
#endif
        for (long i = 0; i < dr_n; i++) {
            long index = df + besto + i;
            long rindex = F.rlen - besto - i - 1;
            int rbits = F.rev_nt((int) rindex);
            int rq = clamp46(F.rev_q((int) rindex));
            pidx[index] = (int16_t) (2 * 2209 + rq);
            asc[index] = (uint8_t) NT_A[rbits];
            rsum += ptbl[2 * 2209 + rq];
            if (POPCNT4[rbits] != 1) degen++;
        }
        double quality = (fsum + rsum + osum) / (double) length;
        oqual[b] = quality;
        oscr[1] = (int32_t) seq_len;
        oscr[2] = (int32_t) degen;
        oscr[3] = (int32_t) ovl_mm;
        if (fmt == 0) {
            codes[b] = CODE_OK;  // caller applies threshold/modules
            return 0;
        }
        if (quality < threshold) {
            codes[b] = CODE_LOWQ;
            bump(counters[1]);
            return 0;
        }
        codes[b] = CODE_OK;
        bump(counters[0]);
        if (besto >= 0 && besto < hist_cap) bump(hist[besto]);
        if (seq_len == 0) return 0;  // counted, no bytes (output.c:89-91)
        // ---- emit (output.c:64-112 fast path) ----
        const char *sid = ids + b * id_stride;
        long sidlen = (long) strlen(sid);
        long need = 1 + sidlen + 1 + 32 + 1 + seq_len + 1
            + (fmt == 2 ? seq_len + 3 : 0);
        if (need > pay_cap) return -1;
        uint8_t *w = pay;
        *w++ = fmt == 2 ? '@' : '>';
        memcpy(w, sid, sidlen);
        w += sidlen;
        *w++ = ';';
        w += fmt_f6((char *) w, exp(quality));
        *w++ = '\n';
        memcpy(w, asc, seq_len);
        w += seq_len;
        if (fmt == 2) {
            *w++ = '\n'; *w++ = '+'; *w++ = '\n';
            for (long j = 0; j < seq_len; j++)
                *w++ = phtbl[(uint16_t) pidx[j]];
        }
        *w++ = '\n';
        return w - pay;
    };
    if (fmt == 0) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
        for (long b = 0; b < B; b++) do_pair(b, nullptr, 0);
    } else {
        // parallel selection/score/reconstruct/format into per-pair
        // slots, then one serial compaction — the payload byte order
        // stays the input order (the single-writer contract,
        // writer.c's committed-transaction ordering), but the f64
        // scoring loops (pear/rdp candidates) spread across cores
        long slot = 1 + id_stride + 1 + 32 + 1 + L2cap + 1
            + (fmt == 2 ? L2cap + 3 : 0);
        // persistent per-thread scratch: a fresh ~19 MB malloc per
        // batch is an mmap + page-fault cycle inside the finalize wall
        // (same lesson as the decode ring buffers)
        static thread_local std::vector<uint8_t> scratch_tls;
        static thread_local std::vector<long> wr_tls;
        if ((long) scratch_tls.size() < B * slot)
            scratch_tls.resize((size_t) (B * slot));
        if ((long) wr_tls.size() < B) wr_tls.resize((size_t) B);
        uint8_t *scratch = scratch_tls.data();
        long *wr = wr_tls.data();
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
        for (long b = 0; b < B; b++)
            wr[b] = do_pair(b, scratch + b * slot, slot);
        for (long b = 0; b < B; b++) {
            if (wr[b] < 0 || plen_out + wr[b] > payload_cap) {
                plen_out = -1;
                break;
            }
            memcpy(payload + plen_out, scratch + b * slot,
                   (size_t) wr[b]);
            plen_out += wr[b];
        }
    }
    return plen_out;
}

}  // extern "C"
