// lut_sums: the f32 per-diagonal LUT score sums of pear and rdp_mle, by
// hand for Hopper (sm_90a).
//
// Replaces pandaseq_tpu/ops/fused2.py:lut_plane_sums (:218-264, K7),
// which the TPU computes as two one-hot matmuls against the 47x47 tables
// (giving a [B, Oj, O] f32 term plane) reduced against the diagonal
// indicator in a HIGHEST-precision dot_general on the matrix unit. Plain
// twin: pandaseq_tpu_torch/ops/fused2.py plain_lut_sums.
//
// For pair b and diagonal t < O, over plane rows j in [j0, jend) with
// j <= t (forward frame row j, reverse frame row i = t - j):
//   term = 0                   if f or r is a pad (nibble 0)
//        = nn_term             (pear only) if f or r is N (0x0F)
//        = Tm[qf][q2]          if f & r != 0 (rdp_mle: N matches all)
//        = Tmm[qf][q2]         otherwise
// with qf = clip(fq[j], 0, 46) and q2 = clip(rq[i], 0, 46) for rdp_mle,
// or for pear clip(fq[idx], 0, 46), idx = clip(x < flen ? flen-1-x : x,
// 0, ld-1), x = rlen-1-i: pear reads both quals from the forward buffer,
// its stale tail past flen included (algo_pear.c:52-54). f / r are the
// low / high nibbles of nt [B, ld] int8 (bytes unsigned), fq / rq [B, ld]
// int8 (signed). Output [B, O] f32.
//
// Exactness: each diagonal is summed by one thread in ascending j, one
// __fadd_rn at a time from +0.0, which nvcc never reorders or contracts;
// the twin adds row by row in the same order, so the two agree bit for
// bit on the card. Adding a term of +0.0 changes nothing: the sum starts
// at +0.0 and under round-to-nearest never becomes -0.0, and x + (+0.0)
// == x for every other x. There are no multiplies: the one-hot matmuls
// of the TPU become table gathers from shared memory.
//
// What bounds it on this card: a pair moves ~3 B per position in and 4*O
// bytes out, so device memory is not the limit; the function needs one
// f32 add per cell (O^2/2 cells a pair), but each cell is a gather from a
// 47x47 table chosen by a data-dependent match bit. The first design (one
// thread per diagonal, PR 3) issued five shared-memory loads and three
// selects per cell and ran at ~4 cells per clock per SM, 3% of the
// f32-add bound. This design:
// 1. builds one word per position per pair, once, at load: forward
//    fw[j] = table row (qf; pear's N row; the zero row for a pad and for
//    rows outside [j0, jend)) | f << 8 | f << 24; reverse rv[i] = 4 *
//    column (perm(q2), the pad column, or pear's N column) | r << 8, 16
//    bits. pear's stale-tail gather happens here;
// 2. keeps both tables in one static shared array [row][half][col],
//    half 0 the match table, 1 the mismatch table, with a reverse-pad
//    column and a zero row of +0.0 and, for pear, an N row and an N
//    column of nn_term; the columns are the quals with 2 and 10 swapped,
//    so that the common quals 2 and 11-41 sit in 32 different banks of a
//    row;
// 3. register-blocks diagonals: a thread owns R consecutive diagonals
//    [t0, t0+R) and walks j upward R rows at a time. The reverse words of
//    its R diagonals are a window of 2R registers, refilled with one
//    vector load per R rows, and the R forward words come in one vector
//    load. A cell is then a match test (one 3-input logic operation on
//    the window word and fw), a select of the half's row offset, an
//    address add, ONE table load and the f32 add (5 instructions, no
//    select chain). Cells past j = t read the pad entries before position
//    0 (+0.0), so the triangle's edge needs no predicate;
// 4. balances the triangle without idle lanes: thread u owns the blocks
//    A at t0 = R*u and B at t0 = O-R*(u+1) and walks them as ONE run of
//    O/R + 1 steps, A then B, so every lane of a warp runs the same
//    count. (Walking A and B as two loops leaves lanes idle: a warp
//    waits for its longest A, then for its longest B.) In A the
//    lanes of a pair share the row j (a broadcast); in B, whose t0 falls
//    as u rises, they share the reverse row i.
// What is left is the table gather: lanes that read different entries in
// one bank wait for each other, and nothing short of a copy of the table
// per lane avoids that.
// R is 4 below O = 512 and 8 from there, so that at O = 256 and 512 a
// warp holds one pair. A block holds THREADS / (O/2R) pairs (at most
// MAX_PAIRS): 19.2 KB of tables and 6 bytes a position a pair, under 48
// KB of shared memory at every O.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NQ = 47;  // quals 0..46
constexpr int THREADS = 256;
constexpr int MAX_PAIRS = 32;
constexpr int KIND_PEAR = 0;  // 1: rdp_mle (ops/dense.py LUT_KINDS)
// the table [row][half][col]: rows 0..46 the forward quals, ROW_N a
// forward N (pear), ROW_ZERO a forward pad or a row outside [j0, jend)
// (all +0.0); columns perm(q2), COL_PAD a reverse pad (+0.0), COL_N a
// reverse N (pear)
constexpr int ROW_N = NQ;
constexpr int ROW_ZERO = NQ + 1;
constexpr int COL_PAD = NQ;
constexpr int COL_N = NQ + 1;
constexpr int NCOLS = NQ + 2;
constexpr int ROW_FLOATS = 2 * NCOLS;
constexpr int TABLE_FLOATS = (NQ + 2) * ROW_FLOATS;  // 19,208 bytes
constexpr unsigned MISMATCH_BYTES = 4 * NCOLS;
constexpr uint16_t PAD_ELEM = 4 * COL_PAD;  // column of +0.0, r = 0

__device__ __forceinline__ int clip_q(int q) {
    return min(max(q, 0), NQ - 1);
}

// the column of qual q: quals 2 and 10 swapped (an involution)
__device__ __forceinline__ int col_of(int q) {
    return q == 2 ? 10 : q == 10 ? 2 : q;
}

// N 32-bit words from shared memory at p, aligned to 8 (N = 2) or 16
// bytes, in 8- or 16-byte loads
template <int N>
__device__ __forceinline__ void load_words(const void *p, uint32_t *w) {
    if constexpr (N == 2) {
        const uint2 v = *(const uint2 *) p;
        w[0] = v.x;
        w[1] = v.y;
    } else {
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
            const uint4 v = ((const uint4 *) p)[q];
            w[4 * q] = v.x;
            w[4 * q + 1] = v.y;
            w[4 * q + 2] = v.z;
            w[4 * q + 3] = v.w;
        }
    }
}

// R consecutive sums to out, 16-byte aligned
template <int R>
__device__ __forceinline__ void store_sums(float *out, const float *acc) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q)
        ((float4 *) out)[q] = make_float4(acc[4 * q], acc[4 * q + 1],
                                          acc[4 * q + 2], acc[4 * q + 3]);
}

// R: the diagonals a thread owns (4 or 8)
template <int R>
__global__ void __launch_bounds__(THREADS, 4)
lut_sums_kernel(const uint8_t *__restrict__ nt,
                const int8_t *__restrict__ fq,
                const int8_t *__restrict__ rq,
                const int32_t *__restrict__ flen,
                const int32_t *__restrict__ rlen, long B, int ld, int O,
                int kind, const float *__restrict__ tm,
                const float *__restrict__ tmm, float nn_term, int j0,
                int jend, int ppb, float *__restrict__ out) {
    // the table is static, so its address folds into each load
    __shared__ float tab[TABLE_FLOATS];
    extern __shared__ uint4 smem[];
    const int span = O + R;  // positions a pair holds
    uint32_t *fw = (uint32_t *) smem;
    uint16_t *rv = (uint16_t *) (fw + ppb * span);

    const int tid = threadIdx.x;
    const int tpp = O / (2 * R);  // threads a pair
    for (int x = tid; x < TABLE_FLOATS; x += blockDim.x) {
        const int row = x / ROW_FLOATS, col = x % NCOLS;
        const bool mismatch = x % ROW_FLOATS >= NCOLS;
        float v;
        if (col == COL_PAD || row == ROW_ZERO) {
            v = 0.0f;
        } else if (row == ROW_N || col == COL_N) {
            v = nn_term;
        } else {
            const int q = row * NQ + col_of(col);
            v = mismatch ? tmm[q] : tm[q];
        }
        tab[x] = v;
    }
    // position pos of a pair: forward row j = pos, reverse row i = pos - R
    for (int x = tid; x < ppb * span; x += blockDim.x) {
        const int p = x / span, pos = x - p * span;
        const long b = (long) blockIdx.x * ppb + p;
        uint32_t fword = ROW_ZERO;
        uint16_t relem = PAD_ELEM;
        if (b < B) {
            const uint8_t *ntrow = nt + b * ld;
            const int8_t *fqrow = fq + b * ld;
            if (pos >= j0 && pos < jend) {
                const unsigned f = ntrow[pos] & 0x0Fu;
                if (f) {
                    const int row = kind == KIND_PEAR && f == 0x0Fu
                                    ? ROW_N : clip_q(fqrow[pos]);
                    fword = (uint32_t) row | f << 8 | f << 24;
                }
            }
            const int i = pos - R;
            if (i >= 0 && i < O) {
                const unsigned r = ntrow[i] >> 4;
                int col = COL_PAD;
                if (kind == KIND_PEAR && r == 0x0Fu) {
                    col = COL_N;
                } else if (r) {
                    int q2;
                    if (kind == KIND_PEAR) {
                        const int fl = flen[b];
                        const int xr = rlen[b] - 1 - i;
                        q2 = fqrow[min(max(xr < fl ? fl - 1 - xr : xr, 0),
                                       ld - 1)];
                    } else {
                        q2 = rq[b * ld + i];
                    }
                    col = col_of(clip_q(q2));
                }
                relem = (uint16_t) (4 * col | r << 8);
            }
        }
        fw[x] = fword;
        rv[x] = relem;
    }
    __syncthreads();

    const int p = tid / tpp, u = tid - p * tpp;
    const long b = (long) blockIdx.x * ppb + p;
    if (p >= ppb || b >= B) return;
    const uint32_t *pfw = fw + p * span;
    const uint16_t *prv = rv + p * span;
    const char *tabb = (const char *) tab;
    const int jstart = j0 & ~(R - 1);
    // the thread's two blocks, A near t = 0 and B near t = O-1, walked as
    // one run of nA + nB steps of R rows, so that every lane of a warp
    // runs the same count: in A the lanes of a pair share the row j, in
    // B (whose t0 falls as u rises) the reverse row i
    const int t0a = R * u, t0b = O - R * (u + 1);
    const int lasta = min(t0a, jend - 1), lastb = min(t0b, jend - 1);
    const int na = lasta >= jstart ? (lasta - jstart) / R + 1 : 0;
    const int nb = lastb >= jstart ? (lastb - jstart) / R + 1 : 0;
    float *orow = out + b * O;
    float acc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = 0.0f;
    // window element m (0..2R-1) of the step block at jb is reverse row
    // t0-jb-R+m, at position t0-jb+m: two aligned groups of R 16-bit
    // words, R/2 32-bit words each
    uint32_t words[R];
    if (na) load_words<R / 2>(prv + (t0a - jstart) + R, words + R / 2);
    int t0 = t0a;
    for (int n = 0; n < na + nb; ++n) {
        if (n == na) {  // A is done: on to B
            store_sums<R>(orow + t0a, acc);
#pragma unroll
            for (int k = 0; k < R; ++k) acc[k] = 0.0f;
            t0 = t0b;
            load_words<R / 2>(prv + (t0b - jstart) + R, words + R / 2);
        }
        const int jb = jstart + R * (n < na ? n : n - na);
        load_words<R / 2>(prv + (t0 - jb), words);
        uint32_t fwv[R];
        load_words<R>(pfw + jb, fwv);
        uint32_t colb[2 * R];
#pragma unroll
        for (int m = 0; m < 2 * R; ++m)
            colb[m] = m & 1 ? __byte_perm(words[m >> 1], 0, 0x4442)
                            : words[m >> 1] & 0xFFu;
#pragma unroll
        for (int s = 0; s < R; ++s) {
            // byte offsets of row j's match and mismatch halves
            const uint32_t row_m = (fwv[s] & 0x3Fu) * (4u * ROW_FLOATS);
            const uint32_t row_mm = row_m + MISMATCH_BYTES;
#pragma unroll
            for (int k = 0; k < R; ++k) {
                const int m = k - s + R;  // reverse row t0+k-jb-s
                const uint32_t rbits = m & 1 ? 0x0F000000u : 0x00000F00u;
                const bool match = (words[m >> 1] & fwv[s] & rbits) != 0u;
                const uint32_t off = (match ? row_m : row_mm) + colb[m];
                acc[k] = __fadd_rn(acc[k], *(const float *) (tabb + off));
            }
        }
#pragma unroll
        for (int q = 0; q < R / 2; ++q) words[R / 2 + q] = words[q];
    }
    if (nb) {
        store_sums<R>(orow + t0b, acc);
    } else {  // neither block meets a row of [j0, jend)
        store_sums<R>(orow + t0a, acc);
        store_sums<R>(orow + t0b, acc);
    }
}

template <int R>
void launch(const void *nt, const void *fq, const void *rq,
            const void *flen, const void *rlen, long B, int ld, int O,
            int kind, const void *tm, const void *tmm, float nn_term, int j0,
            int jend, void *out, cudaStream_t stream) {
    const int tpp = O / (2 * R);
    int ppb = THREADS / tpp;
    if (ppb > MAX_PAIRS) ppb = MAX_PAIRS;
    if (ppb < 1) ppb = 1;
    const size_t shared = (size_t) ppb * (O + R) * (4 + 2);
    lut_sums_kernel<R><<<(unsigned) ((B + ppb - 1) / ppb), ppb * tpp,
                         shared, stream>>>(
        (const uint8_t *) nt, (const int8_t *) fq, (const int8_t *) rq,
        (const int32_t *) flen, (const int32_t *) rlen, B, ld, O, kind,
        (const float *) tm, (const float *) tmm, nn_term, j0, jend, ppb,
        (float *) out);
}

}  // namespace

extern "C" int psq_cuda_lut_sums(const void *nt, const void *fq,
                                 const void *rq, const void *flen,
                                 const void *rlen, long B, int ld, int O,
                                 int kind, const void *tm, const void *tmm,
                                 float nn_term, int j0, int Oj, void *out,
                                 void *stream) {
    // O is a multiple of 32 (the wrapper checks), so O/R blocks of R
    // diagonals pair up
    if (B > 0) {
        if (O < 512)
            launch<4>(nt, fq, rq, flen, rlen, B, ld, O, kind, tm, tmm,
                      nn_term, j0, j0 + Oj, out, (cudaStream_t) stream);
        else
            launch<8>(nt, fq, rq, flen, rlen, B, ld, O, kind, tm, tmm,
                      nn_term, j0, j0 + Oj, out, (cudaStream_t) stream);
    }
    return (int) cudaGetLastError();
}
