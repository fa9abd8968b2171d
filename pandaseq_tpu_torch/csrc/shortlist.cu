// shortlist: f32 scoring, candidate-range rules and the winner / top-SL
// shortlist of the dense path, by hand for Hopper (sm_90a).
//
// Replaces pandaseq_tpu/ops/fused2.py:shortlist_from_counts (:267-355)
// for the count-based score kinds (simple_bayesian / uparse "counts",
// ea_util, flash, stitch) and the LUT kind (pear, rdp_mle: the scores
// are the f32 LUT sums of lut_sums.cu), the tail of _shortlist_core
// (:358) and of assemble_shortlist(_nt, _packed) (:396-466). Plain
// version: pandaseq_tpu_torch/ops/fused2.py plain_shortlist.
//
// Input: the exact diagonal sums m, unk, candc [B, O] int32 (counts.cu),
// for the LUT kind the sums lutsum [B, O] f32, and flen, rlen, fo, ro [B]
// int32. Output: [B, 2*SL + 4] int32, the
// layout of fused2.py:436-444 — the top SL offsets by f32 score packed
// as o | m<<10 | mm<<20 (0 where the score is -inf), their scores as
// bitcast f32 (-3e38 where -inf), the first-max offset besto32, the
// number of offsets examined, n_band (offsets within `band` of the
// maximum; 1 for stitch once any offset wraps), and the bitcast f32
// maximum (-3e38 where not finite).
//
// Exactness traps: every f32 operation is rounded on its own, in the
// JAX code's order (fused2.py:297-328), through __fmul_rn / __fadd_rn /
// __fdiv_rn, which nvcc never contracts into a fused multiply-add; logf
// is the full-precision one (no fast math). The ties are the JAX code's:
// the top SL are jax.lax.top_k's, (key descending, offset ascending) on
// the total-order key of the f32 score (key_of: +0.0 above -0.0); besto32
// is jnp.argmax's, the first offset whose score equals the maximum by
// float comparison (-0.0 equals +0.0), and a row of -inf gives besto32 =
// 1; best32 is what the JAX code's jnp.max compiles to (XLA folds it into
// the argmax's reduction, whose value keeps the later of two equal
// operands): the maximum with the sign of the LAST offset equal to it.
// Both come from one ballot a slot after the rounds. flash divides
// integers with floor (not C's truncation).
//
// Design: one warp per pair, WARPS pairs per block, no block barrier.
// Lane l holds offsets x = l + 32k, k < K (O <= 32K; K a template
// argument, so the K scores stay in registers), loaded coalesced. The
// block-wide reductions become warp votes: ALL_BITS_IF_NONE is
// __any_sync, examined and n_band sums of __popc(__ballot_sync), stitch's
// wrap __any_sync. Each of the SL rounds takes each lane's best untaken
// score, then a 5-step xor-shuffle argmax on (score, offset), after
// which every lane knows the winner and its lane marks it taken; lane r
// keeps round r's winner for the output. A slot holds its score's key,
// not the score: the rounds compare integers, and the score comes back
// from the key where it is needed (key_of is its own inverse).
//
// What bounds it on this card: its bytes, 12*O + 16 in and 4*(2*SL+4)
// out a pair (26.0 MB for 8192 pairs at O=256, 7.8 us at 3.35 TB/s);
// one f32 score and one compare per offset take less. The design adds
// SL * (K + 10) operations a lane for the rounds.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_SL = 32;  // one output slot per lane
constexpr int WARPS = 8;    // pairs per block
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xFFFFFFFFu;
// score kinds (ops/dense.py SCORE_KINDS); 0 is "counts"
constexpr int KIND_EA_UTIL = 1, KIND_FLASH = 2, KIND_STITCH = 3,
              KIND_LUT = 4;

// IEEE total order as an int: the sign bit stays, the other bits of a
// negative value flip, so -0.0 (0x80000000) becomes -1, just below +0.0's
// 0. Its own inverse.
__device__ __forceinline__ int key_of(int bits) {
    return bits ^ ((bits >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float score_of_key(int key) {
    return __int_as_float(key_of(key));
}

// (key descending, index ascending)
__device__ __forceinline__ bool ahead(int k, int i, int bk, int bi) {
    return k > bk || (k == bk && i < bi);
}

__device__ __forceinline__ int nvalid_of(int o2, int fl, int rl) {
    return max(0, min(o2, rl) - max(0, o2 - fl));
}

__device__ float score_of(int kind, int o2, int fl, int rl, int mv, int uv,
                          int mmv, int nvalid, float pmatch,
                          float pmismatch, float nn) {
    switch (kind) {
    case KIND_EA_UTIL: {  // algo_ea_util.c:49-55
        const float bad = (float) (mmv + uv);
        return logf(__fdiv_rn(__fadd_rn(__fmul_rn(bad, bad), 1.0f),
                              (float) max(nvalid, 1)));
    }
    case KIND_FLASH: {
        if (nvalid == 0) return -2.0f;
        const int num = mmv + uv;
        int ratio = num / nvalid;
        if (num % nvalid != 0 && num < 0) --ratio;  // floor division
        return ratio > 0 ? logf((float) ratio) : -INFINITY;
    }
    case KIND_STITCH: {  // uint64 wrap quirk, algo_stitch.c:40-56
        const int diff = mv - mmv;
        if (diff > 0)
            return logf(__fdiv_rn(fmaxf((float) diff, 1e-30f),
                                  (float) (fl + rl)));
        return diff < 0 ? 60.0f : -INFINITY;
    }
    default: {  // counts: algo_simple_bayes.c:45-65
        const bool tail = o2 < fl || o2 < rl;
        const int nnc = tail ? fl + rl - 2 * o2 + uv : uv;
        return __fadd_rn(__fadd_rn(__fmul_rn(nn, (float) nnc),
                                   __fmul_rn((float) mv, pmatch)),
                         __fmul_rn((float) mmv, pmismatch));
    }
    }
}

// up to 16 slots a lane, 32 registers a thread let 8 blocks (64 warps)
// share an SM: one wave of 132 * 64 pairs covers a batch of 8192, where
// 40 registers (6 blocks a SM) took 1.3 waves
template <int K>
__global__ void __launch_bounds__(THREADS, K <= 16 ? 8 : 1)
shortlist_kernel(const int32_t *__restrict__ m,
                 const int32_t *__restrict__ unk,
                 const int32_t *__restrict__ candc,
                 const float *__restrict__ lutsum,
                 const int32_t *__restrict__ flen,
                 const int32_t *__restrict__ rlen,
                 const int32_t *__restrict__ fo,
                 const int32_t *__restrict__ ro, long B, int O, int SL,
                 int minoverlap, int maxoverlap, int kind, float pmatch,
                 float pmismatch, float nn, float band,
                 int32_t *__restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long b = (long) blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (b >= B) return;  // the whole warp
    const int32_t *mrow = m + b * O;
    const int32_t *urow = unk + b * O;
    const int32_t *crow = candc + b * O;
    const int fl = flen[b], rl = rlen[b];
    // candidate range (assembler.c:73-84,118); maxoverlap == 0 replaces
    // the offset-derived bound with min(flen, rlen)
    const int maxo = maxoverlap == 0
        ? min(fl, rl)
        : min(fl + rl - minoverlap - fo[b] - ro[b] - 1, maxoverlap);

    // slot k of this lane is offset x = lane + 32k
    uint32_t in_range = 0u, hit = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int x = lane + 32 * k;
        if (x < O) {
            const bool in = x + 1 >= minoverlap && x + 1 <= maxo;
            in_range |= (uint32_t) in << k;
            hit |= (uint32_t) (in && crow[x] != 0) << k;
        }
    }
    // ALL_BITS_IF_NONE: no k-mer hit in range examines the whole range
    const uint32_t cand = __any_sync(FULL, hit != 0u) ? hit : in_range;

    int key[K];  // key_of the score
    int examined = 0;
    bool wrapped = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int x = lane + 32 * k;
        const bool c = (cand >> k) & 1u;
        float s = -INFINITY;
        if (c) {
            const int o2 = x + 1;
            const int mv = mrow[x], uv = urow[x];
            const int nvalid = nvalid_of(o2, fl, rl);
            const int mmv = nvalid - mv - uv;
            s = kind == KIND_LUT
                ? lutsum[b * O + x]
                : score_of(kind, o2, fl, rl, mv, uv, mmv, nvalid, pmatch,
                           pmismatch, nn);
            wrapped |= kind == KIND_STITCH && mv - mmv < 0;
        }
        key[k] = key_of(__float_as_int(s));
        examined += __popc(__ballot_sync(FULL, c));
    }
    wrapped = __any_sync(FULL, wrapped);

    // top SL; slots past O are never candidates: taken from the start
    uint32_t taken = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k)
        if (lane + 32 * k >= O) taken |= 1u << k;
    const int ninf_key = key_of(__float_as_int(-INFINITY));
    int my_k = ninf_key, max_k = ninf_key;
    int my_i = 0;
    for (int r = 0; r < SL; ++r) {
        int bk = INT_MIN;  // below every key, -inf's included
        int bi = 0x7fffffff;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if (!((taken >> k) & 1u) && ahead(key[k], lane + 32 * k, bk,
                                                bi)) {
                bk = key[k];
                bi = lane + 32 * k;
            }
        }
        for (int off = 16; off > 0; off >>= 1) {
            const int sk = __shfl_xor_sync(FULL, bk, off);
            const int i = __shfl_xor_sync(FULL, bi, off);
            if (ahead(sk, i, bk, bi)) {
                bk = sk;
                bi = i;
            }
        }
        if (lane == (bi & 31)) taken |= 1u << (bi >> 5);
        if (lane == r) {
            my_k = bk;
            my_i = bi;
        }
        if (r == 0) max_k = bk;
    }
    const float top = score_of_key(max_k);

    // the offsets equal to the maximum as floats: offsets grow with k,
    // then with the lane, so besto32 is the lowest set lane of the first
    // slot whose ballot is not empty, and best32's sign that of the
    // highest set lane of the last. Slots past O hold -inf: they match only
    // in a row of -inf, where slot 0 of lane 0 (offset 1) comes first.
    int best_i = 0;
    bool seen = false, last_neg = false;
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
        const float s = score_of_key(key[k]);
        const unsigned eq = __ballot_sync(FULL, s == top);
        const unsigned neg = __ballot_sync(FULL, s == top && signbit(s));
        if (eq) {
            best_i = 32 * k + __ffs(eq) - 1;
            if (!seen) last_neg = (neg >> (31 - __clz(eq))) & 1u;
            seen = true;
        }
    }
    const float best = copysignf(top, last_neg ? -1.0f : 1.0f);

    const float thr = __fsub_rn(best, band);
    int n_band = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {  // -inf off the candidate set
        const float s = score_of_key(key[k]);
        n_band += __popc(__ballot_sync(FULL, isfinite(s) && s >= thr));
    }

    int32_t *orow = out + b * (2 * SL + 4);
    if (lane < SL) {
        const float my_v = score_of_key(my_k);
        const bool live = my_v > -INFINITY;
        unsigned packed = 0u;
        if (live) {
            const int mv = mrow[my_i];
            const int mmv = nvalid_of(my_i + 1, fl, rl) - mv - urow[my_i];
            packed = (unsigned) (my_i + 1) | ((unsigned) mv << 10)
                | ((unsigned) mmv << 20);
        }
        orow[lane] = (int32_t) packed;
        orow[SL + lane] = __float_as_int(live ? my_v : -3e38f);
    }
    if (lane == 0) {
        orow[2 * SL] = best_i + 1;
        orow[2 * SL + 1] = examined;
        orow[2 * SL + 2] = kind == KIND_STITCH && wrapped ? 1 : n_band;
        orow[2 * SL + 3] = __float_as_int(isfinite(best) ? best : -3e38f);
    }
}

template <int K>
void launch(const void *m, const void *unk, const void *candc,
            const void *lutsum, const void *flen, const void *rlen,
            const void *fo, const void *ro, long B, int O, int SL,
            int minoverlap, int maxoverlap, int kind, float pmatch,
            float pmismatch, float nn, float band, void *out,
            cudaStream_t stream) {
    const unsigned blocks = (unsigned) ((B + WARPS - 1) / WARPS);
    shortlist_kernel<K><<<blocks, THREADS, 0, stream>>>(
        (const int32_t *) m, (const int32_t *) unk, (const int32_t *) candc,
        (const float *) lutsum, (const int32_t *) flen,
        (const int32_t *) rlen, (const int32_t *) fo, (const int32_t *) ro,
        B, O, SL, minoverlap, maxoverlap, kind, pmatch, pmismatch, nn, band,
        (int32_t *) out);
}

}  // namespace

extern "C" int psq_cuda_shortlist(const void *m, const void *unk,
                                  const void *candc, const void *lutsum,
                                  const void *flen,
                                  const void *rlen, const void *fo,
                                  const void *ro, long B, int O, int SL,
                                  int minoverlap, int maxoverlap, int kind,
                                  float pmatch, float pmismatch, float nn,
                                  float band, void *out, void *stream) {
    if (B > 0) {
#define PSQ_SHORTLIST(K)                                                  \
    launch<K>(m, unk, candc, lutsum, flen, rlen, fo, ro, B, O, SL,        \
              minoverlap, maxoverlap, kind, pmatch, pmismatch, nn, band, \
              out, (cudaStream_t) stream)
        if (O <= 128) PSQ_SHORTLIST(4);
        else if (O <= 256) PSQ_SHORTLIST(8);
        else if (O <= 384) PSQ_SHORTLIST(12);
        else if (O <= 512) PSQ_SHORTLIST(16);
        else PSQ_SHORTLIST(32);
#undef PSQ_SHORTLIST
    }
    return (int) cudaGetLastError();
}
