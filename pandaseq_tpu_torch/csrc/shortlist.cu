// shortlist: f32 scoring, candidate-range rules and the winner / top-SL
// shortlist of the dense path, by hand for Hopper (sm_90a).
//
// Replaces pandaseq_tpu/ops/fused2.py:shortlist_from_counts (:267-355)
// for the count-based score kinds (simple_bayesian / uparse "counts",
// ea_util, flash, stitch) and the LUT kind (pear, rdp_mle: the scores
// are the f32 LUT sums of lut_sums.cu), the tail of _shortlist_core
// (:358) and of assemble_shortlist(_nt, _packed) (:396-466). Plain twin:
// pandaseq_tpu_torch/ops/fused2.py plain_shortlist.
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
// is the full-precision one (no fast math). The ordering is (score
// descending, offset ascending) with float comparison, so -0.0 ties
// +0.0 and a row of -inf gives besto32 = 1 — the stable descending sort
// of the twin. flash divides integers with floor (not C's truncation).
//
// What bounds it on this card: nothing much — a pair moves 3 KB in
// (at O=256) and 80 B out, and does O scores plus SL block-wide
// argmax rounds. One block per pair keeps the row's scores in shared
// memory; each round is a warp-shuffle reduction and one pass over the
// warps' results, and the chosen offset is marked taken.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_O = 1024;
constexpr int MAX_SL = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// score kinds (ops/dense.py SCORE_KINDS); 0 is "counts"
constexpr int KIND_EA_UTIL = 1, KIND_FLASH = 2, KIND_STITCH = 3,
              KIND_LUT = 4;

// (score descending, index ascending)
__device__ __forceinline__ bool ahead(float s, int i, float bs, int bi) {
    return s > bs || (s == bs && i < bi);
}

// the block's first maximum, handed to every thread
__device__ void block_best(float &bs, int &bi, float *ws, int *wi) {
    for (int off = 16; off > 0; off >>= 1) {
        const float s = __shfl_down_sync(0xffffffffu, bs, off);
        const int i = __shfl_down_sync(0xffffffffu, bi, off);
        if (ahead(s, i, bs, bi)) {
            bs = s;
            bi = i;
        }
    }
    if ((threadIdx.x & 31) == 0) {
        ws[threadIdx.x >> 5] = bs;
        wi[threadIdx.x >> 5] = bi;
    }
    __syncthreads();
    bs = ws[0];
    bi = wi[0];
    for (int w = 1; w < WARPS; ++w) {
        if (ahead(ws[w], wi[w], bs, bi)) {
            bs = ws[w];
            bi = wi[w];
        }
    }
    __syncthreads();
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

__global__ void __launch_bounds__(THREADS)
shortlist_kernel(const int32_t *__restrict__ m,
                 const int32_t *__restrict__ unk,
                 const int32_t *__restrict__ candc,
                 const float *__restrict__ lutsum,
                 const int32_t *__restrict__ flen,
                 const int32_t *__restrict__ rlen,
                 const int32_t *__restrict__ fo,
                 const int32_t *__restrict__ ro, int O, int SL,
                 int minoverlap, int maxoverlap, int kind, float pmatch,
                 float pmismatch, float nn, float band,
                 int32_t *__restrict__ out) {
    __shared__ float score[MAX_O];
    __shared__ uint8_t taken[MAX_O];
    __shared__ float ws[WARPS];
    __shared__ int wi[WARPS];
    __shared__ float top_v[MAX_SL];
    __shared__ int top_i[MAX_SL];
    __shared__ int s_examined, s_band;

    const long b = blockIdx.x;
    const int32_t *mrow = m + b * O;
    const int32_t *urow = unk + b * O;
    const int32_t *crow = candc + b * O;
    const int fl = flen[b], rl = rlen[b];
    // candidate range (assembler.c:73-84,118); maxoverlap == 0 replaces
    // the offset-derived bound with min(flen, rlen)
    const int maxo = maxoverlap == 0
        ? min(fl, rl)
        : min(fl + rl - minoverlap - fo[b] - ro[b] - 1, maxoverlap);
    if (threadIdx.x == 0) {
        s_examined = 0;
        s_band = 0;
    }
    int any = 0;
    for (int x = threadIdx.x; x < O; x += blockDim.x) {
        const int o2 = x + 1;
        any |= o2 >= minoverlap && o2 <= maxo && crow[x] != 0;
    }
    // ALL_BITS_IF_NONE: no k-mer hit in range examines the whole range
    any = __syncthreads_or(any);

    int examined = 0, wrapped = 0;
    for (int x = threadIdx.x; x < O; x += blockDim.x) {
        const int o2 = x + 1;
        const bool cand = o2 >= minoverlap && o2 <= maxo
            && (!any || crow[x] != 0);
        const int mv = mrow[x], uv = urow[x];
        const int nvalid = nvalid_of(o2, fl, rl);
        const int mmv = nvalid - mv - uv;
        const float s = kind == KIND_LUT
            ? lutsum[b * O + x]
            : score_of(kind, o2, fl, rl, mv, uv, mmv, nvalid, pmatch,
                       pmismatch, nn);
        if (kind == KIND_STITCH) wrapped |= cand && mv - mmv < 0;
        examined += cand;
        score[x] = cand ? s : -INFINITY;
        taken[x] = 0;
    }
    atomicAdd(&s_examined, examined);
    wrapped = __syncthreads_or(wrapped);

    for (int r = 0; r < SL; ++r) {
        float bs = -INFINITY;
        int bi = 0x7fffffff;
        for (int x = threadIdx.x; x < O; x += blockDim.x) {
            if (!taken[x] && ahead(score[x], x, bs, bi)) {
                bs = score[x];
                bi = x;
            }
        }
        block_best(bs, bi, ws, wi);
        if (threadIdx.x == 0) {
            top_v[r] = bs;
            top_i[r] = bi;
            taken[bi] = 1;
        }
        __syncthreads();
    }

    const float best = top_v[0];
    const float thr = __fsub_rn(best, band);
    int nb = 0;
    for (int x = threadIdx.x; x < O; x += blockDim.x) {
        const float s = score[x];  // -inf off the candidate set
        nb += isfinite(s) && s >= thr;
    }
    atomicAdd(&s_band, nb);
    __syncthreads();

    int32_t *orow = out + b * (2 * SL + 4);
    for (int r = threadIdx.x; r < SL; r += blockDim.x) {
        const float v = top_v[r];
        const int i = top_i[r];
        const bool live = v > -INFINITY;
        unsigned packed = 0u;
        if (live) {
            const int mv = mrow[i];
            const int mmv = nvalid_of(i + 1, fl, rl) - mv - urow[i];
            packed = (unsigned) (i + 1) | ((unsigned) mv << 10)
                | ((unsigned) mmv << 20);
        }
        orow[r] = (int32_t) packed;
        orow[SL + r] = __float_as_int(live ? v : -3e38f);
    }
    if (threadIdx.x == 0) {
        orow[2 * SL] = top_i[0] + 1;
        orow[2 * SL + 1] = s_examined;
        orow[2 * SL + 2] = kind == KIND_STITCH && wrapped ? 1 : s_band;
        orow[2 * SL + 3] = __float_as_int(isfinite(best) ? best : -3e38f);
    }
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
    if (B > 0)
        shortlist_kernel<<<(unsigned) B, THREADS, 0,
                           (cudaStream_t) stream>>>(
            (const int32_t *) m, (const int32_t *) unk,
            (const int32_t *) candc, (const float *) lutsum,
            (const int32_t *) flen,
            (const int32_t *) rlen, (const int32_t *) fo,
            (const int32_t *) ro, O, SL, minoverlap, maxoverlap, kind,
            pmatch, pmismatch, nn, band, (int32_t *) out);
    return (int) cudaGetLastError();
}
