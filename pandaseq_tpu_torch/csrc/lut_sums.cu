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
// bit on the card. There are no multiplies: the one-hot matmuls of the
// TPU become table gathers from shared memory.
//
// What bounds it on this card: shared-memory reads, O^2/2 cells per pair
// (131k at O=512), each a nibble pair, a qual pair and one table word; a
// pair moves ~2 KB in and 4*O bytes out, so device memory is not the
// limit. One block per pair holds both nibble rows, both qual rows (the
// pear gather done once at load) and the two f32 tables (17.7 KB) in
// shared memory; each thread sums the diagonals t and O-1-t, as counts.cu
// does, to balance the triangle. The table reads are data-dependent and
// may conflict on banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_O = 1024;
constexpr int NQ = 47;  // quals 0..46
constexpr int THREADS = 128;
constexpr int KIND_PEAR = 0;  // 1: rdp_mle (ops/dense.py LUT_KINDS)

__device__ __forceinline__ uint8_t clip_q(int q) {
    return (uint8_t) min(max(q, 0), NQ - 1);
}

__global__ void __launch_bounds__(THREADS)
lut_sums_kernel(const uint8_t *__restrict__ nt,
                const int8_t *__restrict__ fq,
                const int8_t *__restrict__ rq,
                const int32_t *__restrict__ flen,
                const int32_t *__restrict__ rlen, int ld, int O, int kind,
                const float *__restrict__ tm,
                const float *__restrict__ tmm, float nn_term, int j0,
                int jend, float *__restrict__ out) {
    __shared__ uint8_t sf[MAX_O];
    __shared__ uint8_t sr[MAX_O];
    __shared__ uint8_t sqf[MAX_O];
    __shared__ uint8_t sq2[MAX_O];
    __shared__ float stm[NQ * NQ];
    __shared__ float stmm[NQ * NQ];

    const long b = blockIdx.x;
    const int fl = flen[b], rl = rlen[b];
    const int8_t *fqrow = fq + b * ld;
    for (int x = threadIdx.x; x < NQ * NQ; x += blockDim.x) {
        stm[x] = tm[x];
        stmm[x] = tmm[x];
    }
    for (int x = threadIdx.x; x < O; x += blockDim.x) {
        const unsigned v = nt[b * ld + x];
        sf[x] = v & 0x0F;
        sr[x] = v >> 4;
        sqf[x] = clip_q(fqrow[x]);
        int q2;
        if (kind == KIND_PEAR) {
            const int xr = rl - 1 - x;
            const int idx = min(max(xr < fl ? fl - 1 - xr : xr, 0), ld - 1);
            q2 = fqrow[idx];
        } else {
            q2 = rq[b * ld + x];
        }
        sq2[x] = clip_q(q2);
    }
    __syncthreads();

    for (int u = threadIdx.x; u < O / 2; u += blockDim.x) {
        for (int half = 0; half < 2; ++half) {
            const int t = half ? O - 1 - u : u;
            const int jhi = min(t, jend - 1);
            float acc = 0.0f;
            for (int j = j0; j <= jhi; ++j) {
                const int i = t - j;
                const unsigned f = sf[j];
                const unsigned r = sr[i];
                const int q = sqf[j] * NQ + sq2[i];
                float term = (f & r) != 0 ? stm[q] : stmm[q];
                if (kind == KIND_PEAR && (f == 0x0F || r == 0x0F))
                    term = nn_term;
                if (f == 0 || r == 0) term = 0.0f;
                acc = __fadd_rn(acc, term);
            }
            out[b * O + t] = acc;
        }
    }
}

}  // namespace

extern "C" int psq_cuda_lut_sums(const void *nt, const void *fq,
                                 const void *rq, const void *flen,
                                 const void *rlen, long B, int ld, int O,
                                 int kind, const void *tm, const void *tmm,
                                 float nn_term, int j0, int Oj, void *out,
                                 void *stream) {
    if (B > 0)
        lut_sums_kernel<<<(unsigned) B, THREADS, 0,
                          (cudaStream_t) stream>>>(
            (const uint8_t *) nt, (const int8_t *) fq, (const int8_t *) rq,
            (const int32_t *) flen, (const int32_t *) rlen, ld, O, kind,
            (const float *) tm, (const float *) tmm, nn_term, j0, j0 + Oj,
            (float *) out);
    return (int) cudaGetLastError();
}
