// counts: the exact per-diagonal sums of the dense shortlist path, by
// hand for Hopper (sm_90a).
//
// Replaces pandaseq_tpu/ops/fused2.py:plane_counts (:190-215, with the
// diagonal indicator _diag_t3 :180), which the TPU computes as one
// [3B, O, O] int8 plane reduced against T3 in a single dot_general on
// the matrix unit. Plain twin: pandaseq_tpu_torch/ops/fused2.py
// plain_counts.
//
// For pair b and diagonal t < O, over the live triangle j + i = t with
// j, i < O (forward frame row j, reverse frame row i; offset o = t+1),
// restricted to the plane rows j in [j0, j0+Oj) (the row block of one
// op shard, parallel/shard.py; j0 = 0, Oj = O is the whole plane, and
// the counts of disjoint blocks add up to the whole plane's):
//   m     = #{ (f & r) != 0 and not N }
//   unk   = #{ f or r is N (0x0F), and neither is a pad (0) }
//   candc = #{ Fkm[j] == Rkm[i] }
// f / r are the low / high nibbles of the nibble plane nt [B, ld] int8
// (bytes read unsigned), Fkm / Rkm [B, ld] int32 the k-mer frames
// (kmer_frames.cu). Outputs m, unk, candc [B, O] int32, exact.
//
// What bounds it on this card: integer work and shared-memory reads,
// O^2/2 cells per pair (33k at O=256); a pair moves ~2.3 KB in and 3 KB
// out, so device memory is not the limit. The TPU reduces diagonals
// through its matrix unit because it has no cheap per-lane loop; here
// one block per pair holds both nibble rows and both k-mer rows in
// shared memory, so the plane never reaches device memory, and each
// thread walks two diagonals, t and O-1-t, so every thread does O+1
// cells and the triangle is balanced. All lanes of a warp read the same
// forward cell (a broadcast) and neighbouring reverse cells, so the
// reads have no bank conflicts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_O = 1024;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
counts_kernel(const uint8_t *__restrict__ nt,
              const int32_t *__restrict__ fkm,
              const int32_t *__restrict__ rkm, int ld, int O, int j0,
              int jend, int32_t *__restrict__ m_out,
              int32_t *__restrict__ unk_out,
              int32_t *__restrict__ cand_out) {
    __shared__ uint8_t sf[MAX_O];
    __shared__ uint8_t sr[MAX_O];
    __shared__ int32_t skf[MAX_O];
    __shared__ int32_t skr[MAX_O];

    const long b = blockIdx.x;
    for (int x = threadIdx.x; x < O; x += blockDim.x) {
        const unsigned v = nt[b * ld + x];
        sf[x] = v & 0x0F;
        sr[x] = v >> 4;
        skf[x] = fkm[b * ld + x];
        skr[x] = rkm[b * ld + x];
    }
    __syncthreads();

    for (int u = threadIdx.x; u < O / 2; u += blockDim.x) {
        for (int half = 0; half < 2; ++half) {
            const int t = half ? O - 1 - u : u;
            const int jhi = min(t, jend - 1);
            int m = 0, unk = 0, cand = 0;
            for (int j = j0; j <= jhi; ++j) {
                const int i = t - j;
                const unsigned f = sf[j];
                const unsigned r = sr[i];
                const bool n = (f == 0x0F || r == 0x0F) && f != 0 && r != 0;
                m += ((f & r) != 0) && !n;
                unk += n;
                cand += skf[j] == skr[i];
            }
            const long at = b * O + t;
            m_out[at] = m;
            unk_out[at] = unk;
            cand_out[at] = cand;
        }
    }
}

}  // namespace

extern "C" int psq_cuda_counts(const void *nt, const void *fkm,
                               const void *rkm, long B, int ld, int O,
                               int j0, int Oj, void *m, void *unk,
                               void *cand, void *stream) {
    if (B > 0)
        counts_kernel<<<(unsigned) B, THREADS, 0, (cudaStream_t) stream>>>(
            (const uint8_t *) nt, (const int32_t *) fkm,
            (const int32_t *) rkm, ld, O, j0, j0 + Oj, (int32_t *) m,
            (int32_t *) unk, (int32_t *) cand);
    return (int) cudaGetLastError();
}
