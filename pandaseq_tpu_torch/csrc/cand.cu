// cand: the anti-diagonal k-mer candidate search, by hand for Hopper
// (sm_90a), with the candidate-list and bitmask epilogues fused in.
//
// Replaces pandaseq_tpu/ops/pallas_cand.py:plane_cand_pallas (:117, the
// repo's one Pallas kernel) and its production XLA form
// pandaseq_tpu/ops/fused2.py:_plane_cand_tri (:601), plus the list tail
// of assemble_candidates_list_packed4 (:707-717) and pack_bits16
// (:638). Plain twin: pandaseq_tpu_torch/ops/fused2.py plain_candidates.
//
// For each pair b, offset o = t+1 (t < O) is a candidate iff some
// stored forward k-mer Fkm[b, j] equals an emitted reverse k-mer
// Rkm[b, i] with j + i = t, over the plane rows j in [j0, j0+Oj) (the
// row block of one op shard, parallel/shard.py; j0 = 0, Oj = O is the
// whole plane, and the masks of disjoint blocks OR to the whole plane's:
// shard.py:144-146 pack_bits16(psum(candc) != 0)). The TPU kernels
// count the hits per diagonal through the matrix unit and then test
// count != 0; the engine reads
// only that test (fused2.py:707), so here each block keeps one presence
// bit per diagonal in an O/32-word shared-memory mask, and the
// [B, O, O] equality plane never reaches device memory.
//
// Epilogue, mode 0 (list): [popcount, first C set offsets t+1 ascending
// via ffs, zero-padded, 0] as int16. Mode 1 (mask): the words as int32
// (bit 31 makes a word negative, which is the same bit pattern).
//
// What bounds it on this card: integer compares and shared-memory
// reads. A pair moves ~2 KB of frames in (L=O=256) and 12 B (list) out;
// the search is O^2/2 compares. One block per pair holds the forward
// row in shared memory; each thread keeps one reverse k-mer in a
// register and walks j, so all lanes of a warp read the same Fkm[j]
// (a broadcast, no bank conflicts). Reverse positions that emit
// nothing (-2) skip the walk, and hits — rare, a few per pair — set
// their bit with a shared-memory atomicOr.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_O = 1024;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
cand_kernel(const int32_t *__restrict__ fkm,
            const int32_t *__restrict__ rkm, int ld, int O, int j0,
            int jend, int mode, int C, void *__restrict__ out) {
    __shared__ int32_t sf[MAX_O];
    __shared__ uint32_t mask[MAX_O / 32];

    const long b = blockIdx.x;
    const int W = O / 32;
    const int32_t *frow = fkm + b * ld;
    const int32_t *rrow = rkm + b * ld;
    for (int x = threadIdx.x; x < O; x += blockDim.x) sf[x] = frow[x];
    for (int w = threadIdx.x; w < W; w += blockDim.x) mask[w] = 0u;
    __syncthreads();

    for (int i = threadIdx.x; i < O; i += blockDim.x) {
        const int32_t r = rrow[i];
        if (r < 0) continue;  // not emitted: equals no stored k-mer
        const int jhi = min(O - i, jend);
        for (int j = j0; j < jhi; ++j) {
            if (sf[j] == r) {
                const int t = j + i;
                atomicOr(&mask[t >> 5], 1u << (t & 31));
            }
        }
    }
    __syncthreads();

    if (mode == 1) {
        int32_t *orow = (int32_t *) out + b * W;
        for (int w = threadIdx.x; w < W; w += blockDim.x)
            orow[w] = (int32_t) mask[w];
        return;
    }
    if (threadIdx.x == 0) {
        int16_t *orow = (int16_t *) out + b * (C + 2);
        int cnt = 0;
        for (int w = 0; w < W; ++w) cnt += __popc(mask[w]);
        int n = 0;
        for (int w = 0; w < W && n < C; ++w) {
            uint32_t m = mask[w];
            while (m != 0u && n < C) {
                const int bit = __ffs(m) - 1;
                orow[1 + n++] = (int16_t) (w * 32 + bit + 1);
                m &= m - 1u;
            }
        }
        for (; n < C; ++n) orow[1 + n] = 0;
        orow[0] = (int16_t) cnt;
        orow[C + 1] = 0;
    }
}

}  // namespace

extern "C" int psq_cuda_cand(const void *fkm, const void *rkm, long B,
                             int ld, int O, int j0, int Oj, int mode, int C,
                             void *out, void *stream) {
    if (B > 0)
        cand_kernel<<<(unsigned) B, THREADS, 0, (cudaStream_t) stream>>>(
            (const int32_t *) fkm, (const int32_t *) rkm, ld, O, j0,
            j0 + Oj, mode, C, out);
    return (int) cudaGetLastError();
}
