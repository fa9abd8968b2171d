// cand_join: the whole k-mer candidate search of a pair in one kernel,
// by hand for Hopper (sm_90a): the k-mer frames, the kmerseen rank and
// the anti-diagonal hit search as a sort-join in shared memory, with the
// candidate-list and bitmask epilogues fused in.
//
// Replaces, on the TPU side:
// * pandaseq_tpu/ops/pallas_cand.py:plane_cand_pallas (:117, the repo's
//   one Pallas kernel) and its XLA form fused2.py:_plane_cand_tri (:601);
// * fused2.py:_unpack2bit (:720) + kmer_frames_codes (:119), and with N
//   fused2.py:kmer_frames (:108) on the nibble plane;
// * the list tail of assemble_candidates_list_packed4 (:707-717) and
//   pack_bits16 (:638);
// * fused2.py:cand_mask_join (:487, K9), the sorted join, whose design
//   this kernel follows: sort the forward emissions by (k-mer, raw
//   order), and let each reverse emission find its k-mer's stored
//   occurrences in the sorted run.
// Plain versions: pandaseq_tpu_torch/ops/fused2.py plain_candidates_join
// (the composition plain_kmer_frames[_nt] + plain_candidates).
//
// Per pair b, one block:
// 1. Decode the row into shared memory (2-bit k-mer code, bit 2 = N):
//    the 4-bit packed plane4 [B, L/2] (psq_pack4 layout: PLANAR, forward
//    bytes [0, L/4), reverse bytes [L/4, L/2), position p in byte
//    p % (L/4) at bits 2*(p / (L/4)); every base non-N) or, NT, the
//    nibble plane [B, L] (forward low nibble, reverse high nibble, read
//    unsigned; N is nibble 0x0F, a pad 0 is not N).
// 2-4. The sort-join of join.cuh (shared with counts.cu): forward keys
//    kmer << 10 | (L-1-p), a bitonic sort that ranks the whole read, and
//    the reverse emissions' probes (8 <= i < min(rlen, O)). Each hit
//    (stored source j, t = j+i < O) sets bit t of an
//    O/32-word shared mask (a shared atomicOr; hits are a few per pair).
//    num_kmers = 0 stores nothing, any num_kmers >= 1 is exact (the JAX
//    join unrolls only up to 2).
// 5. Epilogue by one warp: mode 1 writes the mask words as int32 (bit 31
//    makes a word negative, the same bit pattern); mode 0 writes
//    [popcount, first C offsets t+1 ascending, zero-padded, 0] as int16,
//    the ranks from a warp prefix sum of the words' popcounts and the
//    offsets by find-first-set within each lane's word.
//
// The function's bound is its bytes: a pair moves L/2 + 8 bytes in (136
// B at L=256) and 12 B out, 0.36 us for 8192 pairs at 3.35 TB/s; the
// operations it needs (one per emitted k-mer and per candidate, ~500 a
// pair) take less at the card's 32-bit integer rate. This design's own
// floor is the sort: Lpad/2 * log2(Lpad) * (log2(Lpad)+1)/2
// compare-exchanges (4608 at Lpad=256, 11520 at 512), a min and a max
// each, 75.5M integer operations for 8192 pairs at 256, ~4.5 us at 64
// lanes per SM. Nothing intermediate goes to device memory: the k-mer
// frames (2 KB a pair at L=256) stay in shared memory, and an O(L^2)
// rank scan and O(O^2/2) hit scan become an O(L log^2 L) sort and
// O(L log L) probes.
// It always searches the whole plane: a (dp, op) mesh runs it once per
// dp row (parallel/shard.py), not once per op cell.
//
// Occupancy: a block has Lpad/2 threads (64 to 512) and 6.2 KB of static
// shared memory at most (keys 4 KB, codes 2 KB, mask 128 B), so an SM
// holds 16 blocks at L=256 and 8 at L=384-512 (2048 threads), far inside
// its 228 KB; __launch_bounds__(512, 2) caps a thread at 64 registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "join.cuh"

namespace {

constexpr int MAX_L = join::MAX_L;
constexpr int MAX_THREADS = 512;
using join::nt_code;

template <bool NT>
__global__ void __launch_bounds__(MAX_THREADS, 2)
cand_join_kernel(const uint8_t *__restrict__ plane,
                 const int32_t *__restrict__ flen,
                 const int32_t *__restrict__ rlen, int L, int Lpad, int O,
                 int num_kmers, int mode, int C,
                 void *__restrict__ out) {
    __shared__ uint32_t keys[MAX_L];
    __shared__ uint8_t cf[MAX_L];
    __shared__ uint8_t cr[MAX_L];
    __shared__ uint32_t mask[MAX_L / 32];

    const long b = blockIdx.x;
    const int tid = threadIdx.x;
    const int T = blockDim.x;
    const int W = O / 32;

    // 1. decode
    if (NT) {
        const uint8_t *row = plane + b * L;
        for (int p = tid; p < L; p += T) {
            const unsigned v = row[p];
            cf[p] = nt_code(v & 0x0F);
            cr[p] = nt_code(v >> 4);
        }
    } else {
        const int quarter = L / 4;
        const uint8_t *row = plane + b * (L / 2);
        for (int p = tid; p < L; p += T) {
            const int byte = p % quarter;
            const int shift = 2 * (p / quarter);
            cf[p] = (row[byte] >> shift) & 3;
            cr[p] = (row[quarter + byte] >> shift) & 3;
        }
    }
    for (int w = tid; w < W; w += T) mask[w] = 0u;
    __syncthreads();

    // 2-4. forward keys, sort, probes (join.cuh)
    const int fmax = min(flen[b] - 9, L - 9);
    join::forward_keys<NT>(cf, L, Lpad, fmax, num_kmers, keys, tid, T);
    __syncthreads();
    join::bitonic_sort(keys, Lpad, tid, T);
    join::probes<NT>(cr, keys, L, Lpad, O, min(rlen[b], O), num_kmers, 0,
                     O, tid, T, [&](int t) {
                         atomicOr(&mask[t >> 5], 1u << (t & 31));
                     });
    __syncthreads();

    // 5. epilogue
    if (mode == 1) {
        int32_t *orow = (int32_t *) out + b * W;
        for (int w = tid; w < W; w += T) orow[w] = (int32_t) mask[w];
        return;
    }
    if (tid < 32) {
        const unsigned full = 0xFFFFFFFFu;
        const int lane = tid;
        int16_t *orow = (int16_t *) out + b * (C + 2);
        uint32_t m = lane < W ? mask[lane] : 0u;
        const int c = __popc(m);
        int incl = c;
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(full, incl, d);
            if (lane >= d) incl += v;
        }
        const int total = __shfl_sync(full, incl, 31);
        for (int rank = incl - c; m != 0u && rank < C; ++rank) {
            orow[1 + rank] = (int16_t) (lane * 32 + __ffs(m));
            m &= m - 1u;
        }
        for (int x = total + lane; x < C; x += 32) orow[1 + x] = 0;
        if (lane == 0) {
            orow[0] = (int16_t) total;
            orow[C + 1] = 0;
        }
    }
}

template <bool NT>
int launch(const void *plane, const void *flen, const void *rlen, long B,
           int L, int O, int num_kmers, int mode, int C, void *out,
           void *stream) {
    int Lpad = 1;
    while (Lpad < L) Lpad <<= 1;
    const int threads = Lpad / 2 < 64 ? 64
                        : Lpad / 2 > MAX_THREADS ? MAX_THREADS : Lpad / 2;
    if (B > 0)
        cand_join_kernel<NT><<<(unsigned) B, threads, 0,
                               (cudaStream_t) stream>>>(
            (const uint8_t *) plane, (const int32_t *) flen,
            (const int32_t *) rlen, L, Lpad, O, num_kmers, mode, C, out);
    return (int) cudaGetLastError();
}

}  // namespace

extern "C" int psq_cuda_cand_join(const void *plane4, const void *flen,
                                  const void *rlen, long B, int L, int O,
                                  int num_kmers, int mode, int C, void *out,
                                  void *stream) {
    return launch<false>(plane4, flen, rlen, B, L, O, num_kmers, mode, C,
                         out, stream);
}

extern "C" int psq_cuda_cand_join_nt(const void *nt, const void *flen,
                                     const void *rlen, long B, int L, int O,
                                     int num_kmers, int mode, int C,
                                     void *out, void *stream) {
    return launch<true>(nt, flen, rlen, B, L, O, num_kmers, mode, C, out,
                        stream);
}

extern "C" const char *psq_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t) err);
}
