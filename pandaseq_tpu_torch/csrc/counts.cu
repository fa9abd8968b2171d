// counts: the exact per-diagonal sums of the dense shortlist path, with
// the k-mer frames fused in, by hand for Hopper (sm_90a).
//
// Replaces pandaseq_tpu/ops/fused2.py:plane_counts (:190-215, with the
// diagonal indicator _diag_t3 :180), which the TPU computes as one
// [3B, O, O] int8 plane reduced against T3 in a single dot_general on
// the matrix unit, and the N-aware k-mer frames it reads,
// fused2.py:kmer_frames (:108). Plain version:
// pandaseq_tpu_torch/ops/fused2.py plain_counts (plain_kmer_frames_nt,
// then plane_counts).
//
// For pair b and diagonal t < O, over the live triangle j + i = t with
// j, i < O (forward position j, reverse position i; offset o = t+1):
//   m     = #{ (f & r) != 0 and not N }, over the bit rows j in
//           [j0, jend)
//   unk   = #{ f or r is N (0x0F), and neither is a pad (0) }, over the
//           bit rows
//   candc = #{ Fkm[j] == Rkm[i] }, over the hit rows j in [h0, hend):
//           stored forward k-mer j (the first num_kmers occurrences in
//           raw order) equal to the reverse k-mer emitted at i
// Either range [0, O) is the whole plane, and the counts of disjoint
// ranges add up to the whole plane's. An op cell of a (dp, op) mesh
// (parallel/shard.py) counts its block of bit rows; one cell of each dp
// row counts the hits of every row and the others none, so the
// sort-join runs once per dp row (an empty hit range skips it).
// f / r are the low / high nibbles of the nibble plane nt [B, L] int8
// (bytes read unsigned); flen / rlen [B] int32. Outputs m, unk, candc
// [B, O] int32, exact.
//
// Per pair b, one block, nothing intermediate in device memory:
// 1. Decode. Each warp reads 32 bytes of the row at a time. For p < O a
//    ballot per property builds bit planes in shared memory: the four
//    base bits of the nibble, N and "not a pad", each O/32 words, for
//    the forward read (bit j) and for the reverse read stored reversed
//    (bit x = O-1-i, the ballot's word bit-reversed), plus one zero
//    word. Then diagonal t pairs forward bit j with reverse bit
//    j + (O-1-t): one funnel shift of two neighbouring words aligns 32
//    cells. With k-mer hits to count, the 2-bit k-mer codes of all L
//    positions go to shared memory as well.
// 2. candc: the sort-join of join.cuh (shared with cand_join.cu): forward
//    keys, a bitonic sort that ranks the whole read, and probes by the
//    reverse emissions; each hit (j in the hit rows, t = j+i < O) is a
//    shared atomicAdd on its diagonal. That is exact: each reverse
//    emission walks at most num_kmers stored keys of its run. At
//    num_kmers = 0, or with no hit rows, nothing is stored: no keys, no
//    sort, candc = 0.
// 3. m and unk, bit-parallel: for each 32-bit word of j on diagonal t,
//      N = (Fn | Rn) & Fv & Rv
//      M = ((Fa&Ra) | (Fc&Rc) | (Fg&Rg) | (Ft&Rt)) & ~N
//    masked to j <= t and to [j0, jend), then a popcount of each. A
//    thread takes diagonals t and O-1-t, O/32 + 1 words in all, so the
//    triangle is balanced; the 32 lanes of a warp read the same words
//    (broadcasts, no bank conflicts) and run the same word count.
//
// The function's bound is its bytes: a pair moves L + 8 bytes in and
// 12*O out (27.3 MB for 8192 pairs at L=O=256, 8.2 us at 3.35 TB/s); its
// operations, 3 per 32 live cells of a bit-parallel compare, take less.
// This design does ~22 integer operations per word of 32 cells (6
// funnel shifts, 14 logic operations, 2 popcounts) and 18 broadcast
// shared loads, plus cand_join's sort where it counts k-mer hits.
//
// Occupancy: Lpad/2 threads (64 to 512, Lpad the next power of two >= L)
// and 11.8 KB of static shared memory (keys 4 KB, hit counts 4 KB, codes
// 2 KB, planes 1.5 KB): 16 blocks per SM at L=256, 8 at L=384-512.

#include <cuda_runtime.h>
#include <stdint.h>

#include "join.cuh"

namespace {

constexpr int MAX_O = 1024;
constexpr int MAX_W = MAX_O / 32;
constexpr int MAX_THREADS = 512;
constexpr unsigned FULL = 0xFFFFFFFFu;
// bit planes: 0-3 the nibble's base bits, then N (0x0F) and not a pad
constexpr int PN = 4, PV = 5, NPLANES = 6;

__device__ __forceinline__ bool plane_bit(unsigned nib, int q) {
    return q < 4 ? (nib >> q) & 1u : q == PN ? nib == 0x0Fu : nib != 0u;
}

__global__ void __launch_bounds__(MAX_THREADS, 2)
counts_kernel(const uint8_t *__restrict__ nt,
              const int32_t *__restrict__ flen,
              const int32_t *__restrict__ rlen, int L, int Lpad, int O,
              int j0, int jend, int h0, int hend, int num_kmers,
              int32_t *__restrict__ m_out,
              int32_t *__restrict__ unk_out,
              int32_t *__restrict__ cand_out) {
    __shared__ uint32_t keys[join::MAX_L];
    __shared__ uint8_t cf[join::MAX_L];
    __shared__ uint8_t cr[join::MAX_L];
    __shared__ int32_t hits[MAX_O];
    __shared__ uint32_t fw[NPLANES][MAX_W];
    __shared__ uint32_t rw[NPLANES][MAX_W + 1];

    const long b = blockIdx.x;
    const int tid = threadIdx.x;
    const int T = blockDim.x;  // a multiple of 32
    const int lane = tid & 31;
    const int W = O / 32;
    const uint8_t *row = nt + b * L;
    const bool with_hits = num_kmers > 0 && h0 < hend;

    // 1. decode: a warp takes 32 positions at a time (base is the same
    //    for its 32 lanes, so every ballot sees the whole warp)
    for (int base = tid & ~31; base < L; base += T) {
        const int p = base + lane;
        const unsigned v = p < L ? row[p] : 0u;
        const unsigned f = v & 0x0Fu, r = v >> 4;
        if (with_hits && p < L) {
            cf[p] = join::nt_code(f);
            cr[p] = join::nt_code(r);
        }
        if (base < O) {
            const int k = base >> 5;
#pragma unroll
            for (int q = 0; q < NPLANES; ++q) {
                const uint32_t fword = __ballot_sync(FULL, plane_bit(f, q));
                const uint32_t rword = __ballot_sync(FULL, plane_bit(r, q));
                if (lane == 0) {
                    fw[q][k] = fword;
                    // i = 32k + l sits at x = O-1-i: word W-1-k, bit 31-l
                    rw[q][W - 1 - k] = __brev(rword);
                }
            }
        }
    }
    for (int q = tid; q < NPLANES; q += T) rw[q][W] = 0u;
    for (int t = tid; t < O; t += T) hits[t] = 0;
    __syncthreads();

    // 2. k-mer hits per diagonal (join.cuh)
    if (with_hits) {
        const int fmax = min(flen[b] - 9, L - 9);
        join::forward_keys<true>(cf, L, Lpad, fmax, num_kmers, keys, tid,
                                 T);
        __syncthreads();
        join::bitonic_sort(keys, Lpad, tid, T);
        join::probes<true>(cr, keys, L, Lpad, O, min(rlen[b], O),
                           num_kmers, h0, hend, tid, T,
                           [&](int t) { atomicAdd(&hits[t], 1); });
    }

    // 3. m and unk, 32 cells a word
    for (int u = tid; u < O / 2; u += T) {
        for (int half = 0; half < 2; ++half) {
            const int t = half ? O - 1 - u : u;
            const int s = O - 1 - t;  // forward bit j meets reverse bit j+s
            const int q = s >> 5, sh = s & 31;
            const int jhi = min(jend - 1, t);
            int m = 0, unk = 0;
            if (jhi >= j0) {
                // (t >> 5) + q <= W-1, so word w+q+1 <= W exists
                for (int w = j0 >> 5; w <= jhi >> 5; ++w) {
                    const int lo = max(j0 - 32 * w, 0);
                    const int hi = min(jhi - 32 * w, 31);
                    const uint32_t live = (FULL >> (31 - hi)) & (FULL << lo);
                    uint32_t rv[NPLANES];
#pragma unroll
                    for (int p = 0; p < NPLANES; ++p)
                        rv[p] = __funnelshift_r(rw[p][w + q],
                                                rw[p][w + q + 1], sh);
                    const uint32_t n =
                        (fw[PN][w] | rv[PN]) & fw[PV][w] & rv[PV] & live;
                    const uint32_t hit =
                        ((fw[0][w] & rv[0]) | (fw[1][w] & rv[1])
                         | (fw[2][w] & rv[2]) | (fw[3][w] & rv[3]))
                        & live & ~n;
                    m += __popc(hit);
                    unk += __popc(n);
                }
            }
            m_out[b * O + t] = m;
            unk_out[b * O + t] = unk;
        }
    }
    __syncthreads();

    // 4. candc
    for (int t = tid; t < O; t += T) cand_out[b * O + t] = hits[t];
}

}  // namespace

extern "C" int psq_cuda_counts(const void *nt, const void *flen,
                               const void *rlen, long B, int L, int O,
                               int j0, int Oj, int h0, int Oh,
                               int num_kmers, void *m, void *unk,
                               void *cand, void *stream) {
    int Lpad = 1;
    while (Lpad < L) Lpad <<= 1;
    const int threads = Lpad / 2 < 64 ? 64
                        : Lpad / 2 > MAX_THREADS ? MAX_THREADS : Lpad / 2;
    if (B > 0)
        counts_kernel<<<(unsigned) B, threads, 0, (cudaStream_t) stream>>>(
            (const uint8_t *) nt, (const int32_t *) flen,
            (const int32_t *) rlen, L, Lpad, O, j0, j0 + Oj, h0, h0 + Oh,
            num_kmers,
            (int32_t *) m, (int32_t *) unk, (int32_t *) cand);
    return (int) cudaGetLastError();
}
