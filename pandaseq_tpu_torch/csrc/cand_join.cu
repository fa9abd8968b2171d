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
// (the composition plain_kmer_frames[_nt] + plain_candidates, which the
// kernels kmer_frames.cu + cand.cu computed in two launches).
//
// Per pair b, one block:
// 1. Decode the row into shared memory (2-bit k-mer code, bit 2 = N):
//    the 4-bit packed plane4 [B, L/2] (psq_pack4 layout: PLANAR, forward
//    bytes [0, L/4), reverse bytes [L/4, L/2), position p in byte
//    p % (L/4) at bits 2*(p / (L/4)); every base non-N) or, NT, the
//    nibble plane [B, L] (forward low nibble, reverse high nibble, read
//    unsigned; N is nibble 0x0F, a pad 0 is not N).
// 2. Forward source keys kmer << 10 | (L-1-p) (fused2.py:158) at every
//    emitted position: p <= min(flen-9, L-9) taken literally, and for NT
//    no N in p..p+8; other slots hold 0xFFFFFFFF, which sorts last.
// 3. Bitonic sort of the Lpad (next power of two >= L) keys in shared
//    memory. Inside one k-mer's run ascending key is descending p, which
//    is raw order, so the stored occurrences (the first num_kmers in raw
//    order, assembler.c:91-100) are the first num_kmers keys of the run.
//    The rank is over the whole read; only then do the row block's
//    sources count.
// 4. Each reverse emission i (8 <= i < rlen, i < O, for NT no N in
//    i-8..i) binary-searches its k-mer's run and walks its first
//    num_kmers keys; a stored source j in [j0, jend) with t = j+i < O
//    sets bit t of an O/32-word shared mask (a shared atomicOr; hits are
//    a few per pair). num_kmers = 0 stores nothing, any num_kmers >= 1 is
//    exact (the JAX join unrolls only up to 2).
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
// lanes per SM. Nothing intermediate goes to device memory: the frames
// that kmer_frames wrote (2 KB a pair at L=256) and cand read back stay
// in shared memory, and the O(L^2) rank scan and O(O^2/2) hit scan of
// those two kernels become an O(L log^2 L) sort and O(L log L) probes.
// A row block [j0, jend) only filters the bits set: a mesh op cell
// repeats the decode, sort and probes of the whole pair.
//
// Occupancy: a block has Lpad/2 threads (64 to 512) and 6.2 KB of static
// shared memory at most (keys 4 KB, codes 2 KB, mask 128 B), so an SM
// holds 16 blocks at L=256 and 8 at L=384-512 (2048 threads), far inside
// its 228 KB; __launch_bounds__(512, 2) caps a thread at 64 registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KMER_LEN = 8;
constexpr int MAX_L = 1024;
constexpr int MAX_THREADS = 512;
constexpr uint32_t NO_KEY = 0xFFFFFFFFu;
constexpr uint8_t N_BIT = 4;  // shared-memory code byte: bits 0-1 code

__device__ __forceinline__ uint8_t nt_code(unsigned n) {
    const uint8_t c = n == 8 ? 3 : n == 4 ? 2 : n == 2 ? 1 : 0;
    return n == 0x0F ? (uint8_t) (c | N_BIT) : c;
}

template <bool NT>
__global__ void __launch_bounds__(MAX_THREADS, 2)
cand_join_kernel(const uint8_t *__restrict__ plane,
                 const int32_t *__restrict__ flen,
                 const int32_t *__restrict__ rlen, int L, int Lpad, int O,
                 int j0, int jend, int num_kmers, int mode, int C,
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

    // 2. forward source keys
    const int fmax = min(flen[b] - 9, L - 9);
    for (int p = tid; p < Lpad; p += T) {
        uint32_t key = NO_KEY;
        if (p <= fmax && num_kmers > 0) {
            // k-mer over p..p+7, N window over p..p+8
            uint32_t acc = 0;
            uint8_t any = cf[p + KMER_LEN];
            for (int t = 0; t < KMER_LEN; ++t) {
                const uint8_t c = cf[p + t];
                acc |= (uint32_t) (c & 3) << (2 * t);
                any |= c;
            }
            if (!NT || !(any & N_BIT))
                key = acc << 10 | (uint32_t) (L - 1 - p);
        }
        keys[p] = key;
    }
    __syncthreads();

    // 3. bitonic sort, ascending, Lpad a power of two
    for (int k = 2; k <= Lpad; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int x = tid; x < Lpad / 2; x += T) {
                const int lo = ((x & ~(j - 1)) << 1) | (x & (j - 1));
                const int hi = lo + j;
                const uint32_t a = keys[lo];
                const uint32_t c = keys[hi];
                if ((a > c) == ((lo & k) == 0)) {
                    keys[lo] = c;
                    keys[hi] = a;
                }
            }
            __syncthreads();
        }
    }

    // 4. probes: reverse emission i, k-mer over i-7..i, N window i-8..i
    const int imax = min(rlen[b], O);
    for (int i = KMER_LEN + tid; i < imax; i += T) {
        uint32_t r = 0;
        uint8_t any = cr[i - KMER_LEN];
        for (int t = 0; t < KMER_LEN; ++t) {
            const uint8_t c = cr[i - t];
            r |= (uint32_t) (c & 3) << (2 * t);
            any |= c;
        }
        if (NT && (any & N_BIT)) continue;
        // lower bound of r << 10 among the sorted keys
        const uint32_t target = r << 10;
        int lo = 0, hi = Lpad;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (keys[mid] < target) lo = mid + 1;
            else hi = mid;
        }
        for (int q = lo; q < lo + num_kmers && q < Lpad; ++q) {
            const uint32_t key = keys[q];
            if ((key >> 10) != r) break;
            const int j = L - 1 - (int) (key & 1023u);
            const int t = j + i;
            if (j >= j0 && j < jend && t < O)
                atomicOr(&mask[t >> 5], 1u << (t & 31));
        }
    }
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
           int L, int O, int j0, int Oj, int num_kmers, int mode, int C,
           void *out, void *stream) {
    int Lpad = 1;
    while (Lpad < L) Lpad <<= 1;
    const int threads = Lpad / 2 < 64 ? 64
                        : Lpad / 2 > MAX_THREADS ? MAX_THREADS : Lpad / 2;
    if (B > 0)
        cand_join_kernel<NT><<<(unsigned) B, threads, 0,
                               (cudaStream_t) stream>>>(
            (const uint8_t *) plane, (const int32_t *) flen,
            (const int32_t *) rlen, L, Lpad, O, j0, j0 + Oj, num_kmers,
            mode, C, out);
    return (int) cudaGetLastError();
}

}  // namespace

extern "C" int psq_cuda_cand_join(const void *plane4, const void *flen,
                                  const void *rlen, long B, int L, int O,
                                  int j0, int Oj, int num_kmers, int mode,
                                  int C, void *out, void *stream) {
    return launch<false>(plane4, flen, rlen, B, L, O, j0, Oj, num_kmers,
                         mode, C, out, stream);
}

extern "C" int psq_cuda_cand_join_nt(const void *nt, const void *flen,
                                     const void *rlen, long B, int L, int O,
                                     int j0, int Oj, int num_kmers, int mode,
                                     int C, void *out, void *stream) {
    return launch<true>(nt, flen, rlen, B, L, O, j0, Oj, num_kmers, mode, C,
                        out, stream);
}
