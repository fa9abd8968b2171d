// kmer_frames: the k-mer frames of the candidate search, by hand for
// Hopper (sm_90a). Two entry points share one kernel template:
//
// * psq_cuda_kmer_frames (the sparse default path) replaces
//   pandaseq_tpu/ops/fused2.py:_unpack2bit (:720) and kmer_frames_codes
//   (:119, with _kmer_lead :99, _kmer_trail :90, _window9_lead :81,
//   _window9_trail :72), which XLA runs on the TPU. Plain twin:
//   pandaseq_tpu_torch/ops/fused2.py plain_kmer_frames.
// * psq_cuda_kmer_frames_nt (the dense -k 0 path and
//   assemble_candidates_nt) replaces fused2.py:kmer_frames (:108) on the
//   nibble-packed plane, with the true N positions. Plain twin:
//   plain_kmer_frames_nt.
//
// Inputs: the 4-bit packed upload plane4 [B, L/2] int8 (psq_pack4
// layout, native/psq_io.cpp), or the nibble plane nt [B, L] int8
// (forward read in the low nibble, reverse read in the high nibble,
// fused2.py:371-373); flen/rlen [B] int32. Output: Fkm, Rkm [B, L]
// int32 — the forward k-mer where the kmerseen table stores it (-1
// elsewhere) and the reverse k-mer where it is emitted (-2 elsewhere;
// the sentinels differ so that -1 never equals -2).
//
// Layout traps: plane4 is PLANAR, not interleaved. Forward codes are
// bytes [0, L/4), reverse codes bytes [L/4, L/2); frame position p sits
// in byte p % (L/4) at bits 2*(p / (L/4)). plane4 takes every base as
// non-N: rows with N are recomputed on the host (psq_cand_mask). The
// nibble plane's bytes are read unsigned; its 2-bit codes come from
// _KCODE (T=3, G=2, C=1, anything else 0, fused2.py:63-64) and N is the
// nibble 0x0F. A pad (nibble 0) is not N. A forward emission at frame
// p needs p..p+8 free of N, a reverse one p-8..p (the 9-wide windows
// of fused2.py:72-87), besides p <= flen-9 and 8 <= p < rlen.
//
// What bounds it on this card: not device memory — a pair moves 128 B
// (plane4) or 256 B (nt) in at L=256 and 2 KB out, and one block per
// pair keeps the whole row in shared memory. The work is the sort-free
// rank: each stored candidate scans the emissions at larger frame
// positions for equal k-mers, O(L^2) integer compares from shared
// memory per pair, cut short once num_kmers equal ones are seen.
// Neighbouring threads read neighbouring words, so the scan has no bank
// conflicts. The JAX code needs two [B, L] sorts for the same rank
// because the TPU has no cheap per-lane loops; here a loop per thread is
// the cheap thing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KMER_LEN = 8;
constexpr int MAX_L = 1024;
constexpr int THREADS = 256;

// shared-memory code byte: bits 0-1 the 2-bit k-mer code, bit 2 = N
constexpr uint8_t N_BIT = 4;

__device__ __forceinline__ uint8_t nt_code(unsigned n) {
    const uint8_t c = n == 8 ? 3 : n == 4 ? 2 : n == 2 ? 1 : 0;
    return n == 0x0F ? (uint8_t) (c | N_BIT) : c;
}

template <bool NT>
__global__ void __launch_bounds__(THREADS)
kmer_frames_kernel(const uint8_t *__restrict__ plane,
                   const int32_t *__restrict__ flen,
                   const int32_t *__restrict__ rlen,
                   int32_t *__restrict__ fkm, int32_t *__restrict__ rkm,
                   int L, int num_kmers) {
    __shared__ uint8_t cf[MAX_L];
    __shared__ uint8_t cr[MAX_L];
    __shared__ int32_t kf[MAX_L];

    const long b = blockIdx.x;
    if (NT) {
        const uint8_t *row = plane + b * L;
        for (int p = threadIdx.x; p < L; p += blockDim.x) {
            const unsigned v = row[p];
            cf[p] = nt_code(v & 0x0F);
            cr[p] = nt_code(v >> 4);
        }
    } else {
        const int quarter = L / 4;
        const uint8_t *row = plane + b * (L / 2);
        for (int p = threadIdx.x; p < L; p += blockDim.x) {
            const int byte = p % quarter;
            const int shift = 2 * (p / quarter);
            cf[p] = (row[byte] >> shift) & 3;
            cr[p] = (row[quarter + byte] >> shift) & 3;
        }
    }
    __syncthreads();

    // forward gate: p <= flen-9 and the 9-wide window inside the frame
    const int fmax = min(flen[b] - 9, L - 9);
    const int rl = rlen[b];
    int32_t *frow = fkm + b * L;
    int32_t *rrow = rkm + b * L;
    for (int p = threadIdx.x; p < L; p += blockDim.x) {
        int v = -1;
        if (p <= fmax) {
            // k-mer over p..p+7, N window over p..p+8
            int acc = 0;
            uint8_t any = cf[p + KMER_LEN];
            for (int t = 0; t < KMER_LEN; ++t) {
                const uint8_t c = cf[p + t];
                acc |= (c & 3) << (2 * t);
                any |= c;
            }
            if (!NT || !(any & N_BIT)) v = acc;
        }
        kf[p] = v;
        // reverse gate: 8 <= p < rlen; k-mer over p-7..p, N window p-8..p
        int r = -2;
        if (p >= KMER_LEN && p < rl) {
            int acc = 0;
            uint8_t any = cr[p - KMER_LEN];
            for (int t = 0; t < KMER_LEN; ++t) {
                const uint8_t c = cr[p - t];
                acc |= (c & 3) << (2 * t);
                any |= c;
            }
            if (!NT || !(any & N_BIT)) r = acc;
        }
        rrow[p] = r;
    }
    __syncthreads();

    // rank: raw order is DESCENDING frame position, so an emission is
    // stored iff fewer than num_kmers equal emissions lie above it
    // (positions that emit nothing hold -1 and equal no k-mer)
    for (int p = threadIdx.x; p < L; p += blockDim.x) {
        const int v = kf[p];
        bool stored = false;
        if (v >= 0 && num_kmers > 0) {
            int later = 0;
            for (int s = p + 1; s <= fmax && later < num_kmers; ++s)
                later += kf[s] == v;
            stored = later < num_kmers;
        }
        frow[p] = stored ? v : -1;
    }
}

template <bool NT>
int launch(const void *plane, const void *flen, const void *rlen,
           void *fkm, void *rkm, long B, int L, int num_kmers,
           void *stream) {
    if (B > 0)
        kmer_frames_kernel<NT><<<(unsigned) B, THREADS, 0,
                                 (cudaStream_t) stream>>>(
            (const uint8_t *) plane, (const int32_t *) flen,
            (const int32_t *) rlen, (int32_t *) fkm, (int32_t *) rkm, L,
            num_kmers);
    return (int) cudaGetLastError();
}

}  // namespace

extern "C" int psq_cuda_kmer_frames(const void *plane4, const void *flen,
                                    const void *rlen, void *fkm, void *rkm,
                                    long B, int L, int num_kmers,
                                    void *stream) {
    return launch<false>(plane4, flen, rlen, fkm, rkm, B, L, num_kmers,
                         stream);
}

extern "C" int psq_cuda_kmer_frames_nt(const void *nt, const void *flen,
                                       const void *rlen, void *fkm,
                                       void *rkm, long B, int L,
                                       int num_kmers, void *stream) {
    return launch<true>(nt, flen, rlen, fkm, rkm, B, L, num_kmers, stream);
}

extern "C" const char *psq_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t) err);
}
