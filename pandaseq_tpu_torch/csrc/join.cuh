// join.cuh: the sort-join of the k-mer candidate search, shared by
// cand_join.cu (which sets a candidate bit per hit) and counts.cu (which
// counts the hits of each diagonal), so that the two cannot drift.
//
// A block holds one pair. Its shared memory holds the 2-bit k-mer codes
// of both reads (bits 0-1 the code, bit 2 = N; the caller decodes) and
// Lpad (next power of two >= L) 32-bit keys. The steps, each run by all
// T threads of the block:
// * forward_keys: the key kmer << 10 | (L-1-p) (fused2.py:158) at every
//   emitted forward position: p <= fmax = min(flen-9, L-9) taken
//   literally and, for the nibble plane (NT), no N in p..p+8; other
//   slots hold NO_KEY, which sorts last;
// * bitonic_sort: ascending. Inside one k-mer's run ascending key is
//   descending p, which is raw order, so the stored occurrences (the
//   first num_kmers in raw order, assembler.c:91-100) are the first
//   num_kmers keys of the run. The rank is over the whole read;
// * probes: each reverse emission i (8 <= i < imax, for NT no N in
//   i-8..i) binary-searches its k-mer's run and walks its first
//   num_kmers keys; each stored source j in [j0, jend) with t = j+i < O
//   is a hit, handed to hit(t) (cand_join takes every row; counts the
//   hit rows its caller names). num_kmers = 0 stores nothing; any
//   num_kmers >= 1 is exact.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace join {

constexpr int KMER_LEN = 8;
constexpr int MAX_L = 1024;
constexpr uint32_t NO_KEY = 0xFFFFFFFFu;
constexpr uint8_t N_BIT = 4;  // shared-memory code byte: bits 0-1 code

// 2-bit k-mer code of a nibble (T=3, G=2, C=1, anything else 0,
// fused2.py:63-64), with N_BIT where the nibble is N (0x0F)
__device__ __forceinline__ uint8_t nt_code(unsigned n) {
    const uint8_t c = n == 8 ? 3 : n == 4 ? 2 : n == 2 ? 1 : 0;
    return n == 0x0F ? (uint8_t) (c | N_BIT) : c;
}

template <bool NT>
__device__ __forceinline__ void forward_keys(const uint8_t *cf, int L,
                                             int Lpad, int fmax,
                                             int num_kmers, uint32_t *keys,
                                             int tid, int T) {
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
}

// ascending, Lpad a power of two; ends with the block synchronised
__device__ __forceinline__ void bitonic_sort(uint32_t *keys, int Lpad,
                                             int tid, int T) {
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
}

template <bool NT, class Hit>
__device__ __forceinline__ void probes(const uint8_t *cr,
                                       const uint32_t *keys, int L,
                                       int Lpad, int O, int imax,
                                       int num_kmers, int j0, int jend,
                                       int tid, int T, Hit hit) {
    // reverse emission i: k-mer over i-7..i, N window i-8..i
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
            if (j >= j0 && j < jend && t < O) hit(t);
        }
    }
}

}  // namespace join
