// The `select` route of K1 and K2 (csrc/median_time.cu,
// csrc/median_freq.cu): an MSD radix select for calls whose outputs are
// too few to share a sort.
//
// The sort routes (rank_select.cuh) order a block's staged samples once
// and let each output walk the ranks: the sort is shared by the block's
// outputs. Where a call has few outputs (hop 1 at 192 and 384 kHz: 3 to
// 96; a pre-padded row of 58,112 samples: 256), each block sorts tens of
// thousands of keys for one output on one SM, and torch.kthvalue, which
// selects per output across the card, wins. Here a block selects each of
// its outputs alone, in kPasses passes over the 32 order bits of its
// staged samples (zen_rank::order_bits, the sort routes' order: -0.0 <
// +0.0, NaN above +inf), kDigitBits a pass, most significant first:
//
// * a thread counts, for the samples whose higher digits match the prefix
//   chosen so far, each sample's next digit with the sample's
//   multiplicity in this output's window (the caller's `weight`: K1's
//   table of tap counts, K2's one per window position, or a whole row's
//   repeat count where K passes F under wrap or edge) in kBins integer
//   bins of its own: in shared memory where they fit (kHist: a thread's
//   bin d at word d * threads + tid, so a warp's adds never share a bank
//   whatever its digits, and no atomics: the bins are the thread's), else
//   in registers (a compare and add per bin: 16 instructions a sample
//   where the shared bins take three);
// * the block sums each bin over its threads (kHist: every thread adds
//   16 words of one bin and zeroes them, then a shuffle sum over the
//   bin's threads; in registers: a warp's fold, 16 shuffles), and one lane
//   a bin adds its sum to the block's bins with a shared-memory atomic
//   (integers: the sum does not depend on the order);
// * after one barrier every warp scans the bins and takes the one holding
//   the remaining rank, which extends the prefix.
//
// The digits that the least and the largest staged sample share, every
// sample shares: no pass counts them (on magnitudes in [0.001, 1) the
// first of eight).
//
// After the last pass the prefix is the order bits of sorted(window)[m],
// m = (K - 1) / 2, the element the sort routes' walk, the plain twins,
// torch.kthvalue and zen_tpu's median pick; zen_rank::value_of_bits turns
// it back into the value. Per output that is kPasses reads of its staged
// samples, against the sort's log^2 compare-swaps per sample shared by
// the block's outputs: the wrappers weigh the two on the call's geometry
// (ops/median_cuda.py, time_rank_pick, freq_rank_pick). The staged
// samples lie in shared memory as 4-byte order bits where they fit, else
// the caller's `bits` reads them through L2 on each pass.
#pragma once

#include <cuda_runtime.h>

namespace zen_pick {

constexpr int kDigitBits = 4;
constexpr int kBins = 1 << kDigitBits;
constexpr int kPasses = 32 / kDigitBits;
constexpr int kMaxThreads = 1024;  // a block's threads: 64 to kMaxThreads

// The block's bins, three sets in turn: pass t adds to set t % 3, and
// after its barrier every warp reads that set; then the first kBins
// threads zero set (t + 2) % 3, which pass t - 1 read before this barrier
// and pass t + 2 fills after two more (pass t + 1 adds to set (t + 1) % 3,
// zeroed after pass t - 1's barrier). One barrier a pass. `lo` and `hi`
// are the least and the largest staged order bits (stage_range), whose
// common digits no pass needs to count.
struct Shared {
  int bins[3][kBins];
  unsigned int lo;
  unsigned int hi;
};

// Zero the block's bins, the staged range, and each thread's own bins
// where they are in shared memory (`hist`, kBins words a thread); the
// caller syncs before staging into the range and before the first select.
__device__ __forceinline__ void begin(Shared* sh, int* hist) {
  if (threadIdx.x < 3 * kBins) sh->bins[threadIdx.x / kBins][threadIdx.x % kBins] = 0;
  if (threadIdx.x == 0) {
    sh->lo = ~0u;
    sh->hi = 0u;
  }
  if (hist != nullptr) {
#pragma unroll
    for (int q = 0; q < kBins; ++q) hist[q * blockDim.x + threadIdx.x] = 0;
  }
}

// Widen the block's staged range by a thread's least and largest staged
// order bits (~0u and 0 where it staged none); every thread calls it
// after staging, between the barrier after begin and the one that ends
// the staging.
__device__ __forceinline__ void stage_range(Shared* sh, unsigned int lo, unsigned int hi) {
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&sh->lo, lo);
    atomicMax(&sh->hi, hi);
  }
}

// Bytes of a block's own bins in shared memory, for `threads` threads.
__host__ __device__ __forceinline__ int hist_bytes(int threads) {
  return kBins * threads * static_cast<int>(sizeof(int));
}

// One round of the warp's fold: lanes whose bit 2 * Half is set keep the
// upper Half of their bins, the others the lower, each adding its
// partner's (lane ^ 2 * Half) copy of the bins it keeps.
template <int Half>
__device__ __forceinline__ void fold(int (&c)[kBins], int lane) {
  const bool upper = (lane & (2 * Half)) != 0;
#pragma unroll
  for (int i = 0; i < Half; ++i) {
    const int send = upper ? c[i] : c[i + Half];
    const int keep = upper ? c[i + Half] : c[i];
    c[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * Half);
  }
}

// The warp's sum of bin (lane >> 1) over its 32 lanes, in every lane:
// after the four folds a lane holds bin 8 b4 + 4 b3 + 2 b2 + b1 (its lane
// bits) summed over the 16 lanes that share bit 0; lane ^ 1 holds the
// same bin over the other 16.
__device__ __forceinline__ int warp_bins(int (&c)[kBins]) {
  const int lane = threadIdx.x & 31;
  fold<8>(c, lane);
  fold<4>(c, lane);
  fold<2>(c, lane);
  fold<1>(c, lane);
  return c[0] + __shfl_xor_sync(0xffffffffu, c[0], 1);
}

// The order bits of the sample at rank m (0-based) of the weighted
// multiset {bits(e) repeated weight(e) times : e in [0, n)}, by all
// threads of the block (a power of two, 64 to kMaxThreads), each
// returning it. `bits(e)` is sample e's order bits, `weight(e)` its
// multiplicity in this output's window (>= 0; the weights sum past m).
// kHist: `hist` holds the threads' own bins (hist_bytes). `sh` (and
// `hist`) are begun, the staged range set, and synced before; `tick`
// counts the block's passes (0 before its first select, the same in every
// thread). The digits the staged range's ends share are every sample's,
// and no pass counts them (the whole answer where the ends are equal).
// Each pass ends at its barrier (kHist: two), its bins read by every
// warp and the threads' own zero again, so the next output's select may
// follow.
template <bool kHist, typename Bits, typename Weight>
__device__ __forceinline__ unsigned int select(int n, int m, Bits bits, Weight weight,
                                               Shared* sh, int* hist, int& tick) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int count = blockDim.x;
  const unsigned int lo = sh->lo;
  const unsigned int hi = sh->hi;
  const int first = lo == hi ? kPasses : __clz(lo ^ hi) / kDigitBits;
  unsigned int prefix = first == 0 ? 0u : lo & (~0u << (32 - kDigitBits * first));
  int rank = m;
#pragma unroll 1
  for (int pass = first; pass < kPasses; ++pass) {
    const int shift = 32 - kDigitBits * (pass + 1);
    const unsigned int above = pass == 0 ? 0u : ~0u << (shift + kDigitBits);
    int* bins = sh->bins[tick % 3];
    if (kHist) {
      int* mine = hist + tid;
      for (int e = tid; e < n; e += count) {
        const unsigned int v = bits(e);
        if (((v ^ prefix) & above) == 0) {
          mine[((v >> shift) & (kBins - 1)) * count] += weight(e);
        }
      }
      __syncthreads();
      // bin b's `group` threads each add (and zero) kBins of its words
      const int group = count / kBins;
      const int b = tid / group;
      int* words = hist + b * count + tid % group;
      int sum = 0;
#pragma unroll
      for (int i = 0; i < kBins; ++i) {
        sum += words[i * group];
        words[i * group] = 0;
      }
      const int width = group < 32 ? group : 32;
      for (int off = 1; off < width; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (tid % width == 0 && sum != 0) atomicAdd(&bins[b], sum);
    } else {
      int c[kBins];
#pragma unroll
      for (int q = 0; q < kBins; ++q) c[q] = 0;
      for (int e = tid; e < n; e += count) {
        const unsigned int v = bits(e);
        if (((v ^ prefix) & above) == 0) {
          const int w = weight(e);
          const unsigned int d = (v >> shift) & (kBins - 1);
#pragma unroll
          for (int q = 0; q < kBins; ++q) c[q] += d == static_cast<unsigned int>(q) ? w : 0;
        }
      }
      const int sum = warp_bins(c);
      if ((lane & 1) == 0 && sum != 0) atomicAdd(&bins[lane >> 1], sum);
    }
    __syncthreads();
    // every warp: the bin that holds the remaining rank
    const int mine = lane < kBins ? bins[lane] : 0;
    int upto = mine;  // inclusive scan over the bins
    for (int d = 1; d < kBins; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, upto, d);
      if (lane >= d) upto += y;
    }
    const unsigned int hit = __ballot_sync(0xffffffffu, lane < kBins && upto > rank);
    const int q = __ffs(hit) - 1;
    rank -= __shfl_sync(0xffffffffu, upto - mine, q);
    prefix |= static_cast<unsigned int>(q) << shift;
    if (tid < kBins) sh->bins[(tick + 2) % 3][tid] = 0;
    ++tick;
  }
  return prefix;
}

// Where a select block keeps its staged order bits and its threads' bins
// for `staged` samples and `threads` threads within `optin` bytes beside
// Shared: both in shared memory where they fit and `shared_bins` asks
// for it (kShared, kHist), else the bits alone with the bins in registers,
// else the bins alone with the bits read through L2. Returns the dynamic
// shared memory's bytes too.
struct Layout {
  bool shared;  // the order bits in shared memory
  bool hist;    // the threads' bins in shared memory, after the bits
  size_t bytes;
};

__host__ __forceinline__ Layout layout(long long staged, int threads, int optin,
                                       bool shared_bins) {
  const long long room = optin - static_cast<long long>(sizeof(Shared));
  const long long bits = staged * static_cast<long long>(sizeof(unsigned int));
  const long long bins = hist_bytes(threads);
  if (shared_bins && bits + bins <= room) return {true, true, static_cast<size_t>(bits + bins)};
  if (bits <= room) return {true, false, static_cast<size_t>(bits)};
  return {false, true, static_cast<size_t>(bins)};
}

}  // namespace zen_pick
