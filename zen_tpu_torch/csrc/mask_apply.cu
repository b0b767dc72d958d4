// The masked spectra of the live stems: hard masks formed from the two
// filtered features and applied to the spectrum in one pass.
//
// Replaces no TPU kernel: the JAX engine leaves its masks and the masked
// spectrum to XLA, which fuses them (zen_tpu/engine/spectral.py,
// compute_masks and synthesize). The port ran them as a chain of ATen
// passes (two divisions, two compares, two casts, the residual, a stack
// and a complex product), each over device memory. This kernel reads
// h = K1's output, p = K2's output (float32) and s (complex64) once and
// writes, for each live stem l, s * mask_l straight into the buffer the
// inverse transform reads; no mask is ever stored.
//
//   pm = p / (h + eps) >= beta          (percussive)
//   hm = h / (p + eps) >= beta - eps    (harmonic; ties go percussive)
//   rm = 1 - (hm_eff + pm_eff)          (residual; a disabled stem's mask
//                                        taken as 0, hps.cu:562-567)
//   out = (a*m - b*0, a*0 + b*m)        for s = (a, b)
//
// Each step rounds as the tensor path does on the card (IEEE division and
// adds, no contraction: the __f*_rn intrinsics), and the complex product
// keeps torch's operand order, so the output is bit for bit the tensor
// path's, zero signs included.
//
// Layout: flat element i = o * inner + r of the inputs goes, for stem
// slot l, to out[(o * n_stems + l) * stride + r]: the streaming step's
// [C, L, B, bins] (inner = B * bins, stride = inner) and an offline
// pass's [L, T, bins] (one o; stride >= inner, rounded up to an even
// count so that every stem's row starts on a 16-byte pair).
//
// What bounds it on this card: bytes. 16 + 8 L bytes an element (the
// fleet's 81,920 x 16 x 513 elements at L = 1: 16.1 GB, 4.8 ms at 3.35
// TB/s). The design: a lane takes two consecutive elements a step, with
// 8-byte loads of h and p and 16-byte loads of s and stores of each stem,
// so that every load and store of a warp is one contiguous run (a lane
// taking four, with two 16-byte accesses of s and out 32 bytes apart, ran
// 14% slower on the track's pass 1 on an H100, and no faster on the
// fleet); two steps'
// loads in flight before the first step's stores; a grid-stride loop of
// kBlocksPerSm blocks an SM; streaming cache hints (each byte is touched
// once); the masks picked by value, so nothing lives in local memory; and
// a scalar kernel where a pointer or the layout does not allow pairs.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kUnroll = 2;  // steps of the pair kernel whose loads are in flight at once

struct Args {
  const float* h;
  const float* p;
  const float2* s;
  float2* out;
  long long n;       // elements of h, p and s
  long long inner;   // elements of one o
  long long stride;  // elements between the output rows (o, l) and (o, l + 1)
  int n_stems;
  int stems;         // stem of slot l at bits 2l..2l+1: 0 harmonic, 1 percussive, 2 residual
  int need_h;        // the harmonic mask is read (a live harmonic or residual)
  int need_p;
  int out_h;         // output_harmonic: the residual reads hm
  int out_p;
  float eps;
  float beta;
  float beta_h;      // beta - eps, rounded to float32 on the host
};

struct Masks {
  float h, p, r;
};

// the three masks of one element; the unread ones are left 0
__device__ __forceinline__ Masks masks(float h, float p, const Args& a) {
  const float hm = a.need_h && __fdiv_rn(h, __fadd_rn(p, a.eps)) >= a.beta_h ? 1.0f : 0.0f;
  const float pm = a.need_p && __fdiv_rn(p, __fadd_rn(h, a.eps)) >= a.beta ? 1.0f : 0.0f;
  return {hm, pm, __fsub_rn(1.0f, __fadd_rn(a.out_h ? hm : 0.0f, a.out_p ? pm : 0.0f))};
}

__device__ __forceinline__ float pick(const Masks& m, int stem) {
  return stem == 0 ? m.h : (stem == 1 ? m.p : m.r);
}

// s * m as torch multiplies complex64 by a real promoted to (m, 0)
__device__ __forceinline__ float2 apply(float2 v, float m) {
  return make_float2(__fsub_rn(__fmul_rn(v.x, m), __fmul_rn(v.y, 0.0f)),
                     __fadd_rn(__fmul_rn(v.x, 0.0f), __fmul_rn(v.y, m)));
}

// the output offset of flat element i's stem slot l
__device__ __forceinline__ long long out_at(const Args& a, long long i, int l) {
  const long long o = a.inner == a.n ? 0 : i / a.inner;
  return (o * a.n_stems + l) * a.stride + (i - o * a.inner);
}

__device__ __forceinline__ void scalar_element(const Args& a, long long i) {
  const Masks m = masks(__ldcs(a.h + i), __ldcs(a.p + i), a);
  const float2 v = __ldcs(a.s + i);
  for (int l = 0; l < a.n_stems; ++l)
    __stcs(a.out + out_at(a, i, l), apply(v, pick(m, (a.stems >> (2 * l)) & 3)));
}

__global__ void __launch_bounds__(kThreads) mask_apply_scalar_kernel(Args a) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < a.n;
       i += step)
    scalar_element(a, i);
}

// Pairs: a lane takes two consecutive elements a step (a float2 of h and
// of p, a float4 of s and of each stem's output), so that each of a warp's
// loads and stores is one contiguous run; kUnroll steps' loads are issued
// before the first step's stores. The host checks that h and p are 8-byte
// and s and out 16-byte aligned, that no pair straddles two o (inner even,
// or one o) and that every output row starts on a pair (stride even, or
// one stem).
__global__ void __launch_bounds__(kThreads) mask_apply_pair_kernel(Args a) {
  const long long pairs = a.n / 2;
  const long long lanes = static_cast<long long>(gridDim.x) * kThreads;
  const float2* h2 = reinterpret_cast<const float2*>(a.h);
  const float2* p2 = reinterpret_cast<const float2*>(a.p);
  const float4* s4 = reinterpret_cast<const float4*>(a.s);
  for (long long q0 = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; q0 < pairs;
       q0 += kUnroll * lanes) {
    float2 hv[kUnroll], pv[kUnroll];
    float4 sv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + u * lanes;
      if (q < pairs) {
        hv[u] = __ldcs(h2 + q);
        pv[u] = __ldcs(p2 + q);
        sv[u] = __ldcs(s4 + q);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + u * lanes;
      if (q >= pairs) break;
      const Masks m0 = masks(hv[u].x, pv[u].x, a), m1 = masks(hv[u].y, pv[u].y, a);
      const float2 v0 = make_float2(sv[u].x, sv[u].y), v1 = make_float2(sv[u].z, sv[u].w);
      for (int l = 0; l < a.n_stems; ++l) {
        const int k = (a.stems >> (2 * l)) & 3;
        const float2 w0 = apply(v0, pick(m0, k)), w1 = apply(v1, pick(m1, k));
        __stcs(reinterpret_cast<float4*>(a.out + out_at(a, 2 * q, l)),
               make_float4(w0.x, w0.y, w1.x, w1.y));
      }
    }
  }
  // an odd count's last element (one o only: an even inner leaves none)
  if (blockIdx.x == 0 && threadIdx.x == 0 && (a.n & 1)) scalar_element(a, a.n - 1);
}

}  // namespace

// pairs: 1 the pair kernel, 0 the scalar kernel
extern "C" int zen_mask_apply(const float* h, const float* p, const void* s, void* out,
                              long long n, long long inner, long long stride, int n_stems,
                              int stems, int need_h, int need_p, int out_h, int out_p,
                              float eps, float beta, float beta_h, int pairs, int sms,
                              void* stream) {
  const Args a{h, p, static_cast<const float2*>(s), static_cast<float2*>(out), n, inner,
               stride, n_stems, stems, need_h, need_p, out_h, out_p, eps, beta, beta_h};
  const long long work = pairs ? (n / 2 + kUnroll - 1) / kUnroll : n;
  const long long want = (work + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(want < 1 ? 1 : (want < most ? want : most));
  auto st = static_cast<cudaStream_t>(stream);
  if (pairs)
    mask_apply_pair_kernel<<<blocks, kThreads, 0, st>>>(a);
  else
    mask_apply_scalar_kernel<<<blocks, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
