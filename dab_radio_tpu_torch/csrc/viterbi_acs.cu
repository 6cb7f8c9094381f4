// Viterbi add-compare-select and chainback for the DAB K=7, rate-1/4
// mother code (generators 133, 171, 145, 133 octal), on NVIDIA Hopper.
//
// Replaces the Pallas TPU kernel dab_radio_tpu/ops/viterbi_pallas.py
// (_acs_kernel, driven by viterbi_decode_pallas) and the lax.scan chainback
// around it, with the results of ops/viterbi.py:viterbi_decode_soft_radix4:
// the same decoded bits, ties included, and the path error.
//
// What bounds it: the trellis recursion is sequential in T (each step needs
// the previous step's 64 metrics), and the work per step is tiny (64
// compare-selects, 4 soft symbols in, 8 bytes of decisions out). So one
// message is latency-bound on the chain of dependent ACS steps, and the card
// fills only through many messages in flight; at the 72-message MSC group of
// a full ensemble most SMs idle. Bytes are not the limit: 4 bytes in and 8
// bytes out per message step.
//
// Design: one warp per message, any number of messages. Lane j owns new
// states j and 32+j; both read predecessors 2j and 2j+1, which arrive from
// the owning lanes' registers through __shfl_sync, so the metrics never
// leave registers and there is no shared memory and no __syncthreads.
// Metrics are int32 for the whole message with no rebasing: a step moves a
// metric by at most 508, so they stay below ~4.7e6 + 5080 for T = 9222.
// The branch metric is the sign correlation -sum_r e_r d_r, computed per
// step from the 4 depunctured soft symbols and each lane's expected signs,
// which it derives at entry from the generator polynomials in __constant__
// memory. sum_r |d_r - 127 e_r| = 508 - sum_r e_r d_r for |d_r| <= 127, so
// the minimum and its ties are the same, and the path error adds T * 508
// back. A tie goes to the even predecessor: the odd one wins only on a
// strict '<'. Decisions are packed 64 bits a step with two __ballot_sync
// (states 0-31, then 32-63), 8 bytes per step per message, written by lane
// 0 in a (T, B) layout that the chainback reads coalesced across messages.
// Chainback is one thread per message, walking from state 0 backwards.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kChainbackThreads = 128;
constexpr int kInitialNonStart = 5 * 4 * 254;   // metric of non-start states
constexpr int kStepErrOffset = 4 * 127;          // 508 per trellis step
constexpr unsigned kFullMask = 0xffffffffu;

__constant__ int c_polys[4] = {0133, 0171, 0145, 0133};

// Expected sign (+1/-1) of code bit r for the transition from `state` with
// input `bit`: parity of the register [bit, s5..s0] under polynomial r.
__device__ __forceinline__ int expected_sign(int state, int bit, int r) {
  const int reg = (bit << 6) | state;
  return 2 * (__popc(reg & c_polys[r]) & 1) - 1;
}

// d: (B, T, 4) int8 depunctured soft symbols. dec: (T, B) packed decisions,
// bit s = 1 when new state s came from its odd predecessor. err: (B,) path
// error pm[0] + T * 508.
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
acs_forward(const int8_t* __restrict__ d, unsigned long long* __restrict__ dec,
            int32_t* __restrict__ err, int B, int T) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together

  // the lane's expected signs: e[p][bit][r] for predecessor 2*lane + p
  int e[2][2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int bit = 0; bit < 2; ++bit)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        e[p][bit][r] = expected_sign(2 * lane + p, bit, r);

  int pm_lo = lane == 0 ? 0 : kInitialNonStart;  // state lane
  int pm_hi = kInitialNonStart;                  // state 32 + lane
  const int src = (2 * lane) & 31;               // lane holding state 2*lane
  const bool low_half = lane < 16;
  const int* sym = reinterpret_cast<const int*>(d + (size_t)b * T * 4);

#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    const int w = __ldg(sym + t);
    int s[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r] = (int)(int8_t)((w >> (8 * r)) & 0xff);

    const int a_lo = __shfl_sync(kFullMask, pm_lo, src);
    const int a_hi = __shfl_sync(kFullMask, pm_hi, src);
    const int b_lo = __shfl_sync(kFullMask, pm_lo, src + 1);
    const int b_hi = __shfl_sync(kFullMask, pm_hi, src + 1);
    const int pm_even = low_half ? a_lo : a_hi;  // state 2*lane
    const int pm_odd = low_half ? b_lo : b_hi;   // state 2*lane + 1

    int bm[2][2];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int bit = 0; bit < 2; ++bit)
        bm[p][bit] = -(e[p][bit][0] * s[0] + e[p][bit][1] * s[1] +
                       e[p][bit][2] * s[2] + e[p][bit][3] * s[3]);

    const int c0e = pm_even + bm[0][0], c0o = pm_odd + bm[1][0];
    const int c1e = pm_even + bm[0][1], c1o = pm_odd + bm[1][1];
    const bool odd0 = c0o < c0e;  // tie -> even predecessor
    const bool odd1 = c1o < c1e;
    pm_lo = odd0 ? c0o : c0e;
    pm_hi = odd1 ? c1o : c1e;
    const unsigned lo = __ballot_sync(kFullMask, odd0);
    const unsigned hi = __ballot_sync(kFullMask, odd1);
    if (lane == 0)
      dec[(size_t)t * B + b] = ((unsigned long long)hi << 32) | lo;
  }
  if (lane == 0) err[b] = pm_lo + T * kStepErrOffset;
}

// dec: (T, B) packed decisions. bits: (B, T) int8, the input bit of every
// trellis step on the survivor path that ends in state 0.
__global__ void chainback(const unsigned long long* __restrict__ dec,
                          int8_t* __restrict__ bits, int B, int T) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int state = 0;
  int8_t* out = bits + (size_t)b * T;
  for (int t = T - 1; t >= 0; --t) {
    const unsigned long long w = dec[(size_t)t * B + b];
    out[t] = (int8_t)(state >> 5);
    state = ((state & 31) << 1) | (int)((w >> state) & 1ull);
  }
}

}  // namespace

extern "C" int viterbi_acs_forward(const void* d, void* dec, void* err, int B,
                                   int T, void* stream) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  acs_forward<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      (const int8_t*)d, (unsigned long long*)dec, (int32_t*)err, B, T);
  return (int)cudaGetLastError();
}

extern "C" int viterbi_chainback(const void* dec, void* bits, int B, int T,
                                 void* stream) {
  const int blocks = (B + kChainbackThreads - 1) / kChainbackThreads;
  chainback<<<blocks, kChainbackThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)dec, (int8_t*)bits, B, T);
  return (int)cudaGetLastError();
}
