// Viterbi decode of the DAB K=7, rate-1/4 mother code (generators 133, 171,
// 145, 133 octal) on NVIDIA Hopper: add-compare-select forward pass and
// chainback, as one kernel for trellises whose decisions fit in shared
// memory and as a pair of kernels for longer ones.
//
// Replaces the Pallas TPU kernel dab_radio_tpu/ops/viterbi_pallas.py
// (_acs_kernel, driven by viterbi_decode_pallas) and the lax.scan chainback
// around it, with the results of ops/viterbi.py:viterbi_decode_soft_radix4:
// the same decoded bits, ties included, and the path error.
//
// What bounds it on this card. Per message and trellis step the function
// reads 4 bytes and writes 1, and needs about 300 int32 operations (64 new
// states times two adds, a compare and a select). With the card full of
// messages the int32 rate is the bound; bytes never are. With few messages
// (4 for a FIC decode, 72 for an MSC group) the card is nearly empty and
// the time is T times what one warp needs for a step: the dependent chain
// of add, min and shuffle, or the dispatch of the step's instructions by a
// warp that has its scheduler to itself, whichever is longer. A step
// written plainly is about 35 instructions and their dispatch is the
// longer; the design below counts instructions as well as chain links, and
// ends at about 17 instructions and a chain of about 47 cycles a step.
//
// What the design does about it.
//  * One warp per message. Lane L keeps the metrics of the predecessor pair
//    (2L, 2L+1) in registers and computes both butterflies from them: new
//    states L and L+32. All four generators tap the oldest and the newest
//    register bit, so the four branch metrics of a butterfly are +m, -m,
//    -m, +m for one m per lane: a single __dp4a of the step's symbol word
//    with the lane's packed signs, off the metric chain.
//  * The exchange after a step is two shuffles, not four. Even lanes send
//    new state L in the first shuffle and L+32 in the second, odd lanes the
//    other way round; the upper half of the warp keeps its pair swapped
//    (odd predecessor first). Both are sign flips of m and cost nothing on
//    the chain, which is: add, min, shuffle.
//  * A decision costs one compare and one ballot. The ballots take the raw
//    predicate "second candidate < first candidate + h" with h = 1 in the
//    upper half, where the first candidate is the odd predecessor's and must
//    win only when strictly less. The raw words are turned into the layout
//    of the chainback (bit s of 64 = new state s came from its odd
//    predecessor) by four bitwise operations a step on the whole word, not
//    by selects in every lane: in the fused kernel in one pass after the
//    last step, in the forward kernel before each store.
//  * Symbols are staged through shared memory by cp.async, in chunks of 256
//    steps in a ring of four, two chunks ahead of the recursion; the
//    recursion reads them 16 bytes (4 steps) at a time, 4 to 8 steps ahead
//    of their use. Device-memory latency never sits between two steps.
//  * Fused kernel: the decision words go to shared memory, 8 bytes a step,
//    and the chainback runs in the same kernel right after the last step,
//    reading 8 words ahead of its chain of select, shift, mask and or. It
//    walks 32 segments of the trellis at once, one a lane, each from a
//    guessed entry state that is then checked against the segment above
//    and walked again if wrong, so the bits are exact. The bits leave
//    through shared memory in coalesced stores. One launch, no decision
//    traffic to device memory.
//  * Above 25,372 steps the decisions no longer fit in the 227 KB of a
//    block. The forward kernel then writes them to device memory, each
//    message's words in a row of its own (a store every step to a (T, B)
//    layout cost more than the whole recursion), and the chainback kernel
//    walks each row with one warp in the same 32 segments, reading 32 steps
//    ahead.
//  * Several messages per block when there are more messages than SMs, so
//    that every SM's shared memory is filled in one wave; the caller picks
//    the count.
//  * Windowed mode of the fused kernel, for the overlap-save tiled decode
//    (ops/viterbi.py:viterbi_decode_soft_tiled): a long trellis is cut into
//    windows of a few hundred steps that are messages of their own, so that
//    one launch fills the card where the whole trellis would keep one warp
//    busy. A window that is not the first tile of its message starts from
//    all 64 metrics at 0, and every window is traced back from the state
//    with the least final metric (the lowest such state), not from state 0;
//    there is no path error. See window_anchor for why that minimum is
//    exact.
//
// Metrics are int32 for the whole message with no rebasing: a step moves a
// metric by at most 512, so they stay far below 2^31 for any T that fits a
// tensor. The branch metric is the sign correlation -sum_r e_r d_r;
// sum_r |d_r - 127 e_r| = 508 - sum_r e_r d_r for |d_r| <= 127, so the
// minimum and its ties are the same, and the path error adds T * 508 back.
// A tie goes to the even predecessor: the odd one wins only on a strict '<'.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInitialNonStart = 5 * 4 * 254;   // metric of non-start states
constexpr int kStepErrOffset = 4 * 127;          // 508 per trellis step
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kChunkWords = 256;                 // steps per cp.async chunk
constexpr int kRingWords = 4 * kChunkWords;      // staged symbol words
constexpr int kRingBytes = 4 * kRingWords;
constexpr int kMaxWarpsPerBlock = 16;
constexpr int kMaxDynamicSmem = 232448;          // 227 KB a block on sm_90
constexpr int kWarmup = 96;                      // steps of a chainback guess
constexpr int kChainbackWarps = 4;

constexpr int kPoly0 = 0133, kPoly1 = 0171, kPoly2 = 0145, kPoly3 = 0133;
// every generator taps register bit 0 (oldest) and bit 6 (newest input):
// the butterfly's branch metrics are then +m, -m, -m, +m
static_assert((kPoly0 & kPoly1 & kPoly2 & kPoly3 & 0101) == 0101,
              "butterfly symmetry needs taps at bits 0 and 6");

// The lane's packed int8 signs c_r such that dp4a(symbols, c) is the branch
// metric m of the lane: -e_r(2*lane, input 0), negated once for an odd lane
// and once for a lane of the upper half (see acs_step).
__device__ __forceinline__ int lane_signs(int lane) {
  const int polys[4] = {kPoly0, kPoly1, kPoly2, kPoly3};
  const int flip = ((lane >> 4) ^ lane) & 1;
  unsigned packed = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = 2 * (__popc((2 * lane) & polys[r]) & 1) - 1;
    const int c = flip ? e : -e;
    packed |= (unsigned)(c & 0xff) << (8 * r);
  }
  return (int)packed;
}

// One trellis step of a warp. Lane L < 16 holds x = pm[2L], y = pm[2L+1];
// lane L >= 16 holds them swapped and has upper = 1. m is the lane's branch
// metric with the sign flips of lane_signs. w1, w2: the raw decision words
// (see canonical_decisions).
__device__ __forceinline__ void acs_step(int& x, int& y, int m, int upper,
                                         int src_a, int src_b, unsigned& w1,
                                         unsigned& w2) {
  const int a1 = x + m, b1 = y - m;
  const int a2 = x - m, b2 = y + m;
  const int v1 = min(a1, b1);   // even lane: new state L, odd lane: L + 32
  const int v2 = min(a2, b2);   // even lane: new state L + 32, odd lane: L
  x = __shfl_sync(kFullMask, v1, src_a);
  y = __shfl_sync(kFullMask, v2, src_b);
  w1 = __ballot_sync(kFullMask, b1 < a1 + upper);
  w2 = __ballot_sync(kFullMask, b2 < a2 + upper);
}

// Raw decision words of acs_step -> lo, hi: bit s of the 64 is 1 when new
// state s came from its odd predecessor. In the upper half the raw bit is
// "the odd predecessor did not win", hence the flip; an odd lane's first
// candidate pair belongs to state L + 32, hence the swap of the odd bits.
__device__ __forceinline__ uint2 canonical_decisions(unsigned w1, unsigned w2) {
  constexpr unsigned kEven = 0x55555555u, kUpper = 0xffff0000u;
  return make_uint2(((w1 & kEven) | (w2 & ~kEven)) ^ kUpper,
                    ((w2 & kEven) | (w1 & ~kEven)) ^ kUpper);
}

// One chainback step: the state before step t from the state after it and
// the step's decision words.
__device__ __forceinline__ int chain_step(int s, unsigned lo, unsigned hi) {
  const unsigned sel = (s & 32) ? hi : lo;
  return ((s << 1) & 63) | (int)((sel >> (s & 31)) & 1u);
}

// Chainback of one message by one warp, from state `anchor` at step T (0 for
// a terminated message), 32 segments at once. dec: the message's T decision words (.x = states 0-31). out: its
// T decoded bits. Lane l walks segment [lo, hi). The state it enters with
// is the exit state of the segment above, which is not known yet: the lane
// starts kWarmup steps higher from the anchor (survivor paths merge within a
// few constraint lengths) and takes what it arrives with as its entry
// state. That is a guess, so it is checked: a segment whose entry state
// differs from the exit state of the segment above is walked again from the
// right state, highest first, until none differs. The top segment starts at
// step T in the anchor, which is exact, so every repaired chain is. Decision
// words are read kBlock steps ahead of the chain.
template <int kBlock, typename Out>
__device__ __forceinline__ void chainback_warp(const uint2* dec, Out* out,
                                               int T, int lane, int anchor) {
  const int seg = ((T + 31) / 32) | 1;  // odd: rows in shared memory hit all banks
  const int nb_segs = (T + seg - 1) / seg;
  const int lo = min(lane * seg, T), hi = min(lo + seg, T);
  auto walk = [&](int s, int from, int to, bool keep) {
    int t = from;
    for (; t - kBlock >= to; t -= kBlock) {
      uint2 w[kBlock];
#pragma unroll
      for (int i = 0; i < kBlock; ++i) w[i] = dec[t - kBlock + i];
#pragma unroll
      for (int i = kBlock - 1; i >= 0; --i) {
        if (keep) out[t - kBlock + i] = (Out)(s >> 5);
        s = chain_step(s, w[i].x, w[i].y);
      }
    }
    for (; t > to; --t) {
      const uint2 w = dec[t - 1];
      if (keep) out[t - 1] = (Out)(s >> 5);
      s = chain_step(s, w.x, w.y);
    }
    return s;
  };
  int entry = walk(anchor, min(T, hi + kWarmup), hi, false);
  int leave = walk(entry, hi, lo, true);
  for (;;) {
    const int above = __shfl_down_sync(kFullMask, leave, 1);
    const unsigned wrong =
        __ballot_sync(kFullMask, lane + 1 < nb_segs && entry != above);
    if (!wrong) break;
    if (lane == 31 - __clz(wrong)) {
      entry = above;
      leave = walk(entry, hi, lo, true);
    }
  }
}

// The state with the least final metric, the lowest one among equals, from
// the lane's two metrics (lower half: x = pm[2L], y = pm[2L + 1]; upper
// half: swapped). One signed minimum over the keys pm * 64 + state: for
// pm1 < pm2 every key of pm1 is at most pm1 * 64 + 63 < pm2 * 64, so the
// metric decides first and the state breaks ties, negative metrics
// included (the branch metric is -sum e d, so metrics do go negative). No
// key overflows: |pm| <= kInitialNonStart + 508 T < 2^25 for every T whose
// decisions fit in a block's shared memory (static_assert below). The low
// 6 bits of pm * 64 are 0 in two's complement, so key & 63 is the state.
__device__ __forceinline__ int window_anchor(int x, int y, int lane,
                                             int upper) {
  const int even = upper ? y : x, odd = upper ? x : y;
  const int key = min(even * 64 + 2 * lane, odd * 64 + 2 * lane + 1);
  return __reduce_min_sync(kFullMask, key) & 63;
}
static_assert((long long)kInitialNonStart +
                      (long long)kStepErrOffset * (kMaxDynamicSmem / 8) <
                  (1LL << 25),
              "window_anchor's key must fit in 32 bits for every fused T");

__device__ __forceinline__ void cp_async_4(void* smem_dst, const void* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src)
               : "memory");
}

// Forward pass of one message per warp; with kFused the chainback too.
//
// d: (B, T, 4) int8 depunctured soft symbols, 4-byte aligned. Every message
// starts in start_state (0 for a DAB codeword). err: (B,) path error
// pm[end_state] + T * 508. kFused: bits (B, T) int8, the input bit of every
// step on the survivor path that ends in end_state (0 for a terminated
// codeword); decisions stay in shared memory. Otherwise dec: (B, T) decision
// words of 64 bits.
//
// Windowed mode (kFused only), when first_tile is not null: message b
// starts from the start metrics of start_state where first_tile[b] is set
// and from all metrics at 0 elsewhere, its survivor path ends in the state
// window_anchor names whatever end_state is, and err is not written.
//
// Shared memory of a warp, smem_per_msg bytes (a multiple of 16): the ring
// of kRingWords symbol words (step t at word t mod kRingWords), then for
// kFused T decision words of 8 bytes and T bytes of decoded bits.
template <bool kFused>
__global__ void __launch_bounds__(32 * kMaxWarpsPerBlock)
viterbi_forward(const int8_t* __restrict__ d,
                unsigned long long* __restrict__ dec,
                int8_t* __restrict__ bits, int32_t* __restrict__ err,
                const uint8_t* __restrict__ first_tile, int B, int T,
                int start_state, int end_state, int smem_per_msg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp leaves together

  unsigned char* region = smem + (size_t)warp * smem_per_msg;
  int* ring = reinterpret_cast<int*>(region);
  const int4* ring4 = reinterpret_cast<const int4*>(region);
  uint2* dec_s = reinterpret_cast<uint2*>(region + kRingBytes);
  unsigned char* bits_s = region + kRingBytes + 8 * (size_t)T;
  const int* sym = reinterpret_cast<const int*>(d) + (size_t)b * T;
  unsigned long long* dec_row = dec + (size_t)b * T;
  const int nb_chunks = (T + kChunkWords - 1) / kChunkWords;

  auto stage_chunk = [&](int c) {
    if (c < nb_chunks) {
#pragma unroll
      for (int j = 0; j < kChunkWords / 32; ++j) {
        const int w = kChunkWords * c + 32 * j + lane;
        if (w < T) cp_async_4(ring + (w & (kRingWords - 1)), sym + w);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int signs = lane_signs(lane);
  const int upper = lane >> 4;
  const int src_a = upper ? 2 * lane - 31 : 2 * lane;
  const int src_b = upper ? 2 * lane - 32 : 2 * lane + 1;
  const bool windowed = kFused && first_tile != nullptr;
  const int non_start = windowed && !first_tile[b] ? 0 : kInitialNonStart;
  // state s sits in lane s >> 1: an even s in x of the lower half and in y
  // of the upper half, an odd s the other way round
  const int start_in_x = ((start_state & 1) ^ upper) == 0;
  const bool starts_here = lane == (start_state >> 1);
  int x = starts_here && start_in_x ? 0 : non_start;
  int y = starts_here && !start_in_x ? 0 : non_start;

  auto step = [&](int t, int word) {
    unsigned w1, w2;
    acs_step(x, y, __dp4a(word, signs, 0), upper, src_a, src_b, w1, w2);
    if (lane == 0) {
      if constexpr (kFused) {
        dec_s[t] = make_uint2(w1, w2);  // made canonical after the last step
      } else {
        const uint2 c = canonical_decisions(w1, w2);
        dec_row[t] = ((unsigned long long)c.y << 32) | c.x;
      }
    }
  };

  stage_chunk(0);
  stage_chunk(1);
  int t = 0;
  int4 q0, q1;  // symbol words of steps t .. t + 3 and t + 4 .. t + 7
  for (int c = 0; c < nb_chunks; ++c) {
    stage_chunk(c + 2);
    // all but the newest group have landed: chunks c and c + 1 are readable
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    if (c == 0) {
      q0 = ring4[0];
      q1 = ring4[1];
    }
    // 16 steps at a time, to the end of the chunk; the refills read up to
    // 8 steps past it, into chunk c + 1
    const int chunk_end = min(T, kChunkWords * (c + 1));
    for (; t + 16 <= chunk_end; t += 16) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int4 cur = (g & 1) ? q1 : q0;
        const int4 ahead = ring4[((t >> 2) + g + 2) & (kRingWords / 4 - 1)];
        if (g & 1) q1 = ahead; else q0 = ahead;
        step(t + 4 * g, cur.x);
        step(t + 4 * g + 1, cur.y);
        step(t + 4 * g + 2, cur.z);
        step(t + 4 * g + 3, cur.w);
      }
    }
  }
  for (; t < T; ++t) step(t, ring[t & (kRingWords - 1)]);  // fewer than 16
  int anchor = end_state;
  if (windowed) {
    anchor = window_anchor(x, y, lane, upper);
  } else {
    const int pm_end = __shfl_sync(
        kFullMask, ((end_state & 1) ^ upper) ? y : x, end_state >> 1);
    if (lane == 0) err[b] = pm_end + T * kStepErrOffset;
  }
  if constexpr (!kFused) return;

  __syncwarp();
  for (int i = lane; i < T; i += 32)
    dec_s[i] = canonical_decisions(dec_s[i].x, dec_s[i].y);
  __syncwarp();
  chainback_warp<8>(dec_s, bits_s, T, lane, anchor);
  __syncwarp();
  int8_t* out = bits + (size_t)b * T;
  for (int i = lane; i < T; i += 32) out[i] = (int8_t)bits_s[i];
}

// dec: (B, T) decision words. bits: (B, T) int8, traced back from state
// `anchor` after the last step. One warp per message.
__global__ void __launch_bounds__(32 * kChainbackWarps)
chainback(const unsigned long long* __restrict__ dec, int8_t* __restrict__ bits,
          int B, int T, int anchor) {
  const int b = blockIdx.x * kChainbackWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  chainback_warp<32>(reinterpret_cast<const uint2*>(dec + (size_t)b * T),
                     bits + (size_t)b * T, T, threadIdx.x & 31, anchor);
}

// Shared memory one message needs in the fused kernel; more than a block's
// budget, without overflow, for any T that cannot fit.
int fused_smem_needed(int T) {
  if (T > kMaxDynamicSmem / 8) return kMaxDynamicSmem + 1;
  return kRingBytes + (8 * T + (T + 7) / 8 * 8 + 15) / 16 * 16;
}

// Raises viterbi_forward<kFused>'s dynamic shared memory limit to the
// block's whole budget, once for each device: afterwards a launch is the
// launch alone, which is all a CUDA graph capture may see.
template <bool kFused>
cudaError_t allow_large_smem() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  rc = cudaFuncSetAttribute(viterbi_forward<kFused>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            kMaxDynamicSmem);
  if (rc == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return rc;
}

template <bool kFused>
int launch_forward(const void* d, void* dec, void* bits, void* err,
                   const void* first_tile, int B, int T, int start_state,
                   int end_state, int msgs_per_block, int smem_per_msg,
                   cudaStream_t stream) {
  const int needed = kFused ? fused_smem_needed(T) : kRingBytes;
  const long long smem = (long long)msgs_per_block * smem_per_msg;
  if (msgs_per_block < 1 || msgs_per_block > kMaxWarpsPerBlock ||
      smem_per_msg < needed || smem_per_msg % 16 || smem > kMaxDynamicSmem ||
      ((start_state | end_state) & ~63) || reinterpret_cast<uintptr_t>(d) % 4)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t rc = allow_large_smem<kFused>();
    if (rc != cudaSuccess) return (int)rc;
  }
  const int blocks = (B + msgs_per_block - 1) / msgs_per_block;
  viterbi_forward<kFused><<<blocks, 32 * msgs_per_block, (size_t)smem, stream>>>(
      (const int8_t*)d, (unsigned long long*)dec, (int8_t*)bits, (int32_t*)err,
      (const uint8_t*)first_tile, B, T, start_state, end_state, smem_per_msg);
  return (int)cudaGetLastError();
}

}  // namespace

// What the wrapper's launch plan must agree with: the symbol ring's bytes,
// the warps and the dynamic shared memory a block may have.
extern "C" void viterbi_limits(int* out) {
  out[0] = kRingBytes;
  out[1] = kMaxWarpsPerBlock;
  out[2] = kMaxDynamicSmem;
}

// Shared memory one message of T steps needs in the fused kernel.
extern "C" int viterbi_fused_smem_needed(int T) { return fused_smem_needed(T); }

// Whole decode in one launch: d (B, T, 4) int8 -> bits (B, T) int8, err (B,),
// of the best path from start_state to end_state (states 0..63).
extern "C" int viterbi_decode_fused(const void* d, void* bits, void* err, int B,
                                    int T, int start_state, int end_state,
                                    int msgs_per_block, int smem_per_msg,
                                    void* stream) {
  return launch_forward<true>(d, nullptr, bits, err, nullptr, B, T,
                              start_state, end_state, msgs_per_block,
                              smem_per_msg, (cudaStream_t)stream);
}

// Windowed decode in one launch: d (B, T, 4) int8 windows, first_tile (B,)
// bytes (non-zero: the window opens its message) -> bits (B, T) int8, each
// window traced back from its best final state. No path error.
extern "C" int viterbi_decode_windows(const void* d, const void* first_tile,
                                      void* bits, int B, int T,
                                      int msgs_per_block, int smem_per_msg,
                                      void* stream) {
  if (first_tile == nullptr) return (int)cudaErrorInvalidValue;
  return launch_forward<true>(d, nullptr, bits, nullptr, first_tile, B, T, 0,
                              0, msgs_per_block, smem_per_msg,
                              (cudaStream_t)stream);
}

// Forward pass alone, from start_state: d (B, T, 4) int8 -> dec (B, T)
// uint64, err (B,) of the survivor that ends in end_state.
extern "C" int viterbi_acs_forward(const void* d, void* dec, void* err, int B,
                                   int T, int start_state, int end_state,
                                   int msgs_per_block, void* stream) {
  return launch_forward<false>(d, dec, nullptr, err, nullptr, B, T,
                               start_state, end_state, msgs_per_block,
                               kRingBytes, (cudaStream_t)stream);
}

// Chainback alone, from state `anchor`: dec (B, T) uint64 -> bits (B, T) int8.
extern "C" int viterbi_chainback(const void* dec, void* bits, int B, int T,
                                 int anchor, void* stream) {
  if (anchor & ~63) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kChainbackWarps - 1) / kChainbackWarps;
  chainback<<<blocks, 32 * kChainbackWarps, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)dec, (int8_t*)bits, B, T, anchor);
  return (int)cudaGetLastError();
}
