// Gather-aggregate kernels for NVIDIA Hopper (sm_90a).
//
//   out[f, :] = sum_s w[f, s] * table[idx[f, s], :]        (f32 accumulation)
//
// and, for the control-variate estimator, the same sum over the difference
// of two rows (sgt_cv_fanout_aggregate below).
// A slot with w == 0 or an index outside [0, rows) is never read: the
// history's sentinel row N holds garbage writes by design.  The table is
// float32 or bfloat16 (widened exactly by a 16-bit shift); sums and the
// output are float32.  Every entry launches on the caller's stream,
// allocates nothing, does not synchronise and returns a cudaError_t.
//
// sgt_hbm_gather_aggregate replaces the Pallas kernel
//   stochastic_gcn_tpu/ops/pallas_spmm.py::hbm_gather_aggregate (_hbm_kernel):
//   the CV full-neighbourhood term A_full . h_bar over the [N+1, d] history,
//   idx/w the [F, Dcap] padded graph rows.
//   Bound: bytes.  Each live slot is one random row of 256-512 B and d
//   multiply-adds, and a row that several slots name need come from
//   memory once; at the training shape (bf16 [233008, 128], F = 512,
//   K = 64, ~45 live slots a row, ~22,000 distinct rows) that is 6.1 MB,
//   1.8 us at 3.35 TB/s, against 6 MFLOP.  What a kernel actually pays
//   for is latency: the card needs 2-3 MB of reads in flight to reach its
//   memory rate, and a warp that walks a row's slots a few at a time
//   serialises ten or more dependent memory round trips.  The design
//   (split_gather_kernel):
//   * several warps per output row.  The row's K slots are dealt round-
//     robin to `split` warps of one block: at split 4 the F = 512 rows of
//     the training shape become 2048 warps in 256 blocks (every SM gets
//     one) and each warp is left with about 11 live slots;
//   * sub-warp groups sized to the row.  A row of <= 128, 256 or 512 bytes
//     is read by 8, 16 or 32 lanes (one 16-byte chunk per lane), so a warp
//     fetches 4, 2 or 1 slots with each load instruction and no lane idles
//     on a bfloat16 row;
//   * many rows in flight.  The warp ballots its live slots, compacts
//     them into shared memory, and every group starts up to kDepth row
//     loads before it accumulates any (registers).  Staging the rows
//     through cp.async into shared memory instead measured 1.7-1.8x slower
//     at every shape of the main path (PERF.md) and is not built;
//   * no atomics.  Each lane's partial sums go to shared memory and are
//     added in a fixed order (part, then group), so the result is
//     bitwise the same from run to run.  The split is a fixed function of
//     (F, K, row bytes), plan_split below.
//   On an NVIDIA H100 80GB HBM3 at 700 W the training shape takes 3.9-4.2
//   us against 9.0-9.1 us with one warp per row, 2.1-2.3 us above an empty
//   launch for 1.8 us of traffic; the serving shape (F = 2048, ~76,000
//   distinct rows under ~92,000 live slots) reaches 0.7 of its bound in
//   float32 and in bfloat16 (chip_smoke.py, PERF.md).
//   Rows wider than 512 bytes, and any call for which the plan is one full
//   warp per row, run row_gather_kernel: one warp per output row, up to 4
//   chunks per lane, kUnroll live slots in flight.
//
// sgt_fanout_aggregate replaces
//   stochastic_gcn_tpu/ops/pallas_spmm.py::fanout_aggregate (_fanout_kernel):
//   the sampled SpMM A_samp . X over the [C, d] in-field activations, pos/w
//   the [F, k] fanout slots; positions >= C (parked slots) read as zero.
//   Bound: the launch itself.  At the main path's shapes (k = 1, 512 or
//   2048 rows of 512 B) the bytes take 0.2-0.6 us, less than an empty
//   launch; there is nothing to split, so it takes the same dispatch as the
//   full term and lands on row_gather_kernel.  It serves the estimators
//   without a control variate (NS training, Exact evaluation); the CV
//   estimator's sampled term is sgt_cv_fanout_aggregate.
//
// sgt_cv_fanout_aggregate is that kernel redesigned for the CV estimator
//   (stochastic_gcn_tpu/models/aggregators.py::vr_aggregate, plain CV
//   branch), whose sampled term is not A_samp . X but the whole delta
//     out[f, :] = base[f, :]
//               + sum_s w[f, s] * (x[pos[f, s], :] - hbar(field_in[pos[f, s]]))
//   with hbar(n) = hist[n, :] for 0 <= n < sentinel and zero otherwise, and
//   base the full term's output.  The JAX model leaves the history gather,
//   the subtraction and the last addition to XLA, which fuses them into one
//   program per epoch; in eager PyTorch they are 8 launches and three
//   [C, d] temporaries around a kernel that already sits on the launch
//   floor, in a step whose time is its number of launches.
//   Bound: launches at K = 1 (1-3 MB of traffic, under 1 us); bytes at the
//   exhaustive evaluation shape (F = 2048, K = 64, C = 133,120, d = 128:
//   the live x rows and the distinct history rows, tens of MB, where the
//   composition moved every [C, d] temporary several times).  The design:
//   * one launch for the whole delta, and no temporary: only the rows that
//     live slots name are read, the subtraction happens in registers
//     (float32, after widening a bfloat16 history exactly), and the sum
//     meets base on its way out;
//   * a slot now names two rows, the second through a lookup
//     (pos -> field_in[pos] -> history row).  The lane that owns a slot
//     makes the lookup when it loads the slot, 32 slots of a warp at once,
//     so the x row and the history row of a slot start together and the
//     chain is three dependent loads deep however many slots a row has;
//   * the schedule of the gather is reused, not copied: row_gather_kernel
//     is a template over a slot source (TableSource, CvSource), one warp
//     per output row with kUnroll slots, so 2 kUnroll row loads, in flight,
//     fixed-order sums and no atomics (bitwise reproducible).  Columns go
//     by x's 16-byte chunks (4 floats a lane);
//   * the sentinel is applied in the kernel: row N of the history holds
//     garbage by design and is never read.
//   On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md): 3.0 us
//   at the training shape and 3.3 us at the serving shape, 1.3-1.6 us above
//   an empty launch, against 26-29 us for the composition; 19.4-20.5 us at
//   the exhaustive evaluation shape, 0.70-0.73 of its bound, against
//   294-298 us.  Every shape a path gives it runs one warp per row: with
//   two row loads a slot in flight, several warps per row
//   (split_gather_kernel over this source) measured slower at K = 1 and at
//   F = 2048, K = 64 and ahead only at F = 512, K = 64, a shape no path
//   produces, so that kernel is not built for this source (PERF.md).
//   Its gradient with respect to x is sgt_fanout_aggregate_backward
//   unchanged: the history and base are constants.
//
// sgt_fanout_aggregate_backward is the gradient of the fanout term:
//   grad_x[pos[f, s], :] += w[f, s] * g[f, :].  The Pallas kernel has no
//   VJP; the JAX model differentiates XLA's take + einsum
//   (stochastic_gcn_tpu/ops/pallas_spmm.py::fanout_aggregate_xla), whose
//   transpose is a scatter-add.
//   Bound: launches.  0.8 MB at the training shape (C = 1024, F = 512,
//   k = 1, d = 128) is 0.24 us of traffic, so the time is the number of
//   device operations and the atomic instructions it runs.  The design: the
//   entry zero-fills grad_x itself (no separate zeroing by the caller) and
//   adds whole 16-byte chunks with the float4 atomicAdd of compute
//   capability 9.0, a quarter of the scalar atomics.  One warp per g row
//   (read once into registers), the same ballot over live slots; repeated
//   positions (dedup-compacted fields) sum in any order.  The zero-fill
//   and the scatter are one cooperative launch with a grid-wide barrier
//   between them; a cudaMemsetAsync ahead of a plain launch on the same
//   stream (two device operations) measured slower at the training shape
//   (PERF.md) and is not built.
//
// sgt_empty launches an empty kernel: the floor under any single launch.
//
// sgt_gather_aggregate_split runs the gather with a named split, for
// measurement: plan_split is chosen from its times.  The other entries
// choose for themselves.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kUnroll = 4;   // row_gather_kernel: live slots in flight a warp
constexpr int kDepth = 8;    // split_gather_kernel: row loads in flight a group
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kMaxDevices = 64;  // cards of one process the backward serves
// split arguments of gather_aggregate besides 1, 2, 4, 8 warps per row
constexpr int kPlanSplit = -1;   // choose with plan_split
constexpr int kRowKernel = 0;    // row_gather_kernel

// A 16-byte chunk of a table row, accumulated into float registers.
template <int kBf16>
struct Chunk;

template <>
struct Chunk<0> {  // 4 x float32
  static constexpr int kVals = 4;
  __device__ __forceinline__ static void fma(float* acc, const uint4& v,
                                             float w) {
    acc[0] = fmaf(w, __uint_as_float(v.x), acc[0]);
    acc[1] = fmaf(w, __uint_as_float(v.y), acc[1]);
    acc[2] = fmaf(w, __uint_as_float(v.z), acc[2]);
    acc[3] = fmaf(w, __uint_as_float(v.w), acc[3]);
  }
};

template <>
struct Chunk<1> {  // 8 x bfloat16, element 0 in the low half of v.x
  static constexpr int kVals = 8;
  __device__ __forceinline__ static void pair(float* acc, unsigned u,
                                              float w) {
    acc[0] = fmaf(w, __uint_as_float(u << 16), acc[0]);
    acc[1] = fmaf(w, __uint_as_float(u & 0xffff0000u), acc[1]);
  }
  __device__ __forceinline__ static void fma(float* acc, const uint4& v,
                                             float w) {
    pair(acc + 0, v.x, w);
    pair(acc + 2, v.y, w);
    pair(acc + 4, v.z, w);
    pair(acc + 6, v.w, w);
  }
};

__device__ __forceinline__ bool slot_live(bool in_row, int i, float w,
                                          int64_t rows) {
  return in_row && w != 0.f && i >= 0 && static_cast<int64_t>(i) < rows;
}

// What a live slot reads.  Both gather kernels are written once over a
// source, which names
//   kVals      float sums a lane keeps per 16-byte column chunk;
//   kResolves  whether a slot's index names a second row through a lookup
//              (a slot then keeps two row loads in flight, not one);
//   limit()    the rows a live index stays below;
//   resolve(i) that lookup, made once per slot by the lane that owns it;
//   load()     the slot's chunk(s) for one lane, held in registers (Vals);
//   fma()      acc += w * the slot's value;
//   add_base() what is added to a finished sum before it is written.

// One table row per slot: the full term and the sampled term A_samp . X.
template <int kBf16>
struct TableSource {
  static constexpr int kVals = Chunk<kBf16>::kVals;
  static constexpr bool kResolves = false;
  using Vals = uint4;
  const uint4* table;
  int64_t rows;

  __device__ __forceinline__ int64_t limit() const { return rows; }
  __device__ __forceinline__ int resolve(int) const { return 0; }
  __device__ __forceinline__ Vals load(int row, int, int chunks,
                                       int ch) const {
    return __ldg(table + static_cast<int64_t>(row) * chunks + ch);
  }
  __device__ __forceinline__ static Vals zero() {
    return make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ static void fma(float* acc, const Vals& v,
                                             float w) {
    Chunk<kBf16>::fma(acc, v, w);
  }
  __device__ __forceinline__ void add_base(float4&, int64_t) const {}
};

// Two rows per slot, the control-variate delta: a float32 row of x at the
// slot's position, less the history row of the node at that position
// (float32, or bfloat16 when kBf16), zero for a node id outside
// [0, hist_live).  Columns go by x's chunks, 4 floats a lane, so a lane
// reads 16 bytes of x and 16 or 8 bytes of the history.
template <int kBf16>
struct CvSource {
  static constexpr int kVals = 4;
  static constexpr bool kResolves = true;
  struct Vals {
    float4 x, h;
  };
  const float4* x;
  int64_t c;
  const int32_t* field_in;
  const void* hist;
  int64_t hist_live;  // min(sentinel, rows of hist): never read at or above
  const float4* base;  // read where out is written

  __device__ __forceinline__ int64_t limit() const { return c; }
  __device__ __forceinline__ int resolve(int pos) const {
    const int n = __ldg(field_in + pos);
    return n >= 0 && static_cast<int64_t>(n) < hist_live ? n : -1;
  }
  __device__ __forceinline__ Vals load(int pos, int n, int chunks,
                                       int ch) const {
    Vals v;
    v.x = __ldg(x + static_cast<int64_t>(pos) * chunks + ch);
    v.h = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n >= 0) {
      const int64_t at = static_cast<int64_t>(n) * chunks + ch;
      if (kBf16) {  // 4 x bfloat16, element 0 in the low half of u.x
        const uint2 u = __ldg(static_cast<const uint2*>(hist) + at);
        v.h = make_float4(__uint_as_float(u.x << 16),
                          __uint_as_float(u.x & 0xffff0000u),
                          __uint_as_float(u.y << 16),
                          __uint_as_float(u.y & 0xffff0000u));
      } else {
        v.h = __ldg(static_cast<const float4*>(hist) + at);
      }
    }
    return v;
  }
  __device__ __forceinline__ static Vals zero() {
    Vals v;
    v.x = v.h = make_float4(0.f, 0.f, 0.f, 0.f);
    return v;
  }
  __device__ __forceinline__ static void fma(float* acc, const Vals& v,
                                             float w) {
    acc[0] = fmaf(w, v.x.x - v.h.x, acc[0]);
    acc[1] = fmaf(w, v.x.y - v.h.y, acc[1]);
    acc[2] = fmaf(w, v.x.z - v.h.z, acc[2]);
    acc[3] = fmaf(w, v.x.w - v.h.w, acc[3]);
  }
  __device__ __forceinline__ void add_base(float4& sum, int64_t at) const {
    const float4 b = base[at];
    sum.x += b.x;
    sum.y += b.y;
    sum.z += b.z;
    sum.w += b.w;
  }
};

// One warp per output row.  kCpl: 16-byte column chunks per lane
// (chunks <= 32 * kCpl; a table row is d * sizeof(T) / 16 chunks, a
// control-variate row d / 4).
template <class Src, int kCpl>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const Src src, int chunks, const int32_t* __restrict__ idx,
                  const float* __restrict__ w, int n_out, int k,
                  float4* out) {
  constexpr int V = Src::kVals;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (f >= n_out) return;  // whole warp leaves together

  float acc[kCpl][V];
#pragma unroll
  for (int c = 0; c < kCpl; ++c)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[c][v] = 0.f;

  const int32_t* idx_f = idx + static_cast<int64_t>(f) * k;
  const float* w_f = w + static_cast<int64_t>(f) * k;

  for (int base = 0; base < k; base += 32) {
    const int j = base + lane;
    int my_i = 0;
    float my_w = 0.f;
    if (j < k) {
      my_i = idx_f[j];
      my_w = w_f[j];
    }
    const bool live = slot_live(j < k, my_i, my_w, src.limit());
    int my_a = 0;
    if (Src::kResolves && live) my_a = src.resolve(my_i);
    unsigned mask = __ballot_sync(kFullMask, live);

    while (mask) {  // warp-uniform
      int r[kUnroll], a[kUnroll];
      float ws[kUnroll];
      bool have[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        have[u] = mask != 0;
        const int s = have[u] ? __ffs(mask) - 1 : 0;
        mask &= mask - 1;
        r[u] = __shfl_sync(kFullMask, my_i, s);
        ws[u] = __shfl_sync(kFullMask, my_w, s);
        a[u] = Src::kResolves ? __shfl_sync(kFullMask, my_a, s) : 0;
      }
      typename Src::Vals vals[kUnroll][kCpl];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int c = 0; c < kCpl; ++c) {
          const int ch = lane + c * 32;
          if (have[u] && ch < chunks)
            vals[u][c] = src.load(r[u], a[u], chunks, ch);
          else
            vals[u][c] = Src::zero();
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float wu = have[u] ? ws[u] : 0.f;
#pragma unroll
        for (int c = 0; c < kCpl; ++c) Src::fma(acc[c], vals[u][c], wu);
      }
    }
  }

  // the output row holds chunks * V floats = chunks * V / 4 float4s
  const int64_t row_at = static_cast<int64_t>(f) * (chunks * (V / 4));
#pragma unroll
  for (int c = 0; c < kCpl; ++c) {
    const int ch = lane + c * 32;
    if (ch < chunks) {
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const int64_t at = row_at + ch * (V / 4) + q;
        float4 sum = make_float4(acc[c][4 * q], acc[c][4 * q + 1],
                                 acc[c][4 * q + 2], acc[c][4 * q + 3]);
        src.add_base(sum, at);
        out[at] = sum;
      }
    }
  }
}

// `split` warps per output row (1, 2, 4 or 8; a block of 8 warps owns
// 8 / split rows), groups of kLanes lanes per slot (chunks <= kLanes).
// Warp `part` of a row takes slots part, part + split, part + 2 split, ...
template <class Src, int kLanes>
__global__ void __launch_bounds__(kThreads)
split_gather_kernel(const Src src, int chunks,
                    const int32_t* __restrict__ idx,
                    const float* __restrict__ w, int n_out, int k, int split,
                    float4* out) {
  constexpr int V = Src::kVals;
  constexpr int V4 = V / 4;
  constexpr int G = 32 / kLanes;  // slots fetched per load instruction
  __shared__ int2 slots[kWarpsPerBlock][32];     // a warp's live (index, w)
  __shared__ float4 partial[kThreads * V4];      // every lane's sums

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows_per_block = kWarpsPerBlock / split;
  const int part = warp % split;
  const int f = blockIdx.x * rows_per_block + warp / split;
  const int group = lane / kLanes;
  const int ch = lane % kLanes;
  const bool col_live = ch < chunks;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;

  if (f < n_out) {  // warp-uniform
    const int32_t* idx_f = idx + static_cast<int64_t>(f) * k;
    const float* w_f = w + static_cast<int64_t>(f) * k;
    for (int base = 0; base < k; base += 32 * split) {
      const int j = base + part + split * lane;
      int my_i = 0;
      float my_w = 0.f;
      if (j < k) {
        my_i = idx_f[j];
        my_w = w_f[j];
      }
      const bool live = slot_live(j < k, my_i, my_w, src.limit());
      const unsigned mask = __ballot_sync(kFullMask, live);
      const int n_live = __popc(mask);
      if (live) {
        const int e = __popc(mask & ((1u << lane) - 1u));
        slots[warp][e] = make_int2(my_i, __float_as_int(my_w));
      }
      __syncwarp();

      for (int e0 = 0; e0 < n_live; e0 += G * kDepth) {
        typename Src::Vals vals[kDepth];
        float ws[kDepth];
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          const int e = e0 + u * G + group;
          if (e < n_live && col_live) {
            const int2 s = slots[warp][e];
            ws[u] = __int_as_float(s.y);
            vals[u] = src.load(s.x, 0, chunks, ch);
          } else {
            ws[u] = 0.f;
            vals[u] = Src::zero();
          }
        }
#pragma unroll
        for (int u = 0; u < kDepth; ++u) Src::fma(acc, vals[u], ws[u]);
      }
      __syncwarp();  // all reads of slots[] done before the next round
    }
  }

#pragma unroll
  for (int q = 0; q < V4; ++q)
    partial[threadIdx.x * V4 + q] = make_float4(
        acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  __syncthreads();

  // out[f, ch, q] = sum over (part, group), in that fixed order
  const int row_f4 = chunks * V4;
  const int f0 = blockIdx.x * rows_per_block;
  for (int it = threadIdx.x; it < rows_per_block * row_f4; it += kThreads) {
    const int row_local = it / row_f4;
    const int rem = it - row_local * row_f4;
    if (f0 + row_local >= n_out) break;
    const int c = rem / V4;
    const int q = rem - c * V4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < split; ++p)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 v =
            partial[(((row_local * split + p) * 32) + g * kLanes + c) * V4 + q];
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    out[static_cast<int64_t>(f0 + row_local) * row_f4 + rem] = sum;
  }
}

template <class Src, int kCpl>
void launch_row(const Src& src, int chunks, const int32_t* idx,
                const float* w, int n_out, int k, float* out,
                cudaStream_t stream) {
  const int blocks = (n_out + kWarpsPerBlock - 1) / kWarpsPerBlock;
  row_gather_kernel<Src, kCpl><<<blocks, kThreads, 0, stream>>>(
      src, chunks, idx, w, n_out, k, reinterpret_cast<float4*>(out));
}

template <class Src, int kLanes>
void launch_split(const Src& src, int chunks, const int32_t* idx,
                  const float* w, int n_out, int k, int split, float* out,
                  cudaStream_t stream) {
  const int rows_per_block = kWarpsPerBlock / split;
  const int blocks = (n_out + rows_per_block - 1) / rows_per_block;
  split_gather_kernel<Src, kLanes><<<blocks, kThreads, 0, stream>>>(
      src, chunks, idx, w, n_out, k, split, reinterpret_cast<float4*>(out));
}

// Slots a load instruction of one warp fetches: 32 lanes over the lanes a
// row takes.
int groups_per_warp(int chunks) {
  return chunks <= 8 ? 4 : chunks <= 16 ? 2 : 1;
}

// Warps per output row, a fixed function of (F, K, row bytes); kRowKernel
// stands for row_gather_kernel.  The split doubles while the launch stays
// under kTargetWarps warps (one wave of 32 warps on each of 132 SMs) and
// every group keeps at least kDepth of the row's K slots, one full round
// of its pipeline.  Rows above 512 bytes, and a plan of one full warp per
// row, are row_gather_kernel's.
constexpr int kTargetWarps = 132 * 32;
int plan_split(int n_out, int k, int chunks) {
  if (chunks > 32) return kRowKernel;
  const int groups = groups_per_warp(chunks);
  int split = 1;
  while (split < kWarpsPerBlock &&
         static_cast<int64_t>(n_out) * split * 2 <= kTargetWarps &&
         k >= 2 * split * groups * kDepth)
    split *= 2;
  return split == 1 && groups == 1 ? kRowKernel : split;
}

// Runs row_gather_kernel over `src`, whose rows are `chunks` 16-byte
// column chunks (at most 128).
template <class Src>
int run_row(const Src& src, int chunks, const int32_t* idx, const float* w,
            int n_out, int k, float* out, cudaStream_t stream) {
  const int cpl = (chunks + 31) / 32;
  if (cpl < 1 || cpl > 4 || n_out <= 0 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cpl == 1) launch_row<Src, 1>(src, chunks, idx, w, n_out, k, out, stream);
  else if (cpl == 2) launch_row<Src, 2>(src, chunks, idx, w, n_out, k, out, stream);
  else launch_row<Src, 4>(src, chunks, idx, w, n_out, k, out, stream);
  return static_cast<int>(cudaGetLastError());
}

// Runs one gather over a table.  split: kPlanSplit, kRowKernel, or 1, 2,
// 4, 8 warps per row of at most 32 chunks.
template <class Src>
int run_gather(const Src& src, int chunks, const int32_t* idx, const float* w,
               int n_out, int k, float* out, cudaStream_t stream, int split) {
  if (chunks < 1 || chunks > 128 || n_out <= 0 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (split == kPlanSplit) split = plan_split(n_out, k, chunks);
  if (split == kRowKernel)
    return run_row(src, chunks, idx, w, n_out, k, out, stream);
  if (chunks > 32 || (split != 1 && split != 2 && split != 4 && split != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunks <= 8)
    launch_split<Src, 8>(src, chunks, idx, w, n_out, k, split, out, stream);
  else if (chunks <= 16)
    launch_split<Src, 16>(src, chunks, idx, w, n_out, k, split, out, stream);
  else
    launch_split<Src, 32>(src, chunks, idx, w, n_out, k, split, out, stream);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16.  The wrapper has checked that d fills
// whole 16-byte chunks, that there are at most 128 of them, that every
// pointer is 16-byte aligned and that n_out > 0.
int gather_aggregate(const void* table, int dtype, int64_t rows, int d,
                     const int32_t* idx, const float* w, int n_out, int k,
                     float* out, cudaStream_t stream, int split) {
  const int elem = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || d <= 0 || d * elem % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = d * elem / 16;
  const uint4* t = static_cast<const uint4*>(table);
  if (dtype == 0)
    return run_gather(TableSource<0>{t, rows}, chunks, idx, w, n_out, k, out,
                      stream, split);
  return run_gather(TableSource<1>{t, rows}, chunks, idx, w, n_out, k, out,
                    stream, split);
}

// The control-variate delta, one warp per output row.  The wrapper has
// checked that d is a multiple of 4 and at most 512, that x, hist, base and
// out are 16-byte aligned and that n_out > 0.
int cv_fanout_aggregate(const float* x, int64_t c, int d, const void* hist,
                        int hist_dtype, int64_t hist_rows,
                        const int32_t* field_in, int64_t sentinel,
                        const int32_t* pos, const float* w, int n_out, int k,
                        const float* base, float* out, cudaStream_t stream) {
  if ((hist_dtype != 0 && hist_dtype != 1) || d <= 0 || d % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = d / 4;
  int64_t hist_live = sentinel < hist_rows ? sentinel : hist_rows;
  if (hist_live < 0) hist_live = 0;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* base4 = reinterpret_cast<const float4*>(base);
  if (hist_dtype == 0)
    return run_row(CvSource<0>{x4, c, field_in, hist, hist_live, base4},
                   chunks, pos, w, n_out, k, out, stream);
  return run_row(CvSource<1>{x4, c, field_in, hist, hist_live, base4},
                 chunks, pos, w, n_out, k, out, stream);
}

// Adds w[f, s] * g[f, :] to grad_x[pos[f, s], :] for every live slot of
// row f; one warp, g row in registers.  kCpl: float4 chunks of a g row per
// lane (chunks = d / 4 <= 32 * kCpl).
template <int kCpl>
__device__ __forceinline__ void scatter_row(
    int f, int lane, const float4* __restrict__ g, int chunks,
    const int32_t* __restrict__ pos, const float* __restrict__ w, int k,
    int64_t c, float4* __restrict__ grad_x) {
  float4 gv[kCpl];
#pragma unroll
  for (int q = 0; q < kCpl; ++q) {
    const int ch = lane + q * 32;
    gv[q] = ch < chunks ? g[static_cast<int64_t>(f) * chunks + ch]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int32_t* pos_f = pos + static_cast<int64_t>(f) * k;
  const float* w_f = w + static_cast<int64_t>(f) * k;
  for (int base = 0; base < k; base += 32) {
    const int j = base + lane;
    int my_p = 0;
    float my_w = 0.f;
    if (j < k) {
      my_p = pos_f[j];
      my_w = w_f[j];
    }
    unsigned mask = __ballot_sync(kFullMask, slot_live(j < k, my_p, my_w, c));
    while (mask) {  // warp-uniform
      const int s = __ffs(mask) - 1;
      mask &= mask - 1;
      const int p = __shfl_sync(kFullMask, my_p, s);
      const float ws = __shfl_sync(kFullMask, my_w, s);
      float4* row = grad_x + static_cast<int64_t>(p) * chunks;
#pragma unroll
      for (int q = 0; q < kCpl; ++q) {
        const int ch = lane + q * 32;
        if (ch < chunks)  // one 16-byte reduction (compute capability 9.0)
          atomicAdd(row + ch, make_float4(ws * gv[q].x, ws * gv[q].y,
                                          ws * gv[q].z, ws * gv[q].w));
      }
    }
  }
}

// One cooperative launch: zero-fill grad_x, grid-wide barrier, scatter.
template <int kCpl>
__global__ void __launch_bounds__(kThreads)
fanout_backward_coop_kernel(const float4* __restrict__ g, int chunks,
                            const int32_t* __restrict__ pos,
                            const float* __restrict__ w, int n_out, int k,
                            int64_t c, float4* __restrict__ grad_x) {
  const int64_t total = c * chunks;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride)
    grad_x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  cg::this_grid().sync();
  for (int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); f < n_out;
       f += gridDim.x * kWarpsPerBlock)
    scatter_row<kCpl>(f, threadIdx.x & 31, g, chunks, pos, w, k, c, grad_x);
}

// Blocks of fanout_backward_coop_kernel<kCpl> that the current device
// holds at once, counted at the first call on each device.
template <int kCpl>
cudaError_t resident_blocks(int* blocks) {
  static int counted[kMaxDevices] = {};  // 0: not yet counted
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (counted[device] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fanout_backward_coop_kernel<kCpl>, kThreads, 0);
    if (e != cudaSuccess) return e;
    if (sms * per_sm < 1) return cudaErrorLaunchOutOfResources;
    counted[device] = sms * per_sm;
  }
  *blocks = counted[device];
  return cudaSuccess;
}

template <int kCpl>
cudaError_t launch_backward(const float* g, int chunks, const int32_t* pos,
                            const float* w, int n_out, int k, int64_t c,
                            float* grad_x, cudaStream_t stream) {
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* grad4 = reinterpret_cast<float4*>(grad_x);
  const int row_blocks = (n_out + kWarpsPerBlock - 1) / kWarpsPerBlock;
  // cooperative: every block must be resident at once
  int resident = 0;
  const cudaError_t counted = resident_blocks<kCpl>(&resident);
  if (counted != cudaSuccess) return counted;
  // a thread zero-fills kFillPerThread chunks: a smaller grid, whose
  // barrier is cheaper, measured no slower to fill
  constexpr int kFillPerThread = 4;
  const int64_t fill_blocks = (c * chunks + kThreads * kFillPerThread - 1) /
                              (kThreads * kFillPerThread);
  int64_t blocks = row_blocks > fill_blocks ? row_blocks : fill_blocks;
  if (blocks > resident) blocks = resident;
  void* args[] = {&g4, &chunks, &pos, &w, &n_out, &k, &c, &grad4};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fanout_backward_coop_kernel<kCpl>),
      dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, 0, stream);
}

// The wrapper has checked that d is a multiple of 4, at most 512, that
// grad_x is 16-byte aligned and that n_out > 0 and c > 0.
int fanout_backward(const float* g, const int32_t* pos, const float* w,
                    int n_out, int k, int64_t c, int d, float* grad_x,
                    cudaStream_t s) {
  const int chunks = d / 4;
  const int cpl = (chunks + 31) / 32;
  if (d % 4 != 0 || cpl < 1 || cpl > 4 || n_out <= 0 || k < 0 || c <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (cpl == 1) err = launch_backward<1>(g, chunks, pos, w, n_out, k, c, grad_x, s);
  else if (cpl == 2) err = launch_backward<2>(g, chunks, pos, w, n_out, k, c, grad_x, s);
  else err = launch_backward<4>(g, chunks, pos, w, n_out, k, c, grad_x, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Full-neighbourhood term: table [rows, d], idx/w [n_out, k] -> out [n_out, d].
int sgt_hbm_gather_aggregate(const void* table, int dtype, int64_t rows,
                             int d, const int32_t* idx, const float* w,
                             int n_out, int k, float* out, void* stream) {
  return gather_aggregate(table, dtype, rows, d, idx, w, n_out, k, out,
                          static_cast<cudaStream_t>(stream), kPlanSplit);
}

// Sampled fanout term: x [c, d], pos/w [n_out, k] -> out [n_out, d];
// positions >= c (parked slots) contribute zero.
int sgt_fanout_aggregate(const void* x, int dtype, int64_t c, int d,
                         const int32_t* pos, const float* w, int n_out, int k,
                         float* out, void* stream) {
  return gather_aggregate(x, dtype, c, d, pos, w, n_out, k, out,
                          static_cast<cudaStream_t>(stream), kPlanSplit);
}

// The same function with a named split: 0 one warp per row, or 1, 2, 4, 8
// warps per row (rows of at most 512 bytes).  For measurement.
int sgt_gather_aggregate_split(const void* table, int dtype, int64_t rows,
                               int d, const int32_t* idx, const float* w,
                               int n_out, int k, float* out, void* stream,
                               int split) {
  if (split < 0) return static_cast<int>(cudaErrorInvalidValue);
  return gather_aggregate(table, dtype, rows, d, idx, w, n_out, k, out,
                          static_cast<cudaStream_t>(stream), split);
}

// The split sgt_hbm_gather_aggregate / sgt_fanout_aggregate choose, or 0
// where they run one warp per row without the split kernel.
int sgt_gather_plan(int dtype, int d, int n_out, int k) {
  return plan_split(n_out, k, d * (dtype == 1 ? 2 : 4) / 16);
}

// Sampled term of the CV estimator on top of the full term: x [c, d]
// float32, hist [hist_rows, d] float32 (hist_dtype 0) or bfloat16 (1),
// field_in [c], pos/w [n_out, k], base [n_out, d] float32 -> out [n_out, d]
// float32:
//   out[f] = base[f] + sum_s w[f, s] * (x[pos[f, s]] - hbar(field_in[pos[f, s]]))
// with hbar(n) = hist[n] for 0 <= n < min(sentinel, hist_rows), else zero.
int sgt_cv_fanout_aggregate(const float* x, int64_t c, int d,
                            const void* hist, int hist_dtype,
                            int64_t hist_rows, const int32_t* field_in,
                            int64_t sentinel, const int32_t* pos,
                            const float* w, int n_out, int k,
                            const float* base, float* out, void* stream) {
  return cv_fanout_aggregate(x, c, d, hist, hist_dtype, hist_rows, field_in,
                             sentinel, pos, w, n_out, k, base, out,
                             static_cast<cudaStream_t>(stream));
}

// Gradient of the fanout term: g [n_out, d] float32, pos/w [n_out, k] ->
// grad_x [c, d] float32, zero-filled here; positions outside [0, c) and
// zero weights contribute nothing.
int sgt_fanout_aggregate_backward(const float* g, const int32_t* pos,
                                  const float* w, int n_out, int k,
                                  int64_t c, int d, float* grad_x,
                                  void* stream) {
  return fanout_backward(g, pos, w, n_out, k, c, d, grad_x,
                         static_cast<cudaStream_t>(stream));
}

// An empty kernel: what any single launch costs at least.
int sgt_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
