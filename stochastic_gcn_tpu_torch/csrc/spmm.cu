// Gather-aggregate kernels for NVIDIA Hopper (sm_90a).
//
//   out[f, :] = sum_s w[f, s] * table[idx[f, s], :]        (f32 accumulation)
//
// Two entry points share one templated kernel:
//
// * sgt_hbm_gather_aggregate replaces the Pallas kernel
//   stochastic_gcn_tpu/ops/pallas_spmm.py::hbm_gather_aggregate
//   (_hbm_kernel): the CV full-neighbourhood term A_full . h_bar over the
//   [N+1, d] history, with idx/w the [F, Dcap] padded graph rows.
// * sgt_fanout_aggregate replaces
//   stochastic_gcn_tpu/ops/pallas_spmm.py::fanout_aggregate
//   (_fanout_kernel): the sampled SpMM A_samp . X over the [C, d] in-field
//   activations, with pos/w the [F, k] fanout slots.
//
// Both are bound by row-gather traffic, not FLOPs: each slot costs one
// random d-wide row read and d multiply-adds.  At the serving recipe the
// full term reads 2048 x 64 rows of 512 B (d = 128, f32), about 67 MB of
// random rows per batch, against 0.03 GFLOP.  The design answers that:
//
// * one warp per output row; each lane owns 16-byte column chunks of the
//   row, so every table row is read as whole, coalesced 16 B vector loads;
// * the warp loads 32 (index, weight) pairs at once and ballots the live
//   ones, so a slot with w == 0 (sentinel padding; the history's sentinel
//   row N holds garbage writes by design) or an index outside [0, rows)
//   is never read at all;
// * up to kUnroll live slots are fetched before any is accumulated, to
//   keep several row reads in flight per warp.
//
// The table is float32 or bfloat16 (converted exactly by a 16-bit shift);
// sums and the output are float32.  Launches go on the caller's stream,
// allocate nothing, and return cudaGetLastError().
//
// A third entry point, sgt_fanout_aggregate_backward, is the gradient of
// the fanout term: grad_x[pos[f, s], :] += w[f, s] * g[f, :].  The Pallas
// kernel has no VJP; the JAX model differentiates XLA's take + einsum
// (stochastic_gcn_tpu/ops/pallas_spmm.py::fanout_aggregate_xla), whose
// transpose is a scatter-add.  It is bound by the same row traffic as the
// forward, written instead of read: one warp per g row (read once into
// registers as 16 B chunks), the same ballot over live slots, and one
// float atomicAdd per value, so repeated positions (dedup-compacted fields)
// sum correctly in any order.  Under the no-dedup layout positions are
// unique and the atomics never contend.  The caller zeroes grad_x.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;
constexpr unsigned kFullMask = 0xffffffffu;

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

// kCpl: 16-byte chunks per lane (row chunks = d * sizeof(T) / 16 <= 32 * kCpl).
template <int kBf16, int kCpl>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_aggregate_kernel(const uint4* __restrict__ table, int64_t rows,
                        int chunks, const int32_t* __restrict__ idx,
                        const float* __restrict__ w, int n_out, int k,
                        float4* __restrict__ out) {
  constexpr int V = Chunk<kBf16>::kVals;
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
    const bool live = j < k && my_w != 0.f && my_i >= 0 &&
                      static_cast<int64_t>(my_i) < rows;
    unsigned mask = __ballot_sync(kFullMask, live);  // warp-uniform

    while (mask) {
      int r[kUnroll];
      float ws[kUnroll];
      bool have[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        have[u] = mask != 0;
        const int s = have[u] ? __ffs(mask) - 1 : 0;
        mask &= mask - 1;
        r[u] = __shfl_sync(kFullMask, my_i, s);
        ws[u] = __shfl_sync(kFullMask, my_w, s);
      }
      uint4 vals[kUnroll][kCpl];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int c = 0; c < kCpl; ++c) {
          const int ch = lane + c * 32;
          if (have[u] && ch < chunks)
            vals[u][c] =
                __ldg(table + static_cast<int64_t>(r[u]) * chunks + ch);
          else
            vals[u][c] = make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float wu = have[u] ? ws[u] : 0.f;
#pragma unroll
        for (int c = 0; c < kCpl; ++c) Chunk<kBf16>::fma(acc[c], vals[u][c], wu);
      }
    }
  }

  // the output row holds chunks * V floats = chunks * V / 4 float4s
  float4* out_f = out + static_cast<int64_t>(f) * (chunks * (V / 4));
#pragma unroll
  for (int c = 0; c < kCpl; ++c) {
    const int ch = lane + c * 32;
    if (ch < chunks) {
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        out_f[ch * (V / 4) + q] =
            make_float4(acc[c][4 * q], acc[c][4 * q + 1], acc[c][4 * q + 2],
                        acc[c][4 * q + 3]);
    }
  }
}

template <int kBf16, int kCpl>
void launch(const void* table, int64_t rows, int chunks, const int32_t* idx,
            const float* w, int n_out, int k, float* out,
            cudaStream_t stream) {
  const int blocks = (n_out + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gather_aggregate_kernel<kBf16, kCpl><<<blocks, kWarpsPerBlock * 32, 0,
                                         stream>>>(
      static_cast<const uint4*>(table), rows, chunks, idx, w, n_out, k,
      reinterpret_cast<float4*>(out));
}

// dtype: 0 = float32, 1 = bfloat16.  The wrapper has checked that d fills
// whole 16-byte chunks, that there are at most 128 of them, that every
// pointer is 16-byte aligned and that n_out > 0.
int gather_aggregate(const void* table, int dtype, int64_t rows, int d,
                     const int32_t* idx, const float* w, int n_out, int k,
                     float* out, cudaStream_t stream) {
  const int elem = dtype == 1 ? 2 : 4;
  const int chunks = d * elem / 16;
  const int cpl = (chunks + 31) / 32;
  if ((dtype != 0 && dtype != 1) || d * elem % 16 != 0 || cpl < 1 ||
      cpl > 4 || n_out <= 0 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (cpl == 1) launch<0, 1>(table, rows, chunks, idx, w, n_out, k, out, stream);
    else if (cpl == 2) launch<0, 2>(table, rows, chunks, idx, w, n_out, k, out, stream);
    else launch<0, 4>(table, rows, chunks, idx, w, n_out, k, out, stream);
  } else {
    if (cpl == 1) launch<1, 1>(table, rows, chunks, idx, w, n_out, k, out, stream);
    else if (cpl == 2) launch<1, 2>(table, rows, chunks, idx, w, n_out, k, out, stream);
    else launch<1, 4>(table, rows, chunks, idx, w, n_out, k, out, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// kCpl: float4 chunks of a g row per lane (chunks = d / 4 <= 32 * kCpl).
template <int kCpl>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fanout_backward_kernel(const float4* __restrict__ g, int chunks,
                       const int32_t* __restrict__ pos,
                       const float* __restrict__ w, int n_out, int k,
                       int64_t c, float* __restrict__ grad_x) {
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (f >= n_out) return;  // whole warp leaves together

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
    const bool live = j < k && my_w != 0.f && my_p >= 0 &&
                      static_cast<int64_t>(my_p) < c;
    unsigned mask = __ballot_sync(kFullMask, live);  // warp-uniform
    while (mask) {
      const int s = __ffs(mask) - 1;
      mask &= mask - 1;
      const int p = __shfl_sync(kFullMask, my_p, s);
      const float ws = __shfl_sync(kFullMask, my_w, s);
      float* row = grad_x + static_cast<int64_t>(p) * (chunks * 4);
#pragma unroll
      for (int q = 0; q < kCpl; ++q) {
        const int ch = lane + q * 32;
        if (ch < chunks) {
          atomicAdd(row + 4 * ch + 0, ws * gv[q].x);
          atomicAdd(row + 4 * ch + 1, ws * gv[q].y);
          atomicAdd(row + 4 * ch + 2, ws * gv[q].z);
          atomicAdd(row + 4 * ch + 3, ws * gv[q].w);
        }
      }
    }
  }
}

template <int kCpl>
void launch_backward(const float* g, int chunks, const int32_t* pos,
                     const float* w, int n_out, int k, int64_t c,
                     float* grad_x, cudaStream_t stream) {
  const int blocks = (n_out + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fanout_backward_kernel<kCpl><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      reinterpret_cast<const float4*>(g), chunks, pos, w, n_out, k, c,
      grad_x);
}

}  // namespace

extern "C" {

// Full-neighbourhood term: table [rows, d], idx/w [n_out, k] -> out [n_out, d].
int sgt_hbm_gather_aggregate(const void* table, int dtype, int64_t rows,
                             int d, const int32_t* idx, const float* w,
                             int n_out, int k, float* out, void* stream) {
  return gather_aggregate(table, dtype, rows, d, idx, w, n_out, k, out,
                          static_cast<cudaStream_t>(stream));
}

// Sampled fanout term: x [c, d], pos/w [n_out, k] -> out [n_out, d];
// positions >= c (parked slots) contribute zero.
int sgt_fanout_aggregate(const void* x, int dtype, int64_t c, int d,
                         const int32_t* pos, const float* w, int n_out, int k,
                         float* out, void* stream) {
  return gather_aggregate(x, dtype, c, d, pos, w, n_out, k, out,
                          static_cast<cudaStream_t>(stream));
}

// Gradient of the fanout term: g [n_out, d] float32, pos/w [n_out, k] ->
// grad_x [c, d] float32, which the caller has zeroed; positions outside
// [0, c) and zero weights contribute nothing.  The wrapper has checked
// that d is a multiple of 4, at most 512, and that n_out > 0.
int sgt_fanout_aggregate_backward(const float* g, const int32_t* pos,
                                  const float* w, int n_out, int k,
                                  int64_t c, int d, float* grad_x,
                                  void* stream) {
  const int chunks = d / 4;
  const int cpl = (chunks + 31) / 32;
  if (d % 4 != 0 || cpl < 1 || cpl > 4 || n_out <= 0 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cpl == 1) launch_backward<1>(g, chunks, pos, w, n_out, k, c, grad_x, s);
  else if (cpl == 2) launch_backward<2>(g, chunks, pos, w, n_out, k, c, grad_x, s);
  else launch_backward<4>(g, chunks, pos, w, n_out, k, c, grad_x, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
