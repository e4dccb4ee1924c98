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
//   Any call for which the plan is one full warp per row runs
//   row_gather_kernel: one warp per output row, up to 4 chunks per lane,
//   kUnroll live slots in flight.  Rows wider than 512 bytes run
//   wide_split_kernel (below, "Rows of any width") when their plan splits.
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
//   Given the rows' ends it serves the padded-sparse first layer X . W
//   (W [dim, hidden] the table, the sparse rows the slots), whose rows are
//   padded with dead (dim, 0) slots to the table's longest row: on a real
//   PubMed field (F = 15,000 rows of K = 333) reading every slot is 40 MB
//   of padding, while the 59,040 live slots sit on ~342 rows, side by
//   side, and the rest end at 0.  Bound: bytes, ~2.5 MB counted on the
//   live slots (the ends, the slots before them, W once, the output
//   written once), ~0.75 us at 3.35 TB/s; what a call pays for is the
//   launch and three dependent loads (an end, a slot, a row of W from
//   L2).  ends_gather_kernel: one wave of blocks, each owning rows a grid
//   apart (the long rows land in different blocks) and reading their ends
//   256 at once, rows that end at 0 written as zeros, a warp a row, every
//   other row dealt over the block's 8 warps (lanes 8 to a slot at
//   128-byte rows: 4 slots a load instruction, 4 in flight a lane group),
//   sums met in shared memory in a fixed order.  On an NVIDIA H100 80GB
//   HBM3 at 700 W (chip_smoke.py, PERF.md) it takes 8.6 us on 4 real
//   PubMed batches against 27.2 reading every slot, torch.sparse.mm's 98.0
//   and embedding_bag's 256.0, 0.087 of its bound; staging a block's
//   slots in shared memory, walking its long rows side by side, and
//   sharing its warps among the live rows of 4-row tiles (trial copies)
//   were all slower or no faster.  On a served PubMed field, whose 2,000
//   rows are all live (~169 slots each), it loses to the gather's plan
//   over every slot: 14.3 against 9.0 us, a block walking ~4 rows one
//   after another.
//   Without ends every caller keeps the plan above unchanged.
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
//   (PERF.md) and is not built.  Rows of at most 32 units at one warp a
//   row, every slot read (every K = 1 launch), take
//   fanout_backward_row_kernel, whose loop holds nothing else; the other
//   shapes fanout_backward_coop_kernel.
//   Two other shapes are bound by bytes, and the kernel deals with each:
//   * many slots on a row (compacted fields, K = 64 over a grad_x of
//     17 MB at Exact training's layer 1): plan_backward deals a g row's
//     slots over up to 8 warps, so that the rows of a small F fill the
//     grid after the zero-fill; at K = 1 it is one warp per row, as above;
//   * many slots on few rows (the padded-sparse first layer's gradient in
//     W [500, 32]: F = 15,000 rows of 333 slots, 1.2% of them live, up to
//     149 on one row of W).  Its rows are padded with dead (dim, 0) slots
//     to the table's longest row, so reading every slot is reading 40 MB
//     of padding, a bound close to torch.sparse.mm's whole time.  The
//     table carries, per row, the end of its live slots (data/graph.py),
//     and with those ends fanout_backward_ends_kernel reads no slot past
//     them.  A real field's few long rows sit side by side among empty
//     ones: a warp reads the ends of 8 rows a grid apart at once, skips
//     the empty ones, and walks each other row alone, 4 rounds of 32
//     slots loaded at once, lanes 8 to a slot (a row of W is 8 float4
//     units), so 4 slots' atomics go out at once.  On an NVIDIA H100 80GB
//     HBM3 at 700 W: 13.4 us on 4 real PubMed batches against 39.0
//     reading every slot and torch.sparse.mm's 15.6 (PERF.md).  That
//     kernel takes the shapes that plan one warp a row (a large F); where
//     plan_backward splits a row over warps (a small F: one warp walking
//     each long row alone would leave the grid idle; 25 real rows 5.8 us
//     against 23.3), the cooperative kernel runs with the ends.  Without
//     ends (every other caller) the cooperative kernels run alone.
//
// Rows of any width.  The chunked kernels read rows as whole 16-byte
//   chunks, at most 128 of them (4 to 512 floats in steps of 4).  A model
//   without feature preprocessing aggregates the raw features first (602
//   columns on the Reddit-shaped graphs, 1433 on Cora, 3703 on Citeseer:
//   2408-byte float32 rows are 8-byte aligned only, 1204-byte bfloat16
//   history rows 4-byte), and the JAX model computes these sums at any
//   width.  Every entry therefore chooses from the shape and the pointers
//   alone: rows of at most 32 whole 16-byte chunks behind 16-byte aligned
//   pointers take the kernels above, unchanged, and every other row goes
//   by units: the widest of 16, 8, 4 or 2 bytes that its width and its
//   pointers' alignment allow.
//   * The gather: wide_split_kernel.  Bound: bytes, as above (the full
//     term of CV without preprocessing, bf16 [65544, 602] at F = 512,
//     K = 64: ~23,000 distinct live rows of 1204 bytes, 27 MB).  A lane
//     holds a pass of up to 24 floats (602 columns of pairs) in
//     registers, so the slot list is walked once per row at these widths;
//     several warps per output row (the split rule above, with the warp's
//     slots in flight in place of kDepth) and sums added in a fixed order
//     through shared memory, as in split_gather_kernel.  Where a float32
//     row plans one warp per row (F of 1057 rows or more at 602 columns,
//     as at Exact training's first layer, F = 33,280; K too small to
//     split; rows of fewer than 32 units) wide_cols_kernel<TableCols>
//     runs instead (below): it keeps 4 blocks an SM where
//     wide_split_kernel holds 2, and wide_split_kernel at split 1
//     measured 3-46% slower than one warp a row by element (PERF.md).
//   * Rows of 33-128 whole 16-byte chunks (528-2048 bytes: hidden 256+
//     served in float32, PPI's hidden 512) take wide_tma_kernel, the same
//     walk and sums with each slot's row brought into shared memory by one
//     TMA bulk copy (rows of 1-2 KB are the unit such a copy suits), three
//     rows in flight a warp.  It measured 2-13% faster than
//     wide_split_kernel by 16-byte units at F = 512, K = 64 and on the
//     PPI batches at their best splits, and as fast on PPI's bf16 train
//     batch (PERF.md).  Where such rows plan one warp per row they keep
//     row_gather_kernel.
//   * The backward: the cooperative scatter by unit, 4-, 8- or 16-byte
//     atomics (float2 and float4 forms of compute capability 9.0).
//   * The control-variate delta: wide_cols_kernel<CvCols>, its x row and
//     history row paired by column.
//   * Where a float32 row plans one warp per row, and for the CV delta,
//     wide_cols_kernel.  Bound: bytes (Exact training's layer 0, x
//     [98816, 602] f32 at F = 33,280, K = 64, 334 MB of distinct live
//     rows) or latency (the CV delta at K = 1: three dependent loads a
//     slot).  A row's columns are split over up to 8 warps (3 at 602
//     columns), each walking the slot list once over its own range with
//     8 floats a lane, by the widest unit of 4, 2 or 1 columns that the
//     pointers allow (float pairs at 602), 4 live slots in flight a warp
//     (2 for the CV delta's two rows a slot), 4 blocks an SM; the walks of
//     a row run side by side where one warp walked the list once per 256
//     columns, one pass after another: CV's 602-wide delta at K = 1 4.1
//     us against 12.0, Exact layer 0 at its capacities 3-6% faster, a real
//     Exact batch unchanged (its DRAM traffic not measured; PERF.md).
//   Same liveness rules, same float32 fixed-order sums (bitwise
//   reproducible forward).  Times in PERF.md.
//
// sgt_empty launches an empty kernel: the floor under any single launch.
//
// sgt_gather_aggregate_split runs the gather with a named split, for
// measurement: plan_split and plan_wide are chosen from its times.
// sgt_gather_plan and sgt_backward_plan report what the other entries,
// which choose for themselves, choose.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>
#include <utility>

namespace cg = cooperative_groups;

// The build compiles this file once per part, the parts side by side
// (ops/_build.py: -DSGT_PART=1 the gathers, 2 the CV delta, 3 the
// backward), and links them into one library; compiled without SGT_PART
// it holds every part.
#ifndef SGT_PART
#define SGT_GATHER 1
#define SGT_CV 1
#define SGT_BACKWARD 1
#else
#define SGT_GATHER (SGT_PART == 1)
#define SGT_CV (SGT_PART == 2)
#define SGT_BACKWARD (SGT_PART == 3)
#endif

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kUnroll = 4;   // one warp per row: live slots in flight a warp
constexpr int kDepth = 8;    // split_gather_kernel: row loads in flight a group
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kMaxDevices = 64;  // cards of one process the backward serves
// split arguments of gather_aggregate besides 1, 2, 4, 8 warps per row
constexpr int kPlanSplit = -1;   // choose with plan_split
constexpr int kRowKernel = 0;    // one warp per row

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

// ---- rows of any width ----

// A unit of kUB bytes of a table row (kUB = 2 only for bfloat16), widened
// to kVals floats: a float32 unit holds kUB / 4 floats, a bfloat16 unit
// kUB / 2 values, element 0 first (the low half of each 32-bit word).
template <int kBf16, int kUB>
struct Unit {
  static_assert(kUB == 2 || kUB == 4 || kUB == 8 || kUB == 16, "unit bytes");
  static_assert(kBf16 || kUB >= 4, "a float32 unit holds whole floats");
  static constexpr int kVals = kUB / (kBf16 ? 2 : 4);
  using Raw = typename std::conditional<
      kUB == 2, unsigned short,
      typename std::conditional<
          kUB == 4, unsigned,
          typename std::conditional<kUB == 8, uint2,
                                    uint4>::type>::type>::type;

  __device__ __forceinline__ static Raw load(const void* table, int64_t at) {
    return __ldg(static_cast<const Raw*>(table) + at);
  }
  // one 32-bit word: a float32, or two bfloat16
  __device__ __forceinline__ static void word(float* acc, unsigned u,
                                              float w) {
    if constexpr (kBf16) {
      acc[0] = fmaf(w, __uint_as_float(u << 16), acc[0]);
      acc[1] = fmaf(w, __uint_as_float(u & 0xffff0000u), acc[1]);
    } else {
      acc[0] = fmaf(w, __uint_as_float(u), acc[0]);
    }
  }
  // the unit's kVals values as floats
  __device__ __forceinline__ static void widen(float* out, const Raw& v) {
#pragma unroll
    for (int i = 0; i < kVals; ++i) out[i] = 0.f;
    fma(out, v, 1.f);
  }
  __device__ __forceinline__ static void fma(float* acc, const Raw& v,
                                             float w) {
    constexpr int kW = kBf16 ? 2 : 1;  // floats a word widens to
    if constexpr (kUB == 2) {
      acc[0] = fmaf(w, __uint_as_float(static_cast<unsigned>(v) << 16),
                    acc[0]);
    } else if constexpr (kUB == 4) {
      word(acc, v, w);
    } else if constexpr (kUB == 8) {
      word(acc, v.x, w);
      word(acc + kW, v.y, w);
    } else {
      word(acc, v.x, w);
      word(acc + kW, v.y, w);
      word(acc + 2 * kW, v.z, w);
      word(acc + 3 * kW, v.w, w);
    }
  }
};

// ---- rows by column range: one row, several warps ----

constexpr int kLaneCols = 8;  // float sums a lane keeps for one slot walk

// A unit of kV columns of a float32 (kBf16 = 0) or bfloat16 row.
template <int kBf16, int kV>
using ColUnit = Unit<kBf16, kV * (kBf16 ? 2 : 4)>;

// The sources of wide_cols_kernel.  Each names
//   kResolves, limit(), resolve()  as the chunked sources do;
//   kDepth       live slots a warp loads before it adds any;
//   Vals<kV>     what one live slot reads for one unit of kV columns;
//   load(), zero(), fma()  that read, nothing, and acc += w * its value;
//   add_base()   what meets a finished sum before it is written.

// One table row per slot: the sampled term A_samp . X, float32 or
// bfloat16 rows.
template <int kBf16>
struct TableCols {
  static constexpr bool kResolves = false;
  static constexpr int kDepth = 4;
  template <int kV>
  struct Vals {
    typename ColUnit<kBf16, kV>::Raw v;
  };
  const void* table;
  int64_t rows;

  __device__ __forceinline__ int64_t limit() const { return rows; }
  __device__ __forceinline__ int resolve(int) const { return 0; }
  template <int kV>
  __device__ __forceinline__ Vals<kV> load(int row, int, int units,
                                           int un) const {
    return {ColUnit<kBf16, kV>::load(
        table, static_cast<int64_t>(row) * units + un)};
  }
  template <int kV>
  __device__ __forceinline__ static Vals<kV> zero() {
    return {};
  }
  template <int kV>
  __device__ __forceinline__ static void fma(float* acc, const Vals<kV>& v,
                                             float w) {
    ColUnit<kBf16, kV>::fma(acc, v.v, w);
  }
  template <int kV>
  __device__ __forceinline__ void add_base(float*, int64_t) const {}
};

// The control-variate delta: a float32 row of x at the slot's position
// less the history row (float32, or bfloat16 when kBf16) of the node
// there, zero for a node outside [0, hist_live); base added at the end.
template <int kBf16>
struct CvCols {
  static constexpr bool kResolves = true;
  static constexpr int kDepth = 2;  // two rows a slot: 64 registers a lane
  template <int kV>
  struct Vals {
    typename ColUnit<0, kV>::Raw x;
    typename ColUnit<kBf16, kV>::Raw h;
  };
  const float* x;
  int64_t c;
  const int32_t* field_in;
  const void* hist;
  int64_t hist_live;  // min(sentinel, rows of hist): never read at or above
  const float* base;

  __device__ __forceinline__ int64_t limit() const { return c; }
  __device__ __forceinline__ int resolve(int pos) const {
    const int n = __ldg(field_in + pos);
    return n >= 0 && static_cast<int64_t>(n) < hist_live ? n : -1;
  }
  template <int kV>
  __device__ __forceinline__ Vals<kV> load(int pos, int n, int units,
                                           int un) const {
    Vals<kV> v{};
    v.x = ColUnit<0, kV>::load(x, static_cast<int64_t>(pos) * units + un);
    if (n >= 0)
      v.h = ColUnit<kBf16, kV>::load(hist,
                                     static_cast<int64_t>(n) * units + un);
    return v;
  }
  template <int kV>
  __device__ __forceinline__ static Vals<kV> zero() {
    return {};
  }
  template <int kV>
  __device__ __forceinline__ static void fma(float* acc, const Vals<kV>& v,
                                             float w) {
    float xs[kV], hs[kV];
    ColUnit<0, kV>::widen(xs, v.x);
    ColUnit<kBf16, kV>::widen(hs, v.h);
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = fmaf(w, xs[i] - hs[i], acc[i]);
  }
  template <int kV>
  __device__ __forceinline__ void add_base(float* sum, int64_t at) const {
    float b[kV];
    ColUnit<0, kV>::widen(b, ColUnit<0, kV>::load(base, at));
#pragma unroll
    for (int i = 0; i < kV; ++i) sum[i] += b[i];
  }
};

// One output row, `parts` warps (1 to 8), rows of any width d >= 1 going
// by units of kV columns (4, 2 or 1: the most that d and every pointer's
// alignment allow; 8-byte float pairs for 602 raw features).  Warp `part`
// owns a contiguous range of about units / parts units and walks the
// row's slot list once over it (more than once only past
// 32 kLaneCols / kV units a warp, rows wider than 2048 columns), so the
// walks of one row run side by side and read the same rows of the table
// at about the same time.  The live slots of 32 are compacted into shared
// memory and Src::kDepth of them are loaded at once, kLaneCols floats a
// lane each.  A warp's sums cover only its own columns: no reduction
// across warps, sums in slot order, bitwise the same from run to run.
template <class Src, int kV>
__global__ void __launch_bounds__(kThreads, 4)
wide_cols_kernel(const Src src, int units, int parts,
                 const int32_t* __restrict__ idx,
                 const float* __restrict__ w, int n_out, int k,
                 float* __restrict__ out) {
  constexpr int kUpl = kLaneCols / kV;
  constexpr int kD = Src::kDepth;
  constexpr int kPass = 32 * kUpl;
  using Vals = typename Src::template Vals<kV>;
  __shared__ int4 slots[kWarpsPerBlock][32];  // live (index, node, w)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  const int64_t f = gw / parts;
  if (f >= n_out) return;  // whole warp leaves together
  const int part = static_cast<int>(gw - f * parts);
  const int span = (units + parts - 1) / parts;
  const int lo = part * span;
  const int hi = units < lo + span ? units : lo + span;
  const int32_t* idx_f = idx + f * k;
  const float* w_f = w + f * k;

  for (int u0 = lo; u0 < hi; u0 += kPass) {
    float acc[kUpl][kV];
#pragma unroll
    for (int q = 0; q < kUpl; ++q)
#pragma unroll
      for (int v = 0; v < kV; ++v) acc[q][v] = 0.f;

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
      const unsigned mask = __ballot_sync(kFullMask, live);
      const int n_live = __popc(mask);
      if (live)
        slots[warp][__popc(mask & ((1u << lane) - 1u))] =
            make_int4(my_i, my_a, __float_as_int(my_w), 0);
      __syncwarp();

      for (int e0 = 0; e0 < n_live; e0 += kD) {
        Vals vals[kD][kUpl];
        float ws[kD];
#pragma unroll
        for (int s = 0; s < kD; ++s) {
          const bool have = e0 + s < n_live;
          const int4 sl = have ? slots[warp][e0 + s] : make_int4(0, 0, 0, 0);
          ws[s] = __int_as_float(sl.z);  // 0 past the last live slot
#pragma unroll
          for (int q = 0; q < kUpl; ++q) {
            const int un = u0 + lane + 32 * q;
            vals[s][q] = have && un < hi
                             ? src.template load<kV>(sl.x, sl.y, units, un)
                             : Src::template zero<kV>();
          }
        }
#pragma unroll
        for (int s = 0; s < kD; ++s)
#pragma unroll
          for (int q = 0; q < kUpl; ++q)
            Src::template fma<kV>(acc[q], vals[s][q], ws[s]);
      }
      __syncwarp();  // all reads of slots[] done before the next round
    }

#pragma unroll
    for (int q = 0; q < kUpl; ++q) {
      const int un = u0 + lane + 32 * q;
      if (un < hi) {
        const int64_t at = f * units + un;
        src.template add_base<kV>(acc[q], at);
        if constexpr (kV == 1) {
          out[at] = acc[q][0];
        } else if constexpr (kV == 2) {
          reinterpret_cast<float2*>(out)[at] =
              make_float2(acc[q][0], acc[q][1]);
        } else {
          reinterpret_cast<float4*>(out)[at] =
              make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
        }
      }
    }
  }
}

// Columns a unit of wide_cols_kernel holds: the most of 4, 2 and 1 that
// divides d and to whose kV * element bytes every (pointer, element
// bytes) pair is aligned.
int unit_cols(int d, std::initializer_list<std::pair<const void*, int>> ptrs) {
  for (int v = 4; v > 1; v /= 2) {
    bool fits = d % v == 0;
    for (const auto& p : ptrs)
      fits = fits && reinterpret_cast<uintptr_t>(p.first) % (v * p.second) == 0;
    if (fits) return v;
  }
  return 1;
}

// Warps a row of `units` units of kV columns takes in wide_cols_kernel:
// one per kLaneCols * 32 columns, at most a block's.
int cols_parts(int units, int kv) {
  const int pass = 32 * (kLaneCols / kv);
  const int parts = (units + pass - 1) / pass;
  return parts < 1 ? 1 : (parts > kWarpsPerBlock ? kWarpsPerBlock : parts);
}

template <class Src, int kV>
void launch_cols(const Src& src, int d, const int32_t* idx, const float* w,
                 int n_out, int k, float* out, cudaStream_t stream) {
  const int units = d / kV;
  const int parts = cols_parts(units, kV);
  const int64_t warps = static_cast<int64_t>(n_out) * parts;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  wide_cols_kernel<Src, kV><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(src, units, parts, idx, w, n_out, k,
                                        out);
}

// Runs wide_cols_kernel over `src` by units of kv columns.
template <class Src>
int run_cols(const Src& src, int d, int kv, const int32_t* idx,
             const float* w, int n_out, int k, float* out,
             cudaStream_t stream) {
  if (d < 1 || n_out <= 0 || k < 0 || d % kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv == 4) launch_cols<Src, 4>(src, d, idx, w, n_out, k, out, stream);
  else if (kv == 2) launch_cols<Src, 2>(src, d, idx, w, n_out, k, out, stream);
  else launch_cols<Src, 1>(src, d, idx, w, n_out, k, out, stream);
  return static_cast<int>(cudaGetLastError());
}

// Slots a warp of wide_split_kernel keeps in flight: as many (2 or 4) as
// keep a lane's row loads within 64 registers.
__host__ __device__ constexpr int wide_depth(int unit_bytes, int upl) {
  return upl * (unit_bytes >= 4 ? unit_bytes / 4 : 1) * 4 <= 64 ? 4 : 2;
}

// Units a lane holds per pass of wide_split_kernel: 4 of 16 bytes (rows
// of 16-byte units reach it only past 2048 bytes: narrower ones take
// wide_tma_kernel), narrower units as many as make 24 floats a lane.
int wide_upl(int bf16, int unit_bytes) {
  if (unit_bytes == 16) return 4;
  return 24 / (unit_bytes / (bf16 ? 2 : 4));
}

// The gather for rows wider than 512 bytes and for rows that do not go by
// 16-byte chunks.  A row is `units` units of kUB bytes (the widest unit
// its width and the table's alignment allow: 8-byte float32 pairs for
// 602 raw features, 4-byte bfloat16 pairs for their history); a lane
// holds kUpl units a pass, so one walk of the slot list covers 32 kUpl
// units (602 columns in one pass, 1433 in two).  `split` warps per output
// row (1, 2, 4 or 8), as in split_gather_kernel: warp `part` takes slots
// part, part + split, ...; its live slots are compacted into shared memory
// and wide_depth() of them are loaded at once, a whole row per slot.  The
// warps' float sums meet in shared memory and are added in a fixed order
// (part 0 first), so the result is bitwise the same from run to run.
template <int kBf16, int kUB, int kUpl>
__global__ void __launch_bounds__(kThreads)
wide_split_kernel(const void* __restrict__ table, int64_t rows, int units,
                  const int32_t* __restrict__ idx,
                  const float* __restrict__ w, int n_out, int k, int split,
                  float* __restrict__ out) {
  using U = Unit<kBf16, kUB>;
  constexpr int V = U::kVals;
  constexpr int kD = wide_depth(kUB, kUpl);
  constexpr int kPass = 32 * kUpl;
  __shared__ int2 slots[kWarpsPerBlock][32];          // a warp's live slots
  __shared__ float partial[kUpl * V * kThreads];      // every lane's sums

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows_per_block = kWarpsPerBlock / split;
  const int part = warp % split;
  const int f0 = blockIdx.x * rows_per_block;
  const int f = f0 + warp / split;
  const int64_t d = static_cast<int64_t>(units) * V;

  for (int u0 = 0; u0 < units; u0 += kPass) {  // block-uniform
    float acc[kUpl][V];
#pragma unroll
    for (int q = 0; q < kUpl; ++q)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[q][v] = 0.f;

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
        const bool live = slot_live(j < k, my_i, my_w, rows);
        const unsigned mask = __ballot_sync(kFullMask, live);
        const int n_live = __popc(mask);
        if (live)
          slots[warp][__popc(mask & ((1u << lane) - 1u))] =
              make_int2(my_i, __float_as_int(my_w));
        __syncwarp();

        for (int e0 = 0; e0 < n_live; e0 += kD) {
          typename U::Raw vals[kD][kUpl];
          float ws[kD];
#pragma unroll
          for (int s = 0; s < kD; ++s) {
            const bool have = e0 + s < n_live;
            const int2 sl = have ? slots[warp][e0 + s] : make_int2(0, 0);
            ws[s] = __int_as_float(sl.y);  // 0 past the last live slot
            const int64_t row_at = static_cast<int64_t>(sl.x) * units;
#pragma unroll
            for (int q = 0; q < kUpl; ++q) {
              const int un = u0 + lane + 32 * q;
              vals[s][q] = have && un < units ? U::load(table, row_at + un)
                                              : typename U::Raw{};
            }
          }
#pragma unroll
          for (int s = 0; s < kD; ++s)
#pragma unroll
            for (int q = 0; q < kUpl; ++q) U::fma(acc[q], vals[s][q], ws[s]);
        }
        __syncwarp();  // all reads of slots[] done before the next round
      }
    }

#pragma unroll
    for (int q = 0; q < kUpl; ++q)
#pragma unroll
      for (int v = 0; v < V; ++v)
        partial[(q * V + v) * kThreads + threadIdx.x] = acc[q][v];
    __syncthreads();

    // out[f, u0 * V + c] = sum over the row's parts, in order
    const int pass_units = units - u0 < kPass ? units - u0 : kPass;
    const int row_vals = pass_units * V;
    for (int it = threadIdx.x; it < rows_per_block * row_vals;
         it += kThreads) {
      const int row_local = it / row_vals;
      if (f0 + row_local >= n_out) break;
      const int c = it - row_local * row_vals;
      const int un = c / V;
      const int v = c - un * V;
      const float* src = partial + ((un >> 5) * V + v) * kThreads +
                         row_local * split * 32 + (un & 31);
      float sum = 0.f;
      for (int p = 0; p < split; ++p) sum += src[p * 32];
      out[(f0 + row_local) * d + static_cast<int64_t>(u0) * V + c] = sum;
    }
    __syncthreads();  // partial[] is written again by the next pass
  }
}

// ---- rows of 33-128 chunks: through TMA ----

// Rows of 528-2048 bytes of whole 16-byte chunks brought into shared
// memory by the Tensor Memory Accelerator: one lane of each warp issues
// 1-D bulk copies (cp.async.bulk) of whole rows into a ring of kTmaStages
// row buffers, each completed on its own mbarrier, and the warp adds a
// buffer once its copy has landed, then refills it with the row
// kTmaStages slots on.  The slot walk, the split and the fixed-order sums
// are wide_split_kernel's.
constexpr int kTmaStages = 3;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_row(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wait_row(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

template <int kBf16, int kUpl>
__global__ void __launch_bounds__(kThreads)
wide_tma_kernel(const void* __restrict__ table, int64_t rows, int units,
                const int32_t* __restrict__ idx, const float* __restrict__ w,
                int n_out, int k, int split, float* __restrict__ out) {
  using U = Unit<kBf16, 16>;
  constexpr int V = U::kVals;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[kWarpsPerBlock][kTmaStages];
  __shared__ int2 slots[kWarpsPerBlock][32];
  __shared__ float partial[kUpl * V * kThreads];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows_per_block = kWarpsPerBlock / split;
  const int part = warp % split;
  const int f0 = blockIdx.x * rows_per_block;
  const int f = f0 + warp / split;
  const unsigned row_bytes = static_cast<unsigned>(units) * 16u;
  unsigned char* buf = ring + warp * kTmaStages * row_bytes;
  const unsigned char* src = static_cast<const unsigned char*>(table);
  if (lane == 0) {
    for (int s = 0; s < kTmaStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&bars[warp][s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  float acc[kUpl][V];
#pragma unroll
  for (int q = 0; q < kUpl; ++q)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[q][v] = 0.f;

  if (f < n_out) {  // warp-uniform
    const int32_t* idx_f = idx + static_cast<int64_t>(f) * k;
    const float* w_f = w + static_cast<int64_t>(f) * k;
    unsigned used = 0;  // rows this warp has consumed: stage and parity
    for (int base = 0; base < k; base += 32 * split) {
      const int j = base + part + split * lane;
      int my_i = 0;
      float my_w = 0.f;
      if (j < k) {
        my_i = idx_f[j];
        my_w = w_f[j];
      }
      const bool live = slot_live(j < k, my_i, my_w, rows);
      const unsigned mask = __ballot_sync(kFullMask, live);
      const int n_live = __popc(mask);
      if (live)
        slots[warp][__popc(mask & ((1u << lane) - 1u))] =
            make_int2(my_i, __float_as_int(my_w));
      __syncwarp();
      if (lane == 0) {
        // the buffers' last reads (generic proxy) before the copies
        // (async proxy) write them again
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int e = 0; e < n_live && e < kTmaStages; ++e) {
          const int st = (used + e) % kTmaStages;
          bulk_row(buf + st * row_bytes,
                   src + static_cast<int64_t>(slots[warp][e].x) * row_bytes,
                   row_bytes, &bars[warp][st]);
        }
      }
      for (int e = 0; e < n_live; ++e, ++used) {
        const int st = used % kTmaStages;
        wait_row(&bars[warp][st], (used / kTmaStages) & 1u);
        const uint4* row = reinterpret_cast<const uint4*>(buf + st * row_bytes);
        const float ws = __int_as_float(slots[warp][e].y);
#pragma unroll
        for (int q = 0; q < kUpl; ++q) {
          const int un = lane + 32 * q;
          if (un < units) U::fma(acc[q], row[un], ws);
        }
        __syncwarp();  // every lane has read the buffer
        if (lane == 0 && e + kTmaStages < n_live) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          bulk_row(buf + st * row_bytes,
                   src + static_cast<int64_t>(slots[warp][e + kTmaStages].x) *
                             row_bytes,
                   row_bytes, &bars[warp][st]);
        }
      }
      __syncwarp();  // all reads of slots[] done before the next round
    }
  }

#pragma unroll
  for (int q = 0; q < kUpl; ++q)
#pragma unroll
    for (int v = 0; v < V; ++v)
      partial[(q * V + v) * kThreads + threadIdx.x] = acc[q][v];
  __syncthreads();
  const int row_vals = units * V;
  for (int it = threadIdx.x; it < rows_per_block * row_vals; it += kThreads) {
    const int row_local = it / row_vals;
    if (f0 + row_local >= n_out) break;
    const int c = it - row_local * row_vals;
    const int un = c / V;
    const int v = c - un * V;
    const float* p = partial + ((un >> 5) * V + v) * kThreads +
                     row_local * split * 32 + (un & 31);
    float sum = 0.f;
    for (int s = 0; s < split; ++s) sum += p[s * 32];
    out[static_cast<int64_t>(f0 + row_local) * row_vals + c] = sum;
  }
}

// The ring of rows of up to 2048 bytes: 48 KB of dynamic shared memory,
// opted into once per device (a refusal is returned).
constexpr int kTmaRingMax = kWarpsPerBlock * kTmaStages * 2048;

template <int kBf16, int kUpl>
int launch_tma(const void* table, int64_t rows, int units, const int32_t* idx,
               const float* w, int n_out, int k, int split, float* out,
               cudaStream_t stream) {
  static bool opted[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess && (device < 0 || device >= kMaxDevices))
    e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && !opted[device]) {
    e = cudaFuncSetAttribute(wide_tma_kernel<kBf16, kUpl>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTmaRingMax);
    opted[device] = e == cudaSuccess;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = kWarpsPerBlock * kTmaStages * units * 16;
  const int rows_per_block = kWarpsPerBlock / split;
  const int blocks = (n_out + rows_per_block - 1) / rows_per_block;
  wide_tma_kernel<kBf16, kUpl><<<blocks, kThreads, smem, stream>>>(
      table, rows, units, idx, w, n_out, k, split, out);
  return static_cast<int>(cudaGetLastError());
}

#if SGT_GATHER
// Runs wide_tma_kernel over rows of 33-128 chunks (16-byte aligned).
int run_tma(const void* table, int bf16, int64_t rows, int chunks,
            const int32_t* idx, const float* w, int n_out, int k, int split,
            float* out, cudaStream_t s) {
  if (chunks <= 32 || chunks > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!bf16)
    return chunks <= 64
               ? launch_tma<0, 2>(table, rows, chunks, idx, w, n_out, k, split, out, s)
               : launch_tma<0, 4>(table, rows, chunks, idx, w, n_out, k, split, out, s);
  return chunks <= 64
             ? launch_tma<1, 2>(table, rows, chunks, idx, w, n_out, k, split, out, s)
             : launch_tma<1, 4>(table, rows, chunks, idx, w, n_out, k, split, out, s);
}
#endif  // SGT_GATHER

// Whether rows of row_bytes behind these pointers can go by 16-byte
// chunks, 1 to 4 a lane.
bool chunked_rows(int64_t row_bytes, std::initializer_list<const void*> ptrs) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || row_bytes / 16 > 128)
    return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// The widest unit of 16, 8, 4 or 2 bytes, and no narrower than `elem`,
// that divides row_bytes and to which every pointer is aligned; 0 if none.
int row_unit(int64_t row_bytes, int elem,
             std::initializer_list<const void*> ptrs) {
  for (int unit = 16; unit >= elem; unit /= 2) {
    bool fits = row_bytes % unit == 0;
    for (const void* p : ptrs)
      fits = fits && reinterpret_cast<uintptr_t>(p) % unit == 0;
    if (fits) return unit;
  }
  return 0;
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

// Warps per output row for rows of at most 32 chunks, a fixed function of
// (F, K, row bytes); kRowKernel stands for row_gather_kernel.  The split
// doubles while the launch stays under kTargetWarps warps (one wave of 32
// warps on each of 132 SMs) and every group keeps at least kDepth of the
// row's K slots, one full round of its pipeline.  A plan of one full warp
// per row is row_gather_kernel's.
constexpr int kTargetWarps = 132 * 32;
int plan_split(int n_out, int k, int chunks) {
  const int groups = groups_per_warp(chunks);
  int split = 1;
  while (split < kWarpsPerBlock &&
         static_cast<int64_t>(n_out) * split * 2 <= kTargetWarps &&
         k >= 2 * split * groups * kDepth)
    split *= 2;
  return split == 1 && groups == 1 ? kRowKernel : split;
}

// The same rule for the kernels of wider rows, whose warp should keep
// `depth` slots, up to `max_split` warps per row and `target` warps a
// launch (one wave of the blocks an SM holds at once).  A plan of one
// warp per row is kRowKernel.
int plan_wide(int n_out, int k, int depth, int max_split, int target) {
  int split = 1;
  while (split < max_split &&
         static_cast<int64_t>(n_out) * split * 2 <= target &&
         k >= 2 * split * depth)
    split *= 2;
  return split == 1 ? kRowKernel : split;
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

// Runs split_gather_kernel over a table of rows of at most 32 chunks with
// `split` 1, 2, 4 or 8 warps per row.
template <class Src>
int run_split(const Src& src, int chunks, const int32_t* idx, const float* w,
              int n_out, int k, float* out, cudaStream_t stream, int split) {
  if (chunks <= 8)
    launch_split<Src, 8>(src, chunks, idx, w, n_out, k, split, out, stream);
  else if (chunks <= 16)
    launch_split<Src, 16>(src, chunks, idx, w, n_out, k, split, out, stream);
  else
    launch_split<Src, 32>(src, chunks, idx, w, n_out, k, split, out, stream);
  return static_cast<int>(cudaGetLastError());
}

template <int kBf16, int kUB, int kUpl>
void launch_wide_split(const void* table, int64_t rows, int units,
                       const int32_t* idx, const float* w, int n_out, int k,
                       int split, float* out, cudaStream_t stream) {
  const int rows_per_block = kWarpsPerBlock / split;
  const int blocks = (n_out + rows_per_block - 1) / rows_per_block;
  wide_split_kernel<kBf16, kUB, kUpl><<<blocks, kThreads, 0, stream>>>(
      table, rows, units, idx, w, n_out, k, split, out);
}

#if SGT_GATHER
// Runs wide_split_kernel at the instantiation for (dtype, unit bytes,
// units a lane).
int run_wide_split(const void* table, int bf16, int64_t rows, int unit_bytes,
                   int units, int upl, const int32_t* idx, const float* w,
                   int n_out, int k, int split, float* out,
                   cudaStream_t stream) {
  using Launch = void (*)(const void*, int64_t, int, const int32_t*,
                          const float*, int, int, int, float*, cudaStream_t);
  Launch launch = nullptr;
  if (!bf16) {
    if (unit_bytes == 4 && upl == 24) launch = launch_wide_split<0, 4, 24>;
    if (unit_bytes == 8 && upl == 12) launch = launch_wide_split<0, 8, 12>;
    if (unit_bytes == 16 && upl == 4) launch = launch_wide_split<0, 16, 4>;
  } else {
    if (unit_bytes == 2 && upl == 24) launch = launch_wide_split<1, 2, 24>;
    if (unit_bytes == 4 && upl == 12) launch = launch_wide_split<1, 4, 12>;
    if (unit_bytes == 8 && upl == 6) launch = launch_wide_split<1, 8, 6>;
    if (unit_bytes == 16 && upl == 4) launch = launch_wide_split<1, 16, 4>;
  }
  if (launch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  launch(table, rows, units, idx, w, n_out, k, split, out, stream);
  return static_cast<int>(cudaGetLastError());
}
#endif  // SGT_GATHER

// The kernel a gather runs, from the shape and the alignment alone:
// rows of at most 32 whole 16-byte chunks behind 16-byte aligned pointers
// take split_gather_kernel / row_gather_kernel by plan_split; rows of
// 33-128 such chunks wide_tma_kernel by plan_wide, or row_gather_kernel
// where they plan one warp per row; every other row wide_split_kernel by
// plan_wide, or wide_cols_kernel<TableCols> where it plans one warp per
// row (several warps a row there, each over its own columns).
struct GatherPlan {
  int chunks;      // 16-byte chunks of a row, or 0 where not chunked_rows
  int unit_bytes;  // the row's unit, or 0 for rows of <= 32 chunks
  int units;
  int upl;
  int split;       // kRowKernel, or warps per row
};

GatherPlan plan_gather(int dtype, int d, int n_out, int k, bool chunked,
                       int unit_bytes) {
  const int64_t row_bytes = static_cast<int64_t>(d) * (dtype == 1 ? 2 : 4);
  GatherPlan plan{chunked ? static_cast<int>(row_bytes / 16) : 0, 0, 0, 0, 0};
  if (chunked && plan.chunks <= 32) {
    plan.split = plan_split(n_out, k, plan.chunks);
    return plan;
  }
  plan.unit_bytes = unit_bytes;
  plan.units = static_cast<int>(row_bytes / unit_bytes);
  plan.upl = wide_upl(dtype, unit_bytes);
  if (chunked) {
    // wide_tma_kernel: two rounds of its kTmaStages-row ring a warp (the
    // PPI train batch, K = 41, measured faster at 4 warps per row than at
    // 8, whose warps hold ~2 live slots); 2048-byte rows measured faster
    // at 4 warps per row than at 8
    plan.split = plan_wide(n_out, k, 2 * kTmaStages,
                           plan.chunks > 64 ? 4 : kWarpsPerBlock,
                           kTargetWarps);
  } else if (plan.units < 32) {
    plan.split = kRowKernel;  // a row narrower than a warp's lanes
  } else {
    // wide_split_kernel.  Where a lane holds 24 or more floats a pass
    // the registers leave room for 2 blocks an SM, so the launch should
    // fit 16 warps an SM, and the split stops at 4 (602 columns split 4
    // ways measured faster than 8; at F = 2048 one warp per row measured
    // faster than 2)
    const int lane_floats = plan.upl * unit_bytes / (dtype == 1 ? 2 : 4);
    const bool heavy = lane_floats >= 24;
    plan.split = plan_wide(n_out, k, wide_depth(unit_bytes, plan.upl),
                           heavy ? 4 : kWarpsPerBlock,
                           heavy ? kTargetWarps / 2 : kTargetWarps);
    // One warp per row goes to wide_cols_kernel<TableCols> (4 blocks an
    // SM, a row's columns over several warps) for a float32 row; a
    // bfloat16 row keeps wide_split_kernel at split 1, whose 4- or 8-byte
    // units measured ~3x faster than 2-byte element loads.
    if (plan.split == kRowKernel && dtype == 1) plan.split = 1;
  }
  return plan;
}

#if SGT_GATHER
// dtype: 0 = float32, 1 = bfloat16.  split: kPlanSplit (the plan above),
// kRowKernel (one warp per row: row_gather_kernel, or where rows do not go
// by chunks wide_cols_kernel<TableCols>, the row's columns over warps), or
// 1, 2, 4, 8 warps per row.
// The wrapper has checked that n_out > 0.
int gather_aggregate(const void* table, int dtype, int64_t rows, int d,
                     const int32_t* idx, const float* w, int n_out, int k,
                     float* out, cudaStream_t stream, int split) {
  const int elem = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || d <= 0 || n_out <= 0 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t row_bytes = static_cast<int64_t>(d) * elem;
  const int unit_bytes = row_unit(row_bytes, elem, {table});
  if (unit_bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  const GatherPlan plan = plan_gather(
      dtype, d, n_out, k, chunked_rows(row_bytes, {table, out}), unit_bytes);
  if (split == kPlanSplit) split = plan.split;
  if (split != kRowKernel && split != 1 && split != 2 && split != 4 &&
      split != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint4* t = static_cast<const uint4*>(table);
  if (split == kRowKernel && plan.chunks > 0) {
    if (dtype == 0)
      return run_row(TableSource<0>{t, rows}, plan.chunks, idx, w, n_out, k,
                     out, stream);
    return run_row(TableSource<1>{t, rows}, plan.chunks, idx, w, n_out, k,
                   out, stream);
  }
  if (split == kRowKernel) {  // rows that do not go by chunks
    const int kv = unit_cols(d, {{table, elem}, {out, 4}});
    if (dtype == 0)
      return run_cols(TableCols<0>{table, rows}, d, kv, idx, w, n_out, k,
                      out, stream);
    return run_cols(TableCols<1>{table, rows}, d, kv, idx, w, n_out, k, out,
                    stream);
  }
  if (plan.unit_bytes == 0) {  // rows of at most 32 chunks
    if (dtype == 0)
      return run_split(TableSource<0>{t, rows}, plan.chunks, idx, w, n_out,
                       k, out, stream, split);
    return run_split(TableSource<1>{t, rows}, plan.chunks, idx, w, n_out, k,
                     out, stream, split);
  }
  if (plan.chunks > 0)  // 33-128 chunks
    return run_tma(table, dtype, rows, plan.chunks, idx, w, n_out, k, split,
                   out, stream);
  return run_wide_split(table, dtype, rows, plan.unit_bytes, plan.units,
                        plan.upl, idx, w, n_out, k, split, out, stream);
}

// ---- the sampled term over rows with ends ----

constexpr int kEndsDepth = 4;  // slots a lane group loads before it adds

// acc += w[s] * table[idx[s], unit un] over the live slots s < e of one
// row (idx, w: its slots), dealt to the block's warps of `groups` lane
// groups: warp `warp`, group `group` takes slot (u * kWarpsPerBlock +
// warp) * groups + group of each round of kEndsDepth * kWarpsPerBlock *
// groups slots, u < kEndsDepth.  A lane loads its slot's index and weight
// itself (the lanes of a group read the same address), so a round is two
// dependent loads deep.  un < 0: the lane holds no unit of this pass and
// loads no row.
template <int kBf16, int kUB>
__device__ __forceinline__ void ends_walk(
    float* acc, const void* __restrict__ table, int64_t rows, int units,
    int un, const int32_t* __restrict__ idx, const float* __restrict__ w,
    int e, int warp, int groups, int group) {
  using U = Unit<kBf16, kUB>;
  const int round = kEndsDepth * kWarpsPerBlock * groups;
  for (int base = 0; base < e; base += round) {
    int r[kEndsDepth];
    float ws[kEndsDepth];
#pragma unroll
    for (int u = 0; u < kEndsDepth; ++u) {
      const int s = base + (u * kWarpsPerBlock + warp) * groups + group;
      int i = -1;
      float wv = 0.f;
      if (s < e) {
        i = __ldg(idx + s);
        wv = __ldg(w + s);
      }
      const bool live = slot_live(s < e, i, wv, rows);
      r[u] = live ? i : -1;
      ws[u] = live ? wv : 0.f;
    }
    typename U::Raw v[kEndsDepth];
#pragma unroll
    for (int u = 0; u < kEndsDepth; ++u)
      v[u] = r[u] >= 0 && un >= 0
                 ? U::load(table, static_cast<int64_t>(r[u]) * units + un)
                 : typename U::Raw{};
#pragma unroll
    for (int u = 0; u < kEndsDepth; ++u) U::fma(acc, v[u], ws[u]);
  }
}

// One row of the sampled term with ends, its e > 0 slots (idx, w) walked
// by the block's 8 warps: lane groups of `lanes` lanes, one unit a lane,
// sums added across a warp's groups by shuffle (the same order in every
// lane), then across the warps in shared memory (`partial`), in warp
// order, into out_f.
template <int kBf16, int kUB>
__device__ __forceinline__ void ends_row(
    const void* __restrict__ table, int64_t rows, int units, int lanes,
    const int32_t* __restrict__ idx, const float* __restrict__ w, int e,
    float (*partial)[32 * Unit<kBf16, kUB>::kVals],
    float* __restrict__ out_f) {
  constexpr int V = Unit<kBf16, kUB>::kVals;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = lane / lanes;
  const int sub = lane - group * lanes;
  for (int u0 = 0; u0 < units; u0 += lanes) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    const int un = u0 + sub < units ? u0 + sub : -1;
    ends_walk<kBf16, kUB>(acc, table, rows, units, un, idx, w, e, warp,
                          32 / lanes, group);
    for (int off = lanes; off < 32; off <<= 1)
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[v] += __shfl_xor_sync(kFullMask, acc[v], off);
    if (group == 0)
#pragma unroll
      for (int v = 0; v < V; ++v) partial[warp][sub * V + v] = acc[v];
    __syncthreads();
    // value t of the pass: unit u0 + t / V, column u0 * V + t
    for (int t = threadIdx.x; t < lanes * V; t += kThreads) {
      if (u0 + t / V < units) {
        float sum = 0.f;
#pragma unroll
        for (int p = 0; p < kWarpsPerBlock; ++p) sum += partial[p][t];
        out_f[static_cast<int64_t>(u0) * V + t] = sum;
      }
    }
    __syncthreads();  // partial[] is read before the next pass writes it
  }
}

// The sampled term where every live slot of row f lies before ends[f]: the
// padded-sparse first layer X . W, W the table.  Block b owns rows b,
// b + G, b + 2G, ... (G = gridDim.x, at most the blocks the card holds at
// once), so the long rows of a field, which sit side by side, land in
// different blocks, and one launch is one wave.  It takes them 256 at a
// time, a thread reading one row's end, so a field of mostly empty rows
// costs one load of the ends a block.  Rows that end at 0 are written as
// zeros, a warp a row; the others are walked one after another, each by
// all 8 warps (a real field's fall 0-4 to a block).  A pass covers `lanes`
// units of the row (8, 16 or 32: the row's units, up to 32), one unit a
// lane, so 32 / lanes slots go out with each load instruction; wider rows
// take several passes.  Sums in a fixed order (slots, then lane groups by
// shuffle, then warps), the same for every row whatever the grid: bitwise
// the same from run to run.
template <int kBf16, int kUB>
__global__ void __launch_bounds__(kThreads, 4)
ends_gather_kernel(const void* __restrict__ table, int64_t rows, int units,
                   const int32_t* __restrict__ idx,
                   const float* __restrict__ w,
                   const int32_t* __restrict__ ends, int n_out, int k,
                   int lanes, float* __restrict__ out) {
  constexpr int V = Unit<kBf16, kUB>::kVals;
  __shared__ float partial[kWarpsPerBlock][32 * V];
  __shared__ int row_end[kThreads];
  __shared__ unsigned live_rows[kWarpsPerBlock];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t grid = gridDim.x;
  const int64_t d = static_cast<int64_t>(units) * V;
  // rows of this block: b + i * grid for i < mine
  const int64_t mine =
      (static_cast<int64_t>(n_out) - 1 - blockIdx.x) / grid + 1;
  for (int64_t i0 = 0; i0 < mine; i0 += kThreads) {  // block-uniform
    const int here = static_cast<int>(
        mine - i0 < kThreads ? mine - i0 : kThreads);
    int e = 0;
    if (threadIdx.x < here) {
      e = __ldg(ends + blockIdx.x + (i0 + threadIdx.x) * grid);
      e = e < 0 ? 0 : (e > k ? k : e);
    }
    row_end[threadIdx.x] = e;
    const unsigned l = __ballot_sync(kFullMask, e > 0);
    if (lane == 0) live_rows[warp] = l;
    __syncthreads();

    // rows that end at 0: zeros, a warp a row
    for (int j = warp; j < here; j += kWarpsPerBlock) {
      if (row_end[j] != 0) continue;  // warp-uniform
      float* out_j = out + (blockIdx.x + (i0 + j) * grid) * d;
      for (int64_t i = lane; i < d; i += 32) out_j[i] = 0.f;
    }
    // the other rows, a block each
    for (int m = 0; m < kWarpsPerBlock; ++m) {
      unsigned mask = live_rows[m];
      while (mask) {  // block-uniform
        const int j = m * 32 + __ffs(mask) - 1;
        mask &= mask - 1;
        const int64_t f = blockIdx.x + (i0 + j) * grid;
        ends_row<kBf16, kUB>(table, rows, units, lanes, idx + f * k,
                             w + f * k, row_end[j], partial, out + f * d);
      }
    }
    __syncthreads();  // row_end[] and the masks are read before reuse
  }
}

template <int kBf16, int kUB>
int launch_ends_gather(const void* table, int64_t rows, int units,
                       const int32_t* idx, const float* w,
                       const int32_t* ends, int n_out, int k, float* out,
                       cudaStream_t stream) {
  // the blocks the card holds at once, counted at the first call on each
  // device
  static int resident[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess && (device < 0 || device >= kMaxDevices))
    e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && resident[device] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ends_gather_kernel<kBf16, kUB>, kThreads, 0);
    if (e == cudaSuccess) resident[device] = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int lanes = units <= 8 ? 8 : units <= 16 ? 16 : 32;
  const int blocks = n_out < resident[device] ? n_out : resident[device];
  ends_gather_kernel<kBf16, kUB><<<blocks, kThreads, 0, stream>>>(
      table, rows, units, idx, w, ends, n_out, k, lanes, out);
  return static_cast<int>(cudaGetLastError());
}

// The sampled term given the rows' ends, rows of any width: by the widest
// unit of 16, 8, 4 or 2 bytes the row and the table pointer allow (W
// [dim, 32] float32: 8 units of 16 bytes).  The wrapper has checked that
// n_out > 0.
int ends_gather(const void* table, int dtype, int64_t rows, int d,
                const int32_t* idx, const float* w, const int32_t* ends,
                int n_out, int k, float* out, cudaStream_t s) {
  const int elem = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) || d <= 0 || n_out <= 0 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t row_bytes = static_cast<int64_t>(d) * elem;
  const int unit = row_unit(row_bytes, elem, {table});
  if (unit == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int units = static_cast<int>(row_bytes / unit);
  if (dtype == 0) {
    if (unit == 16)
      return launch_ends_gather<0, 16>(table, rows, units, idx, w, ends, n_out, k, out, s);
    if (unit == 8)
      return launch_ends_gather<0, 8>(table, rows, units, idx, w, ends, n_out, k, out, s);
    return launch_ends_gather<0, 4>(table, rows, units, idx, w, ends, n_out, k, out, s);
  }
  if (unit == 16)
    return launch_ends_gather<1, 16>(table, rows, units, idx, w, ends, n_out, k, out, s);
  if (unit == 8)
    return launch_ends_gather<1, 8>(table, rows, units, idx, w, ends, n_out, k, out, s);
  if (unit == 4)
    return launch_ends_gather<1, 4>(table, rows, units, idx, w, ends, n_out, k, out, s);
  return launch_ends_gather<1, 2>(table, rows, units, idx, w, ends, n_out, k, out, s);
}

#endif  // SGT_GATHER

#if SGT_CV
// The control-variate delta.  Columns go by x's 16-byte chunks, one warp
// per output row, where d is a multiple of 4, at most 512, and x, hist,
// base and out are 16-byte aligned (a bfloat16 history row is then read 8
// bytes a lane); otherwise wide_cols_kernel by units of 4, 2 or 1
// columns.  The wrapper has checked that n_out > 0.
int cv_fanout_aggregate(const float* x, int64_t c, int d, const void* hist,
                        int hist_dtype, int64_t hist_rows,
                        const int32_t* field_in, int64_t sentinel,
                        const int32_t* pos, const float* w, int n_out, int k,
                        const float* base, float* out, cudaStream_t stream) {
  if ((hist_dtype != 0 && hist_dtype != 1) || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t hist_live = sentinel < hist_rows ? sentinel : hist_rows;
  if (hist_live < 0) hist_live = 0;
  if (!chunked_rows(static_cast<int64_t>(d) * 4, {x, hist, base, out})) {
    const int kv = unit_cols(
        d, {{x, 4}, {hist, hist_dtype == 1 ? 2 : 4}, {base, 4}, {out, 4}});
    if (hist_dtype == 0)
      return run_cols(CvCols<0>{x, c, field_in, hist, hist_live, base}, d,
                      kv, pos, w, n_out, k, out, stream);
    return run_cols(CvCols<1>{x, c, field_in, hist, hist_live, base}, d, kv,
                    pos, w, n_out, k, out, stream);
  }
  const int chunks = d / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* base4 = reinterpret_cast<const float4*>(base);
  if (hist_dtype == 0)
    return run_row(CvSource<0>{x4, c, field_in, hist, hist_live, base4},
                   chunks, pos, w, n_out, k, out, stream);
  return run_row(CvSource<1>{x4, c, field_in, hist, hist_live, base4},
                 chunks, pos, w, n_out, k, out, stream);
}

#endif  // SGT_CV

#if SGT_BACKWARD
// ---- the backward ----

// A unit of a float32 g / grad_x row: 4, 8 or 16 bytes, scattered with
// one atomicAdd (the float2 and float4 forms: compute capability 9.0).
template <int kUB>
struct GradUnit;
template <>
struct GradUnit<4> {
  using T = float;
  __device__ __forceinline__ static T scaled(T v, float s) { return s * v; }
};
template <>
struct GradUnit<8> {
  using T = float2;
  __device__ __forceinline__ static T scaled(T v, float s) {
    return make_float2(s * v.x, s * v.y);
  }
};
template <>
struct GradUnit<16> {
  using T = float4;
  __device__ __forceinline__ static T scaled(T v, float s) {
    return make_float4(s * v.x, s * v.y, s * v.z, s * v.w);
  }
};

// Zero-fills n floats of p from thread `at` of `stride` threads, 16 bytes
// a store where p is 16-byte aligned.
__device__ __forceinline__ void zero_fill(float* __restrict__ p, int64_t n,
                                          int64_t at, int64_t stride) {
  if (reinterpret_cast<uintptr_t>(p) % 16 == 0) {
    float4* p4 = reinterpret_cast<float4*>(p);
    for (int64_t i = at; i < n / 4; i += stride)
      p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t i = n / 4 * 4 + at; i < n; i += stride) p[i] = 0.f;
  } else {
    for (int64_t i = at; i < n; i += stride) p[i] = 0.f;
  }
}

// Zero-fills n units of grad_x: a 16-byte unit a store by its own type
// (the pointer is 16-byte aligned), other units through zero_fill.
template <int kUB>
__device__ __forceinline__ void zero_units(
    typename GradUnit<kUB>::T* __restrict__ p, int64_t n, int64_t at,
    int64_t stride) {
  if constexpr (kUB == 16) {
    for (int64_t i = at; i < n; i += stride)
      p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    zero_fill(reinterpret_cast<float*>(p), n * (kUB / 4), at, stride);
  }
}

// The end of row f's slots: k, or with ends, ends[f] clamped to [0, k].
template <bool kEnds>
__device__ __forceinline__ int row_end(const int32_t* __restrict__ ends,
                                       int64_t f, int k) {
  if constexpr (!kEnds) {
    return k;
  } else {
    const int e = __ldg(ends + f);
    return e < 0 ? 0 : (e > k ? k : e);
  }
}

// Adds w[f, s] * g[f, :] to grad_x[pos[f, s], :] for the live slots part,
// part + split, ... before `end` of row f (of k); one warp, the g row's
// units in registers, kUpl units a lane a pass (rows of more than 32 kUpl
// units take several passes over the slots).
template <int kUB, int kUpl>
__device__ __forceinline__ void scatter_row(
    int f, int part, int split, int lane,
    const typename GradUnit<kUB>::T* __restrict__ g, int units,
    const int32_t* __restrict__ pos, const float* __restrict__ w, int k,
    int end, int64_t c, typename GradUnit<kUB>::T* __restrict__ grad_x) {
  using T = typename GradUnit<kUB>::T;
  const int32_t* pos_f = pos + static_cast<int64_t>(f) * k;
  const float* w_f = w + static_cast<int64_t>(f) * k;
  for (int u0 = 0; u0 < units; u0 += 32 * kUpl) {
    T gv[kUpl];
#pragma unroll
    for (int q = 0; q < kUpl; ++q) {
      const int un = u0 + lane + q * 32;
      gv[q] = un < units ? g[static_cast<int64_t>(f) * units + un] : T{};
    }
    for (int base = 0; base < end; base += 32 * split) {
      const int j = base + part + split * lane;
      int my_p = 0;
      float my_w = 0.f;
      if (j < end) {
        my_p = pos_f[j];
        my_w = w_f[j];
      }
      unsigned mask =
          __ballot_sync(kFullMask, slot_live(j < end, my_p, my_w, c));
      while (mask) {  // warp-uniform
        const int s = __ffs(mask) - 1;
        mask &= mask - 1;
        const int p = __shfl_sync(kFullMask, my_p, s);
        const float ws = __shfl_sync(kFullMask, my_w, s);
        T* row = grad_x + static_cast<int64_t>(p) * units;
#pragma unroll
        for (int q = 0; q < kUpl; ++q) {
          const int un = u0 + lane + q * 32;
          if (un < units)
            atomicAdd(row + un, GradUnit<kUB>::scaled(gv[q], ws));
        }
      }
    }
  }
}

// One cooperative launch: zero-fill grad_x, grid-wide barrier, scatter,
// one warp a row of at most 32 units, every slot read: every K = 1 launch
// of the main path.  fanout_backward_coop_kernel below does the same at
// split 1 with passes, parts and ends in its loop, and measured 0.09 us
// slower at the training shape (PERF.md), so this shape keeps its own.
template <int kUB>
__global__ void __launch_bounds__(kThreads)
fanout_backward_row_kernel(const typename GradUnit<kUB>::T* __restrict__ g,
                           int units, const int32_t* __restrict__ pos,
                           const float* __restrict__ w, int n_out, int k,
                           int64_t c,
                           typename GradUnit<kUB>::T* __restrict__ grad_x) {
  using T = typename GradUnit<kUB>::T;
  zero_units<kUB>(grad_x, c * units,
                  static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x,
                  static_cast<int64_t>(gridDim.x) * kThreads);
  cg::this_grid().sync();
  const int lane = threadIdx.x & 31;
  for (int f = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); f < n_out;
       f += gridDim.x * kWarpsPerBlock) {
    const T gv = lane < units ? g[static_cast<int64_t>(f) * units + lane]
                              : T{};
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
      unsigned mask =
          __ballot_sync(kFullMask, slot_live(j < k, my_p, my_w, c));
      while (mask) {  // warp-uniform
        const int s = __ffs(mask) - 1;
        mask &= mask - 1;
        const int p = __shfl_sync(kFullMask, my_p, s);
        const float ws = __shfl_sync(kFullMask, my_w, s);
        if (lane < units)
          atomicAdd(grad_x + static_cast<int64_t>(p) * units + lane,
                    GradUnit<kUB>::scaled(gv, ws));
      }
    }
  }
}

// The same launch for any row and split: warp `item` of the grid-stride
// loop takes row item >> split_shift, part item & (split - 1) of its
// slots (split = 1 << split_shift warps a row).  With kEnds a row's slots
// at or past ends[f] are not read.
template <int kUB, int kUpl, bool kEnds>
__global__ void __launch_bounds__(kThreads)
fanout_backward_coop_kernel(const typename GradUnit<kUB>::T* __restrict__ g,
                            int units, const int32_t* __restrict__ pos,
                            const float* __restrict__ w,
                            const int32_t* __restrict__ ends, int n_out,
                            int k, int split_shift, int64_t c,
                            typename GradUnit<kUB>::T* __restrict__ grad_x) {
  zero_units<kUB>(grad_x, c * units,
                  static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x,
                  static_cast<int64_t>(gridDim.x) * kThreads);
  cg::this_grid().sync();
  // split > 1 only where n_out * split is at most kTargetWarps
  const int items = n_out << split_shift;
  const int split = 1 << split_shift;
  for (int item = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       item < items; item += gridDim.x * kWarpsPerBlock) {
    const int f = item >> split_shift;
    scatter_row<kUB, kUpl>(f, item & (split - 1), split, threadIdx.x & 31, g,
                           units, pos, w, k, row_end<kEnds>(ends, f, k), c,
                           grad_x);
  }
}

// ---- the backward over rows with ends ----

constexpr int kEndsRows = 8;    // rows whose ends a warp reads at once
constexpr int kEndsRounds = 4;  // rounds of 32 slots a warp loads at once

// The same scatter where every live slot of row f lies before ends[f]: the
// padded-sparse first layer's gradient in W, whose rows are padded with
// dead (dim, 0) slots to the table's longest row.  Slots at or past
// ends[f] are never read.  On a real field most rows are empty (sentinel
// rows and unused capacity end at 0) and the rest long and side by side
// (PubMed: ~340 of 15,000 rows, ~170 slots each).  So a warp reads the ends
// of kEndsRows rows a grid of warps apart at once (lane j: row w + j W;
// the long rows land on different warps), skips the empty ones, and walks
// each other row alone: its slots before the end, kEndsRounds rounds of 32
// loaded at once, added 32 / kLanes at a time, groups of kLanes lanes
// taking one slot each (one unit a lane, kLanes >= the row's units where
// it can), the g row's first unit held in registers.
template <int kUB, int kLanes>
__global__ void __launch_bounds__(kThreads)
fanout_backward_ends_kernel(const typename GradUnit<kUB>::T* __restrict__ g,
                            int units, const int32_t* __restrict__ pos,
                            const float* __restrict__ w,
                            const int32_t* __restrict__ ends, int n_out,
                            int k, int64_t c,
                            typename GradUnit<kUB>::T* __restrict__ grad_x) {
  using T = typename GradUnit<kUB>::T;
  constexpr int G = 32 / kLanes;  // slots a warp adds at once
  zero_units<kUB>(grad_x, c * units,
                  static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x,
                  static_cast<int64_t>(gridDim.x) * kThreads);
  cg::this_grid().sync();
  const int lane = threadIdx.x & 31;
  const int group = lane / kLanes;
  const int sub = lane % kLanes;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t r0 = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       r0 < n_out; r0 += warps * kEndsRows) {
    const int64_t mine = r0 + warps * lane;  // lane's row, lanes < kEndsRows
    int my_e = 0;
    if (lane < kEndsRows && mine < n_out) {
      my_e = __ldg(ends + mine);
      my_e = my_e < 0 ? 0 : (my_e > k ? k : my_e);
    }
    unsigned rows = __ballot_sync(kFullMask, my_e > 0);
    while (rows) {  // warp-uniform
      const int j = __ffs(rows) - 1;
      rows &= rows - 1;
      const int64_t f = r0 + warps * j;
      const int e = __shfl_sync(kFullMask, my_e, j);
      const T* g_f = g + f * units;
      const T gv = sub < units ? __ldg(g_f + sub) : T{};
      const int32_t* pos_f = pos + f * k;
      const float* w_f = w + f * k;
      for (int base = 0; base < e; base += 32 * kEndsRounds) {
        int my_p[kEndsRounds];
        float my_w[kEndsRounds];
#pragma unroll
        for (int r = 0; r < kEndsRounds; ++r) {
          const int s = base + 32 * r + lane;
          my_p[r] = s < e ? pos_f[s] : -1;
          my_w[r] = s < e ? w_f[s] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kEndsRounds; ++r) {
          if (base + 32 * r >= e) break;  // warp-uniform
#pragma unroll 8  // all of it at 8 lanes a slot; fully, 128 copies at 32
          for (int it = 0; it < 32 / G; ++it) {
            const int src = it * G + group;  // the lane holding this slot
            const int p = __shfl_sync(kFullMask, my_p[r], src);
            const float ws = __shfl_sync(kFullMask, my_w[r], src);
            if (!slot_live(true, p, ws, c)) continue;
            T* row = grad_x + static_cast<int64_t>(p) * units;
            if (sub < units)
              atomicAdd(row + sub, GradUnit<kUB>::scaled(gv, ws));
            for (int un = sub + kLanes; un < units; un += kLanes)
              atomicAdd(row + un, GradUnit<kUB>::scaled(__ldg(g_f + un), ws));
          }
        }
      }
    }
  }
}

// The current device, checked against kMaxDevices.
cudaError_t current_device(int* device) {
  const cudaError_t e = cudaGetDevice(device);
  if (e != cudaSuccess) return e;
  return *device < 0 || *device >= kMaxDevices ? cudaErrorInvalidDevice
                                               : cudaSuccess;
}

// Blocks of the cooperative `kernel` that the current device holds at
// once, counted at the first call on each device into the caller's
// `counted[kMaxDevices]` (0: not yet counted).
template <class Kernel>
cudaError_t resident_blocks(Kernel kernel, int* counted, int* blocks) {
  int device = 0;
  cudaError_t e = current_device(&device);
  if (e != cudaSuccess) return e;
  if (counted[device] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) return e;
    if (sms * per_sm < 1) return cudaErrorLaunchOutOfResources;
    counted[device] = sms * per_sm;
  }
  *blocks = counted[device];
  return cudaSuccess;
}

// Launches a cooperative backward `kernel` whose grid-stride loop has
// `warps` warps of work and which zero-fills `fill_floats` floats.
template <class Kernel>
cudaError_t launch_coop(Kernel kernel, int* counted, int64_t warps,
                        int64_t fill_floats, void** args,
                        cudaStream_t stream) {
  const int64_t warp_blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  // cooperative: every block must be resident at once
  int resident = 0;
  const cudaError_t e = resident_blocks(kernel, counted, &resident);
  if (e != cudaSuccess) return e;
  // a thread zero-fills kFillPerThread 16-byte stores: a smaller grid,
  // whose barrier is cheaper
  constexpr int kFillPerThread = 16;
  const int64_t fill_blocks = (fill_floats / 4 + kThreads * kFillPerThread - 1) /
                              (kThreads * kFillPerThread);
  int64_t blocks = warp_blocks > fill_blocks ? warp_blocks : fill_blocks;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), dim3(static_cast<unsigned>(blocks)),
      dim3(kThreads), args, 0, stream);
}

template <int kUB, int kUpl>
cudaError_t launch_backward(const float* g, int units, const int32_t* pos,
                            const float* w, const int32_t* ends, int n_out,
                            int k, int split, int64_t c, float* grad_x,
                            cudaStream_t stream) {
  using T = typename GradUnit<kUB>::T;
  static int counted[kMaxDevices] = {};
  const T* gu = reinterpret_cast<const T*>(g);
  T* grad = reinterpret_cast<T*>(grad_x);
  int shift = 0;
  while ((1 << shift) < split) ++shift;
  void* args[] = {&gu, &units, &pos, &w, &ends, &n_out, &k, &shift, &c, &grad};
  const int64_t warps = static_cast<int64_t>(n_out) * split;
  const int64_t fill = c * units * (kUB / 4);
  if constexpr (kUpl == 1) {  // the ends reach this kernel at one unit a lane
    static int counted_row[kMaxDevices] = {};
    static int counted_ends[kMaxDevices] = {};
    if (ends != nullptr)
      return launch_coop(fanout_backward_coop_kernel<kUB, 1, true>,
                         counted_ends, warps, fill, args, stream);
    if (split == 1) {
      void* row_args[] = {&gu, &units, &pos, &w, &n_out, &k, &c, &grad};
      return launch_coop(fanout_backward_row_kernel<kUB>, counted_row, warps,
                         fill, row_args, stream);
    }
  }
  return launch_coop(fanout_backward_coop_kernel<kUB, kUpl, false>, counted,
                     warps, fill, args, stream);
}

template <int kUB, int kLanes>
cudaError_t launch_backward_ends(const float* g, int units,
                                 const int32_t* pos, const float* w,
                                 const int32_t* ends, int n_out, int k,
                                 int64_t c, float* grad_x,
                                 cudaStream_t stream) {
  using T = typename GradUnit<kUB>::T;
  static int counted[kMaxDevices] = {};
  const T* gu = reinterpret_cast<const T*>(g);
  T* grad = reinterpret_cast<T*>(grad_x);
  void* args[] = {&gu, &units, &pos, &w, &ends, &n_out, &k, &c, &grad};
  return launch_coop(fanout_backward_ends_kernel<kUB, kLanes>, counted,
                     (static_cast<int64_t>(n_out) + kEndsRows - 1) / kEndsRows,
                     c * units * (kUB / 4), args, stream);
}

// Warps per g row in the cooperative scatter, a fixed function of (F, K):
// the split doubles while the launch stays under kTargetWarps warps and
// each warp keeps at least 8 of the row's K slots (at K = 1 it is 1).
int plan_backward(int n_out, int k) {
  int split = 1;
  while (split < kWarpsPerBlock &&
         static_cast<int64_t>(n_out) * split * 2 <= kTargetWarps &&
         k >= 2 * split * 8)
    split *= 2;
  return split;
}

// Units a lane holds per pass of the cooperative scatter: one where a row
// is at most 32 units; else 16-byte chunks 2 or 4 (rows of up to 128
// chunks in one pass), 8-byte pairs 12 and floats 24 (602 columns in one
// pass).
int backward_upl(int unit_bytes, int units) {
  if (units <= 32) return 1;
  if (unit_bytes == 16) return units <= 64 ? 2 : 4;
  return unit_bytes == 8 ? 12 : 24;
}

// The scatter with ends: lanes a slot, as many as the row's units up to 32.
template <int kUB>
cudaError_t run_backward_ends(const float* g, int units, const int32_t* pos,
                              const float* w, const int32_t* ends, int n_out,
                              int k, int64_t c, float* grad_x,
                              cudaStream_t s) {
  if (units <= 8)
    return launch_backward_ends<kUB, 8>(g, units, pos, w, ends, n_out, k, c, grad_x, s);
  if (units <= 16)
    return launch_backward_ends<kUB, 16>(g, units, pos, w, ends, n_out, k, c, grad_x, s);
  return launch_backward_ends<kUB, 32>(g, units, pos, w, ends, n_out, k, c, grad_x, s);
}

// The cooperative scatter by the widest unit (16, 8 or 4 bytes) that d
// and both rows' alignment allow, plan_backward() warps per g row, from
// the shape and the alignment alone.  With ends it reads no slot past a
// row's end: where the plan is one warp a row (a large F),
// fanout_backward_ends_kernel; where it splits a row over warps (a small
// F, whose long rows one warp each would walk alone) and a row is at most
// 32 units, fanout_backward_coop_kernel with the ends.  The wrapper has
// checked that n_out > 0 and c > 0.
int fanout_backward(const float* g, const int32_t* pos, const float* w,
                    const int32_t* ends, int n_out, int k, int64_t c, int d,
                    float* grad_x, cudaStream_t s) {
  if (d < 1 || n_out <= 0 || k < 0 || c <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int unit = row_unit(static_cast<int64_t>(d) * 4, 4, {g, grad_x});
  const int units = d * 4 / unit;
  const int upl = backward_upl(unit, units);
  const int split = plan_backward(n_out, k);
  cudaError_t err;
  if (ends != nullptr && (split == 1 || upl != 1)) {
    if (unit == 16)
      err = run_backward_ends<16>(g, units, pos, w, ends, n_out, k, c, grad_x, s);
    else if (unit == 8)
      err = run_backward_ends<8>(g, units, pos, w, ends, n_out, k, c, grad_x, s);
    else
      err = run_backward_ends<4>(g, units, pos, w, ends, n_out, k, c, grad_x, s);
  } else if (unit == 16 && upl == 1) {
    err = launch_backward<16, 1>(g, units, pos, w, ends, n_out, k, split, c, grad_x, s);
  } else if (unit == 16 && upl == 2) {
    err = launch_backward<16, 2>(g, units, pos, w, nullptr, n_out, k, split, c, grad_x, s);
  } else if (unit == 16) {
    err = launch_backward<16, 4>(g, units, pos, w, nullptr, n_out, k, split, c, grad_x, s);
  } else if (unit == 8 && upl == 1) {
    err = launch_backward<8, 1>(g, units, pos, w, ends, n_out, k, split, c, grad_x, s);
  } else if (unit == 8) {
    err = launch_backward<8, 12>(g, units, pos, w, nullptr, n_out, k, split, c, grad_x, s);
  } else if (upl == 1) {
    err = launch_backward<4, 1>(g, units, pos, w, ends, n_out, k, split, c, grad_x, s);
  } else {
    err = launch_backward<4, 24>(g, units, pos, w, nullptr, n_out, k, split, c, grad_x, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

#endif  // SGT_BACKWARD

}  // namespace

extern "C" {

#if SGT_GATHER
// Full-neighbourhood term: table [rows, d], idx/w [n_out, k] -> out [n_out, d].
int sgt_hbm_gather_aggregate(const void* table, int dtype, int64_t rows,
                             int d, const int32_t* idx, const float* w,
                             int n_out, int k, float* out, void* stream) {
  return gather_aggregate(table, dtype, rows, d, idx, w, n_out, k, out,
                          static_cast<cudaStream_t>(stream), kPlanSplit);
}

// Sampled fanout term: x [c, d], pos/w [n_out, k] -> out [n_out, d];
// positions >= c (parked slots) contribute zero.  ends: null, or int32
// [n_out], row f's slots at or past ends[f] are not read (they must be
// dead): ends_gather_kernel; without ends the gather's own plan.
int sgt_fanout_aggregate(const void* x, int dtype, int64_t c, int d,
                         const int32_t* pos, const float* w,
                         const int32_t* ends, int n_out, int k, float* out,
                         void* stream) {
  if (ends != nullptr)
    return ends_gather(x, dtype, c, d, pos, w, ends, n_out, k, out,
                       static_cast<cudaStream_t>(stream));
  return gather_aggregate(x, dtype, c, d, pos, w, n_out, k, out,
                          static_cast<cudaStream_t>(stream), kPlanSplit);
}

// The same function with a named split: 0 one warp per row, or 1, 2, 4, 8
// warps per row, at any width.  For measurement.
int sgt_gather_aggregate_split(const void* table, int dtype, int64_t rows,
                               int d, const int32_t* idx, const float* w,
                               int n_out, int k, float* out, void* stream,
                               int split) {
  if (split < 0) return static_cast<int>(cudaErrorInvalidValue);
  return gather_aggregate(table, dtype, rows, d, idx, w, n_out, k, out,
                          static_cast<cudaStream_t>(stream), split);
}

// The split sgt_hbm_gather_aggregate / sgt_fanout_aggregate choose for
// 16-byte aligned rows: 0 where they run one warp per row
// (row_gather_kernel, or for rows that do not go by chunks
// wide_cols_kernel<TableCols>, which splits a row by columns instead),
// else the warps per row of split_gather_kernel
// (rows of at most 512 bytes), wide_tma_kernel (528-2048 bytes of whole
// chunks) or wide_split_kernel.
int sgt_gather_plan(int dtype, int d, int n_out, int k) {
  const int elem = dtype == 1 ? 2 : 4;
  const int64_t row_bytes = static_cast<int64_t>(d) * elem;
  const int unit_bytes = row_unit(row_bytes, elem, {});
  if ((dtype != 0 && dtype != 1) || d <= 0 || unit_bytes == 0) return -1;
  return plan_gather(dtype, d, n_out, k, chunked_rows(row_bytes, {}),
                     unit_bytes).split;
}

#endif  // SGT_GATHER

#if SGT_BACKWARD
// The warps per g row sgt_fanout_aggregate_backward deals a row's slots
// over.
int sgt_backward_plan(int n_out, int k) { return plan_backward(n_out, k); }
#endif  // SGT_BACKWARD

#if SGT_CV
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

#endif  // SGT_CV

#if SGT_BACKWARD
// Gradient of the fanout term: g [n_out, d] float32, pos/w [n_out, k] ->
// grad_x [c, d] float32, zero-filled here; positions outside [0, c) and
// zero weights contribute nothing.  ends: null, or int32 [n_out], row f's
// slots at or past ends[f] are not read (they must be dead).
int sgt_fanout_aggregate_backward(const float* g, const int32_t* pos,
                                  const float* w, const int32_t* ends,
                                  int n_out, int k, int64_t c, int d,
                                  float* grad_x, void* stream) {
  return fanout_backward(g, pos, w, ends, n_out, k, c, d, grad_x,
                         static_cast<cudaStream_t>(stream));
}

// An empty kernel: what any single launch costs at least.
int sgt_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

#endif  // SGT_BACKWARD

}  // extern "C"
