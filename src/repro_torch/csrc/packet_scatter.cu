// Scatter-accumulate of the packet-path server (paper §3.2.2) into the
// live (S, W) accumulator and its per-slot counts, written for Hopper
// (sm_90a), in two forms:
//
//   per drain : one drained ring batch (the eager engine's worker loop,
//               one launch per drain);
//   per round : a whole round's drain schedule of R batches (the compiled
//               engine), folded in one fixed set of launches whatever R is.
//
// Replaces, in the JAX package:
//   src/repro/kernels/packet_scatter.py::packet_scatter_accum_pallas     (f32 wire)
//   src/repro/kernels/packet_scatter.py::packet_scatter_accum_q8_pallas  (int8 wire)
//   and, for the round, their row-by-row scan packet_scatter_accum_scan.
//
// Contract of one batch (the DESIGN.md §3 scatter-accumulate contract,
// and the sequential oracle kernels/ref.py::packet_scatter_accum_ref):
//   exact  : acc'[s] = acc[s] + sum_{n: idx[n]=s} w[n]*pkt[n]
//            (the batch sum is formed from 0, in packet order, then added)
//   approx : acc'[s] = acc[s] + w[l]*pkt[l], l = the last n with idx[n]=s
//            and w[n] > 0; a slot with no such n keeps acc[s]
//   counts : cnt'[s] = cnt[s] + sum_{n: idx[n]=s} w[n] (from 0, in packet
//            order, then added), in both modes
//   idx < 0 and idx >= S are inert.  On the int8 wire each element is
//   decoded first, pkt[n] = float(q[n]) * scale[n], then weighted.
// A round applies that contract to its schedule rows in order.  Products
// and sums use the _rn intrinsics, so no multiply-add is contracted and
// every element sees the reference's operations in the reference's
// order: the round kernel equals the batch kernel run row after row, bit
// for bit, on any payload.
//
// Bound on an H100 SXM (3.35 TB/s): a paper-width f32 round reads ~124k
// accepted payload rows of 1,468 B (182 MB) and reads and writes 12,495
// accumulator rows (37 MB): about 65 us of bytes and 0.2 GFLOP, so the
// fold is bound by bytes.  A drained batch of 64 rows is well under a
// microsecond of bytes: bound by launch latency.
//
// Round design: the TPU kernel routes every batch through a one-hot
// (S x N) product on the MXU and carries the accumulator across the
// sequential grid.  Tensor cores have nothing to do here (each term is a
// scalar times a row), and the card's blocks run in no order, so the grid
// is turned around: a CTA owns one slot for the whole round.
//   1. count : integer atomics count each slot's hits over the R*B
//              schedule entries;
//   2. scan  : one CTA takes the exclusive scan into offsets;
//   3. fill  : each entry writes its flat position r*B + n into its
//              slot's segment (in scheduling order);
//   4. fold  : one warp per slot sorts its positions (unique integers, so
//              the order is deterministic: ranked in registers up to 32
//              hits, merged runs in global memory above), then walks them
//              row by row with the slot's running value in registers:
//              the accumulator row is read once and written once per
//              round, each hit payload row read once.  Hits are taken
//              two at a time with all their loads issued first, so that
//              two rows are in flight per slot (and, with a warp per
//              slot, up to 64 slots per SM).
// No float atomics: every accumulator row and count has one writer, and
// the result does not depend on scheduling.  Any multiplicity is handled
// by the same code.
//
// Loads: a lane keeps the same columns of the slot's running value for
// every hit.  On the int8 wire (W=1,464, a multiple of 8) every row
// starts 8-byte aligned, and a lane loads 8 bytes (the scale is read
// once per hit); other widths fall back to one byte a lane.  On the f32
// wire the paper's W=367 starts payload rows (1,468 B) at a 4-byte
// alignment that cycles from row to row, so no fixed set of columns is
// one aligned 16-byte unit in every row and an aligned prologue cannot
// serve a lane's fixed columns.  Padding the schedule's row stride to 368
// would, but it changes the layout that the plain version, the norm clip
// and the robust table fold share, for a fold at 1.5x its bound.  So f32
// rows are loaded one float a lane (a warp still reads 128 contiguous
// bytes), and the schedule's row stride stays as the reference builds it.
//
// Per-drain design: one CTA per batch position, sized to W.  Each warp
// holds the batch's idx, weights and scales in registers (up to 64
// packets, the eager ring) and lists the slot's hits itself with ballots
// (no shared memory, no __syncthreads); the CTA of the slot's first
// position folds them, every other CTA exits.  Its critical path is two
// dependent loads (the batch's columns; the slot's row and its hits'
// payloads) and the store.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kEntryThreads = 256;   // count and fill passes
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;        // a scan tile is 8,192 counts
constexpr int kFoldThreads = 128;

// -- element loads: VEC consecutive elements of a row, as floats --------

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 1> {
  using raw = float;
  __device__ static raw load(const float* p) { return *p; }
  __device__ static void decode(raw r, float, float* x) { x[0] = r; }
};

template <>
struct Vec<int8_t, 1> {
  using raw = int8_t;
  __device__ static raw load(const int8_t* p) { return *p; }
  __device__ static void decode(raw r, float scale, float* x) {
    x[0] = __fmul_rn(static_cast<float>(r), scale);
  }
};

template <>
struct Vec<int8_t, 8> {
  using raw = uint2;
  __device__ static raw load(const int8_t* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  __device__ static void decode(raw r, float scale, float* x) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned word = i < 4 ? r.x : r.y;
      const int8_t q = static_cast<int8_t>((word >> (8 * (i % 4))) & 0xffu);
      x[i] = __fmul_rn(static_cast<float>(q), scale);
    }
  }
};

// -- per drain ----------------------------------------------------------

// NCH > 0: a batch of at most 32 * NCH packets (the eager ring: 64),
// whose idx, weights and scales each warp holds in registers (NCH per
// lane), so that every global load of the CTA's critical path is issued
// at its start: the batch's columns, then the slot's accumulator row
// and its hits' payloads.  NCH == 0: any batch, the columns reread chunk
// by chunk.
template <typename T, int NCH>
__global__ void batch_kernel(const T* __restrict__ pkt,
                             const float* __restrict__ scales,
                             const int32_t* __restrict__ idx,
                             const float* __restrict__ w,
                             float* __restrict__ acc, float* __restrict__ cnt,
                             int n, int width, int n_slots, int exact) {
  constexpr int C = NCH > 0 ? NCH : 1;
  const int pos = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  int id_c[C];
  float w_c[C], s_c[C];
  // chunk k of the batch: the lane's idx, weight and scale
  auto column = [&](int k, int& id, float& wm, float& sm) {
    if (NCH > 0) {
      id = id_c[k]; wm = w_c[k]; sm = s_c[k];
      return;
    }
    const int m = k * kWarp + lane;
    id = m < n ? idx[m] : -1;
    wm = m < n ? w[m] : 0.f;
    sm = m < n && scales != nullptr ? scales[m] : 1.f;
  };
  int slot;
  if (NCH > 0) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int m = k * kWarp + lane;
      id_c[k] = m < n ? idx[m] : -1;
      w_c[k] = m < n ? w[m] : 0.f;
      s_c[k] = m < n && scales != nullptr ? scales[m] : 1.f;
    }
    slot = -1;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int s = __shfl_sync(kFull, id_c[k], pos % kWarp);
      if (k == pos / kWarp) slot = s;
    }
  } else {
    slot = idx[pos];
  }
  if (slot < 0 || slot >= n_slots) return;  // inert; uniform over the CTA
  const int n_chunks = NCH > 0 ? NCH : (n + kWarp - 1) / kWarp;
  // only the first position of a slot owns it; every warp decides alike
  // (loops over the chunks unroll fully when NCH > 0, so the register
  // columns are indexed by constants)
#pragma unroll 2
  for (int k = 0; k < n_chunks; ++k) {
    if (k * kWarp >= pos) break;
    int id;
    float wm, sm;
    column(k, id, wm, sm);
    if (__any_sync(kFull, k * kWarp + lane < pos && id == slot)) return;
  }
  float* row = acc + static_cast<int64_t>(slot) * width;
  const int first = pos / kWarp;
  if (threadIdx.x < kWarp) {   // counts: the slot's weights from 0, in order
    const float old = cnt[slot];
    float c = 0.f;
#pragma unroll 2
    for (int k = 0; k < n_chunks; ++k) {
      if (k < first) continue;
      int id;
      float wm, sm;
      column(k, id, wm, sm);
      const int m = k * kWarp + lane;
      unsigned mask = __ballot_sync(kFull, m >= pos && m < n && id == slot);
      while (mask) {
        const int b = __ffs(mask) - 1;
        mask &= mask - 1;
        c = __fadd_rn(c, __shfl_sync(kFull, wm, b));
      }
    }
    if (lane == 0) cnt[slot] = __fadd_rn(old, c);
  }
  for (int c0 = 0; c0 < width; c0 += blockDim.x) {
    const int col = c0 + threadIdx.x;
    const bool live = col < width;
    const float old = live ? row[col] : 0.f;
    float sum = 0.f;
    int last = -1;               // approx: the last hit with a positive weight
    float w_last = 0.f, s_last = 1.f;
#pragma unroll 2
    for (int k = 0; k < n_chunks; ++k) {
      if (k < first) continue;
      int id;
      float wm, sm;
      column(k, id, wm, sm);
      const int m = k * kWarp + lane;
      const bool hit = m >= pos && m < n && id == slot;
      if (!exact) {
        const unsigned pos_w = __ballot_sync(kFull, hit && wm > 0.f);
        if (pos_w) {
          const int b = kWarp - 1 - __clz(pos_w);
          last = k * kWarp + b;
          w_last = __shfl_sync(kFull, wm, b);
          s_last = __shfl_sync(kFull, sm, b);
        }
        continue;
      }
      unsigned mask = __ballot_sync(kFull, hit);
      while (mask) {               // the hits in packet order
        const int b = __ffs(mask) - 1;
        mask &= mask - 1;
        const float wh = __shfl_sync(kFull, wm, b);
        const float sh = __shfl_sync(kFull, sm, b);
        if (live) {
          float x;
          Vec<T, 1>::decode(
              pkt[static_cast<int64_t>(k * kWarp + b) * width + col], sh, &x);
          sum = __fadd_rn(sum, __fmul_rn(wh, x));
        }
      }
    }
    if (exact) {
      if (live) row[col] = __fadd_rn(old, sum);
    } else if (last >= 0 && live) {
      float x;
      Vec<T, 1>::decode(pkt[static_cast<int64_t>(last) * width + col],
                        s_last, &x);
      row[col] = __fadd_rn(old, __fmul_rn(w_last, x));
    }
  }
}

template <typename T>
int launch_batch(const T* pkt, const float* scales, const int32_t* idx,
                 const float* w, float* acc, float* cnt, int n, int width,
                 int n_slots, int exact, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads =
      width >= 1024 ? 1024 : (width + kWarp - 1) / kWarp * kWarp;
  if (n <= 2 * kWarp) {
    batch_kernel<T, 2><<<n, threads, 0, stream>>>(pkt, scales, idx, w, acc,
                                                 cnt, n, width, n_slots,
                                                 exact);
  } else {
    batch_kernel<T, 0><<<n, threads, 0, stream>>>(pkt, scales, idx, w, acc,
                                                 cnt, n, width, n_slots,
                                                 exact);
  }
  return static_cast<int>(cudaGetLastError());
}

// -- per round: count, scan, fill ---------------------------------------

__global__ void __launch_bounds__(kEntryThreads)
count_hits(const int32_t* __restrict__ idx, int32_t* __restrict__ count,
           int n_entries, int n_slots) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_entries) return;
  const int s = idx[e];
  if (s >= 0 && s < n_slots) atomicAdd(&count[s], 1);
}

// Exclusive scan of count[0, n_slots) into offsets[0, n_slots]; count
// becomes each slot's fill cursor (= its offset).  One CTA walks tiles of
// kScanThreads * kScanItems counts, loading the next tile while it scans
// this one.
__global__ void __launch_bounds__(kScanThreads)
scan_offsets(int32_t* count, int32_t* __restrict__ offsets, int n_slots) {
  __shared__ int32_t s_tile[kScanThreads * kScanItems];
  __shared__ int32_t s_warp[kScanThreads / kWarp];
  constexpr int kTile = kScanThreads * kScanItems;
  const int t = threadIdx.x;
  const int lane = t % kWarp, warp = t / kWarp;
  int32_t next[kScanItems];
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int i = k * kScanThreads + t;
    next[k] = i < n_slots ? count[i] : 0;
  }
  int32_t carry = 0;
  for (int base = 0; base < n_slots; base += kTile) {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) s_tile[k * kScanThreads + t] = next[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {      // prefetch the next tile
      const int i = base + kTile + k * kScanThreads + t;
      next[k] = i < n_slots ? count[i] : 0;
    }
    int32_t mine[kScanItems];
    int32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      mine[k] = sum;
      sum += s_tile[t * kScanItems + k];
    }
    int32_t incl = sum;                         // warp inclusive scan
#pragma unroll
    for (int d = 1; d < kWarp; d *= 2) {
      const int32_t up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == kWarp - 1) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int32_t v = s_warp[lane];
#pragma unroll
      for (int d = 1; d < kWarp; d *= 2) {
        const int32_t up = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v += up;
      }
      s_warp[lane] = v;                         // inclusive warp totals
    }
    __syncthreads();
    const int32_t before =
        carry + (warp > 0 ? s_warp[warp - 1] : 0) + incl - sum;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      s_tile[t * kScanItems + k] = before + mine[k];
    }
    const int32_t tile_total = s_warp[kScanThreads / kWarp - 1];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int i = base + k * kScanThreads + t;
      if (i < n_slots) {
        const int32_t off = s_tile[k * kScanThreads + t];
        offsets[i] = off;
        count[i] = off;
      }
    }
    carry += tile_total;
    __syncthreads();
  }
  if (t == 0) offsets[n_slots] = carry;
}

__global__ void __launch_bounds__(kEntryThreads)
fill_hits(const int32_t* __restrict__ idx, int32_t* __restrict__ cursor,
          int32_t* __restrict__ hits, int n_entries, int n_slots) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_entries) return;
  const int s = idx[e];
  if (s >= 0 && s < n_slots) hits[atomicAdd(&cursor[s], 1)] = e;
}

// -- per round: fold ----------------------------------------------------

// Sort the n hit positions of a warp's slot ascending -> a pointer to
// them.  Up to a warp's width they are ranked in registers and land in
// the warp's 32 ints of shared memory; above it, runs of 32 are ranked
// and written back to list, then merged pairwise between list and tmp
// (both in global memory, written only by this warp) with a binary
// search per element.  Positions are unique, so every sort gives the
// same order.
__device__ const int32_t* warp_sort(int32_t* list, int32_t* tmp, int n,
                                    int32_t* s_warp) {
  const int lane = threadIdx.x % kWarp;
  for (int c0 = 0; c0 < n; c0 += kWarp) {
    const int m = min(kWarp, n - c0);
    const int32_t v = lane < m ? list[c0 + lane] : INT32_MAX;
    int rank = 0;
    for (int j = 0; j < m; ++j) rank += __shfl_sync(kFull, v, j) < v;
    if (n <= kWarp) {
      if (lane < m) s_warp[rank] = v;
      __syncwarp();
      return s_warp;
    }
    __syncwarp();
    if (lane < m) list[c0 + rank] = v;
  }
  __syncwarp();
  int32_t* src = list;
  int32_t* dst = tmp;
  for (int64_t len = kWarp; len < n; len *= 2) {
    for (int i = lane; i < n; i += kWarp) {
      const int64_t run = i / len, start = run * len;
      const int64_t other = (run ^ 1) * len;
      const int32_t v = src[i];
      int64_t lo = other;
      int64_t hi = other >= n ? other : (other + len < n ? other + len : n);
      while (lo < hi) {                 // partner elements below v
        const int64_t mid = (lo + hi) / 2;
        if (src[mid] < v) lo = mid + 1; else hi = mid;
      }
      dst[(start < other ? start : other) + (i - start) + (lo - other)] = v;
    }
    __syncwarp();
    int32_t* swap = src; src = dst; dst = swap;
  }
  return src;
}

// VEC consecutive accumulator floats: 16-byte accesses where VEC allows
// (a wide fold's rows are 16-byte aligned)
template <int VEC>
__device__ __forceinline__ void load_acc(const float* p, float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      v[k] = q.x; v[k + 1] = q.y; v[k + 2] = q.z; v[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = p[k];
  }
}

template <int VEC>
__device__ __forceinline__ void store_acc(float* p, const float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = v[k];
  }
}

// One warp per slot, kFoldThreads / 32 slots a CTA.  Lane l holds units
// l, l + 32, ... (UPT of them, VEC elements each) of the slot's running
// value, a pass over the columns at a time; hits are taken D at a time:
// their weights, scales and payload units are all loaded before any is
// added, so D rows are in flight (D * UPT = 24 registers of loads).
// EXACT is a template parameter, so that each mode keeps only its own
// registers (the row's batch sum, or the row's last live hit).
template <typename T, int VEC, int UPT, bool EXACT>
__global__ void __launch_bounds__(kFoldThreads)
fold_kernel(const T* __restrict__ pkt, const float* __restrict__ scales,
            const float* __restrict__ w, const int32_t* __restrict__ offsets,
            int32_t* hits, int32_t* tmp, float* __restrict__ acc,
            float* __restrict__ cnt, int n_slots, int width, int bsz) {
  __shared__ int32_t s_sorted[kFoldThreads];
  using V = Vec<T, VEC>;
  using Raw = typename V::raw;
  constexpr int D = 2;
  constexpr int M = EXACT ? 1 : UPT;     // approx keeps a hit's units
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int slot = blockIdx.x * (kFoldThreads / kWarp) + warp;
  if (slot >= n_slots) return;                 // uniform over the warp
  const int begin = offsets[slot];
  const int n = offsets[slot + 1] - begin;
  if (n == 0) return;
  const int units = width / VEC;
  float* arow = acc + static_cast<int64_t>(slot) * width;
  const float cnt0 = cnt[slot];
  const int32_t* hit =
      warp_sort(hits + begin, tmp + begin, n, s_sorted + warp * kWarp);

  for (int u0 = 0; u0 < units; u0 += kWarp * UPT) {
    float v[UPT][VEC] = {};
    bool live[UPT];
#pragma unroll
    for (int u = 0; u < UPT; ++u) {
      const int unit = u0 + u * kWarp + lane;
      live[u] = unit < units;
      if (live[u]) load_acc<VEC>(arow + unit * VEC, v[u]);
    }
    float bs[EXACT ? UPT : 1][VEC] = {};   // exact: the row's batch sum
    Raw raw_l[M] = {};                     // approx: the row's last live hit
    float w_l = 0.f, s_l = 1.f;
    bool have = false;
    float c = cnt0, c_row = 0.f;
    int row = hit[0] / bsz;
    auto flush = [&]() {                   // the end of a row: add its sums
      c = __fadd_rn(c, c_row);
      c_row = 0.f;
#pragma unroll
      for (int u = 0; u < UPT; ++u) {
        if constexpr (EXACT) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            v[u][k] = __fadd_rn(v[u][k], bs[u][k]);
            bs[u][k] = 0.f;
          }
        } else if (have) {
          float x[VEC];
          V::decode(raw_l[u], s_l, x);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            v[u][k] = __fadd_rn(v[u][k], __fmul_rn(w_l, x[k]));
          }
        }
      }
      have = false;
    };
    for (int i0 = 0; i0 < n; i0 += D) {
      int p[D];
      float wv[D], sv[D];
      Raw raw[D][UPT];
#pragma unroll
      for (int d = 0; d < D; ++d) {   // issue every load of the D hits
        p[d] = i0 + d < n ? hit[i0 + d] : -1;
        if (p[d] < 0) continue;
        wv[d] = w[p[d]];
        sv[d] = scales != nullptr ? scales[p[d]] : 1.f;
        const T* prow = pkt + static_cast<int64_t>(p[d]) * width;
#pragma unroll
        for (int u = 0; u < UPT; ++u) {
          if (live[u]) {
            raw[d][u] = V::load(prow + (u0 + u * kWarp + lane) * VEC);
          }
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {   // then add them in schedule order
        if (p[d] < 0) continue;
        const int r = p[d] / bsz;
        if (r != row) {
          flush();
          row = r;
        }
        c_row = __fadd_rn(c_row, wv[d]);
#pragma unroll
        for (int u = 0; u < UPT; ++u) {
          if constexpr (EXACT) {
            float x[VEC];
            V::decode(raw[d][u], sv[d], x);
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              bs[u][k] = __fadd_rn(bs[u][k], __fmul_rn(wv[d], x[k]));
            }
          } else if (wv[d] > 0.f) {
            raw_l[u] = raw[d][u];
          }
        }
        if (!EXACT && wv[d] > 0.f) {
          w_l = wv[d];
          s_l = sv[d];
          have = true;
        }
      }
    }
    flush();
#pragma unroll
    for (int u = 0; u < UPT; ++u) {
      if (live[u]) store_acc<VEC>(arow + (u0 + u * kWarp + lane) * VEC, v[u]);
    }
    if (u0 == 0 && lane == 0) cnt[slot] = c;
  }
}

// One pass covers 384 columns on the f32 wire (UPT 12: W=367 in one) and
// 1,536 on the int8 wire (UPT 6 of 8 bytes: W=1,464 in one); wider rows
// take more passes, narrower ones leave lanes idle.
template <typename T, int VEC>
void launch_fold(bool exact, int n_slots, cudaStream_t stream, const T* pkt,
                 const float* scales, const float* w, const int32_t* offsets,
                 int32_t* hits, int32_t* tmp, float* acc, float* cnt,
                 int width, int bsz) {
  constexpr int kUpt = VEC == 1 ? 12 : 6;
  constexpr int kSlotsPerCta = kFoldThreads / kWarp;
  const int grid = (n_slots + kSlotsPerCta - 1) / kSlotsPerCta;
  if (exact) {
    fold_kernel<T, VEC, kUpt, true><<<grid, kFoldThreads, 0, stream>>>(
        pkt, scales, w, offsets, hits, tmp, acc, cnt, n_slots, width, bsz);
  } else {
    fold_kernel<T, VEC, kUpt, false><<<grid, kFoldThreads, 0, stream>>>(
        pkt, scales, w, offsets, hits, tmp, acc, cnt, n_slots, width, bsz);
  }
}

template <typename T>
int launch_rounds(const T* pkt, const float* scales, const int32_t* idx,
                  const float* w, float* acc, float* cnt, int32_t* count,
                  int32_t* offsets, int32_t* hits, int32_t* tmp, int n_rows,
                  int bsz, int width, int n_slots, int exact,
                  cudaStream_t stream) {
  const int n_entries = n_rows * bsz;
  if (n_entries <= 0 || n_slots <= 0) return 0;
  cudaError_t err = cudaMemsetAsync(
      count, 0, static_cast<size_t>(n_slots) * sizeof(int32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n_entries + kEntryThreads - 1) / kEntryThreads;
  count_hits<<<grid, kEntryThreads, 0, stream>>>(idx, count, n_entries,
                                                 n_slots);
  scan_offsets<<<1, kScanThreads, 0, stream>>>(count, offsets, n_slots);
  fill_hits<<<grid, kEntryThreads, 0, stream>>>(idx, count, hits, n_entries,
                                                n_slots);
  bool wide = false;        // int8 rows, width a multiple of 8: 8-byte loads
  if constexpr (sizeof(T) == 1) {
    wide = width % 8 == 0 && reinterpret_cast<uintptr_t>(pkt) % 8 == 0 &&
           reinterpret_cast<uintptr_t>(acc) % 16 == 0;
    if (wide) {
      launch_fold<T, 8>(exact != 0, n_slots, stream, pkt, scales, w, offsets,
                        hits, tmp, acc, cnt, width, bsz);
    }
  }
  if (!wide) {
    launch_fold<T, 1>(exact != 0, n_slots, stream, pkt, scales, w, offsets,
                      hits, tmp, acc, cnt, width, bsz);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One drained batch: packets (n, width) f32, idx (n,) i32, w (n,) f32, acc
// (n_slots, width) f32 and cnt (n_slots,) f32, all contiguous on the
// device; acc and cnt are updated in place.  Returns cudaGetLastError()
// after the launch.
int packet_scatter_accum_f32(const void* pkt, const void* idx, const void* w,
                             void* acc, void* cnt, int n, int width,
                             int n_slots, int exact, void* stream) {
  return launch_batch<float>(
      static_cast<const float*>(pkt), nullptr,
      static_cast<const int32_t*>(idx), static_cast<const float*>(w),
      static_cast<float*>(acc), static_cast<float*>(cnt), n, width, n_slots,
      exact, static_cast<cudaStream_t>(stream));
}

// As above on the int8 wire: packets (n, width) i8 and scales (n,) f32.
int packet_scatter_accum_q8(const void* pkt, const void* scales,
                            const void* idx, const void* w, void* acc,
                            void* cnt, int n, int width, int n_slots,
                            int exact, void* stream) {
  return launch_batch<int8_t>(
      static_cast<const int8_t*>(pkt), static_cast<const float*>(scales),
      static_cast<const int32_t*>(idx), static_cast<const float*>(w),
      static_cast<float*>(acc), static_cast<float*>(cnt), n, width, n_slots,
      exact, static_cast<cudaStream_t>(stream));
}

// A round's drain schedule: idx/w (n_rows, bsz), packets (n_rows, bsz,
// width) f32, folded row after row into acc (n_slots, width) and cnt
// (n_slots,) in place.  Scratch, all int32 on the device: count and
// offsets (n_slots + 1,), hits and tmp (n_rows * bsz,).  One memset and
// four kernel launches on the stream, whatever n_rows is.
int packet_scatter_rounds_f32(const void* pkt, const void* idx, const void* w,
                              void* acc, void* cnt, void* count, void* offsets,
                              void* hits, void* tmp, int n_rows, int bsz,
                              int width, int n_slots, int exact,
                              void* stream) {
  return launch_rounds<float>(
      static_cast<const float*>(pkt), nullptr,
      static_cast<const int32_t*>(idx), static_cast<const float*>(w),
      static_cast<float*>(acc), static_cast<float*>(cnt),
      static_cast<int32_t*>(count), static_cast<int32_t*>(offsets),
      static_cast<int32_t*>(hits), static_cast<int32_t*>(tmp), n_rows, bsz,
      width, n_slots, exact, static_cast<cudaStream_t>(stream));
}

// As above on the int8 wire: packets (n_rows, bsz, width) i8 and scales
// (n_rows, bsz) f32.
int packet_scatter_rounds_q8(const void* pkt, const void* scales,
                             const void* idx, const void* w, void* acc,
                             void* cnt, void* count, void* offsets,
                             void* hits, void* tmp, int n_rows, int bsz,
                             int width, int n_slots, int exact,
                             void* stream) {
  return launch_rounds<int8_t>(
      static_cast<const int8_t*>(pkt), static_cast<const float*>(scales),
      static_cast<const int32_t*>(idx), static_cast<const float*>(w),
      static_cast<float*>(acc), static_cast<float*>(cnt),
      static_cast<int32_t*>(count), static_cast<int32_t*>(offsets),
      static_cast<int32_t*>(hits), static_cast<int32_t*>(tmp), n_rows, bsz,
      width, n_slots, exact, static_cast<cudaStream_t>(stream));
}

const char* packet_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
