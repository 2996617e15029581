// Scatter-accumulate of one drained ring batch into the live (S, W)
// accumulator and its per-slot counts: the worker loop of the packet-path
// server (paper §3.2.2), written for Hopper (sm_90a).
//
// Replaces, in the JAX package:
//   src/repro/kernels/packet_scatter.py::packet_scatter_accum_pallas     (f32 wire)
//   src/repro/kernels/packet_scatter.py::packet_scatter_accum_q8_pallas  (int8 wire)
//
// Contract (the DESIGN.md §3 scatter-accumulate contract, and the
// sequential oracle kernels/ref.py::packet_scatter_accum_ref):
//   exact  : acc'[s] = acc[s] + sum_{n: idx[n]=s} w[n]*pkt[n]
//            (the batch sum is formed first, in packet order, then added)
//   approx : acc'[s] = acc[s] + w[l]*pkt[l], l = the last n with idx[n]=s
//            and w[n] > 0; a slot with no such n keeps acc[s]
//   counts : cnt'[s] = cnt[s] + sum_{n: idx[n]=s} w[n], in both modes
//   idx < 0 and idx >= S are inert.  On the int8 wire each row is decoded
//   first, pkt[n] = float(q[n]) * scale[n], then weighted.
//
// Bound on an H100 SXM (3.35 TB/s): a paper-width batch reads 64 payload
// rows (64 x 367 x 4 B = 94 KB) and reads and writes at most 64
// accumulator rows (188 KB), well under 1 us of memory traffic, so one
// launch per batch is bound by launch latency, not by bytes or
// operations.  A whole paper-width round (K=10) moves about 182 MB of
// payload plus 37 MB of accumulator: about 65 us.  This design does not
// close that gap: it keeps one launch per drained batch, as simple and
// correct first; one launch (or one CUDA graph) per round is later work.
// Measured times (chip_smoke.py) are in PERF.md.
//
// Design: the TPU kernel routes each batch through a one-hot (S x N)
// matrix product on the MXU, O(S*N*W) multiply-adds for O(N*W) useful
// adds.  Here the scatter is direct.  One CTA per batch position n; the
// CTA whose position is the first of its slot in the batch owns that
// slot: its first warp lists the slot's hits in packet order, and the
// CTA folds them across the W columns (threads stride the columns, so
// row loads coalesce).  Every other CTA exits.  Each accumulator row has
// exactly one writer, so the kernel needs no atomics and its result does
// not depend on scheduling: the approx mode's last-writer-wins race stays
// deterministic, as the reference requires.  Products and sums use the
// _rn intrinsics so that no multiply-add is contracted and each row sees
// the reference's op order (decode, weight, add).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float decode(const float* p, int64_t i, float) {
  return p[i];
}

__device__ __forceinline__ float decode(const int8_t* p, int64_t i,
                                        float scale) {
  return __fmul_rn(static_cast<float>(p[i]), scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_accum_kernel(const T* __restrict__ pkt,
                     const float* __restrict__ scales,
                     const int32_t* __restrict__ idx,
                     const float* __restrict__ w,
                     float* __restrict__ acc, float* __restrict__ cnt,
                     int n, int width, int n_slots, int exact) {
  extern __shared__ unsigned char smem[];
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem);
  float* s_w = reinterpret_cast<float*>(s_idx + n);
  int32_t* s_hit = reinterpret_cast<int32_t*>(s_w + n);
  __shared__ int s_nhit;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_idx[i] = idx[i];
    s_w[i] = w[i];
  }
  __syncthreads();

  const int pos = blockIdx.x;
  const int slot = s_idx[pos];
  if (slot < 0 || slot >= n_slots) return;  // inert; uniform over the CTA

  // only the first position of a slot owns it
  int earlier = 0;
  for (int m = threadIdx.x; m < pos; m += blockDim.x) {
    earlier |= (s_idx[m] == slot);
  }
  if (__syncthreads_or(earlier)) return;

  // warp 0 lists the slot's hits once, in packet order (ballot + popc),
  // so the column loops below visit the hits and not the whole batch
  if (threadIdx.x < 32) {
    const unsigned lane = threadIdx.x;
    int nhit = 0;
    for (int base = pos; base < n; base += 32) {
      const int m = base + static_cast<int>(lane);
      const bool hit = m < n && s_idx[m] == slot;
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (hit) s_hit[nhit + __popc(mask & ((1u << lane) - 1u))] = m;
      nhit += __popc(mask);
    }
    if (lane == 0) {
      s_nhit = nhit;
      float c = 0.f;
      for (int h = 0; h < nhit; ++h) c = __fadd_rn(c, s_w[s_hit[h]]);
      cnt[slot] = __fadd_rn(cnt[slot], c);
    }
  }
  __syncthreads();
  const int nhit = s_nhit;

  float* row = acc + static_cast<int64_t>(slot) * width;
  if (exact) {
    for (int col = threadIdx.x; col < width; col += blockDim.x) {
      float sum = 0.f;
      for (int h = 0; h < nhit; ++h) {
        const int m = s_hit[h];
        const float sc = scales != nullptr ? scales[m] : 1.f;
        const float x = decode(pkt, static_cast<int64_t>(m) * width + col,
                               sc);
        sum = __fadd_rn(sum, __fmul_rn(s_w[m], x));
      }
      row[col] = __fadd_rn(row[col], sum);
    }
    return;
  }
  int last = -1;  // the same value in every thread: shared reads only
  for (int h = nhit - 1; h >= 0; --h) {
    if (s_w[s_hit[h]] > 0.f) {
      last = s_hit[h];
      break;
    }
  }
  if (last < 0) return;
  const float wl = s_w[last];
  const float sc = scales != nullptr ? scales[last] : 1.f;
  for (int col = threadIdx.x; col < width; col += blockDim.x) {
    const float x = decode(pkt, static_cast<int64_t>(last) * width + col, sc);
    row[col] = __fadd_rn(row[col], __fmul_rn(wl, x));
  }
}

template <typename T>
int launch(const T* pkt, const float* scales, const int32_t* idx,
           const float* w, float* acc, float* cnt, int n, int width,
           int n_slots, int exact, void* stream) {
  if (n <= 0) return 0;
  const size_t smem =
      static_cast<size_t>(n) * (2 * sizeof(int32_t) + sizeof(float));
  scatter_accum_kernel<T>
      <<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          pkt, scales, idx, w, acc, cnt, n, width, n_slots, exact);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// packets (n, width) f32, idx (n,) i32, w (n,) f32, acc (n_slots, width)
// f32 and cnt (n_slots,) f32, all contiguous on the device; acc and cnt
// are updated in place.  Returns cudaGetLastError() after the launch.
int packet_scatter_accum_f32(const void* pkt, const void* idx, const void* w,
                             void* acc, void* cnt, int n, int width,
                             int n_slots, int exact, void* stream) {
  return launch<float>(static_cast<const float*>(pkt), nullptr,
                       static_cast<const int32_t*>(idx),
                       static_cast<const float*>(w), static_cast<float*>(acc),
                       static_cast<float*>(cnt), n, width, n_slots, exact,
                       stream);
}

// As above on the int8 wire: packets (n, width) i8 and scales (n,) f32.
int packet_scatter_accum_q8(const void* pkt, const void* scales,
                            const void* idx, const void* w, void* acc,
                            void* cnt, int n, int width, int n_slots,
                            int exact, void* stream) {
  return launch<int8_t>(static_cast<const int8_t*>(pkt),
                        static_cast<const float*>(scales),
                        static_cast<const int32_t*>(idx),
                        static_cast<const float*>(w),
                        static_cast<float*>(acc), static_cast<float*>(cnt), n,
                        width, n_slots, exact, stream);
}

const char* packet_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
