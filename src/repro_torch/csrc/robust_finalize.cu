// Trimmed-mean / coordinate-wise-median finalize over the per-slot client
// table of a Byzantine-robust round (DESIGN.md §11), written for Hopper
// (sm_90a).
//
// Replaces, in the JAX package:
//   src/repro/kernels/packet_scatter.py::robust_finalize_pallas
//   (body _robust_finalize_kernel)
//
// Contract (the Pallas body, and kernels/packet_scatter.py::
// robust_finalize_plain in the port):
//   table (S, K, W) f32, pres (S, K) f32 (> 0 marks a present client row).
//   Per slot s: m = #present clients, t = the trim depth
//     trimmed mean: t = max(floorf(f32(m) * f32(beta)), 0)
//     median      : t = max(floorf((f32(m) - 1) * 0.5), 0)
//   Per coordinate w: vm[k] = table[s, k, w] if present else FLT_MAX;
//   rank[k] = #{j : vm[j] < vm[k] or (vm[j] == vm[k] and j < k)};
//   keep[k] = present[k] and t <= rank[k] < m - t; the kept values are
//   summed in client order from 0.0f and divided by their count:
//     agg[s, w] = sum / fmaxf(kept, 1e-12f), or 0 where kept == 0;
//     m_out[s] = f32(m).
//   The absent entries rank against the FLT_MAX sentinel and are masked
//   again by presence, as in the Pallas body, so a present value equal to
//   the sentinel still ranks as the reference ranks it.
//
// Bound on an H100 SXM (3.35 TB/s): at paper width the table is 183.4 MB
// (12,495 x 10 x 367 x 4 B; the q8 round's 3,133 x 10 x 1,464 x 4 B is the
// same size) and the output 18.3 MB, so about 60 us of memory traffic.
// The ranking costs K^2 compares per coordinate (100 at K=10), about
// 4.6 G compares in all: at K=10 the kernel sits near the line between
// bytes and operations.
//
// Design: the TPU kernel holds a (block, K, W) table block in VMEM and
// ranks with a K-step loop of block-wide compares.  Here one CTA owns one
// slot: its (K,) presence is staged in shared memory and m and t are
// computed once; the threads stride the W columns, so each of the K row
// loads of a slot coalesces.  Each thread ranks its column's K values
// with O(K^2) compares, in registers up to a compile-time cap on K (2, 4,
// 8, 16 or 32) and re-read from global memory (L1) above it.  No atomics
// and no sort, so the result does not depend on scheduling; sums and the
// divide use the _rn intrinsics, so nothing is contracted and the plain
// version, which repeats the order, agrees bit for bit on any payload.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float trim_depth(int m, int median, float beta) {
  const float mf = static_cast<float>(m);
  const float t = median ? floorf(__fmul_rn(__fsub_rn(mf, 1.0f), 0.5f))
                         : floorf(__fmul_rn(mf, beta));
  return fmaxf(t, 0.0f);
}

// Stage the slot's presence in shared memory and count it: -> m.
__device__ __forceinline__ int stage_presence(const float* __restrict__ pres,
                                              unsigned char* s_pres,
                                              int n_clients, float* m_out) {
  __shared__ int s_m;
  const int64_t slot = blockIdx.x;
  for (int k = threadIdx.x; k < n_clients; k += blockDim.x) {
    s_pres[k] = pres[slot * n_clients + k] > 0.0f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
    for (int k = 0; k < n_clients; ++k) m += s_pres[k];
    s_m = m;
    m_out[slot] = static_cast<float>(m);
  }
  __syncthreads();
  return s_m;
}

__device__ __forceinline__ float mean_of_kept(float sum, int kept) {
  return kept > 0 ? __fdiv_rn(sum, fmaxf(static_cast<float>(kept), 1e-12f))
                  : 0.0f;
}

// K <= KC: a column's K values live in registers (the loops over KC are
// unrolled, so every index is a compile-time constant).
template <int KC>
__global__ void __launch_bounds__(kThreads)
robust_finalize_reg(const float* __restrict__ table,
                    const float* __restrict__ pres, float* __restrict__ agg,
                    float* __restrict__ m_out, int n_clients, int width,
                    int median, float beta) {
  __shared__ unsigned char s_pres[KC];
  const int m = stage_presence(pres, s_pres, n_clients, m_out);
  const float t = trim_depth(m, median, beta);
  const float hi = __fsub_rn(static_cast<float>(m), t);
  const int64_t slot = blockIdx.x;
  const float* base = table + slot * n_clients * width;
  for (int col = threadIdx.x; col < width; col += blockDim.x) {
    float vm[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      vm[k] = (k < n_clients && s_pres[k])
                  ? base[static_cast<int64_t>(k) * width + col]
                  : FLT_MAX;
    }
    float sum = 0.0f;
    int kept = 0;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      if (k < n_clients && s_pres[k]) {
        int rank = 0;
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          if (j < n_clients) {
            rank += (vm[j] < vm[k]) || (vm[j] == vm[k] && j < k);
          }
        }
        const float r = static_cast<float>(rank);
        if (r >= t && r < hi) {
          sum = __fadd_rn(sum, vm[k]);
          ++kept;
        }
      }
    }
    agg[slot * width + col] = mean_of_kept(sum, kept);
  }
}

// Any K: the values are re-read from global memory (they stay in L1).
__global__ void __launch_bounds__(kThreads)
robust_finalize_gmem(const float* __restrict__ table,
                     const float* __restrict__ pres, float* __restrict__ agg,
                     float* __restrict__ m_out, int n_clients, int width,
                     int median, float beta) {
  extern __shared__ unsigned char s_pres[];
  const int m = stage_presence(pres, s_pres, n_clients, m_out);
  const float t = trim_depth(m, median, beta);
  const float hi = __fsub_rn(static_cast<float>(m), t);
  const int64_t slot = blockIdx.x;
  const float* base = table + slot * n_clients * width;
  for (int col = threadIdx.x; col < width; col += blockDim.x) {
    float sum = 0.0f;
    int kept = 0;
    for (int k = 0; k < n_clients; ++k) {
      if (!s_pres[k]) continue;
      const float vk = base[static_cast<int64_t>(k) * width + col];
      int rank = 0;
      for (int j = 0; j < n_clients; ++j) {
        const float vj =
            s_pres[j] ? base[static_cast<int64_t>(j) * width + col] : FLT_MAX;
        rank += (vj < vk) || (vj == vk && j < k);
      }
      const float r = static_cast<float>(rank);
      if (r >= t && r < hi) {
        sum = __fadd_rn(sum, vk);
        ++kept;
      }
    }
    agg[slot * width + col] = mean_of_kept(sum, kept);
  }
}

template <int KC>
void launch_reg(const float* table, const float* pres, float* agg, float* m,
                int n_slots, int n_clients, int width, int median, float beta,
                cudaStream_t stream) {
  robust_finalize_reg<KC><<<n_slots, kThreads, 0, stream>>>(
      table, pres, agg, m, n_clients, width, median, beta);
}

}  // namespace

extern "C" {

// table (n_slots, n_clients, width) f32 and pres (n_slots, n_clients) f32
// in; agg (n_slots, width) f32 and m (n_slots,) f32 out; all contiguous on
// the device.  beta is the trimmed mean's fraction per side (f32); median
// != 0 selects the median.  Returns cudaGetLastError() after the launch.
int robust_finalize_f32(const void* table, const void* pres, void* agg,
                        void* m, int n_slots, int n_clients, int width,
                        int median, float beta, void* stream) {
  if (n_slots <= 0) return 0;
  const auto* tab = static_cast<const float*>(table);
  const auto* p = static_cast<const float*>(pres);
  auto* out = static_cast<float*>(agg);
  auto* mo = static_cast<float*>(m);
  auto st = static_cast<cudaStream_t>(stream);
  if (n_clients <= 2) {
    launch_reg<2>(tab, p, out, mo, n_slots, n_clients, width, median, beta, st);
  } else if (n_clients <= 4) {
    launch_reg<4>(tab, p, out, mo, n_slots, n_clients, width, median, beta, st);
  } else if (n_clients <= 8) {
    launch_reg<8>(tab, p, out, mo, n_slots, n_clients, width, median, beta, st);
  } else if (n_clients <= 16) {
    launch_reg<16>(tab, p, out, mo, n_slots, n_clients, width, median, beta,
                   st);
  } else if (n_clients <= 32) {
    launch_reg<32>(tab, p, out, mo, n_slots, n_clients, width, median, beta,
                   st);
  } else {
    robust_finalize_gmem<<<n_slots, kThreads,
                           static_cast<size_t>(n_clients), st>>>(
        tab, p, out, mo, n_clients, width, median, beta);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* robust_finalize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
