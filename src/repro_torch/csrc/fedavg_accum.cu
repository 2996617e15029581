// Count-normalised masked FedAvg accumulation over K clients: the server
// step of the FedAvg training loop (paper Algorithm 1, line 8, with the
// per-packet divisor of §3.2.2), written for Hopper (sm_90a).
//
// Replaces, in the JAX package:
//   src/repro/kernels/fedavg_accum.py::fedavg_accum_pallas        (f32, bf16)
//   src/repro/kernels/quantized_accum.py::quantized_accum_pallas  (int8)
//
// Contract (the oracles kernels/ref.py::fedavg_accum_ref and
// quantized_accum_ref; payloads (K, C, W), masks and scales (K, C)):
//   term[k,c,w] = x[k,c,w] * m[k,c]              f32, or bf16 widened
//               = float(q[k,c,w]) * (s[k,c] * m[k,c])   int8: s*m first
//   sum[c,w]    = the terms over k, in blocks of 8 clients in order:
//                 each block's sum is formed from 0, then added to the
//                 running total (the Pallas kernel's order, whose
//                 output block carries the total across client blocks)
//   cnt[c]      = the same over m[k,c]
//   mode 0 raw      : out = sum, counts = cnt
//   mode 1 finalize : out = cnt > 0 ? sum / max(cnt, 1e-12) : 0
//   mode 2 into     : out = out + sum, counts = counts + cnt (the sums
//                     are formed first, then added, as the reference's
//                     ops.fedavg_accum_into does: total + sums)
// Products and sums use the _rn intrinsics, so no multiply-add is
// contracted into an FMA, and the divide is IEEE (__fdiv_rn).
//
// Bound on an H100 SXM (3.35 TB/s): the work is one multiply and one add
// per payload element, far below the card's rate, so bytes bound it.  At
// the paper-width round (K=10, C=12,495 packets, W=367) the f32 kernel
// reads 183.4 MB of payload and 0.5 MB of mask and writes 18.3 MB: about
// 60 us.  The int8 kernel reads 45.9 MB of payload and 1 MB of masks
// and scales: about 19.5 us.
//
// Design: the TPU kernel walks a (C/8, K/8) grid in order and carries the
// (8, W) output block across the client blocks in VMEM.  Blocks of a CUDA
// grid run in no order, so here the client loop moves inside the thread:
// each thread owns kElems<T> output elements (c, w), blockDim apart, so that
// consecutive threads sit on consecutive w and each client's (C, W) plane
// is read in coalesced, contiguous rows, each payload byte exactly once;
// the output is written once.  The running sums live in registers; no
// shared memory, no atomics, and the result does not depend on
// scheduling.  Owning several elements gives each thread that many
// independent loads per client to keep in flight.  The mask m[k,c] is
// the same for a whole row, so a warp's mask loads are broadcasts.  Loads
// are plain 1/2/4-byte loads: rows of W=367 start at any byte, so wider
// vector loads need an aligned prologue (later work; PERF.md has the
// times).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockClients = 8;     // the Pallas kernel's BK
constexpr int kFinalize = 1, kInto = 2;   // mode 0 writes the raw sums

// Output elements a thread owns.  Four keep four loads per client in
// flight and made the f32 kernel faster on the card; for int8 payloads
// (three loads per term, 32 bytes per warp load) the same change made
// it slower, so int8 keeps one (PERF.md has both times).
template <typename T>
constexpr int kElems = 4;
template <>
constexpr int kElems<int8_t> = 1;

__device__ __forceinline__ float term(const float* x, const float*, float m,
                                      int64_t i, int64_t) {
  return __fmul_rn(x[i], m);
}

__device__ __forceinline__ float term(const __nv_bfloat16* x, const float*,
                                      float m, int64_t i, int64_t) {
  return __fmul_rn(__bfloat162float(x[i]), m);
}

__device__ __forceinline__ float term(const int8_t* q, const float* s,
                                      float m, int64_t i, int64_t kc) {
  return __fmul_rn(static_cast<float>(q[i]), __fmul_rn(s[kc], m));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
accum_kernel(const T* __restrict__ x, const float* __restrict__ scales,
             const float* __restrict__ m, float* __restrict__ out,
             float* __restrict__ cnt, int n_clients, int n_chunks, int width,
             int mode) {
  constexpr int E = kElems<T>;
  const int64_t plane = static_cast<int64_t>(n_chunks) * width;
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * blockDim.x * E + threadIdx.x;
  int64_t idx[E];
  int row[E];
  bool live[E];
  float total[E], count[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    idx[e] = base + static_cast<int64_t>(e) * blockDim.x;
    live[e] = idx[e] < plane;
    row[e] = live[e] ? static_cast<int>(idx[e] / width) : 0;
    total[e] = 0.f;
    count[e] = 0.f;
  }
  for (int k0 = 0; k0 < n_clients; k0 += kBlockClients) {
    float bsum[E], bcnt[E];
#pragma unroll
    for (int e = 0; e < E; ++e) bsum[e] = bcnt[e] = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockClients; ++j) {
      const int k = k0 + j;
      if (k < n_clients) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (live[e]) {
            const int64_t kc = static_cast<int64_t>(k) * n_chunks + row[e];
            const float mk = m[kc];
            bsum[e] = __fadd_rn(bsum[e],
                                term(x, scales, mk, k * plane + idx[e], kc));
            bcnt[e] = __fadd_rn(bcnt[e], mk);
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      total[e] = __fadd_rn(total[e], bsum[e]);
      count[e] = __fadd_rn(count[e], bcnt[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (!live[e]) continue;
    const int64_t i = idx[e];
    const int c = row[e];
    const bool first_of_row = i == static_cast<int64_t>(c) * width;
    if (mode == kInto) {
      out[i] = __fadd_rn(out[i], total[e]);
      if (first_of_row) cnt[c] = __fadd_rn(cnt[c], count[e]);
      continue;
    }
    float v = total[e];
    if (mode == kFinalize) {
      v = count[e] > 0.f ? __fdiv_rn(v, fmaxf(count[e], 1e-12f)) : 0.f;
    }
    out[i] = v;
    if (first_of_row) cnt[c] = count[e];
  }
}

template <typename T>
int launch(const T* x, const float* scales, const float* m, float* out,
           float* cnt, int n_clients, int n_chunks, int width, int mode,
           void* stream) {
  const int64_t plane = static_cast<int64_t>(n_chunks) * width;
  if (plane <= 0) return 0;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kElems<T>;
  const unsigned blocks =
      static_cast<unsigned>((plane + per_block - 1) / per_block);
  accum_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, scales, m, out, cnt, n_clients, n_chunks, width, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (K, C, W) f32, m (K, C) f32, out (C, W) f32, cnt (C,) f32, all
// contiguous on the device.  mode 0 raw sums, 1 finalize, 2 into (out
// and cnt are read and updated in place).  Returns cudaGetLastError()
// after the launch.
int fedavg_accum_f32(const void* x, const void* m, void* out, void* cnt,
                     int n_clients, int n_chunks, int width, int mode,
                     void* stream) {
  return launch<float>(static_cast<const float*>(x), nullptr,
                       static_cast<const float*>(m), static_cast<float*>(out),
                       static_cast<float*>(cnt), n_clients, n_chunks, width,
                       mode, stream);
}

// As above on bf16 payloads, widened to f32 exactly in the kernel.
int fedavg_accum_bf16(const void* x, const void* m, void* out, void* cnt,
                      int n_clients, int n_chunks, int width, int mode,
                      void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), nullptr,
                               static_cast<const float*>(m),
                               static_cast<float*>(out),
                               static_cast<float*>(cnt), n_clients, n_chunks,
                               width, mode, stream);
}

// The int8 wire: q (K, C, W) i8 and scales (K, C) f32; the rest as above.
int quantized_accum_i8(const void* q, const void* scales, const void* m,
                       void* out, void* cnt, int n_clients, int n_chunks,
                       int width, int mode, void* stream) {
  return launch<int8_t>(static_cast<const int8_t*>(q),
                        static_cast<const float*>(scales),
                        static_cast<const float*>(m),
                        static_cast<float*>(out), static_cast<float*>(cnt),
                        n_clients, n_chunks, width, mode, stream);
}

const char* fedavg_accum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
