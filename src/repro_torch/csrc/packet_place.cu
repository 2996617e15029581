// Packet placement: the receive side of the paper's index-prefixed UDP
// payloads (§4.1), written for Hopper (sm_90a).  Row idx[n] of an
// (n_slots, W) buffer becomes packets[n].
//
// Replaces, in the JAX package:
//   src/repro/kernels/packet_scatter.py::packet_scatter_pallas
//   (body _packet_scatter_kernel)
//
// Contract (the Pallas kernel, and kernels/packet_scatter.py::
// packet_scatter_plain in the port):
//   out[idx[n]] = packets[n]; rows no packet covers keep their contents
//   (the destination buffer is updated in place, where the reference
//   aliases its ``init`` onto the output); when several packets name one
//   row the last in packet order wins.  idx < 0 and idx >= n_slots are
//   inert (the reference leaves them undefined).  Rows are copied as bit
//   patterns of 1, 2, 4 or 8 bytes, so any element type is placed
//   exactly.
//
// Bound on an H100 SXM (3.35 TB/s): each packet row read once and each
// placed row written once, 2 x 183.4 MB at the chip_smoke shape (124,950
// f32 rows of W=367), about 110 us; no arithmetic.
//
// Design: the TPU kernel places each packet with a DMA whose destination
// block comes from the prefetched index, and duplicates resolve because
// the grid runs in order.  Blocks on the card run in no order, so
// last-writer-wins needs a decision that does not depend on scheduling,
// without float atomics: pass 1 has each packet n do an integer
// atomicMax(last[idx[n]], n) into an (n_slots,) int32 scratch buffer set
// to -1 by the wrapper (the maximum is the same whatever the order of
// the atomics); pass 2 has one warp per packet copy its row only if
// last[idx[n]] == n, so each output row has exactly one writer.  Lanes
// stride the row, so loads and stores coalesce.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

__global__ void __launch_bounds__(kThreads)
mark_last(const int32_t* __restrict__ idx, int32_t* __restrict__ last, int n,
          int n_slots) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int slot = idx[i];
  if (slot >= 0 && slot < n_slots) atomicMax(&last[slot], static_cast<int>(i));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
place_rows(const T* __restrict__ pkt, const int32_t* __restrict__ idx,
           const int32_t* __restrict__ last, T* __restrict__ out, int n,
           int width, int n_slots) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;
  const int slot = idx[row];
  if (slot < 0 || slot >= n_slots || last[slot] != row) return;
  const T* src = pkt + row * width;
  T* dst = out + static_cast<int64_t>(slot) * width;
  for (int c = lane; c < width; c += kWarp) dst[c] = src[c];
}

template <typename T>
int launch(const void* pkt, const int32_t* idx, int32_t* last, void* out,
           int n, int width, int n_slots, cudaStream_t stream) {
  mark_last<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      idx, last, n, n_slots);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int64_t threads = static_cast<int64_t>(n) * kWarp;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  place_rows<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(pkt), idx, last, static_cast<T*>(out), n, width,
      n_slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// packets (n, width) of elem_bytes-byte elements, idx (n,) i32, last
// (n_slots,) i32 scratch holding -1, out (n_slots, width) of the packets'
// type, updated in place; all contiguous on the device.  Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for an
// element size other than 1, 2, 4 or 8).
int packet_place(const void* pkt, const void* idx, void* last, void* out,
                 int n, int width, int n_slots, int elem_bytes,
                 void* stream) {
  if (n <= 0 || width <= 0 || n_slots <= 0) return 0;
  const auto* i = static_cast<const int32_t*>(idx);
  auto* l = static_cast<int32_t*>(last);
  auto st = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1:
      return launch<uint8_t>(pkt, i, l, out, n, width, n_slots, st);
    case 2:
      return launch<uint16_t>(pkt, i, l, out, n, width, n_slots, st);
    case 4:
      return launch<uint32_t>(pkt, i, l, out, n, width, n_slots, st);
    case 8:
      return launch<uint64_t>(pkt, i, l, out, n, width, n_slots, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* packet_place_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
