// Ring halo exchange between the ranks of a time-sharded mesh (kernel 13).
//
// Replaces the Pallas kernel doa_tpu/ops/pallas/ring.py `_halo_kernel`:
// each rank holds a plane x[T_loc, C] and produces out[T_loc + overlap, C]
// with out[:T_loc] = x and out[T_loc:] = the first `overlap` rows of the
// RIGHT neighbour in the snap ring (wrapping: the last rank gets rank 0's
// head). Put the other way round, which is what the kernel does: each rank
// copies x into its own out and writes its head x[:overlap] into its LEFT
// neighbour's halo slot through a peer pointer.
//
// Memory route. Every rank's out is a symmetric window: device memory
// taken once per shape with cudaMalloc (not from PyTorch's caching
// allocator, so the handle covers the window from offset 0), kept on the
// mesh, and exported with cudaIpcGetMemHandle. The right neighbour opens
// it with cudaIpcOpenMemHandle: ranks that share one card are processes on
// one device, and the same handle maps a peer card's memory over NVLink
// when the ranks have cards of their own (the wrapper checks
// cudaDeviceCanAccessPeer there). A rank's writes reach its left
// neighbour's window directly; no send/recv and no host copy is involved.
//
// Ordering. Ranks on one card are processes that the card time-slices
// (without MPS), so a kernel spinning on a flag another process sets
// would progress only at timeslice ends: nothing here spins on the device.
// Two interprocess events a rank order the exchange on the streams
// (ops/cuda/ring.py drives them, with a bounded host barrier between
// the records and the waits):
//   * free: recorded before the launch; the right neighbour's stream
//     waits on it before writing into this window, so no halo of epoch
//     e + 1 lands while this rank's readers of epoch e are still queued;
//   * done: recorded after the launch; the left neighbour's stream waits
//     on it before any consumer of its window.
//
// Bound (bytes): the local copy reads and writes T_loc*C values and the
// halo overlap*C, 2*T_loc*C*4 + 2*overlap*C*4 bytes over 3.35 TB/s on one
// card (the halo crosses NVLink, 450 GB/s each way, between cards). At the
// c4 shape on 4 ranks (T_loc = 2^22, C = 32, overlap = 512) that is about
// 0.32 ms a rank, at 2 ranks 0.64 ms. The design does nothing about the
// bound yet: a grid-stride 16-byte copy. Writing the ingest straight into
// the window would remove the local copy.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;

// one pass over local then halo units: unit i < n_local copies
// x[i] -> local[i], the rest copy the head x[j] -> remote[j]
template <typename T>
__global__ void halo_kernel(const T* __restrict__ x, T* __restrict__ local,
                            T* __restrict__ remote, long long n_local,
                            long long n_halo) {
  const long long total = n_local + n_halo;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    if (i < n_local) {
      local[i] = x[i];
    } else {
      const long long j = i - n_local;
      remote[j] = x[j];
    }
  }
}

template <typename T>
int launch(const void* x, void* local, void* remote, long long n_local,
           long long n_halo, cudaStream_t stream) {
  const long long total = n_local + n_halo;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  halo_kernel<T><<<(int)blocks, THREADS, 0, stream>>>(
      (const T*)x, (T*)local, (T*)remote, n_local, n_halo);
  return (int)cudaGetLastError();
}

}  // namespace

// x: this rank's plane (local_bytes); local: its own window; remote: the
// left neighbour's halo slot (halo_bytes), a pointer opened by
// doa_ring_window_open. 16-byte units when every size and pointer allows,
// else bytes.
extern "C" int doa_halo(const void* x, void* local, void* remote,
                        long long local_bytes, long long halo_bytes,
                        void* stream) {
  if (local_bytes < 0 || halo_bytes < 0 || halo_bytes > local_bytes)
    return (int)cudaErrorInvalidValue;
  if (local_bytes + halo_bytes == 0) return (int)cudaSuccess;
  const uintptr_t mis = ((uintptr_t)x | (uintptr_t)local | (uintptr_t)remote
                         | (uintptr_t)local_bytes | (uintptr_t)halo_bytes)
                        & 15u;
  if (mis == 0)
    return launch<uint4>(x, local, remote, local_bytes / 16, halo_bytes / 16,
                         (cudaStream_t)stream);
  return launch<unsigned char>(x, local, remote, local_bytes, halo_bytes,
                               (cudaStream_t)stream);
}

// A window of `bytes` on `device` and its IPC handle (64 bytes at handle).
extern "C" int doa_ring_window_alloc(long long bytes, int device,
                                     void* ptr_out, void* handle) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  void* p = nullptr;
  e = cudaMalloc(&p, (size_t)bytes);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  e = cudaIpcGetMemHandle(&h, p);
  if (e != cudaSuccess) {
    cudaFree(p);
    return (int)e;
  }
  memcpy(handle, &h, sizeof(h));
  *(void**)ptr_out = p;
  return (int)cudaSuccess;
}

// Map another process's window (peer access enabled on demand).
extern "C" int doa_ring_window_open(const void* handle, int device,
                                    void* ptr_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  void* p = nullptr;
  e = cudaIpcOpenMemHandle(&p, h, cudaIpcMemLazyEnablePeerAccess);
  if (e != cudaSuccess) return (int)e;
  *(void**)ptr_out = p;
  return (int)cudaSuccess;
}

extern "C" int doa_ring_window_close(void* ptr) {
  return (int)cudaIpcCloseMemHandle(ptr);
}

extern "C" int doa_ring_window_free(void* ptr) { return (int)cudaFree(ptr); }

// An interprocess event and its IPC handle (64 bytes at handle).
extern "C" int doa_ring_event_create(int device, void* ev_out,
                                     void* handle) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaEvent_t ev;
  e = cudaEventCreateWithFlags(
      &ev, cudaEventDisableTiming | cudaEventInterprocess);
  if (e != cudaSuccess) return (int)e;
  cudaIpcEventHandle_t h;
  e = cudaIpcGetEventHandle(&h, ev);
  if (e != cudaSuccess) {
    cudaEventDestroy(ev);
    return (int)e;
  }
  memcpy(handle, &h, sizeof(h));
  *(cudaEvent_t*)ev_out = ev;
  return (int)cudaSuccess;
}

extern "C" int doa_ring_event_open(const void* handle, int device,
                                   void* ev_out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaIpcEventHandle_t h;
  memcpy(&h, handle, sizeof(h));
  cudaEvent_t ev;
  e = cudaIpcOpenEventHandle(&ev, h);
  if (e != cudaSuccess) return (int)e;
  *(cudaEvent_t*)ev_out = ev;
  return (int)cudaSuccess;
}

extern "C" int doa_ring_event_destroy(void* ev) {
  return (int)cudaEventDestroy((cudaEvent_t)ev);
}

extern "C" int doa_ring_record(void* ev, void* stream) {
  return (int)cudaEventRecord((cudaEvent_t)ev, (cudaStream_t)stream);
}

extern "C" int doa_ring_wait(void* stream, void* ev) {
  return (int)cudaStreamWaitEvent((cudaStream_t)stream, (cudaEvent_t)ev, 0);
}

extern "C" int doa_ring_can_access_peer(int device, int peer, void* out) {
  return (int)cudaDeviceCanAccessPeer((int*)out, device, peer);
}
