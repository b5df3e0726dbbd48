// gather_rows: out[r, :] = src[idx[r], :], with idx[r] == n_src reading a
// zero row (the INVALID sentinel of the kernel-map tables).
//
// Replaces: the Pallas TPU kernel `band_gather` / `_band_gather_impl` in
// d3net_tpu/ops/pallas_gather.py. On the TPU a row gather was planned as a
// per-chunk window of source rows block-pipelined into VMEM and gathered
// by a one-hot MXU matmul, because random HBM row reads were slow there.
// On Hopper that memory plan buys nothing: the L2 (50 MB) and the memory
// system serve 16-byte random reads directly, so this kernel gathers any
// idx, banded or not. band_gather's absolute index is rebuilt by the
// Python wrapper (bases[r / chunk] * wblk + rel[r]) and lands here too.
//
// Bound: device-memory bytes. It moves n*row_bytes written, at least the
// distinct source rows it reads, and 4n bytes of index; it does no
// arithmetic. At the flagship detector forward the gathered sparse-conv
// operands are written about 18 GB per forward (about 5 ms at 3.35 TB/s),
// before the matmul reads them back; fusing the gather into the GEMM is
// the follow-up, not this kernel's job.
//
// Design: dtype-agnostic byte copy. Each row is `row_bytes` long and is
// copied as V-sized vectors, V the widest of 16/8/4/2/1 bytes that divides
// the row and both base pointers. A group of G threads (G a power of two,
// the least >= vectors per row, at most 32) copies one row, so narrow rows
// (16 bf16 channels = 32 bytes = two 16-byte vectors) do not leave most of
// a warp idle; groups walk the rows in a grid-stride loop. Neighbouring
// threads of a group touch neighbouring 16-byte words of one row, so each
// row read and write is one coalesced transaction run.
//
// Interface: plain C, bound with ctypes. Launches on the caller's stream,
// allocates nothing, does not synchronise; returns cudaGetLastError().
// Every index outside [0, n_src), the sentinel among them, reads a zero row,
// as in the plain PyTorch version (kernels/gather.py gather_rows_plain).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ src,
                                   const int32_t* __restrict__ idx,
                                   V* __restrict__ out, int64_t n,
                                   int64_t n_src, int vpr, int group) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = (int)(tid & (group - 1));
  const int64_t first = tid / group;
  const int64_t stride = ((int64_t)gridDim.x * blockDim.x) / group;
  for (int64_t r = first; r < n; r += stride) {
    const int64_t j = __ldg(idx + r);
    V* dst = out + r * vpr;
    if (j >= 0 && j < n_src) {
      const V* s = src + j * vpr;
      for (int c = lane; c < vpr; c += group) dst[c] = __ldg(s + c);
    } else {
      const V zero{};
      for (int c = lane; c < vpr; c += group) dst[c] = zero;
    }
  }
}

template <typename V>
cudaError_t launch(const void* src, const int32_t* idx, void* out, int64_t n,
                   int64_t n_src, int64_t row_bytes, cudaStream_t stream) {
  const int vpr = (int)(row_bytes / sizeof(V));
  int group = 1;
  while (group < vpr && group < 32) group <<= 1;
  const int threads = 256;
  const int64_t rows_per_block = threads / group;
  int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  // enough blocks to fill 132 SMs many times over; the loop takes the rest
  const int64_t max_blocks = 132 * 32;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  gather_rows_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(src), idx, static_cast<V*>(out), n, n_src, vpr,
      group);
  return cudaGetLastError();
}

}  // namespace

extern "C" int d3_gather_rows(const void* src, const void* idx, void* out,
                              long long n, long long n_src,
                              long long row_bytes, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (row_bytes <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)src | (uintptr_t)out;
  int vec = 16;
  while (vec > 1 && ((row_bytes % vec) != 0 || (align % vec) != 0)) vec >>= 1;
  const int32_t* ix = static_cast<const int32_t*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (vec) {
    case 16: err = launch<uint4>(src, ix, out, n, n_src, row_bytes, s); break;
    case 8: err = launch<uint2>(src, ix, out, n, n_src, row_bytes, s); break;
    case 4: err = launch<uint32_t>(src, ix, out, n, n_src, row_bytes, s); break;
    case 2: err = launch<uint16_t>(src, ix, out, n, n_src, row_bytes, s); break;
    default: err = launch<uint8_t>(src, ix, out, n, n_src, row_bytes, s); break;
  }
  return (int)err;
}
