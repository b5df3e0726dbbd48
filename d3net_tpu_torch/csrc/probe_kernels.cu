// The three kernels of the banded-gather probe (d3net_tpu_torch/probe.py),
// ported from the Pallas TPU kernels of scripts/pallas_probe.py. The
// probe asks whether staging a banded window of source rows in fast memory
// beats a direct row gather (gather_rows.cu); on Hopper the fast memory is
// a block's shared memory.
//
// probe_scale2 -- replaces probe_smoke.kernel, scripts/pallas_probe.py:62
//   (pallas_call at :72): o = 2 * x in bf16, the toolchain smoke test.
//   Bound: bytes, one read and one write of x. Design: grid-stride loop
//   over 16-byte vectors (8 bf16), each pair scaled through f32; 2*x is
//   exact in bf16 barring overflow, so the result is bit-exact against
//   x * 2 in PyTorch. A scalar loop takes a ragged tail or a misaligned
//   tensor.
//
// window3_gather -- replaces _band_gather_pallas, scripts/pallas_probe.py:84
//   (pallas_call at :122): output chunk j (ch rows) reads its rows from a
//   window of three source chunks [max(j-1, 0), j, min(j+1, nchunk-1)];
//   rel = idx - (j-1)*ch indexes the window, and a rel outside [0, 3*ch)
//   gives a zero row (the TPU kernel's one-hot row is empty). At the edge
//   chunks the window repeats a chunk (0,0,1 and j-1,j,j), so its row map
//   is its own: window row w is source row clamp(j-1+w/ch)*ch + w%ch.
//   Bound: bytes the gather needs, each distinct source row it reaches
//   read once, the output written (n*C*b) and the index read (4n). The
//   window plan itself reads every row three times (3*n*C*b); the gap
//   between the two is what the plan costs.
//
// prefetch_window_gather -- replaces probe_prefetch.f,
//   scripts/pallas_probe.py:210 (pallas_call at :280), the memory plan of
//   the JAX band_gather (d3net_tpu/ops/pallas_gather.py:100): output chunk
//   j reads from nwin*wblk source rows starting at row bases[j]*wblk;
//   out[r] = window[rel[r]] for 0 <= rel < nwin*wblk, else a zero row.
//   Window rows outside the source read zeros. Bound: bytes the gather
//   needs, each distinct source row it reaches read once, the output
//   written, rel and bases read; the plan reads nwin*wblk rows per chunk.
//
// Design of the two window gathers: there is no one-hot matmul on Hopper;
// a gather out of shared memory is exact and costs no tensor-core work. A
// block per (output chunk, column slice) stages its window of source rows
// into dynamic shared memory with 16-byte cp.async copies (zero-filled for
// rows outside the source), waits, synchronises, then copies each output
// row's slice out of shared memory. The TPU kernel keeps 3*512 rows x
// 256 B = 384 KB in VMEM; a Hopper block has at most 227 KB, so the rows
// are cut into column slices of at most 96 KB per window (64-byte slices
// for the 3*512-row window, 128-byte for 6*128 rows), two blocks per SM.
// A launch that asks for too much shared memory never runs: every entry
// point returns cudaGetLastError() and the wrapper raises on it.
//
// Interface: plain C, bound with ctypes. Launches on the caller's stream,
// allocates nothing, does not synchronise. Rows must be a multiple of 16
// bytes and 16-byte aligned for the window gathers; the wrappers in
// kernels/probe.py check that, and hold the plain PyTorch versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSliceBudget = 96 * 1024;   // smem per block: 2 per SM
constexpr int64_t kSmemMax = 232448;          // 227 KB opt-in per block

union Bf16Pair {
  uint32_t u;
  __nv_bfloat162 h;
};

__device__ __forceinline__ uint32_t scale2_pair(uint32_t u) {
  Bf16Pair p;
  p.u = u;
  const float2 f = __bfloat1622float2(p.h);
  p.h = __floats2bfloat162_rn(f.x * 2.0f, f.y * 2.0f);
  return p.u;
}

__global__ void scale2_kernel(const uint16_t* __restrict__ x,
                              uint16_t* __restrict__ out, int64_t n,
                              int64_t nvec) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (int64_t i = tid; i < nvec; i += stride) {
    uint4 v = __ldg(xv + i);
    v.x = scale2_pair(v.x);
    v.y = scale2_pair(v.y);
    v.z = scale2_pair(v.z);
    v.w = scale2_pair(v.w);
    ov[i] = v;
  }
  for (int64_t i = nvec * 8 + tid; i < n; i += stride) {
    const float f = __bfloat162float(__ushort_as_bfloat16(x[i]));
    out[i] = __bfloat16_as_ushort(__float2bfloat16_rn(f * 2.0f));
  }
}

// Window of the probe's band kernel: three source chunks around chunk j.
struct Window3 {
  const int32_t* idx;
  int64_t ch;
  int64_t nchunk;
  __device__ __forceinline__ int64_t src_row(int64_t j, int64_t w) const {
    int64_t b = j - 1 + w / ch;
    b = b < 0 ? 0 : (b > nchunk - 1 ? nchunk - 1 : b);
    return b * ch + w % ch;
  }
  __device__ __forceinline__ int64_t rel(int64_t j, int64_t r) const {
    return (int64_t)__ldg(idx + r) - (j - 1) * ch;
  }
};

// Window of the prefetch kernel: contiguous rows from a per-chunk base.
struct PrefetchWindow {
  const int32_t* rel_;
  const int32_t* bases;
  int64_t wblk;
  __device__ __forceinline__ int64_t src_row(int64_t j, int64_t w) const {
    return (int64_t)__ldg(bases + j) * wblk + w;
  }
  __device__ __forceinline__ int64_t rel(int64_t j, int64_t r) const {
    return (int64_t)__ldg(rel_ + r);
  }
};

template <class Map>
__global__ void window_gather_kernel(const uint8_t* __restrict__ src,
                                     uint8_t* __restrict__ out, Map map,
                                     int64_t n, int64_t n_src, int64_t chunk,
                                     int64_t wrows, int64_t row_bytes,
                                     int slice_bytes) {
  extern __shared__ __align__(16) uint8_t win[];
  const int64_t j = blockIdx.x;
  const int64_t col = (int64_t)blockIdx.y * slice_bytes;
  const int vps = slice_bytes / 16;

  // stage the window's column slice: 16-byte async copies, zero-filled
  // (src-size 0) for rows outside the source
  for (int64_t v = threadIdx.x; v < wrows * vps; v += blockDim.x) {
    const int64_t w = v / vps;
    const int c = (int)(v % vps);
    const int64_t s = map.src_row(j, w);
    const bool ok = s >= 0 && s < n_src;
    const uint8_t* g = ok ? src + s * row_bytes + col + c * 16 : src;
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(
        win + w * slice_bytes + c * 16);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(g), "r"(ok ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int64_t r0 = j * chunk;
  const int64_t rows = (n - r0) < chunk ? (n - r0) : chunk;
  for (int64_t v = threadIdx.x; v < rows * vps; v += blockDim.x) {
    const int64_t i = v / vps;
    const int c = (int)(v % vps);
    const int64_t rel = map.rel(j, r0 + i);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (rel >= 0 && rel < wrows)
      val = *reinterpret_cast<const uint4*>(win + rel * slice_bytes + c * 16);
    *reinterpret_cast<uint4*>(out + (r0 + i) * row_bytes + col + c * 16) = val;
  }
}

template <class Map>
cudaError_t launch_window(const Map& map, const void* src, void* out,
                          int64_t n, int64_t n_src, int64_t chunk,
                          int64_t wrows, int64_t row_bytes,
                          cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (row_bytes <= 0 || row_bytes % 16 || chunk <= 0 || wrows <= 0 ||
      ((uintptr_t)src | (uintptr_t)out) % 16)
    return cudaErrorInvalidValue;
  // widest power-of-two column slice that divides the row and keeps the
  // window inside the per-block budget (at least one 16-byte vector)
  int64_t slice = 16;
  while (row_bytes % (slice * 2) == 0 && wrows * slice * 2 <= kSliceBudget)
    slice *= 2;
  const int64_t smem = wrows * slice;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      window_gather_kernel<Map>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + chunk - 1) / chunk),
                  (unsigned)(row_bytes / slice));
  window_gather_kernel<Map><<<grid, kThreads, (size_t)smem, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(out), map, n,
      n_src, chunk, wrows, row_bytes, (int)slice);
  return cudaGetLastError();
}

}  // namespace

extern "C" int d3_probe_scale2(const void* x, void* out, long long n,
                               void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const bool aligned = (((uintptr_t)x | (uintptr_t)out) % 16) == 0;
  const int64_t nvec = aligned ? n / 8 : 0;
  int64_t blocks = (nvec + (n - nvec * 8) + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  scale2_kernel<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), n, nvec);
  return (int)cudaGetLastError();
}

extern "C" int d3_window3_gather(const void* src, const void* idx, void* out,
                                 long long n, long long ch,
                                 long long row_bytes, void* stream) {
  if (ch <= 0 || n % ch) return (int)cudaErrorInvalidValue;
  const Window3 map{static_cast<const int32_t*>(idx), ch, n / ch};
  return (int)launch_window(map, src, out, n, n, ch, 3 * ch, row_bytes,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int d3_prefetch_window_gather(const void* src, const void* rel,
                                         const void* bases, void* out,
                                         long long n, long long n_src,
                                         long long chunk, long long wblk,
                                         long long nwin, long long row_bytes,
                                         void* stream) {
  const PrefetchWindow map{static_cast<const int32_t*>(rel),
                           static_cast<const int32_t*>(bases), wblk};
  return (int)launch_window(map, src, out, n, n_src, chunk, nwin * wblk,
                            row_bytes, static_cast<cudaStream_t>(stream));
}
