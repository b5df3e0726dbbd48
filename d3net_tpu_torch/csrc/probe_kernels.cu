// The three kernels of the banded-gather probe (d3net_tpu_torch/probe.py),
// ported from the Pallas TPU kernels of scripts/pallas_probe.py. The
// probe asks whether staging a banded window of source rows in fast memory
// beats a direct row gather (gather_rows.cu); on Hopper the fast memory is
// a block's shared memory.
//
// probe_scale2 -- replaces probe_smoke.kernel, scripts/pallas_probe.py:62
//   (pallas_call at :72): o = 2 * x in bf16, the toolchain smoke test.
//   Bound: bytes, one read and one write of x; at the probe's 64 KB block
//   the launch latency is the whole device time. Design: grid-stride loop
//   over 16-byte vectors (8 bf16), each pair scaled through f32, with one
//   wave of blocks at most; 2*x is exact in bf16 barring overflow, so the
//   result is bit-exact against x * 2 in PyTorch. A scalar loop takes a
//   ragged tail or a misaligned tensor.
//
// window3_gather -- replaces _band_gather_pallas, scripts/pallas_probe.py:84
//   (pallas_call at :122): output chunk j (ch rows) reads its rows from a
//   window of three source chunks [max(j-1, 0), j, min(j+1, nchunk-1)];
//   rel = idx - (j-1)*ch indexes the window, and a rel outside [0, 3*ch)
//   gives a zero row (the TPU kernel's one-hot row is empty). At the edge
//   chunks the window repeats a chunk (0,0,1 and j-1,j,j), so its row map
//   is its own: window row w is source row clamp(j-1+w/ch)*ch + w%ch.
//   Bound: bytes the gather needs, each distinct source row it reaches
//   read once, the output written (n*C*b) and the index read (4n).
//   Design: a ring of source chunks in shared memory. A block owns one
//   column slice of S bytes and a run of L consecutive output chunks. It
//   keeps 4 chunk slots; thread 0 fills them with 2-D TMA copies (boxes of
//   at most 256 rows x S bytes, completing on one mbarrier per slot with
//   the slot's byte count), so each source chunk slice is read once per
//   run: (L+2)/L of the source instead of the 3x of a window per chunk.
//   While the block gathers chunk j out of the slots of chunks j-1, j and
//   j+1, the copy of chunk j+2 is in flight; the slot of chunk j-1 is
//   refilled with chunk j+3 once every thread is done with chunk j. Each
//   chunk's indices come into shared memory by cp.async one chunk ahead.
//   Stores are 16-byte vectors from registers; S is a power of two, so a
//   thread's vector and rows are shifts, and the window block of a row
//   takes two compares (no 64-bit division on the gather path). Slot rows
//   are rounded up to whole boxes; the extra rows of a box hold rows of
//   the next chunk (or zeros past the source end) and are never gathered.
//   S, L and the grid come from kernels/probe.py window3_ring_plan. On the
//   H100 the ring moves its bytes at about 2.4 TB/s whether 64 or 128
//   blocks run (PERF.md): the 64-byte slices of 256-byte rows, not the SM
//   count or the overlap, hold it below the direct gather.
//
// prefetch_window_gather -- replaces probe_prefetch.f,
//   scripts/pallas_probe.py:210 (pallas_call at :280), the memory plan of
//   the JAX band_gather (d3net_tpu/ops/pallas_gather.py:100): output chunk
//   j reads from nwin*wblk source rows starting at row bases[j]*wblk;
//   out[r] = window[rel[r]] for 0 <= rel < nwin*wblk, else a zero row.
//   Window rows outside the source read zeros. Bound: bytes the gather
//   needs, each distinct source row it reaches read once, the output
//   written, rel and bases read; the plan reads nwin*wblk rows per chunk.
//   Design: there is no one-hot matmul on Hopper; a gather out of shared
//   memory is exact and costs no tensor-core work. A block per (output
//   chunk, column slice) stages its window of source rows into dynamic
//   shared memory with 16-byte cp.async copies (zero-filled for rows
//   outside the source), waits, synchronises, then copies each output
//   row's slice out of shared memory. The TPU kernel keeps 6*128 rows x
//   256 B in VMEM; a Hopper block takes column slices of at most 96 KB
//   per window, two blocks per SM.
//
// A launch that asks for too much shared memory never runs: every entry
// point returns cudaGetLastError() and the wrapper raises on it.
//
// Interface: plain C, bound with ctypes. Launches on the caller's stream,
// allocates nothing, does not synchronise. Rows must be a multiple of 16
// bytes and 16-byte aligned for the window gathers; the wrappers in
// kernels/probe.py check that, and hold the plain PyTorch versions. The
// tensor map of window3_gather is encoded by cuTensorMapEncodeTiled as
// cudaGetDriverEntryPoint hands it out, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSliceBudget = 96 * 1024;   // smem per block: 2 per SM
constexpr int64_t kSmemMax = 232448;          // 227 KB opt-in per block
constexpr int kScaleBlocksPerSm = 2048 / kThreads;
constexpr int kSms = 132;

constexpr int kRingSlots = 4;                 // chunks j-1, j, j+1 and j+2
constexpr int kRingThreads = 512;             // kernels/probe.py RING_THREADS

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

// ---- window3_gather: the ring -------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spins until the phase of parity `parity` of `bar` has completed. A copy
// that never lands traps (the launch then fails) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// One box of the tensor map at (x bytes, y rows) into shared memory; the
// copy completes on `bar` with the box's byte count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Shared memory of one block: the ring, two index buffers, the barriers.
__host__ __device__ __forceinline__ int64_t ring_smem_bytes(
    int64_t ch, int64_t slice_bytes, int64_t slot_rows) {
  return kRingSlots * slot_rows * slice_bytes + 2 * ch * 4 + 8 * kRingSlots;
}

__global__ void __launch_bounds__(kRingThreads)
    window3_ring_kernel(const __grid_constant__ CUtensorMap src_map,
                        const int32_t* __restrict__ idx,
                        uint8_t* __restrict__ out, int64_t ch, int64_t nchunk,
                        int64_t row_bytes, int slice_bytes, int64_t run_chunks,
                        int box_rows, int nbox) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int64_t slot_bytes = (int64_t)nbox * box_rows * slice_bytes;
  uint8_t* ring = smem;
  int32_t* idx_s = reinterpret_cast<int32_t*>(smem + kRingSlots * slot_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRingSlots * slot_bytes +
                                               2 * ch * 4);
  const int tid = threadIdx.x;
  const int col = (int)blockIdx.y * slice_bytes;
  const int64_t j0 = (int64_t)blockIdx.x * run_chunks;
  const int64_t j1 = j0 + run_chunks < nchunk ? j0 + run_chunks : nchunk;
  const int64_t cf = j0 > 0 ? j0 - 1 : 0;          // first source chunk
  const int64_t cl = j1 < nchunk ? j1 : nchunk - 1;  // last source chunk

  if (tid == 0) {
    for (int s = 0; s < kRingSlots; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // source chunk c goes to slot (c - cf) % slots, as fill (c - cf) / slots
  int64_t next = cf;  // next chunk to load (thread 0's copy is the one used)
  auto load = [&](int64_t c) {
    const int s = (int)((c - cf) % kRingSlots);
    uint8_t* dst = ring + s * slot_bytes;
    mbar_arrive_expect_tx(full + s, (uint32_t)slot_bytes);
    for (int b = 0; b < nbox; ++b)
      tma_load_2d(dst + (int64_t)b * box_rows * slice_bytes, &src_map, col,
                  (int)(c * ch + (int64_t)b * box_rows), full + s);
  };
  auto wait_chunk = [&](int64_t c) -> const uint8_t* {
    c = c < 0 ? 0 : (c > nchunk - 1 ? nchunk - 1 : c);
    const int64_t k = c - cf;
    mbar_wait(full + k % kRingSlots, (uint32_t)((k / kRingSlots) & 1));
    return ring + (k % kRingSlots) * slot_bytes;
  };
  auto load_idx = [&](int64_t j, int buf) {
    const int32_t* g = idx + j * ch;
    int32_t* d = idx_s + buf * ch;
    for (int64_t i = tid; i < ch; i += blockDim.x) cp_async4(d + i, g + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (tid == 0)
    while (next <= cl && next < cf + kRingSlots) load(next++);
  load_idx(j0, 0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // thread t copies 16-byte vector t % vps of rows t / vps, t / vps + rpp,
  // ... of the chunk: S is a power of two, so these are shifts
  const int vshift = __ffs(slice_bytes >> 4) - 1;
  const int c16 = (tid & ((1 << vshift) - 1)) * 16;
  const int rpp = (int)blockDim.x >> vshift;
  const int chi = (int)ch;
  for (int64_t j = j0; j < j1; ++j) {
    const int buf = (int)((j - j0) & 1);
    if (j + 1 < j1) load_idx(j + 1, buf ^ 1);
    const uint8_t* win0 = wait_chunk(j - 1);
    const uint8_t* win1 = wait_chunk(j);
    const uint8_t* win2 = wait_chunk(j + 1);
    const int32_t* ix = idx_s + buf * ch;
    const int64_t base = (j - 1) * ch;
    uint8_t* ocol = out + j * ch * row_bytes + col + c16;
#pragma unroll 4
    for (int i = tid >> vshift; i < chi; i += rpp) {
      const int64_t rel = (int64_t)ix[i] - base;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (rel >= 0 && rel < 3 * ch) {
        const int r = (int)rel;
        const uint8_t* win = r < chi ? win0 : (r < 2 * chi ? win1 : win2);
        const int w = r < chi ? r : (r < 2 * chi ? r - chi : r - 2 * chi);
        val = *reinterpret_cast<const uint4*>(win + w * slice_bytes + c16);
      }
      *reinterpret_cast<uint4*>(ocol + (int64_t)i * row_bytes) = val;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // chunk j is done: the slot of chunk j-1 is free
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      while (next <= cl && next < j + kRingSlots) load(next++);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// ---- prefetch_window_gather: a window per (chunk, column slice) ---------
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
  // one thread per vector (and per tail element), one wave at most
  int64_t blocks = (nvec + (n - nvec * 8) + kThreads - 1) / kThreads;
  if (blocks > kSms * kScaleBlocksPerSm) blocks = kSms * kScaleBlocksPerSm;
  if (blocks < 1) blocks = 1;
  scale2_kernel<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), n, nvec);
  return (int)cudaGetLastError();
}

// The plan (slice_bytes S, run_chunks L, box_rows, nbox) comes from
// kernels/probe.py window3_ring_plan; this checks it and launches a grid of
// (ceil(nchunk / L) runs, row_bytes / S slices). A tensor map that
// cuTensorMapEncodeTiled refuses returns 10000 + its CUresult.
extern "C" int d3_window3_gather(const void* src, const void* idx, void* out,
                                 long long n, long long ch,
                                 long long row_bytes, long long slice_bytes,
                                 long long run_chunks, long long box_rows,
                                 long long nbox, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (ch <= 0 || n % ch || n > INT32_MAX || row_bytes <= 0 ||
      row_bytes % 16 || slice_bytes < 16 || slice_bytes > 256 ||
      (slice_bytes & (slice_bytes - 1)) || row_bytes % slice_bytes ||
      run_chunks <= 0 ||
      box_rows <= 0 || box_rows > 256 || nbox <= 0 || nbox * box_rows < ch ||
      (box_rows * slice_bytes) % 128 || row_bytes / slice_bytes > 65535 ||
      ((uintptr_t)src | (uintptr_t)out) % 16 || (uintptr_t)idx % 4)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = ring_smem_bytes(ch, slice_bytes, nbox * box_rows);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;

  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)slice_bytes, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(src), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;

  // the shared-memory opt-in, per device, only grows
  static int64_t smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(window3_ring_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = smem;
  }
  const int64_t nchunk = n / ch;
  const dim3 grid((unsigned)((nchunk + run_chunks - 1) / run_chunks),
                  (unsigned)(row_bytes / slice_bytes));
  window3_ring_kernel<<<grid, kRingThreads, (size_t)smem,
                        static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const int32_t*>(idx), static_cast<uint8_t*>(out), ch,
      nchunk, row_bytes, (int)slice_bytes, run_chunks, (int)box_rows,
      (int)nbox);
  return (int)cudaGetLastError();
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
