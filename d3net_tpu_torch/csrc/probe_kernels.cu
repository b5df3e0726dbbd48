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
//   blocks run (PERF.md), and 146.5 MB of them at the probe where the
//   gather needs 110.6: whole chunks, reached rows or not.
//
// prefetch_window_gather -- replaces probe_prefetch.f,
//   scripts/pallas_probe.py:210 (pallas_call at :280), the memory plan of
//   the JAX band_gather (d3net_tpu/ops/pallas_gather.py:100): output chunk
//   j reads from nwin*wblk source rows starting at row bases[j]*wblk;
//   out[r] = window[rel[r]] for 0 <= rel < nwin*wblk, else a zero row.
//   Window rows outside the source read zeros. Any bases are taken:
//   banded, constant, moving back or jumping, negative or past the end.
//   Bound: bytes the gather needs, each distinct source row it reaches
//   read once, the output written, rel and bases read (at the probe's
//   size, 110.6 MB: 0.033 ms at 3.35 TB/s); the TPU plan reads nwin*wblk
//   rows per chunk, 1.5x the source there.
//   Design: a ring of window blocks in shared memory, as window3_gather's
//   ring of chunks. A block owns a column slice of S bytes and a run of L
//   consecutive output chunks, and keeps R = nwin + ceil(chunk / wblk)
//   slots of wblk rows x S bytes, one mbarrier each: a banded window moves
//   about chunk / wblk blocks per chunk, so the next chunk's new blocks fit
//   beside the current window. Source block b lives in slot b mod R, so a
//   lookup is one compare and a window advancing at most R - nwin blocks
//   never lands in a slot that the current chunk reads. Warp 0 keeps the
//   slots (tag, last reading chunk, fill count), a lane per window block,
//   and, while the block gathers chunk j, issues the 2-D TMA copies of the
//   blocks chunk j+1 lacks; a block whose slot chunk j still reads is
//   copied after the __syncthreads that ends chunk j. Each chunk's map
//   (slot and fill parity per window block) and rel come into shared
//   memory one chunk ahead, and every thread waits for every block of its
//   chunk's window, so no fill of a slot is left unwaited when the slot
//   takes its next. Blocks wholly outside the source are not copied and
//   read zeros; TMA zero-fills the rows of a partial block outside it.
//   So each source block slice is read once per run (34 blocks per 8-chunk
//   run at the probe, against 48 for a window per chunk). Why S = 128 at
//   256-byte rows: ten 256-byte slots need 320 KB, more than a block's
//   227 KB; ten 128-byte slots take 168 KB, one block per SM, 2 slices x
//   64 runs = 128 blocks in one wave. The copies ask for no L2 promotion:
//   at 256 bytes it fetched the other slice's half of every row as well.
//   On the H100 (PERF.md) it trails the direct gather mostly by bytes: it
//   copies every row of its window blocks, reached or not (140 MB at the
//   probe where the gather needs 111), at ~2.5 TB/s. S, L, R and the grid
//   come from kernels/probe.py prefetch_ring_plan, which mirrors the slot
//   schedule on the host (prefetch_ring_loads) to count the bytes moved.
//
// A launch that asks for too much shared memory never runs: every entry
// point returns cudaGetLastError() and the wrapper raises on it.
//
// Interface: plain C, bound with ctypes. Launches on the caller's stream,
// allocates nothing, does not synchronise. Rows must be a multiple of 16
// bytes and 16-byte aligned for the window gathers; the wrappers in
// kernels/probe.py check that, and hold the plain PyTorch versions. The
// tensor maps of the two rings are encoded by cuTensorMapEncodeTiled as
// cudaGetDriverEntryPoint hands it out, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

// The tensor map of a (rows, row_bytes) byte matrix, read in boxes of
// box_rows rows x slice_bytes bytes with L2 promotion `promo`; rows outside
// [0, rows) read zeros. Returns 10000 + the CUresult when
// cuTensorMapEncodeTiled refuses.
int encode_rows_map(CUtensorMap* map, const void* src, int64_t rows,
                    int64_t row_bytes, int64_t slice_bytes, int64_t box_rows,
                    CUtensorMapL2promotion promo) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)slice_bytes, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(src), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, promo, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 10000 + (int)res;
}

// Raises `kernel`'s dynamic shared-memory opt-in on the current device to
// `smem` bytes; `done` (one entry per device) remembers it, so the opt-in
// only grows and is set once.
cudaError_t opt_in_smem(const void* kernel, int64_t smem, int64_t* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem > done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    done[dev] = smem;
  }
  return cudaSuccess;
}

// ---- prefetch_window_gather: a ring of window blocks --------------------
// Shared memory of one block (kernels/probe.py prefetch_ring_plan): the
// ring's slots, then per slot its barrier, tag, last reader and fill
// count, then two window maps and two rel buffers.
__host__ __device__ __forceinline__ int64_t prefetch_smem_bytes(
    int64_t slots, int64_t slot_bytes, int64_t nwin, int64_t chunk) {
  return slots * (slot_bytes + 24) + 2 * nwin * 4 + 2 * chunk * 4;
}

__global__ void __launch_bounds__(kRingThreads) prefetch_ring_kernel(
    const __grid_constant__ CUtensorMap src_map,
    const int32_t* __restrict__ rel, const int32_t* __restrict__ bases,
    uint8_t* __restrict__ out, int64_t n, int64_t n_src, int chunk,
    int wblk, int nwin, int64_t row_bytes, int slice_bytes,
    int64_t run_chunks, int slots, int box_rows, int nbox) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int64_t slot_bytes = (int64_t)nbox * box_rows * slice_bytes;
  uint8_t* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + slots * slot_bytes);
  int64_t* tag = reinterpret_cast<int64_t*>(full + slots);   // block held
  int32_t* last = reinterpret_cast<int32_t*>(tag + slots);   // last reader
  uint32_t* fills = reinterpret_cast<uint32_t*>(last + slots);
  int32_t* wmap = reinterpret_cast<int32_t*>(fills + slots);  // 2 x nwin
  int32_t* rel_s = wmap + 2 * nwin;                           // 2 x chunk
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool keeper = tid < 32;
  const int col = (int)blockIdx.y * slice_bytes;
  const int64_t nchunk = (n + chunk - 1) / chunk;
  const int64_t j0 = (int64_t)blockIdx.x * run_chunks;
  const int64_t j1 = j0 + run_chunks < nchunk ? j0 + run_chunks : nchunk;

  // Warp 0 alone keeps the slot state, lane k that of window block k.
  // Source block b (wblk rows from row b * wblk) lives in slot b mod slots,
  // so the blocks of one window sit in distinct slots (no two lanes share
  // one), and a window that advances at most slots - nwin blocks never
  // puts a new block in a slot of the chunk before it. Fill f of a slot
  // completes phase f of its barrier.
  auto load = [&](int s, int64_t b) {
    uint8_t* dst = ring + s * slot_bytes;
    mbar_arrive_expect_tx(full + s, (uint32_t)slot_bytes);
    for (int x = 0; x < nbox; ++x) {
      // a box that starts past the end reads zeros from row n_src as well,
      // and the coordinate stays an int32
      int64_t y = b * wblk + (int64_t)x * box_rows;
      y = y < n_src ? y : n_src;
      tma_load_2d(dst + (int64_t)x * box_rows * slice_bytes, &src_map, col,
                  (int)y, full + s);
    }
  };
  // Maps the window of run chunk t (base block `base`) into `m`: entry k is
  // 4 * slot + 2 * deferred + the fill's parity, or -1 for a block wholly
  // outside the source (zero rows, no copy). A block not held is loaded
  // now, unless its slot is still read by chunk t - 1: that load is
  // deferred until chunk t - 1 is done (`issue_deferred`).
  auto assign = [&](int t, int64_t base, int32_t* m) {
    const int s0 = (int)(((base % slots) + slots) % slots);
    for (int k = lane; k < nwin; k += 32) {
      const int s = s0 + k < slots ? s0 + k : s0 + k - slots;
      const int64_t b = base + k;
      if (b * wblk + wblk <= 0 || b * wblk >= n_src) {
        m[k] = -1;
        continue;
      }
      int deferred = 0;
      if (tag[s] != b) {
        deferred = last[s] >= t - 1;
        tag[s] = b;
        fills[s] += 1;
        if (!deferred) load(s, b);
      }
      last[s] = t;
      m[k] = 4 * s + 2 * deferred + (int)((fills[s] - 1) & 1);
    }
  };
  auto issue_deferred = [&](int64_t base, const int32_t* m) {
    for (int k = lane; k < nwin; k += 32)
      if (m[k] >= 0 && (m[k] & 2)) load(m[k] >> 2, base + k);
  };
  auto load_rel = [&](int64_t j, int buf) {
    const int64_t r0 = j * chunk;
    const int rows = (int)(n - r0 < chunk ? n - r0 : chunk);
    int32_t* d = rel_s + buf * chunk;
    for (int i = tid; i < rows; i += blockDim.x)
      cp_async4(d + i, rel + r0 + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  int64_t base_next = 0;  // warp 0: the base of the chunk after the next
  int64_t base_pend = 0;  // warp 0: the base whose deferred loads wait
  if (keeper) {
    if (lane == 0) {
      for (int s = 0; s < slots; ++s) {
        mbar_init(full + s, 1);
        tag[s] = INT64_MIN;
        last[s] = -2;
        fills[s] = 0;
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    assign(0, __ldg(bases + j0), wmap);
    if (j0 + 1 < j1) base_next = __ldg(bases + j0 + 1);
  }
  load_rel(j0, 0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // thread t copies 16-byte vector t % vps of rows t / vps, t / vps + rpp,
  // ... of the chunk: S is a power of two, so these are shifts
  const int vshift = __ffs(slice_bytes >> 4) - 1;
  const int c16 = (tid & ((1 << vshift) - 1)) * 16;
  const int rpp = (int)blockDim.x >> vshift;
  const int wrows = nwin * wblk;
  const int wshift = (wblk & (wblk - 1)) == 0 ? __ffs(wblk) - 1 : -1;
  for (int64_t j = j0; j < j1; ++j) {
    const int t = (int)(j - j0);
    const int buf = t & 1;
    if (j + 1 < j1) {
      if (keeper) {
        // chunk t - 1 is done: the slots only it read may take new copies
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        base_pend = base_next;
        if (j + 2 < j1) base_next = __ldg(bases + j + 2);
        assign(t + 1, base_pend, wmap + (buf ^ 1) * nwin);
      }
      load_rel(j + 1, buf ^ 1);
    }
    // every thread waits for every block of the window, so that no fill of
    // a slot is left unwaited when the slot takes its next one
    const int32_t* m = wmap + buf * nwin;
    for (int k = 0; k < nwin; ++k)
      if (m[k] >= 0) mbar_wait(full + (m[k] >> 2), (uint32_t)(m[k] & 1));
    const int32_t* rl = rel_s + buf * chunk;
    const int64_t r0 = j * chunk;
    const int rows = (int)(n - r0 < chunk ? n - r0 : chunk);
    uint8_t* ocol = out + r0 * row_bytes + col + c16;
#pragma unroll 4
    for (int i = tid >> vshift; i < rows; i += rpp) {
      const int r = rl[i];
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r >= 0 && r < wrows) {
        const int k = wshift >= 0 ? r >> wshift : r / wblk;
        const int e = m[k];
        if (e >= 0)
          val = *reinterpret_cast<const uint4*>(
              ring + (e >> 2) * slot_bytes +
              (int64_t)(r - k * wblk) * slice_bytes + c16);
      }
      *reinterpret_cast<uint4*>(ocol + (int64_t)i * row_bytes) = val;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // chunk t is done: its slots may take new copies
    if (keeper && j + 1 < j1) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue_deferred(base_pend, wmap + (buf ^ 1) * nwin);
    }
  }
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
  CUtensorMap map;
  const int enc =
      encode_rows_map(&map, src, n, row_bytes, slice_bytes, box_rows,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (enc != 0) return enc;
  static int64_t smem_set[64] = {};
  const cudaError_t err = opt_in_smem(
      reinterpret_cast<const void*>(window3_ring_kernel), smem, smem_set);
  if (err != cudaSuccess) return (int)err;
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

// The plan (slice_bytes S, run_chunks L, slots R, box_rows, nbox) comes
// from kernels/probe.py prefetch_ring_plan; this checks it and launches a
// grid of (ceil(nchunk / L) runs, row_bytes / S slices).
extern "C" int d3_prefetch_window_gather(
    const void* src, const void* rel, const void* bases, void* out,
    long long n, long long n_src, long long chunk, long long wblk,
    long long nwin, long long row_bytes, long long slice_bytes,
    long long run_chunks, long long slots, long long box_rows,
    long long nbox, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_src <= 0 || n_src > INT32_MAX || chunk <= 0 || chunk > INT32_MAX ||
      wblk <= 0 || nwin <= 0 || nwin * wblk > INT32_MAX ||
      row_bytes <= 0 || row_bytes % 16 || slice_bytes < 16 ||
      slice_bytes > 256 || (slice_bytes & (slice_bytes - 1)) ||
      row_bytes % slice_bytes || row_bytes / slice_bytes > 65535 ||
      run_chunks <= 0 || run_chunks > INT32_MAX || slots < nwin ||
      box_rows <= 0 || box_rows > 256 ||
      nbox <= 0 || nbox * box_rows < wblk ||
      (box_rows * slice_bytes) % 128 ||
      ((uintptr_t)src | (uintptr_t)out) % 16 ||
      ((uintptr_t)rel | (uintptr_t)bases) % 4)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = prefetch_smem_bytes(
      slots, nbox * box_rows * slice_bytes, nwin, chunk);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  // no L2 promotion: a 128-byte slice of a 256-byte row would pull the
  // other slice's half in with it (0.057 against 0.061 ms at the probe)
  const int enc = encode_rows_map(&map, src, n_src, row_bytes, slice_bytes,
                                  box_rows, CU_TENSOR_MAP_L2_PROMOTION_NONE);
  if (enc != 0) return enc;
  static int64_t smem_set[64] = {};
  const cudaError_t err = opt_in_smem(
      reinterpret_cast<const void*>(prefetch_ring_kernel), smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int64_t nchunk = (n + chunk - 1) / chunk;
  const dim3 grid((unsigned)((nchunk + run_chunks - 1) / run_chunks),
                  (unsigned)(row_bytes / slice_bytes));
  prefetch_ring_kernel<<<grid, kRingThreads, (size_t)smem,
                         static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const int32_t*>(rel),
      static_cast<const int32_t*>(bases), static_cast<uint8_t*>(out), n,
      n_src, (int)chunk, (int)wblk, (int)nwin, row_bytes, (int)slice_bytes,
      run_chunks, (int)slots, (int)box_rows, (int)nbox);
  return (int)cudaGetLastError();
}
