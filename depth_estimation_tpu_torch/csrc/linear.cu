// Y = X·Wᵀ (+ bias) (+ exact-erf GELU) in float32 on the tensor cores: the
// ViT's linear layers (qkv, proj, fc1, fc2) and DPT's readout projections.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA
// (models/vit.py's nn.Dense). Without it the port ran them through cuBLAS,
// whose float32 GEMMs with TF32 off (device.full_f32) run on the FMA units,
// at most 67 TFLOP/s. DPT_Large's linear layers are 477 GFLOP a frame, so the
// products bound the kernel: 3 × their FLOPs at the 495 TFLOP/s TF32 rate.
//
// 3xTF32. One TF32 pass keeps 11 significant bits and lands some 1e-3 from
// the float32 result at DPT_Large's depth, so every product x·w is taken as
// x_lo·w_hi + x_hi·w_lo + x_hi·w_hi, as K1 (attention.cu) and K4 do; the
// dropped x_lo·w_lo is about 2^-21 relative. The tensor cores read the top 19
// bits of each operand (they truncate), so w_hi is W itself and w_lo = W −
// trunc(W) comes in as a second matrix (the wrapper computes it once a
// weight, ops/kernels/dense.py). X is split on its way from shared memory
// into registers: x_hi is x rounded to the nearest TF32, x_lo = x − x_hi.
//
// Shape. X (M, K) and W, W_lo (N, K) are row-major, i.e. K-major, the one
// layout wgmma takes for tf32. A block is 384 threads: warpgroup 0 is the
// producer, warpgroups 1 and 2 the consumers, each owning 64 rows of a
// 128 × BN output tile (BN = 128 or 64, chosen by the wrapper from M and N so
// that the tiles fill the SMs). Blocks are persistent, one an SM: block b
// walks tiles b, b + grid, ..., row tiles fastest.
//
// Pipeline. One producer thread loads each 32-column K slice of X (128 rows),
// W and W_lo (BN rows each) by TMA into a ring of kStages stages (192 KB),
// 128-byte swizzled, signalling a "full" mbarrier with the bytes. Each
// consumer warpgroup waits for a stage, reads its X rows into registers
// (fragments below) and splits them, then issues per 8-wide k step three
// wgmma.m64nBNk8.tf32 with A from registers and B (W or W_lo) from shared
// memory by descriptor, into a fresh accumulator (the first product of the
// stage overwrites it). While those products run it reads and splits the
// next stage's X rows; once they complete it adds the partial sum into the
// tile's f32 accumulator with ordinary FADDs and releases the stage (one
// arrival a consumer warp on its "empty" mbarrier).
// The tensor cores' accumulation truncates, so its error grows with the
// number of products summed into one register; a fresh sum per 32-deep
// slice bounds that, as K1's fresh sum per key tile does. The two consumer
// warpgroups share the tensor cores, so one's FADDs and barrier steps overlap
// the other's products. A warpgroup whose 64 rows all lie past M still waits
// for and releases every stage but issues no product.
//
// Epilogue. Bias, then GELU where asked (0.5·y·(1 + erf(y/√2)), PyTorch's
// exact form), stored from the accumulator registers, rows < M and columns
// < N. No split-K and no atomics: each output is one block's sum in a fixed
// order, so a run gives the same bits every time.
//
// Fragments (g = lane >> 2, t = lane & 3; warp w of the consumer warpgroup
// owns rows 16w..16w+15 of its 64):
//   A (64×8, registers): a0 (16w+g, t) a1 (16w+g+8, t) a2 (16w+g, t+4) a3 (16w+g+8, t+4)
//   D (64×BN, f32):      d[4j] (16w+g, 8j+2t) d[4j+1] (.., 8j+2t+1) d[4j+2] (16w+g+8, 8j+2t) d[4j+3]
// A stage's X tile is 128 rows of 128 bytes, TMA's 128-byte swizzle: the
// 16-byte chunk c of row r sits at chunk c ^ (r & 7). A fragment read (8 rows
// g, 4 columns t) touches chunks (2kk) ^ g: 8 distinct chunks, 32 banks.
// W's tile is the canonical K-major 128-byte-swizzled layout of wgmma: 8-row
// groups 1024 bytes apart (SBO), the k step's 32 bytes added to the start
// address inside the swizzle atom.
//
// The wrapper requires K % 32 == 0, N % 8 == 0, 16-byte aligned X, W and
// W_lo (TMA), and a contiguous Y; it falls back to F.linear otherwise.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBlockM = 128;   // two consumer warpgroups × 64 rows
constexpr int kBlockK = 32;    // one 128-byte swizzle row of f32
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kRingBytes = 192 * 1024;
constexpr int kXTileBytes = kBlockM * kBlockK * 4;
constexpr int kMaxDevices = 64;

template <int BN>
struct Tiling {
  static constexpr int kWTileBytes = BN * kBlockK * 4;
  static constexpr int kStageBytes = kXTileBytes + 2 * kWTileBytes;  // X, W, W_lo
  static constexpr int kStages = kRingBytes / kStageBytes;           // 4 at BN 128, 6 at BN 64
  static constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 2-D tensor map (coordinates innermost first) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled tile whose
// 8-row groups lie 1024 bytes apart (start address, LBO 16 (unused),
// SBO 1024, all in 16-byte units; layout type 1 = 128-byte swizzle).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return (static_cast<uint64_t>(smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keep the compiler from moving reads or writes of d across the wgmma wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = (scale_d ? d : 0) + A·B for one m64nNk8 tf32 product, A (64×8) from
// registers, B (8×N) from shared memory by descriptor.
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t desc_b,
                                           int scale_d) {
  if constexpr (BN == 128)
    wgmma_m64n128k8(d, a, desc_b, scale_d);
  else
    wgmma_m64n64k8(d, a, desc_b, scale_d);
}

// A operand: hi rounded to the nearest TF32, lo the rest (attention.cu's split).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Element (r, c) of a stage's 128 × 32 X tile under the 128-byte swizzle.
__device__ __forceinline__ float x_at(const uint8_t* tile, int r, int c) {
  return *reinterpret_cast<const float*>(tile + r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2)));
}

// The 4 k steps' A fragments of a stage for the thread whose rows are r0 and
// r0 + 8 of the X tile, split into hi and lo.
__device__ __forceinline__ void load_a(const uint8_t* xs, int r0, int t, uint32_t (&hi)[4][4],
                                       uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split(x_at(xs, r0, 8 * kk + t), hi[kk][0], lo[kk][0]);
    split(x_at(xs, r0 + 8, 8 * kk + t), hi[kk][1], lo[kk][1]);
    split(x_at(xs, r0, 8 * kk + t + 4), hi[kk][2], lo[kk][2]);
    split(x_at(xs, r0 + 8, 8 * kk + t + 4), hi[kk][3], lo[kk][3]);
  }
}

// Keep the A fragments alive (in their registers) up to this point.
__device__ __forceinline__ void keep_regs(const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(a[kk][e]) : "memory");
}

__device__ __forceinline__ float gelu_erf(float y) { return 0.5f * y * (1.f + erff(y * 0.70710678118654752f)); }

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
linear_gemm_f32x3_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                         const __grid_constant__ CUtensorMap twl, const float* __restrict__ bias,
                         float* __restrict__ y, int m, int n, int k, int gelu) {
  using T = Tiling<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // 1024-byte aligned (swizzle)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kStages * T::kStageBytes);
  uint64_t* empty = full + T::kStages;
  auto x_tile = [&](int s) { return smem + s * T::kStageBytes; };
  auto w_tile = [&](int s) { return smem + s * T::kStageBytes + kXTileBytes; };
  auto wl_tile = [&](int s) { return smem + s * T::kStageBytes + kXTileBytes + T::kWTileBytes; };

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int m_tiles = (m + kBlockM - 1) / kBlockM;
  const int tiles = m_tiles * ((n + BN - 1) / BN);
  const int k_tiles = k / kBlockK;

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * kBlockM, n0 = (tile / m_tiles) * BN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], T::kStageBytes);
          tma_load(x_tile(stage), &tx, &full[stage], kt * kBlockK, m0);
          tma_load(w_tile(stage), &tw, &full[stage], kt * kBlockK, n0);
          tma_load(wl_tile(stage), &twl, &full[stage], kt * kBlockK, n0);
          if (++stage == T::kStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = 64 * c + 16 * warp + g;  // this thread's first row within the 128-row tile
    int stage = 0;
    uint32_t phase = 0;
    float acc[BN / 2], part[BN / 2];
    uint32_t a_hi[4][4], a_lo[4][4];  // the current stage's A fragments, split
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * kBlockM, n0 = (tile / m_tiles) * BN;
      const bool live = m0 + 64 * c < m;  // warpgroup-uniform
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      mbar_wait(&full[stage], phase);
      if (live) load_a(x_tile(stage), r0, t, a_hi, a_lo);
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int cur = stage;
        if (++stage == T::kStages) stage = 0, phase ^= 1;
        const bool more = kt + 1 < k_tiles;
        if (live) {
          const uint64_t dw = desc_sw128(w_tile(cur)), dwl = desc_sw128(wl_tile(cur));
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {  // + 32 bytes (2 in 16-byte units) a k step
            wgmma_tile<BN>(part, a_lo[kk], dw + 2 * kk, kk > 0);
            wgmma_tile<BN>(part, a_hi[kk], dwl + 2 * kk, 1);
            wgmma_tile<BN>(part, a_hi[kk], dw + 2 * kk, 1);
          }
          wgmma_commit();
          // the next stage's fragments are read and split while these products run
          uint32_t n_hi[4][4], n_lo[4][4];
          if (more) {
            mbar_wait(&full[stage], phase);
            load_a(x_tile(stage), r0, t, n_hi, n_lo);
          }
          wgmma_wait0();
          fence_regs(part);
          keep_regs(a_hi);  // the products read these until the wait
          keep_regs(a_lo);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
          if (more) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int e = 0; e < 4; ++e) a_hi[kk][e] = n_hi[kk][e], a_lo[kk][e] = n_lo[kk][e];
          }
        } else if (more) {
          mbar_wait(&full[stage], phase);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[cur]);
      }
      if (!live) continue;
      const int row0 = m0 + r0, row1 = row0 + 8;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= n) continue;
        float2 b = make_float2(0.f, 0.f);
        if (bias) b = make_float2(bias[col], bias[col + 1]);
        float2 v0 = make_float2(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
        float2 v1 = make_float2(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
        if (gelu) {
          v0 = make_float2(gelu_erf(v0.x), gelu_erf(v0.y));
          v1 = make_float2(gelu_erf(v1.x), gelu_erf(v1.y));
        }
        if (row0 < m) *reinterpret_cast<float2*>(y + static_cast<long long>(row0) * n + col) = v0;
        if (row1 < m) *reinterpret_cast<float2*>(y + static_cast<long long>(row1) * n + col) = v1;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so the library links against the runtime alone.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A row-major (rows, k) f32 matrix read in boxes of box_rows × 32, 128-byte swizzled;
// rows past the end read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int rows, int k, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBlockK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// X's tensor map, from a small per-thread cache keyed by (pointer, rows, k):
// the frame programs run the same shapes on the caching allocator's same
// blocks frame after frame, and a map is a function of these alone.
const CUtensorMap* x_map(const void* x, int m, int k) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    int m, k;
  };
  constexpr int kEntries = 64;
  static thread_local Entry cache[kEntries];
  static thread_local int filled = 0, next = 0;
  for (int i = 0; i < filled; ++i)
    if (cache[i].ptr == x && cache[i].m == m && cache[i].k == k) return &cache[i].map;
  Entry& e = cache[next];
  if (!tensor_map(&e.map, x, m, k, kBlockM)) return nullptr;
  e.ptr = x, e.m = m, e.k = k;
  next = (next + 1) % kEntries;
  if (filled < kEntries) ++filled;
  return &e.map;
}

template <int BN>
cudaError_t launch(const void* x, const CUtensorMap& tw, const CUtensorMap& twl, const float* bias, float* y, int m,
                   int n, int k, int gelu, int sms, int device, cudaStream_t stream) {
  using T = Tiling<BN>;
  static bool sized[kMaxDevices];  // the shared-memory attribute, set once a device
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!sized[device]) {
    const cudaError_t err = cudaFuncSetAttribute(linear_gemm_f32x3_kernel<BN>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return err;
    sized[device] = true;
  }
  const CUtensorMap* tx = x_map(x, m, k);
  if (!tx) return cudaErrorInvalidValue;
  const int tiles = ((m + kBlockM - 1) / kBlockM) * ((n + BN - 1) / BN);
  const int grid = tiles < sms ? tiles : sms;
  linear_gemm_f32x3_kernel<BN><<<grid, kThreads, T::kSmemBytes, stream>>>(*tx, tw, twl, bias, y, m, n, k, gelu);
  return cudaGetLastError();
}

}  // namespace

// The tensor maps of a weight w (n, k) and its remainder w_lo = w − trunc_tf32(w),
// for output tiles block_n wide, into maps[0] and maps[1]: made once a weight
// (ops/kernels/dense.py keeps them beside w_lo) so that a launch encodes X's
// map alone. Both 16-byte aligned, row-major and contiguous; k % 32 == 0.
// Returns 0, or cudaErrorInvalidValue if a map cannot be encoded.
extern "C" int linear_weight_maps(const void* w, const void* w_lo, int n, int k, int block_n, void* maps) {
  CUtensorMap* out = static_cast<CUtensorMap*>(maps);
  if (n < 8 || k < kBlockK || k % kBlockK || (block_n != 128 && block_n != 64)) return cudaErrorInvalidValue;
  if (!tensor_map(&out[0], w, n, k, block_n) || !tensor_map(&out[1], w_lo, n, k, block_n))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// y (m, n) = x (m, k) · wᵀ (+ bias) (+ GELU), all float32, row-major and
// contiguous; w_maps: linear_weight_maps' two maps of w and w_lo for this
// block_n. x 16-byte aligned, k % 32 == 0, n % 8 == 0, m ≥ 1; bias (n) or
// null. block_n: 128 or 64 (the output tile's width); sms: the persistent
// grid's size limit; device: the current device, whose stream this is.
// Returns cudaGetLastError() after the launch (no synchronisation).
extern "C" int linear_forward(const void* x, const void* w_maps, const void* bias, void* y, int m, int n, int k,
                              int gelu, int block_n, int sms, int device, void* stream) {
  if (m < 1 || n < 8 || n % 8 || k < kBlockK || k % kBlockK || sms < 1) return cudaErrorInvalidValue;
  CUtensorMap maps[2];
  memcpy(maps, w_maps, sizeof maps);  // the caller's buffer need not be 64-byte aligned
  const float* b = static_cast<const float*>(bias);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_n == 128) return launch<128>(x, maps[0], maps[1], b, out, m, n, k, gelu, sms, device, s);
  if (block_n == 64) return launch<64>(x, maps[0], maps[1], b, out, m, n, k, gelu, sms, device, s);
  return cudaErrorInvalidValue;
}

// The bytes of one tensor map (linear_weight_maps writes two).
extern "C" int linear_map_bytes() { return static_cast<int>(sizeof(CUtensorMap)); }
