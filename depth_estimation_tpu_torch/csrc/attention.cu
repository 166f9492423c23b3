// K1: softmax(Q Kᵀ / sqrt(D)) V over (B, H, N, D) with D = 64.
//
// Replaces depth_estimation_tpu/ops/pallas/attention.py::_flash_kernel (the
// Pallas flash attention inside each ViT block of DPT_Large). Two routes,
// chosen by the input type alone:
//
// f32: tensor cores, 3xTF32 (attention_f32_kernel). At DPT_Large's
// (1, 16, 769, 64) the two products are 4·16·769²·64 ≈ 2.42 GFLOP over
// 12.6 MB of Q/K/V/O, so the kernel is bound by operations. One TF32 pass
// keeps 11 significant bits and misses the f32 tolerance (atol 2e-5)
// several times over (tests/test_torch_kernels.py), so every product a·b
// is taken as three TF32 products, a_lo·b_hi + a_hi·b_lo + a_hi·b_hi,
// accumulated in f32 in that order (a_lo·b_lo, at most about 2^-21 relative, is
// dropped). The bound is therefore 3 · 2.42 GFLOP at the 495 TFLOP/s TF32
// rate.
//   The split. The mma reads the top 19 bits of each 32-bit operand (it
// truncates). A operands (Q, P): hi = x rounded to the nearest TF32 (add half
// of the 13 dropped bits' range, then clear them: the bits cvt.rna.tf32.f32
// gives for finite x), lo = x - hi, which the mma truncates. B operands (K,
// V), which all four warps split again as they read them: hi = x itself
// (the mma truncates it), lo = x - trunc(x): two operations instead of three.
//   Grid: one block of 4 warps per (batch·head, 64-row Q tile); each warp
// owns 16 Q rows, whose fragments are loaded once into registers as hi/lo
// pairs. K/V stream through shared memory in 64-key tiles, double-buffered:
// the cp.async copies of tile j+1 are issued before tile j is computed. S
// stays in registers: the online max and sum run on its C fragments, and P
// feeds the P·V product from the same registers. Each tile's P·V is summed
// in fresh registers and added to O with one f32 FMA (O = alpha·O + P·V):
// the tensor cores' f32 accumulation truncates, so its error grows with the
// number of products summed into one accumulator; a fresh sum per tile
// bounds that to one tile's 24 steps.
//   mma.sync.m16n8k8 .tf32 fragments (g = lane >> 2, t = lane & 3):
//     A (16×8, row × k):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//     B (8×8,  k × col):  b0 (t, g)  b1 (t+4, g)
//     C (16×8, f32):      c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)
//   S = Q·Kᵀ: B is Kᵀ. The reduction over d is permuted across each pair of
// 8-wide k-chunks (2c, 2c+1) so that one 16-byte read serves both: in chunk
// 2c, mma index t is d = 16c + 4t and t+4 is d = 16c + 4t + 1; in chunk
// 2c+1 they are 16c + 4t + 2 and + 3. So a lane reads K[key 8j+g][16c+4t ..
// +3] once (b0, b1 of chunk 2c, then of chunk 2c+1) and Q[row][16c+4t .. +3]
// likewise. K rows are padded to 80 floats, so each quarter-warp's 16-byte
// reads hit 32 distinct banks.
//   O += P·V: the C fragment of S holds keys 2t and 2t+1 of each 8-key chunk,
// where A wants keys t and t+4. The reduction index is permuted within the
// chunk instead (mma index t is key 2t, index t+4 is key 2t+1): a0 = c0,
// a1 = c2, a2 = c1, a3 = c3, and V's fragment is read with the same
// permutation, b0 = V[key 2t][d g], b1 = V[key 2t+1][d g], from rows padded
// to 68 floats (32 distinct banks). The sums over d and over the keys are
// unchanged by either permutation.
//   cp.async and the 16-byte Q loads need 16-byte aligned addresses: the
// wrapper requires 16-byte aligned q, k, v pointers and (batch, head, row)
// strides that are multiples of 4 elements, and raises otherwise. Key rows
// >= N are zero-filled by the copy (0 source bytes) and masked to -inf
// before the row max; Q rows >= N are loaded as zeros and never stored.
//
// bf16: FMA units (attention_bf16_kernel), bound by 2.42 GFLOP at the f32
// FMA rate of 67 TFLOP/s: one block of 256 threads per (batch·head, 64-row Q
// tile), each thread a 4×4 register tile of S and of O, bf16 widened to f32
// in shared memory, the output rounded back once. Its tensor-core version is
// later work.
//
// Both read q, k and v through their (batch, head, row) strides, so the
// ViT's fused qkv projection is consumed without a copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;
constexpr int kTile = 64;     // Q rows and K/V keys per tile
constexpr int kLd = kD + 4;   // row pitch of V (and of the bf16 tiles) in floats: 16-byte aligned, conflict free
constexpr int kTileFloats = kTile * kLd;

struct Strides {
  long long b, h, n;
};

// ---------------------------------------------------------------- f32: 3xTF32

constexpr int kF32Threads = 128;  // 4 warps x 16 Q rows
constexpr int kLdK = kD + 16;     // row pitch of K: conflict-free 16-byte fragment reads
constexpr int kF32SmemBytes = 2 * kTile * (kLdK + kLd) * sizeof(float);  // K and V, two buffers each

// A operand: hi rounded to the nearest TF32, lo the rest.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a · b for one m16n8k8 tile (fragments as in the note above).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[j] += a · b[j] for the eight n8 tiles of a 16×64 product, as three TF32
// passes; within a pass the eight products are independent and issue back
// to back.
__device__ __forceinline__ void mma3_row(float (&d)[8][4], const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                         const uint32_t (&b_hi)[8][2], const uint32_t (&b_lo)[8][2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) mma_tf32(d[j], a_lo, b_hi[j]);
#pragma unroll
  for (int j = 0; j < 8; ++j) mma_tf32(d[j], a_hi, b_lo[j]);
#pragma unroll
  for (int j = 0; j < 8; ++j) mma_tf32(d[j], a_hi, b_hi[j]);
}

// B operand: hi is x, which the mma truncates; lo the rest after truncation.
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Keys [row0, row0 + kTile) of one (batch, head) slice into a padded tile,
// 16 bytes a copy; rows at or beyond n read nothing and become zeros.
__device__ __forceinline__ void stage_tile(float* dst, int ld, const float* src, long long sn, int row0, int n) {
#pragma unroll
  for (int i = 0; i < kTile * kD / 4 / kF32Threads; ++i) {
    const int idx = threadIdx.x + i * kF32Threads;
    const int r = idx / (kD / 4), c = idx % (kD / 4) * 4;
    const int row = row0 + r;
    const bool live = row < n;
    cp_async16(dst + r * ld + c, src + (live ? row * sn + c : 0), live ? 16 : 0);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__global__ void __launch_bounds__(kF32Threads, 2)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, int heads, int n, Strides qs, Strides ks, Strides vs, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // K buffers 0, 1, then V buffers 0, 1

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kTile + 16 * (threadIdx.x / 32);  // this warp's first Q row
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const int tiles = (n + kTile - 1) / kTile;
  const float scale_log2 = scale * 1.4426950408889634f;  // the softmax runs in base 2, on exp2f

  stage_tile(smem, kLdK, kb, ks.n, 0, n);
  stage_tile(smem + 2 * kTile * kLdK, kLd, vb, vs.n, 0, n);
  cp_async_commit();

  // Q fragments of this warp's 16 rows, all 8 k-chunks of D (d permuted as in the note), as hi/lo pairs
  uint32_t q_hi[8][4], q_lo[8][4];
  {
    const float* qb = q + b * qs.b + h * qs.h;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        const float4 x = row < n ? *reinterpret_cast<const float4*>(qb + row * qs.n + 16 * c + 4 * t)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        split(x.x, q_hi[2 * c][r], q_lo[2 * c][r]);
        split(x.y, q_hi[2 * c][2 + r], q_lo[2 * c][2 + r]);
        split(x.z, q_hi[2 * c + 1][r], q_lo[2 * c + 1][r]);
        split(x.w, q_hi[2 * c + 1][2 + r], q_lo[2 * c + 1][2 + r]);
      }
  }

  float acc[8][4];  // O, 16×64 a warp: d-tile dn, C fragment
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g+8
#pragma unroll
  for (int dn = 0; dn < 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * kTile;
    if (tile + 1 < tiles) {  // the buffer it fills was last read in tile - 1, before its closing barrier
      const int nb = (tile + 1) & 1;
      stage_tile(smem + nb * kTile * kLdK, kLdK, kb, ks.n, k0 + kTile, n);
      stage_tile(smem + 2 * kTile * kLdK + nb * kTileFloats, kLd, vb, vs.n, k0 + kTile, n);
    }
    cp_async_commit();  // possibly empty, so that one group is always left pending
    cp_async_wait_1();
    __syncthreads();
    const float* sk = smem + (tile & 1) * kTile * kLdK;
    const float* sv = smem + 2 * kTile * kLdK + (tile & 1) * kTileFloats;

    // S = Q Kᵀ, 16×64 a warp: key tile j (keys 8j .. 8j+7), C fragment
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float4 x[8];
      uint32_t b_hi[8][2], b_lo[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[j] = *reinterpret_cast<const float4*>(sk + (8 * j + g) * kLdK + 16 * c + 4 * t);
        split_trunc(x[j].x, b_hi[j][0], b_lo[j][0]);
        split_trunc(x[j].y, b_hi[j][1], b_lo[j][1]);
      }
      mma3_row(s, q_hi[2 * c], q_lo[2 * c], b_hi, b_lo);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        split_trunc(x[j].z, b_hi[j][0], b_lo[j][0]);
        split_trunc(x[j].w, b_hi[j][1], b_lo[j][1]);
      }
      mma3_row(s, q_hi[2 * c + 1], q_lo[2 * c + 1], b_hi, b_lo);
    }

    // online softmax over the quad that holds each row; every tile holds at
    // least one key < n, so the new max is finite
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (k0 + 8 * j + 2 * t + (e & 1) < n) ? s[j][e] * scale_log2 : -INFINITY;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(tmax[r]));
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        psum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(psum[r]);

    // O = alpha O + P V over the tile's eight 8-key chunks, with the permuted reduction index
    float pv[8][4];
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[dn][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t p_hi[4], p_lo[4];
      split(s[j][0], p_hi[0], p_lo[0]);
      split(s[j][2], p_hi[1], p_lo[1]);
      split(s[j][1], p_hi[2], p_lo[2]);
      split(s[j][3], p_hi[3], p_lo[3]);
      uint32_t b_hi[8][2], b_lo[8][2];
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        split_trunc(sv[(8 * j + 2 * t) * kLd + 8 * dn + g], b_hi[dn][0], b_lo[dn][0]);
        split_trunc(sv[(8 * j + 2 * t + 1) * kLd + 8 * dn + g], b_hi[dn][1], b_lo[dn][1]);
      }
      mma3_row(pv, p_hi, p_lo, b_hi, b_lo);
    }
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] = fmaf(acc[dn][e], alpha[e >> 1], pv[dn][e]);
    __syncthreads();  // all reads of this tile's buffers are done before they are refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row < n) {
      const float inv = 1.f / l[r];
      float* out = o + ((long long)bh * n + row) * kD + 2 * t;
#pragma unroll
      for (int dn = 0; dn < 8; ++dn)
        *reinterpret_cast<float2*>(out + 8 * dn) = make_float2(acc[dn][2 * r] * inv, acc[dn][2 * r + 1] * inv);
    }
  }
}

// --------------------------------------------------------------- bf16: FMA

constexpr int kBf16Threads = 256;                              // 16 x 16 threads, 4 x 4 outputs each
constexpr int kBf16SmemBytes = 4 * kTileFloats * sizeof(float);  // Q, K, V, P

// Rows [row0, row0 + kTile) of one (batch, head) slice into shared memory as
// f32; rows at or beyond n become zeros.
__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* src, Strides s, int b, int h,
                                          int row0, int n) {
  const __nv_bfloat16* base = src + b * s.b + h * s.h;
  for (int idx = threadIdx.x; idx < kTile * kD; idx += kBf16Threads) {
    const int r = idx / kD, d = idx % kD;
    const int row = row0 + r;
    dst[r * kLd + d] = row < n ? __bfloat162float(base[row * s.n + d]) : 0.f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Reduction over the 16 lanes that share a row group (lanes differ in bits 0-3).
__device__ __forceinline__ float row_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kBf16Threads)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int heads, int n,
                      Strides qs, Strides ks, Strides vs, float scale) {
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + kTileFloats;
  float* sv = sk + kTileFloats;
  float* sp = sv + kTileFloats;

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;  // S columns tx + 16 j; O columns 4 tx + j
  const int ty = threadIdx.x / 16;  // rows 4 ty + i

  load_tile(sq, q, qs, b, h, q0, n);

  float acc[4][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // the previous tile's readers of sk/sv/sp are done
    load_tile(sk, k, ks, b, h, k0, n);
    load_tile(sv, v, vs, b, h, k0, n);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(sq + (4 * ty + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = *reinterpret_cast<const float4*>(sk + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], c[j], s[i][j]);
    }

    // online softmax: every tile holds at least one key < n, so m_new is finite
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx + 16 * j < n) ? s[i][j] * scale : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(tmax));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        psum += s[i][j];
        sp[(4 * ty + i) * kLd + tx + 16 * j] = s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // O += P V
#pragma unroll 2
    for (int kk = 0; kk < kTile; kk += 4) {
      float4 vr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) vr[r] = *reinterpret_cast<const float4*>(sv + (kk + r) * kLd + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(sp + (4 * ty + i) * kLd + kk);
        acc[i][0] = dot4(p, make_float4(vr[0].x, vr[1].x, vr[2].x, vr[3].x), acc[i][0]);
        acc[i][1] = dot4(p, make_float4(vr[0].y, vr[1].y, vr[2].y, vr[3].y), acc[i][1]);
        acc[i][2] = dot4(p, make_float4(vr[0].z, vr[1].z, vr[2].z, vr[3].z), acc[i][2]);
        acc[i][3] = dot4(p, make_float4(vr[0].w, vr[1].w, vr[2].w, vr[3].w), acc[i][3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row < n) {
      const float inv = 1.f / l[i];
      __nv_bfloat16* out = o + ((long long)bh * n + row) * kD + 4 * tx;
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j] = __float2bfloat16(acc[i][j] * inv);
    }
  }
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, T*, int, int, Strides, Strides, Strides, float);

template <typename T>
cudaError_t launch(Kernel<T> kernel, int threads, int smem_bytes, const void* q, const void* k, const void* v,
                   void* o, int batch, int heads, int n, Strides qs, Strides ks, Strides vs, float scale,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, batch * heads);
  kernel<<<grid, threads, smem_bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                static_cast<const T*>(v), static_cast<T*>(o), heads, n, qs, ks,
                                                vs, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, H, N, 64) with unit stride on the last axis and the given
// element strides on the others (for float32: 16-byte aligned pointers and
// strides that are multiples of 4); o: contiguous (B, H, N, 64) of the same
// type. dtype 0 = float32 (3xTF32 tensor cores), 1 = bfloat16 (FMA units).
// Returns cudaGetLastError() after the launch (no synchronisation).
extern "C" int attention_forward(const void* q, const void* k, const void* v, void* o, int batch,
                                 int heads, int n, int head_dim, long long q_sb, long long q_sh,
                                 long long q_sn, long long k_sb, long long k_sh, long long k_sn,
                                 long long v_sb, long long v_sh, long long v_sn, float scale,
                                 int dtype, void* stream) {
  if (head_dim != kD || n < 1 || batch < 1 || heads < 1) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_sn}, ks{k_sb, k_sh, k_sn}, vs{v_sb, v_sh, v_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(attention_f32_kernel, kF32Threads, kF32SmemBytes, q, k, v, o, batch, heads, n, qs, ks,
                         vs, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(attention_bf16_kernel, kBf16Threads, kBf16SmemBytes, q, k, v, o, batch, heads,
                                 n, qs, ks, vs, scale, s);
  return cudaErrorInvalidValue;
}
