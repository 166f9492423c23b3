// K1: softmax(Q Kᵀ / sqrt(D)) V with Q (B, H, Nq, D), K and V (B, H, Nk, D), D = 64.
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
// >= Nk are zero-filled by the copy (0 source bytes) and masked to -inf
// before the row max; Q rows >= Nq are loaded as zeros and never stored.
//
// bf16: tensor cores, mma.sync.m16n8k16 .bf16 with f32 accumulation
// (attention_bf16_kernel), bound by 2.42 GFLOP at the 989 TFLOP/s bf16 rate.
//   Grid: one block of 4 warps per (batch·head, 128-row Q tile); each warp
// owns two 16-row tiles (kMt), so every K and V fragment read from shared
// memory feeds two mma. At (1, 16, 769, 64) that is 112 blocks, one an SM.
// Q's A fragments are read once from device memory: 4 k16 steps of 64 d a
// row tile. K/V stream through shared memory in 32-key tiles as bf16, rows
// padded to 72 elements (144 bytes), so each 8-row phase of an ldmatrix hits
// eight distinct 16-byte bank groups; two buffers each of K and V, 18 KB.
// K runs one tile ahead of V: S of tile i+1 is computed while tile i's
// softmax and P·V run, from one unrolled block with no branch (bf16_tile),
// so that the scheduler can interleave the next S's mma with this tile's
// exponentials. The cp.async copies of K of tile i+2 and V of tile i+1 are
// issued after the barrier that opens tile i.
//   Fragments (g = lane >> 2, t = lane & 3; pairs are packed in one 32-bit
// register, the lower index in the lower half):
//     A (16×16, row × k): a0a1 (g, 2t..)  a2a3 (g+8, 2t..)  a4a5 (g, 2t+8..)  a6a7 (g+8, 2t+8..)
//     B (16×8,  k × col): b0b1 (2t.., g)  b2b3 (2t+8.., g)
//     C (16×8,  f32):     c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)
//   S = Q·Kᵀ: B is Kᵀ, so b0b1 = K[key g][d 2t..] and b2b3 = K[key g][d 2t+8..]:
// row g of the 8×8 blocks (keys 8j.., d 16c..) and (keys 8j.., d 16c+8..) of
// K as stored, which is what ldmatrix gives without .trans. One ldmatrix.x4
// reads the B fragments of two key tiles at one k step.
//   O += P·V with P kept in registers: the C fragments of key tiles 2kk and
// 2kk+1, each pair packed to bf16x2 (cvt.rn.bf16x2.f32), are the A fragment
// of k step kk as they stand: (c0c1, c2c3) of tile 2kk are a0a1 and a2a3,
// those of tile 2kk+1 are a4a5 and a6a7. V's B fragment, b0b1 = V[key 2t..][d
// g], is the transpose of V's 8×8 blocks as stored: ldmatrix.x4.trans reads
// two d tiles at one k step. O accumulates in the mma's f32 registers,
// rescaled by alpha each tile: at bf16's tolerance the tensor cores'
// truncating accumulation is far below the rounding of P and of the output
// (the card holds the plain version within one bf16 ulp at DPT_Large's
// shapes), so the f32 route's fresh sum per tile is not needed here.
//   Numerics: f32 logits, the online softmax in base 2 as in the f32 route,
// the unnormalised exp(s - m) rounded to bf16 for the product (where the
// JAX reference rounds the normalised probabilities), the running sum l
// from the unrounded values, a divide by l at the end and bf16 rows out.
// cp.async and ldmatrix need 16-byte aligned addresses: the wrapper requires
// 16-byte aligned q, k, v and (batch, head, row) strides that are multiples
// of 8 elements, and raises otherwise.
//
// Both read q, k and v through their (batch, head, row) strides, so the
// ViT's fused qkv projection is consumed without a copy.
//
// Key length. The query length Nq sets the grid; the key walk and its mask
// run to the key length Nk, which may differ (the sequence-parallel ViT's
// local queries against the gathered keys, parallel/ops.py), as the TPU
// kernel's kv_len mask does over its whole key block. Every key tile starts
// below Nk (tiles = ceil(Nk / tile)), so every tile holds at least one live
// key for every row: the running max stays finite and the sum positive. The
// last tile's rows at or past Nk are zero-filled by the copies and masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;
constexpr int kTile = 64;       // Q rows and K/V keys per tile of the f32 route
constexpr int kThreads = 128;   // 4 warps x 16 Q rows, f32 route

struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_0() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Keys [row0, row0 + kRows) of one (batch, head) slice into a padded tile,
// 16 bytes a copy; rows at or beyond n read nothing and become zeros.
template <typename T, int kBlockThreads = kThreads, int kRows = kTile>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* src, long long sn, int row0, int n) {
  constexpr int kVec = 16 / sizeof(T);  // elements a copy
  constexpr int kCopies = kD / kVec;    // copies a row
#pragma unroll
  for (int i = 0; i < kRows * kCopies / kBlockThreads; ++i) {
    const int idx = threadIdx.x + i * kBlockThreads;
    const int r = idx / kCopies, c = idx % kCopies * kVec;
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

// ---------------------------------------------------------------- f32: 3xTF32

constexpr int kLd = kD + 4;       // row pitch of V in floats: 16-byte aligned, conflict free
constexpr int kTileFloats = kTile * kLd;
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

__global__ void __launch_bounds__(kThreads, 2)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, int heads, int nq, int nk, Strides qs, Strides ks, Strides vs,
                     float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // K buffers 0, 1, then V buffers 0, 1

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kTile + 16 * (threadIdx.x / 32);  // this warp's first Q row
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const int tiles = (nk + kTile - 1) / kTile;
  const float scale_log2 = scale * 1.4426950408889634f;  // the softmax runs in base 2, on exp2f

  stage_tile(smem, kLdK, kb, ks.n, 0, nk);
  stage_tile(smem + 2 * kTile * kLdK, kLd, vb, vs.n, 0, nk);
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
        const float4 x = row < nq ? *reinterpret_cast<const float4*>(qb + row * qs.n + 16 * c + 4 * t)
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
      stage_tile(smem + nb * kTile * kLdK, kLdK, kb, ks.n, k0 + kTile, nk);
      stage_tile(smem + 2 * kTile * kLdK + nb * kTileFloats, kLd, vb, vs.n, k0 + kTile, nk);
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
    // least one key < nk, so the new max is finite
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (k0 + 8 * j + 2 * t + (e & 1) < nk) ? s[j][e] * scale_log2 : -INFINITY;
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
    if (row < nq) {
      const float inv = 1.f / l[r];
      float* out = o + ((long long)bh * nq + row) * kD + 2 * t;
#pragma unroll
      for (int dn = 0; dn < 8; ++dn)
        *reinterpret_cast<float2*>(out + 8 * dn) = make_float2(acc[dn][2 * r] * inv, acc[dn][2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------- bf16: mma.sync m16n8k16

constexpr int kLdH = kD + 8;  // row pitch of the bf16 K/V tiles in elements (144 bytes): ldmatrix conflict free
constexpr int kMt = 2;                            // 16-row tiles a warp: each K and V fragment feeds kMt mma
constexpr int kBf16Threads = 128;                 // 4 warps
constexpr int kBf16Rows = 16 * kMt * kBf16Threads / 32;  // Q rows a block
constexpr int kKeys = 32;                         // keys a K/V tile
constexpr int kJ = kKeys / 8;                     // n8 key tiles of S a K/V tile
constexpr int kTileHalves = kKeys * kLdH;
constexpr int kBf16SmemBytes = 4 * kTileHalves * sizeof(__nv_bfloat16);  // K and V, two buffers each

// d += a · b for one m16n8k16 tile (fragments as in the note above).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8×8 blocks of 16-bit values; lanes 8i .. 8i+7 give the row addresses of block i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 2^x on the MUFU alone: subnormal results flush to zero (probabilities
// under 2^-126, nothing at bf16's resolution), which spares exp2f's range
// fix-up of a compare and two multiplies.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// lo in the lower half, hi in the upper, each rounded to the nearest bf16.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// s[mt][2kk], s[mt][2kk+1] = Q · Kᵀ for key tiles 2kk and 2kk+1, all four k steps (d 16c ..), each K fragment
// serving every row tile mt; sk is this lane's ldmatrix address.
__device__ __forceinline__ void qk_pair(float (&s)[kMt][kJ][4], const uint32_t (&qa)[kMt][4][4],
                                        const __nv_bfloat16* sk, int kk) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t kf[4];
    ldmatrix_x4(kf, sk + 16 * kk * kLdH + 16 * c);
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
      mma_bf16(s[mt][2 * kk], qa[mt][c], kf[0], kf[1]);
      mma_bf16(s[mt][2 * kk + 1], qa[mt][c], kf[2], kf[3]);
    }
  }
}

// One K/V tile for one warp's Q rows: the online softmax of s (S of this
// tile), O = alpha·O + P·V, and, unless kLast, S of the next tile from
// sk_next into s. The three are written as one unrolled block with no branch,
// so that the next tile's mma and this tile's exponentials interleave: key
// tiles 2kk and 2kk+1 of the next S, exponentials of the same key tiles of
// this one (P's k step kk) and P·V's k step kk. valid is the number of keys
// of this tile below Nk; only the last tile may hold fewer than kKeys.
template <bool kLast>
__device__ __forceinline__ void bf16_tile(float (&s)[kMt][kJ][4], float (&acc)[kMt][8][4], float (&m)[kMt][2],
                                          float (&l)[kMt][2], const uint32_t (&qa)[kMt][4][4],
                                          const __nv_bfloat16* sk_next, const __nv_bfloat16* sv, int valid,
                                          float scale_log2, int t) {
  float alpha[kMt][2];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
    if (kLast) {
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t + (e & 1) >= valid) s[mt][j][e] = -INFINITY;
    }
    // each row's max over the lane's 2 kJ values, as a tree, then over the quad that holds the row; every
    // tile holds at least one key < Nk, so the new max is finite
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) x[j] = fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]);
#pragma unroll
      for (int w = kJ / 2; w > 0; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) x[j] = fmaxf(x[j], x[j + w]);
      const float m_new = fmaxf(m[mt][r], quad_max(x[0]) * scale_log2);  // scale > 0 commutes with the max
      alpha[mt][r] = exp2_ftz(m[mt][r] - m_new);
      m[mt][r] = m_new;
    }
#pragma unroll
    for (int dn = 0; dn < 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dn][e] *= alpha[mt][e >> 1];
  }

  float sn[kMt][kJ][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sn[mt][j][e] = 0.f;
  float psum[kMt][2] = {};
#pragma unroll
  for (int kk = 0; kk < kJ / 2; ++kk) {
    if (!kLast) qk_pair(sn, qa, sk_next, kk);
    uint32_t pa[kMt][4];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
      for (int j = 2 * kk; j < 2 * kk + 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][j][e] = exp2_ftz(fmaf(s[mt][j][e], scale_log2, -m[mt][e >> 1]));
          psum[mt][e >> 1] += s[mt][j][e];
        }
      // key tiles 2kk and 2kk+1 of P, packed to bf16, are the A fragment of P·V's k step kk
      pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
      pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
      pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
      pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, sv + 16 * kk * kLdH + 16 * p);
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        mma_bf16(acc[mt][2 * p], pa[mt], vf[0], vf[1]);
        mma_bf16(acc[mt][2 * p + 1], pa[mt], vf[2], vf[3]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) l[mt][r] = l[mt][r] * alpha[mt][r] + quad_sum(psum[mt][r]);
    if (!kLast) {
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = sn[mt][j][e];
    }
  }
}

__global__ void __launch_bounds__(kBf16Threads)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int heads, int nq,
                      int nk, Strides qs, Strides ks, Strides vs, float scale) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem4);  // K buffers 0, 1, then V buffers 0, 1
  const auto k_buf = [smem](int i) { return smem + (i & 1) * kTileHalves; };
  const auto v_buf = [smem](int i) { return smem + (2 + (i & 1)) * kTileHalves; };

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kBf16Rows + 16 * kMt * (threadIdx.x / 32);  // this warp's first Q row
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const int tiles = (nk + kKeys - 1) / kKeys;
  const float scale_log2 = scale * 1.4426950408889634f;  // the softmax runs in base 2, on ex2.approx

  // K of tile i+1 and V of tile i travel together, one tile ahead of K and V of tile i
  stage_tile<__nv_bfloat16, kBf16Threads, kKeys>(k_buf(0), kLdH, kb, ks.n, 0, nk);
  cp_async_commit();
  stage_tile<__nv_bfloat16, kBf16Threads, kKeys>(k_buf(1), kLdH, kb, ks.n, kKeys, nk);
  stage_tile<__nv_bfloat16, kBf16Threads, kKeys>(v_buf(0), kLdH, vb, vs.n, 0, nk);
  cp_async_commit();

  // Q's A fragments of this warp's row tiles (rows r0 + 16 mt ..): k step c is d 16c .. 16c+15
  uint32_t qa[kMt][4][4];
  {
    const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 16 * mt + g + 8 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const __nv_bfloat16* p = qb + row * qs.n + 16 * c + 2 * t;
          qa[mt][c][r] = row < nq ? *reinterpret_cast<const uint32_t*>(p) : 0u;
          qa[mt][c][2 + r] = row < nq ? *reinterpret_cast<const uint32_t*>(p + 8) : 0u;
        }
      }
  }

  // each lane's ldmatrix row address within a tile. K, no .trans: blocks (keys +0, d +0), (+0, +8), (+8, +0),
  // (+8, +8), so r0 r1 are key tile 2kk's b0b1 b2b3 and r2 r3 key tile 2kk+1's. V, .trans: blocks (keys +0,
  // d +0), (+8, +0), (+0, +8), (+8, +8), so r0 r1 are d tile 2p's b0b1 b2b3 and r2 r3 d tile 2p+1's.
  const int k_lane = ((lane & 7) + (lane >> 4) * 8) * kLdH + ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * kLdH + (lane >> 4) * 8;

  float s[kMt][kJ][4], acc[kMt][8][4];  // S of the current tile (key tile j) and O (d tile dn), C fragments
  float m[kMt][2], l[kMt][2];  // rows g and g+8 of each row tile; m in base-2 logit units
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) s[mt][j][e] = 0.f;
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) acc[mt][dn][e] = 0.f;
    }
  }

  cp_async_wait_1();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < kJ / 2; ++kk) qk_pair(s, qa, k_buf(0) + k_lane, kk);

  for (int tile = 0; tile + 1 < tiles; ++tile) {
    cp_async_wait_0();
    __syncthreads();  // K of tile+1 and V of tile have landed; every warp is done with tile-1's buffers
    if (tile + 2 < tiles)
      stage_tile<__nv_bfloat16, kBf16Threads, kKeys>(k_buf(tile), kLdH, kb, ks.n, (tile + 2) * kKeys, nk);
    stage_tile<__nv_bfloat16, kBf16Threads, kKeys>(v_buf(tile + 1), kLdH, vb, vs.n, (tile + 1) * kKeys, nk);
    cp_async_commit();
    bf16_tile<false>(s, acc, m, l, qa, k_buf(tile + 1) + k_lane, v_buf(tile) + v_lane, kKeys, scale_log2, t);
  }
  cp_async_wait_0();
  __syncthreads();
  bf16_tile<true>(s, acc, m, l, qa, nullptr, v_buf(tiles - 1) + v_lane, nk - (tiles - 1) * kKeys, scale_log2, t);

#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 16 * mt + g + 8 * r;
      if (row < nq) {
        const float inv = 1.f / l[mt][r];
        __nv_bfloat16* out = o + ((long long)bh * nq + row) * kD + 2 * t;
#pragma unroll
        for (int dn = 0; dn < 8; ++dn)
          *reinterpret_cast<uint32_t*>(out + 8 * dn) =
              pack_bf16(acc[mt][dn][2 * r] * inv, acc[mt][dn][2 * r + 1] * inv);
      }
    }
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, T*, int, int, int, Strides, Strides, Strides, float);

template <typename T>
cudaError_t launch(Kernel<T> kernel, int threads, int rows, int smem_bytes, const void* q, const void* k,
                   const void* v, void* o, int batch, int heads, int nq, int nk, Strides qs, Strides ks,
                   Strides vs, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + rows - 1) / rows, batch * heads);  // blocks over the queries; each walks all nk keys
  kernel<<<grid, threads, smem_bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                static_cast<const T*>(v), static_cast<T*>(o), heads, nq, nk, qs,
                                                ks, vs, scale);
  return cudaGetLastError();
}

}  // namespace

// q: (B, H, nq, 64), k and v: (B, H, nk, 64), each with unit stride on the
// last axis, a 16-byte aligned pointer and (batch, head, row) element strides
// that are multiples of 16 bytes' worth (4 floats, 8 bfloat16s); o:
// contiguous (B, H, nq, 64) of the same type. dtype 0 = float32 (3xTF32 mma.sync), 1 = bfloat16 (bf16
// mma.sync), both on the tensor cores with f32 accumulation.
// Returns cudaGetLastError() after the launch (no synchronisation).
extern "C" int attention_forward(const void* q, const void* k, const void* v, void* o, int batch,
                                 int heads, int nq, int nk, int head_dim, long long q_sb, long long q_sh,
                                 long long q_sn, long long k_sb, long long k_sh, long long k_sn,
                                 long long v_sb, long long v_sh, long long v_sn, float scale,
                                 int dtype, void* stream) {
  if (head_dim != kD || nq < 1 || nk < 1 || batch < 1 || heads < 1) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_sn}, ks{k_sb, k_sh, k_sn}, vs{v_sb, v_sh, v_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(attention_f32_kernel, kThreads, kTile, kF32SmemBytes, q, k, v, o, batch, heads, nq, nk,
                         qs, ks, vs, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(attention_bf16_kernel, kBf16Threads, kBf16Rows, kBf16SmemBytes, q, k, v, o,
                                 batch, heads, nq, nk, qs, ks, vs, scale, s);
  return cudaErrorInvalidValue;
}
