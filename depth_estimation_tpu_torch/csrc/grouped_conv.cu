// K4: grouped 3×3 convolution, stride 1, zero padding 1, NCHW, f32 or bf16
// in and out, f32 accumulation.
//
// Replaces depth_estimation_tpu/ops/pallas/grouped_conv.py::_kernel (the
// Pallas shifted-matmul kernel behind grouped_conv3x3_pallas): the stride-1
// conv2 of every ResNeXt-101 32x8d bottleneck of MiDaS v2.1, 30 launches a
// frame. The TPU kernel padded the input in HBM, computed two wrap-around
// columns per row and built 128-lane block-diagonal weight tiles for the
// MXU; none of that is needed here: each block stages its group's input
// planes with a one-pixel halo in shared memory, zeros outside the image.
// Two routes, chosen by the input type alone, both an implicit GEMM on the
// tensor cores with the same tiling, staging walk and k split.
//
// f32: 3xTF32 (grouped_conv3x3_tf32_kernel).
//   Every layer does 2·H·W·C·(C/G)·9 = 113 MFLOP at a 192×256 network
// input; as three TF32 products at 495 TFLOP/s that is 0.69 µs, under the
// time its 2.7–6.4 MB of input, output and weights take at 3.35 TB/s
// (0.8–1.9 µs), so every MiDaS shape is bound by bytes. The TPU kernel's f32
// is precision="highest"; one TF32 pass misses the 1e-4 tolerance
// (tests/test_torch_kernels.py), so every product is a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi, with A split by rounding and B by truncation as K1's f32 route
// does (csrc/attention.cu).
//   The GEMM, for each image and group: D[p, co] = Σ_k A[p, k]·B[k, co], p
// the output pixels, co the group's output channels, k = tap·(C/G) + ci
// tap-major, so one k8 step is one tap and 8 input channels: A[p, k] =
// x[ci][row(p) + dy − 1][col(p) + dx − 1], B[k, co] = w[co][ci][dy][dx].
//   mma.sync.m16n8k8 .tf32 fragments (g = lane >> 2, t = lane & 3):
//     A (16×8, pixel × k):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//     B (8×8,  k × co):     b0 (t, g)  b1 (t+4, g)
//     C (16×8, f32):        c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)
//   Blocks: 4 warps own one (image, group, tile of nco = 8, 16 or 32 output
// channels, tile of th × tw output pixels). The host starts from the whole
// group's channels (up to 32) and up to 256 pixels, and halves the channel
// tile where the weights are the larger share of a block's staged bytes
// (layers 3–4) and the rows otherwise (layers 1–2), until the grid has a
// block for every SM at the given batch. The warps then split as wm warps
// over the tile's m16 pixel tiles (mt of them a warp) × wk slices over the
// input channels, whichever of wk = 1, 2, 4 gives a warp the least work: at
// layers 3–4 a tile holds 3 m16 tiles, and 4 slices of one warp each share
// them evenly; the slices' sums meet once in shared memory at the end.
//   Staging: input channels come in chunks of 8·wk (each slice takes 8 of
// them), into two buffers of input planes [ci][th + 2][tw + 8] and weights
// as stored, [co][ci·9 + tap] (one output channel's chunk is contiguous in
// memory): the cp.async copies of chunk j+1 are in flight while chunk j is
// multiplied. A staged row holds the tile's columns from column 4 and the
// halo at columns 3 and tw + 4, so where W and the tile width are multiples
// of 4 and the tensors 16-byte aligned (every MiDaS shape) the rows and the
// weights move in 16-byte copies and only the two halo values of a row in
// 4-byte ones; otherwise every value moves alone. Each thread walks its
// copies with adds and carries, no division. Halo, out-of-image, ci ≥ C/G
// and co ≥ C/G values are zero-filled by copies of fewer (or 0) source
// bytes, so k and n are zero-padded to multiples of 8.
//   The k loop does no division: each lane works out once, before it, the
// shared-memory offsets of its fragment rows g and g + 8 of each m16 tile
// (pixel row·(tw + 8) + column + 3), and a tap is the constant offset
// dy·(tw + 8) + dx. The plane pitch is ≡ 8 (mod 16) words, so the four t
// values of an A read fall on four distinct bank octets and the g values
// (neighbouring pixels) on consecutive banks; the weight row pitch, ck·9 + 4,
// is ≡ 4 (mod 8), so the eight g values (output channels) of a B read fall
// on the eight multiples of 4 and the four t values (input channels, 9
// words apart) on the four residues mod 4: both conflict-free (pinned on the
// CPU by tests/test_torch_kernels.py).
//   Where the time goes (tools/k4_breakdown.py times builds of either
// route's kernel with the staging, the mma or both taken out, by the macros
// K4_NO_STAGE and K4_NO_MMA, or with every block ending at once,
// K4_LAUNCH_ONLY; the library is built with none of them; PERF.md): a
// launch is a fixed part (launch, offsets, stores) plus the staging plus the
// mma, which add up with little overlap, because layers 1 and 3 stage one
// chunk a block and all blocks of the single wave start at once.
//   The tensor cores' f32 accumulation truncates (csrc/attention.cu), and K
// reaches 576 at layer 4, so each chunk's 27 mma an accumulator are summed
// in fresh registers and added to the running sums with an ordinary add.
// Pixels past the tile or the image and channels past the group are
// computed on zeros and not stored.
//
// bf16: mma.sync.m16n8k16 .bf16 with f32 accumulation
// (grouped_conv3x3_bf16_kernel): the f32 route's GEMM, tiling, staging walk
// and k split with bf16 operands and no split. 113 MFLOP at 989 TFLOP/s is
// 0.11 µs, so every MiDaS shape is bound by its 1.4–3.2 MB of bytes (0.4–
// 0.95 µs). bf16 products are exact in f32, and the 1e-2 tolerance is far
// above what truncated f32 sums lose over 576 terms, so the sums stay in the
// accumulators across chunks and are rounded to bf16 once, at the store, as
// the Pallas kernel and the plain version round.
//   One k16 step is two taps × the slice's 8 input channels: k 0–7 are tap
// 2s's channels, k 8–15 tap 2s + 1's, so the nine taps take five steps, and
// the tenth tap's fragments are zero registers, set at compile time (no
// shared read, so no stale value can put a NaN into the sums). At C/G = 8
// that wastes a tenth of the mma; one tap × 16 channels would waste half.
// Fragments (each 32-bit register two bf16, the lower k in the low half):
//     A (16×16): a0a1 (g, 2t..) a2a3 (g+8, 2t..) a4a5 (g, 2t+8..) a6a7 (g+8, 2t+8..)
//     B (16×8):  b0b1 (2t.., g)  b2b3 (2t+8.., g)
// so a register of A holds channels 2t and 2t + 1 of one pixel at one tap,
// which lie in two staged planes, and one of B those two channels' weights
// of output channel g, 9 values apart in a weight row: each is two 16-bit
// shared loads and a byte permute. ldmatrix does not fit: it reads 16-byte
// aligned rows, and a tap shifts a pixel row by 2 bytes.
//   Staging keeps the f32 layout in bf16 values: planes [ci][th + 2][rw],
// weights [co][ci·9 + tap]. cp.async moves 4, 8 or 16 bytes, never one
// bf16, so a staged row holds the tile's columns from element 8 (16 bytes
// in): where W and the tile width are multiples of 8 and the tensors 16-byte
// aligned (every MiDaS shape), the row moves in 16-byte copies of 8 values
// and each halo as a 4-byte pair, columns c0 − 2, c0 − 1 into elements 6, 7
// and c0 + tw, c0 + tw + 1 into tw + 8, tw + 9 (W and c0 are even, so a pair
// lies wholly inside or outside the image); the weights move in 16-byte
// copies where C/G is a multiple of 8. Otherwise every value is an ordinary
// load and store, zero outside the image. rw is a multiple of 8 (16 bytes).
//   Banks: the plane pitch is ≡ 8 (mod 32) elements, so the planes of
// channels 2t (or 2t + 1) start 8 words apart (mod 32) for t = 0..3 and the
// at most 5 words of eight neighbouring pixels fit between them; the weight
// row pitch, the least ≥ ck·9 that is ≡ 8 (mod 16) elements, puts the
// output channels g on the eight multiples of 4 words and t (a channel pair,
// 18 elements = 9 words on) on the four residues mod 4. Lanes that read the
// two halves of one word share it, so every 16-bit fragment read is
// conflict-free (tests/test_torch_kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kGemmThreads = 32 * kWarps;
constexpr int kMaxMt = 4;                               // m16 pixel tiles a warp
constexpr int kMaxTilePixels = 16 * kMaxMt * kWarps;   // 256
constexpr int kMaxTileCols = 64;

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The largest row tile of at most `rows` that splits h into equal-ish tiles.
int balanced_rows(int h, int rows) { return ceil_div(h, ceil_div(h, rows > 0 ? rows : 1)); }

// The least m ≥ n with m ≡ r (mod q).
int pad_to(int n, int r, int q) { return n + ((r - n % q) % q + q) % q; }

struct GemmTiling {
  int nco;          // output channels a block: 8, 16 or 32, nco / 8 n8 tiles
  int th, tw;       // output rows and columns a block
  int wk;           // warp slices over the input channels: 1, 2 or 4; kWarps / wk warps over the pixels
  int mt;           // m16 pixel tiles a warp
  int ck;           // input channels a chunk, 8·wk
  int chunks;
  // Pitches in values of the route's type. f32: rw = tw + 8 (the halo at
  // column 3, the row from 4), plane ≡ 8 (mod 16), pco = ck·9 + 4 ≡ 4 (mod 8).
  // bf16: rw the multiple of 8 ≥ tw + 10 (halo pairs at 6 and tw + 8, the row
  // from 8), plane ≡ 8 (mod 32), pco the least ≥ ck·9 that is ≡ 8 (mod 16).
  int rw;           // staged input row pitch
  int plane;        // staged input plane pitch
  int pco;          // staged weight row pitch (one output channel's ck·9 values)
  int xv, wv;       // values a staging copy: 16 bytes where rows are 16-byte aligned, else 1
  int xu, wu;       // copies a staged input row (2 halo + tw / xv) and a weight row (ck·9 / wv)
  int co_tiles, row_tiles, col_tiles;
  int smem_bytes;
};

// K4_NO_STAGE (a breakdown build): the copies are not issued, and the k loop
// multiplies whatever shared memory holds.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
#ifndef K4_NO_STAGE
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
#endif
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
#ifndef K4_NO_STAGE
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(live ? 4 : 0));
#endif
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// One bf16 value by an ordinary load and store, 0 where it is not live.
__device__ __forceinline__ void copy16(uint16_t* dst, const uint16_t* src, bool live) {
#ifndef K4_NO_STAGE
  *dst = live ? *src : uint16_t(0);
#endif
}

// K4_NO_MMA (a breakdown build): the k loop has no taps; the chunks are staged and zeros stored.
#ifdef K4_NO_MMA
constexpr int kTaps = 0;
#else
constexpr int kTaps = 9;
#endif

// A operand: hi rounded to the nearest TF32, lo the rest (which the mma truncates).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// B operand: hi is x, which the mma truncates; lo the rest after truncation.
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// d += a · b for one m16n8k8 tile (fragments as in the note above).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a · b for one m16n8k16 bf16 tile (fragments as in the note above).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 values from shared memory as one fragment register: p[lo] in the low half.
__device__ __forceinline__ uint32_t pair(const uint16_t* p, int lo, int hi) {
  return __byte_perm(p[lo], p[hi], 0x5410);
}

// Fragment rows g and g + 8 of each m16 tile of warp wm: the offset of the
// pixel's 3×3 window in a staged plane (its top-left halo value sits at
// column pc + col0 of the pixel's row) ...
template <int MT>
__device__ __forceinline__ void fragment_offsets(const GemmTiling& t, int wm, int g, int col0, int (&a_off)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = (wm * MT + mt) * 16 + g + 8 * hh;
      const int pr = p / t.tw, pc = p - pr * t.tw;
      a_off[mt][hh] = p < t.th * t.tw ? pr * t.rw + pc + col0 : 0;
    }
}

// ... and the pixel's index in the output plane (-1: past the tile or the
// image, computed on and not stored).
template <int MT>
__device__ __forceinline__ void output_pixels(const GemmTiling& t, int wm, int g, int r0, int c0, int h, int wd,
                                              int (&y_pix)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = (wm * MT + mt) * 16 + g + 8 * hh;
      const int pr = p / t.tw, pc = p - pr * t.tw;
      y_pix[mt][hh] = p < t.th * t.tw && r0 + pr < h && c0 + pc < wd ? (r0 + pr) * wd + c0 + pc : -1;
    }
}

// Staging walks a chunk's copies in steps of kGemmThreads: input copies
// [ci][th + 2][xu] (a halo, or xv values of a row), then weight copies
// [co][wu]. Each thread's first copy and the step are split into those
// radices once, so each next copy follows by adds and carries.
struct Walk {
  int ci, rr, cc, s_ci, s_rr, s_cc;  // input copies: this thread's first, and the step
  int co, j, s_co, s_j;              // weight copies
  __device__ __forceinline__ explicit Walk(const GemmTiling& t) {
    const int th2 = t.th + 2;
    const int x_row = threadIdx.x / t.xu;
    cc = threadIdx.x - x_row * t.xu;
    ci = x_row / th2;
    rr = x_row - ci * th2;
    const int sx_rows = kGemmThreads / t.xu;
    s_cc = kGemmThreads - sx_rows * t.xu;
    s_ci = sx_rows / th2;
    s_rr = sx_rows - s_ci * th2;
    co = threadIdx.x / t.wu;
    j = threadIdx.x - co * t.wu;
    s_co = kGemmThreads / t.wu;
    s_j = kGemmThreads - s_co * t.wu;
  }
};

// The k split: slices 1 .. wk-1 leave their sums in shared memory (free
// after the last barrier), slice 0 adds them in slice order. Returns whether
// this warp stores.
template <int MT, int NT>
__device__ __forceinline__ bool merge_slices(float (&acc)[MT][NT][4], float* smem, int wk, int ks, int wm,
                                             int wm_count, int lane) {
  if (wk == 1) return true;
  constexpr int kFrag = MT * NT * 4 * 32;  // one warp's sums
  if (ks > 0) {
    float* red = smem + ((ks - 1) * wm_count + wm) * kFrag + lane;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[((mt * NT + nt) * 4 + e) * 32] = acc[mt][nt][e];
  }
  __syncthreads();
  if (ks > 0) return false;
  for (int s = 1; s < wk; ++s) {
    const float* src = smem + ((s - 1) * wm_count + wm) * kFrag + lane;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += src[((mt * NT + nt) * 4 + e) * 32];
  }
  return true;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(uint16_t* p, float v) { *p = __bfloat16_as_ushort(__float2bfloat16_rn(v)); }

// The C fragments to the output planes of the block's channels: yg is channel co0's plane of this image.
template <int MT, int NT, typename T>
__device__ __forceinline__ void store_tile(T* yg, long long hw, int cg, int co0, int tq,
                                           const float (&acc)[MT][NT][4], const int (&y_pix)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (y_pix[mt][hh] < 0) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = 8 * nt + 2 * tq + e;
          if (co0 + co < cg) put(yg + co * hw + y_pix[mt][hh], acc[mt][nt][2 * hh + e]);
        }
    }
}

// ---------------------------------------------------- f32: 3xTF32 implicit GEMM

// grid: (row_tiles · col_tiles, groups · co_tiles, batch); block: kGemmThreads.
// MT = t.mt m16 pixel tiles a warp, NT = t.nco / 8 n8 channel tiles.
// Instances with at most 4 accumulator tiles (layers 1, 2, 4) ask for 3
// blocks an SM, so at most 170 registers, in which ptxas fits them without
// spilling; the others may take 255. With no minimum, ptxas kept layer 4's
// instance at 128 registers and spilled; with a minimum of 1, layer 1's grew
// to 188 and fit only 2 blocks an SM, a second wave at batch 1.
template <int MT, int NT>
__global__ void __launch_bounds__(kGemmThreads, MT * NT <= 4 ? 3 : 1)
grouped_conv3x3_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
                            int channels, int h, int wd, int cg, GemmTiling t) {
#ifdef K4_LAUNCH_ONLY  // a breakdown build: every block ends at once
  if (h > 0) return;
#endif
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // two buffers, each input planes then weights
  const int buf_floats = t.ck * t.plane + t.nco * t.pco;

  const int r0 = (blockIdx.x / t.col_tiles) * t.th;
  const int c0 = (blockIdx.x % t.col_tiles) * t.tw;
  const int grp = blockIdx.y / t.co_tiles;
  const int co0 = (blockIdx.y % t.co_tiles) * t.nco;  // within the group
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm_count = kWarps / t.wk;
  const int wm = warp % wm_count;  // this warp's share of the pixel tiles
  const int ks = warp / wm_count;  // and of each chunk's input channels: 8·ks .. 8·ks + 7

  int a_off[MT][2], y_pix[MT][2];
  fragment_offsets<MT>(t, wm, g, 3, a_off);
  output_pixels<MT>(t, wm, g, r0, c0, h, wd, y_pix);

  const long long hw = (long long)h * wd;
  const float* xg = x + ((long long)b * channels + (long long)grp * cg) * hw;
  const float* wg = w + ((long long)grp * cg + co0) * cg * 9;

  const int th2 = t.th + 2, n_x = t.ck * th2 * t.xu, n_w = t.nco * t.wu;
  const Walk walk(t);
  const auto stage_chunk = [&](int chunk, float* buf) {
    const int ci0 = chunk * t.ck;
    int ci = walk.ci, rr = walk.rr, cc = walk.cc;
    for (int i = threadIdx.x; i < n_x; i += kGemmThreads) {
      const int c = ci0 + ci, row = r0 - 1 + rr;
      const bool row_live = c < cg && row >= 0 && row < h;
      float* dst = buf + ci * t.plane + rr * t.rw + 4;  // column 0 of the tile
      if (t.xv == 4 && cc >= 2) {  // 4 values of the row, 16-byte aligned
        const int col = 4 * (cc - 2);
        const bool live = row_live && c0 + col < wd;
        cp_async16(dst + col, live ? xg + c * hw + (long long)row * wd + c0 + col : x, live ? 16 : 0);
      } else {  // one value: a halo, or any value of a row that is not 16-byte aligned
        const int col = t.xv == 4 ? (cc == 0 ? -1 : t.tw) : cc - 1;
        const bool live = row_live && c0 + col >= 0 && c0 + col < wd;
        cp_async4(dst + col, live ? xg + c * hw + (long long)row * wd + c0 + col : x, live);
      }
      cc += walk.s_cc;
      rr += walk.s_rr;
      ci += walk.s_ci;
      if (cc >= t.xu) { cc -= t.xu; ++rr; }
      if (rr >= th2) { rr -= th2; ++ci; }
    }
    // weights as stored, [co][ci·9 + tap]: the chunk's ck·9 values of each output channel are contiguous
    float* ws = buf + t.ck * t.plane;
    int co = walk.co, j = walk.j;
    for (int i = threadIdx.x; i < n_w; i += kGemmThreads) {
      const int f0 = ci0 * 9 + t.wv * j;  // the copy's first value in the row of co
      const int valid = co0 + co < cg ? min(max(cg * 9 - f0, 0), t.wv) : 0;  // values below ci = C/G
      const float* src = valid > 0 ? wg + (long long)co * cg * 9 + f0 : w;
      if (t.wv == 4) {
        cp_async16(ws + co * t.pco + 4 * j, src, 4 * valid);
      } else {
        cp_async4(ws + co * t.pco + j, src, valid > 0);
      }
      j += walk.s_j;
      co += walk.s_co;
      if (j >= t.wu) { j -= t.wu; ++co; }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int plane4 = 4 * t.plane, pco8 = 8 * t.pco;
  stage_chunk(0, smem);
  cp_async_commit();
  for (int chunk = 0; chunk < t.chunks; ++chunk) {
    if (chunk + 1 < t.chunks)  // the buffer it fills was last read in chunk - 1, before its closing barrier
      stage_chunk(chunk + 1, smem + ((chunk + 1) & 1) * buf_floats);
    cp_async_commit();  // possibly empty, so that one group is always left pending
    cp_async_wait_1();
    __syncthreads();
    const float* xs = smem + (chunk & 1) * buf_floats + (8 * ks + tq) * t.plane;          // channel t of the slice
    const float* ws = smem + (chunk & 1) * buf_floats + t.ck * t.plane + g * t.pco + (8 * ks + tq) * 9;

    float part[MT][NT][4];  // this chunk's sums, fresh: the mma's accumulation truncates
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int toff = (tap / 3) * t.rw + tap % 3;
      uint32_t a_hi[MT][4], a_lo[MT][4], b_hi[NT][2], b_lo[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split(xs[a_off[mt][0] + toff], a_hi[mt][0], a_lo[mt][0]);
        split(xs[a_off[mt][1] + toff], a_hi[mt][1], a_lo[mt][1]);
        split(xs[plane4 + a_off[mt][0] + toff], a_hi[mt][2], a_lo[mt][2]);
        split(xs[plane4 + a_off[mt][1] + toff], a_hi[mt][3], a_lo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        split_trunc(ws[nt * pco8 + tap], b_hi[nt][0], b_lo[nt][0]);       // (ci t, co g)
        split_trunc(ws[nt * pco8 + 36 + tap], b_hi[nt][1], b_lo[nt][1]);  // (ci t + 4, co g)
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(part[mt][nt], a_lo[mt], b_hi[nt]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(part[mt][nt], a_hi[mt], b_lo[nt]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(part[mt][nt], a_hi[mt], b_hi[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
    __syncthreads();  // all reads of this chunk's buffer are done before it is refilled
  }

  if (!merge_slices<MT, NT>(acc, smem, t.wk, ks, wm, wm_count, lane)) return;
  store_tile<MT, NT>(y + ((long long)b * channels + (long long)grp * cg + co0) * hw, hw, cg, co0, tq, acc, y_pix);
}

// ---------------------------------------------------- bf16: mma.sync.m16n8k16 implicit GEMM

// As the f32 kernel, on bf16 bits (x, w, y) and the bf16 pitches; the same launch bounds.
template <int MT, int NT>
__global__ void __launch_bounds__(kGemmThreads, MT * NT <= 4 ? 3 : 1)
grouped_conv3x3_bf16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                            uint16_t* __restrict__ y, int channels, int h, int wd, int cg, GemmTiling t) {
#ifdef K4_LAUNCH_ONLY  // a breakdown build: every block ends at once
  if (h > 0) return;
#endif
  extern __shared__ float4 smem4[];
  uint16_t* smem = reinterpret_cast<uint16_t*>(smem4);  // two buffers, each input planes then weights
  const int buf_elems = t.ck * t.plane + t.nco * t.pco;

  const int r0 = (blockIdx.x / t.col_tiles) * t.th;
  const int c0 = (blockIdx.x % t.col_tiles) * t.tw;
  const int grp = blockIdx.y / t.co_tiles;
  const int co0 = (blockIdx.y % t.co_tiles) * t.nco;  // within the group
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm_count = kWarps / t.wk;
  const int wm = warp % wm_count;
  const int ks = warp / wm_count;

  int a_off[MT][2];
  fragment_offsets<MT>(t, wm, g, 7, a_off);

  const long long hw = (long long)h * wd;
  const uint16_t* xg = x + ((long long)b * channels + (long long)grp * cg) * hw;
  const uint16_t* wg = w + ((long long)grp * cg + co0) * cg * 9;

  const int th2 = t.th + 2, n_x = t.ck * th2 * t.xu, n_w = t.nco * t.wu;
  const Walk walk(t);
  const auto stage_chunk = [&](int chunk, uint16_t* buf) {
    const int ci0 = chunk * t.ck;
    int ci = walk.ci, rr = walk.rr, cc = walk.cc;
    for (int i = threadIdx.x; i < n_x; i += kGemmThreads) {
      const int c = ci0 + ci, row = r0 - 1 + rr;
      const bool row_live = c < cg && row >= 0 && row < h;
      uint16_t* dst = buf + ci * t.plane + rr * t.rw + 8;  // column 0 of the tile
      const uint16_t* src = xg + c * hw + (long long)row * wd + c0;
      if (t.xv == 8) {
        if (cc >= 2) {  // 8 values of the row, 16-byte aligned
          const int col = 8 * (cc - 2);
          const bool live = row_live && c0 + col < wd;
          cp_async16(dst + col, live ? src + col : x, live ? 16 : 0);
        } else {  // a halo pair: columns -2, -1 or tw, tw + 1, both in the image or both out
          const int col = cc == 0 ? -2 : t.tw;
          const bool live = row_live && c0 + col >= 0 && c0 + col < wd;
          cp_async4(dst + col, live ? src + col : x, live);
        }
      } else {  // one value of a row that is not 16-byte aligned: columns -1 .. tw
        const int col = cc - 1;
        copy16(dst + col, src + col, row_live && c0 + col >= 0 && c0 + col < wd);
      }
      cc += walk.s_cc;
      rr += walk.s_rr;
      ci += walk.s_ci;
      if (cc >= t.xu) { cc -= t.xu; ++rr; }
      if (rr >= th2) { rr -= th2; ++ci; }
    }
    uint16_t* ws = buf + t.ck * t.plane;
    int co = walk.co, j = walk.j;
    for (int i = threadIdx.x; i < n_w; i += kGemmThreads) {
      const int f0 = ci0 * 9 + t.wv * j;
      const int valid = co0 + co < cg ? min(max(cg * 9 - f0, 0), t.wv) : 0;
      const uint16_t* src = valid > 0 ? wg + (long long)co * cg * 9 + f0 : w;
      if (t.wv == 8) {
        cp_async16(ws + co * t.pco + 8 * j, src, 2 * valid);
      } else {
        copy16(ws + co * t.pco + j, src, valid > 0);
      }
      j += walk.s_j;
      co += walk.s_co;
      if (j >= t.wu) { j -= t.wu; ++co; }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int pco8 = 8 * t.pco;
  stage_chunk(0, smem);
  cp_async_commit();
  for (int chunk = 0; chunk < t.chunks; ++chunk) {
    if (chunk + 1 < t.chunks)
      stage_chunk(chunk + 1, smem + ((chunk + 1) & 1) * buf_elems);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const uint16_t* xs = smem + (chunk & 1) * buf_elems + (8 * ks + 2 * tq) * t.plane;  // channel 2t of the slice
    const uint16_t* ws = smem + (chunk & 1) * buf_elems + t.ck * t.plane + g * t.pco + (8 * ks + 2 * tq) * 9;
#pragma unroll
    for (int step = 0; step < (kTaps + 1) / 2; ++step) {
      const int tap0 = 2 * step, tap1 = 2 * step + 1;  // tap1 = 9: the zero tap
      const int off0 = (tap0 / 3) * t.rw + tap0 % 3, off1 = (tap1 / 3) * t.rw + tap1 % 3;
      uint32_t a[MT][4], bw[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pair(xs, a_off[mt][0] + off0, t.plane + a_off[mt][0] + off0);  // (g, 2t..)
        a[mt][1] = pair(xs, a_off[mt][1] + off0, t.plane + a_off[mt][1] + off0);  // (g+8, 2t..)
        a[mt][2] = tap1 < 9 ? pair(xs, a_off[mt][0] + off1, t.plane + a_off[mt][0] + off1) : 0u;
        a[mt][3] = tap1 < 9 ? pair(xs, a_off[mt][1] + off1, t.plane + a_off[mt][1] + off1) : 0u;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        bw[nt][0] = pair(ws, nt * pco8 + tap0, nt * pco8 + 9 + tap0);  // (ci 2t.., co g) at tap0
        bw[nt][1] = tap1 < 9 ? pair(ws, nt * pco8 + tap1, nt * pco8 + 9 + tap1) : 0u;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], bw[nt]);
    }
    __syncthreads();
  }

  if (!merge_slices<MT, NT>(acc, reinterpret_cast<float*>(smem4), t.wk, ks, wm, wm_count, lane)) return;
  int y_pix[MT][2];  // worked out here, not held through the k loop: at MT = 4 those 8 registers made ptxas spill
  output_pixels<MT>(t, wm, g, r0, c0, h, wd, y_pix);
  store_tile<MT, NT>(y + ((long long)b * channels + (long long)grp * cg + co0) * hw, hw, cg, co0, tq, acc, y_pix);
}

// x16, w16: whether x and w are 16-byte aligned.
GemmTiling pick_gemm_tiling(int batch, int groups, int cg, int h, int wd, int sms, bool bf16, bool x16, bool w16) {
  GemmTiling t;
  t.nco = cg <= 8 ? 8 : cg <= 16 ? 16 : 32;
  t.tw = wd <= kMaxTileCols ? wd : ceil_div(wd, ceil_div(wd, kMaxTileCols));
  if (wd > kMaxTileCols && wd % 4 == 0) t.tw = ceil_div(t.tw, 4) * 4;  // keep tile rows 16-byte aligned
  t.th = balanced_rows(h, kMaxTilePixels / t.tw);
  auto blocks = [&] {
    return (long long)batch * groups * ceil_div(cg, t.nco) * ceil_div(h, t.th) * ceil_div(wd, t.tw);
  };
  while (blocks() < sms) {
    const bool co_ok = t.nco > 8, rows_ok = t.th > 1;
    // Splitting channels stages the input tile again; splitting rows stages the weights again.
    const bool prefer_co = 9 * t.nco > (t.th + 2) * (t.tw + 2);
    if (co_ok && (prefer_co || !rows_ok)) {
      t.nco /= 2;
    } else if (rows_ok) {
      t.th = balanced_rows(h, ceil_div(t.th, 2));
    } else {
      break;
    }
  }
  // Warps over pixel tiles × slices over the input channels: the least m16 tiles × k8 groups a warp.
  const int mtiles = ceil_div(t.th * t.tw, 16), ci8 = ceil_div(cg, 8);
  int best = 0;
  for (int wk = 1; wk <= kWarps && (wk == 1 || wk <= ci8); wk *= 2) {
    const int mt = ceil_div(mtiles, kWarps / wk);
    const int work = mt * ceil_div(ci8, wk);
    if (mt <= kMaxMt && (best == 0 || work < best)) {
      best = work;
      t.wk = wk;
      t.mt = mt;
    }
  }
  t.ck = 8 * t.wk;
  t.chunks = ceil_div(cg, t.ck);
  const int vec = bf16 ? 8 : 4;  // values in 16 bytes
  t.rw = bf16 ? ceil_div(t.tw + 10, 8) * 8 : t.tw + 8;
  t.plane = bf16 ? pad_to((t.th + 2) * t.rw, 8, 32) : pad_to((t.th + 2) * t.rw, 8, 16);
  t.pco = bf16 ? pad_to(9 * t.ck, 8, 16) : pad_to(9 * t.ck, 4, 8);
  t.xv = x16 && wd % vec == 0 && t.tw % vec == 0 ? vec : 1;
  t.wv = w16 && cg % vec == 0 ? vec : 1;
  t.xu = 2 + t.tw / t.xv;
  t.wu = 9 * t.ck / t.wv;
  t.co_tiles = ceil_div(cg, t.nco);
  t.row_tiles = ceil_div(h, t.th);
  t.col_tiles = ceil_div(wd, t.tw);
  const int staging = (t.chunks > 1 ? 2 : 1) * (t.ck * t.plane + t.nco * t.pco) * (bf16 ? 2 : 4);
  const int reduction = (t.wk - 1) * (kWarps / t.wk) * t.mt * (t.nco / 8) * 4 * 32 * 4;  // f32 sums
  t.smem_bytes = staging > reduction ? staging : reduction;
  return t;
}

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, const void* x, const void* w, void* y, int batch, int channels, int h, int wd,
                   int groups, const GemmTiling& t, cudaStream_t stream) {
  if (t.smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, t.smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(t.row_tiles * t.col_tiles, groups * t.co_tiles, batch);
  kernel<<<grid, kGemmThreads, t.smem_bytes, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                                       static_cast<T*>(y), channels, h, wd, channels / groups, t);
  return cudaGetLastError();
}

template <int MT, int NT>
cudaError_t launch_route(bool bf16, const void* x, const void* w, void* y, int batch, int channels, int h, int wd,
                         int groups, const GemmTiling& t, cudaStream_t stream) {
  if (bf16)
    return launch<uint16_t>(grouped_conv3x3_bf16_kernel<MT, NT>, x, w, y, batch, channels, h, wd, groups, t, stream);
  return launch<float>(grouped_conv3x3_tf32_kernel<MT, NT>, x, w, y, batch, channels, h, wd, groups, t, stream);
}

template <int MT>
cudaError_t launch_nt(bool bf16, const void* x, const void* w, void* y, int batch, int channels, int h, int wd,
                      int groups, const GemmTiling& t, cudaStream_t stream) {
  switch (t.nco) {
    case 8: return launch_route<MT, 1>(bf16, x, w, y, batch, channels, h, wd, groups, t, stream);
    case 16: return launch_route<MT, 2>(bf16, x, w, y, batch, channels, h, wd, groups, t, stream);
    case 32: return launch_route<MT, 4>(bf16, x, w, y, batch, channels, h, wd, groups, t, stream);
  }
  return cudaErrorInvalidValue;
}

bool valid_shape(int batch, int channels, int h, int wd, int groups, int sms) {
  return batch >= 1 && batch <= 65535 && channels >= 1 && h >= 1 && wd >= 1 && groups >= 1 &&
         channels % groups == 0 && sms >= 1;
}

}  // namespace

// x: contiguous (batch, channels, h, w); weight: contiguous
// (channels, channels / groups, 3, 3); y: contiguous like x. dtype 0 is
// float32 (3xTF32), 1 is bfloat16, all three tensors. sms: the card's SM
// count, for the tiling.
extern "C" int grouped_conv3x3(const void* x, const void* w, void* y, int batch, int channels,
                               int h, int wd, int groups, int dtype, int sms, void* stream) {
  if (!valid_shape(batch, channels, h, wd, groups, sms) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
  const GemmTiling t = pick_gemm_tiling(batch, groups, channels / groups, h, wd, sms, bf16,
                                        reinterpret_cast<uintptr_t>(x) % 16 == 0,
                                        reinterpret_cast<uintptr_t>(w) % 16 == 0);
  if ((long long)groups * t.co_tiles > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (t.mt) {
    case 1: return launch_nt<1>(bf16, x, w, y, batch, channels, h, wd, groups, t, s);
    case 2: return launch_nt<2>(bf16, x, w, y, batch, channels, h, wd, groups, t, s);
    case 3: return launch_nt<3>(bf16, x, w, y, batch, channels, h, wd, groups, t, s);
    case 4: return launch_nt<4>(bf16, x, w, y, batch, channels, h, wd, groups, t, s);
  }
  return cudaErrorInvalidValue;
}

// The tiling of route dtype (0 f32, 1 bf16) for these arguments and 16-byte
// aligned tensors: out = {nco, th, tw, wk, mt, rw, plane, pco, smem bytes},
// pitches in values of the route's type.
extern "C" int grouped_conv3x3_tiling(int batch, int channels, int h, int wd, int groups, int dtype, int sms,
                                      int* out) {
  if (!valid_shape(batch, channels, h, wd, groups, sms) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const GemmTiling t = pick_gemm_tiling(batch, groups, channels / groups, h, wd, sms, dtype == 1, true, true);
  const int fields[] = {t.nco, t.th, t.tw, t.wk, t.mt, t.rw, t.plane, t.pco, t.smem_bytes};
  for (int i = 0; i < 9; ++i) out[i] = fields[i];
  return cudaSuccess;
}
