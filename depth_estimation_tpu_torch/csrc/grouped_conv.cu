// K4: grouped 3×3 convolution, stride 1, zero padding 1, NCHW, f32 or bf16
// in and out, f32 accumulation.
//
// Replaces depth_estimation_tpu/ops/pallas/grouped_conv.py::_kernel (the
// Pallas shifted-matmul kernel behind grouped_conv3x3_pallas): the stride-1
// conv2 of every ResNeXt-101 32x8d bottleneck of MiDaS v2.1, 30 launches a
// frame. The TPU kernel padded the input in HBM, computed two wrap-around
// columns per row and built 128-lane block-diagonal weight tiles for the
// MXU; neither route here needs any of that: both stage each group's input
// planes with a one-pixel halo in shared memory, zeros outside the image.
// Two routes, chosen by the input type alone.
//
// f32: tensor cores, 3xTF32 implicit GEMM (grouped_conv3x3_tf32_kernel).
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
//   Where the time goes (tools/k4_breakdown.py times builds of this kernel
// with the staging, the mma or both taken out, by the macros K4_NO_STAGE and
// K4_NO_MMA, or with every block ending at once, K4_LAUNCH_ONLY; the
// library is built with none of them; PERF.md): a launch is a fixed
// part (launch, offsets, stores) plus the staging plus the mma, which add up
// with little overlap, because layers 1 and 3 stage one chunk a block and
// all blocks of the single wave start at once.
//   The tensor cores' f32 accumulation truncates (csrc/attention.cu), and K
// reaches 576 at layer 4, so each chunk's 27 mma an accumulator are summed
// in fresh registers and added to the running sums with an ordinary add.
// Pixels past the tile or the image and channels past the group are
// computed on zeros and not stored.
//
// bf16: the FMA units (grouped_conv3x3_kernel<__nv_bfloat16>, the only
// instance of that template: T is bf16 alone). 113 MFLOP
// at 67 TFLOP/s f32 FMA is 1.7 µs, so layers 2–4 are bound by operations
// there. One block owns one image, one group, a tile of
// that group's output channels (a multiple of 4) and a tile of output rows
// and columns. It loops over the group's input channels in chunks that fit
// 48 KB of shared memory: each pass stages the chunk's weights as
// [ci][tap][co] and the chunk's input planes, widened to f32. Each thread
// keeps 4 output channels × 4 neighbouring pixels of a row in registers
// and, per input channel and kernel row, reads 6 input values and 3 float4s
// of weights for 48 FMAs; the output is rounded to bf16 once at the store.
// The host splits the output tile (channels or rows, whichever duplicates
// less staging) until the grid has two blocks per SM, then gives each block
// up to 16 slices of threads over the same outputs, each summing its share
// of the input channels; the slices' sums meet in shared memory, which also
// lays the outputs out so the stores run along rows. Every thread stages 8
// values a round, loads first, so 8 loads are in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMinTileThreads = 8;
constexpr int kMaxSlices = 16;
constexpr int kUnroll = 8;  // staging loads in flight per thread
constexpr int kSmemBytes = 48 * 1024;

struct Tiling {
  int tco;           // output channels per block, a multiple of 4
  int th, tw;        // output rows and columns per block; tw is a multiple of 4
  int tile_threads;  // (tco / 4) · th · (tw / 4): one per 4 channels × 4 pixels
  int slices;        // thread slices over the input channels; blockDim = tile_threads · slices
  int cic;           // input channels staged per pass
  int co_tiles, row_tiles, col_tiles;
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Stage n values into shared memory, kUnroll loads in flight per thread:
// value i comes from load(i) and goes to dst[place(i)].
template <typename Load, typename Place>
__device__ __forceinline__ void stage(float* dst, int n, Load load, Place place) {
  for (int i0 = threadIdx.x; i0 < n; i0 += blockDim.x * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      v[u] = i < n ? load(i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) dst[place(i)] = v[u];
    }
  }
}

// grid: (row_tiles · col_tiles, groups · co_tiles, batch); block: tile_threads · slices.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
grouped_conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                       int channels, int h, int wd, int cg, Tiling t) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [cic][9][tco]
  float* xs = ws + t.cic * 9 * t.tco;           // [cic][th + 2][tw + 2]
  const int pitch = t.tw + 2;
  const int plane = (t.th + 2) * pitch;

  const int r0 = (blockIdx.x / t.col_tiles) * t.th;
  const int c0 = (blockIdx.x % t.col_tiles) * t.tw;
  const int g = blockIdx.y / t.co_tiles;
  const int co0 = (blockIdx.y % t.co_tiles) * t.tco;  // within the group
  const int b = blockIdx.z;

  const int ncq = t.tco / 4;
  const int qpr = t.tw / 4;
  const int npq = t.th * qpr;
  const int tt = threadIdx.x % t.tile_threads;
  const int slice = threadIdx.x / t.tile_threads;
  const int cq = tt % ncq;  // output-channel quad: fastest, so a warp shares input reads
  const int pq = tt / ncq;  // pixel quad
  const int row_l = pq / qpr;
  const int col_l = (pq % qpr) * 4;

  const long long hw = (long long)h * wd;
  const T* xg = x + ((long long)b * channels + (long long)g * cg) * hw;
  const T* wg = w + ((long long)g * cg + co0) * cg * 9;

  float acc[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[k][p] = 0.f;

  for (int ci0 = 0; ci0 < cg; ci0 += t.cic) {
    const int nci = min(t.cic, cg - ci0);
    const int per_co = nci * 9;
    __syncthreads();  // the previous pass has finished reading
    stage(ws, t.tco * per_co,
          [&](int i) {  // (co, ci·9 + tap): contiguous in memory for each co
            const int co = i / per_co;
            return co0 + co < cg ? to_f32(wg[(long long)co * cg * 9 + ci0 * 9 + (i - co * per_co)]) : 0.f;
          },
          [&](int i) {
            const int co = i / per_co;
            return (i - co * per_co) * t.tco + co;
          });
    stage(xs, nci * plane,
          [&](int i) {
            const int ci = i / plane, rem = i - ci * plane;
            const int row = r0 - 1 + rem / pitch, col = c0 - 1 + rem % pitch;
            return row >= 0 && row < h && col >= 0 && col < wd
                       ? to_f32(xg[(ci0 + ci) * hw + (long long)row * wd + col])
                       : 0.f;
          },
          [](int i) { return i; });
    __syncthreads();
    for (int ci = slice; ci < nci; ci += t.slices) {
      const float* xp = xs + ci * plane + row_l * pitch + col_l;
      const float* wp = ws + ci * 9 * t.tco + cq * 4;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xv[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) xv[j] = xp[dy * pitch + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv = *reinterpret_cast<const float4*>(wp + (dy * 3 + dx) * t.tco);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            acc[0][p] = fmaf(wv.x, xv[p + dx], acc[0][p]);
            acc[1][p] = fmaf(wv.y, xv[p + dx], acc[1][p]);
            acc[2][p] = fmaf(wv.z, xv[p + dx], acc[2][p]);
            acc[3][p] = fmaf(wv.w, xv[p + dx], acc[3][p]);
          }
        }
      }
    }
  }

  // The slices' partial sums, laid out per slice in output order
  // o = ((k·ncq + cq)·npq + pq)·4 + p, so that consecutive o run along a row.
  const int n_out = 16 * t.tile_threads;
  float* red = reinterpret_cast<float*>(smem4);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k)
    *reinterpret_cast<float4*>(red + slice * n_out + ((k * ncq + cq) * npq + pq) * 4) =
        make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
  __syncthreads();
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < t.slices; ++s) sum += red[s * n_out + o];
    const int p = o % 4, q = (o / 4) % npq, r = o / (4 * npq);  // r = k·ncq + cq
    const int chan = co0 + (r % ncq) * 4 + r / ncq;
    const int row = r0 + q / qpr, col = c0 + (q % qpr) * 4 + p;
    if (chan < cg && row < h && col < wd)
      store(y + (((long long)b * channels + (long long)g * cg + chan) * h + row) * wd + col, sum);
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The largest row tile of at most `rows` that splits h into equal-ish tiles.
int balanced_rows(int h, int rows) { return ceil_div(h, ceil_div(h, rows > 0 ? rows : 1)); }

Tiling pick_tiling(int batch, int groups, int cg, int h, int wd, int sms) {
  Tiling t;
  t.tw = wd <= 4 ? 4 : wd <= 8 ? 8 : wd <= 16 ? 16 : 32;
  t.tco = ceil_div(cg, 4) * 4 < 32 ? ceil_div(cg, 4) * 4 : 32;
  const int qpr = t.tw / 4;
  t.th = balanced_rows(h, kMaxThreads / (t.tco / 4 * qpr));
  auto threads = [&](int tco, int th) { return tco / 4 * th * qpr; };
  auto blocks = [&](int tco, int th) {
    return (long long)batch * groups * ceil_div(cg, tco) * ceil_div(h, th) * ceil_div(wd, t.tw);
  };
  while (blocks(t.tco, t.th) < 2LL * sms) {
    const int tco2 = t.tco / 2, th2 = balanced_rows(h, ceil_div(t.th, 2));
    const bool co_ok = tco2 % 4 == 0 && tco2 > 0 && threads(tco2, t.th) >= kMinTileThreads;
    const bool rows_ok = th2 < t.th && threads(t.tco, th2) >= kMinTileThreads;
    // Splitting channels stages the input tile again; splitting rows stages the weights again.
    const bool prefer_co = (t.th + 2) * (t.tw + 2) < 9 * t.tco;
    if (co_ok && (prefer_co || !rows_ok)) {
      t.tco = tco2;
    } else if (rows_ok) {
      t.th = th2;
    } else {
      break;
    }
  }
  t.tile_threads = threads(t.tco, t.th);
  t.slices = 1;
  while (t.slices * 2 <= kMaxSlices && t.slices * 2 <= cg && t.tile_threads * t.slices * 2 <= kMaxThreads)
    t.slices *= 2;
  t.co_tiles = ceil_div(cg, t.tco);
  t.row_tiles = ceil_div(h, t.th);
  t.col_tiles = ceil_div(wd, t.tw);
  const int per_ci = (9 * t.tco + (t.th + 2) * (t.tw + 2)) * (int)sizeof(float);
  t.cic = kSmemBytes / per_ci < cg ? kSmemBytes / per_ci : cg;
  return t;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int batch, int channels, int h, int wd,
                   int groups, const Tiling& t, cudaStream_t stream) {
  const dim3 grid(t.row_tiles * t.col_tiles, groups * t.co_tiles, batch);
  const int threads = t.tile_threads * t.slices;
  const size_t staging = (size_t)t.cic * (9 * t.tco + (t.th + 2) * (t.tw + 2));
  const size_t reduction = (size_t)16 * threads;
  const size_t smem = (staging > reduction ? staging : reduction) * sizeof(float);
  grouped_conv3x3_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), channels, h, wd,
      channels / groups, t);
  return cudaGetLastError();
}

// ---------------------------------------------------- f32: 3xTF32 implicit GEMM

constexpr int kWarps = 4;
constexpr int kGemmThreads = 32 * kWarps;
constexpr int kMaxMt = 4;                               // m16 pixel tiles a warp
constexpr int kMaxTilePixels = 16 * kMaxMt * kWarps;   // 256
constexpr int kMaxTileCols = 64;

struct GemmTiling {
  int nco;          // output channels a block: 8, 16 or 32, nco / 8 n8 tiles
  int th, tw;       // output rows and columns a block
  int wk;           // warp slices over the input channels: 1, 2 or 4; kWarps / wk warps over the pixels
  int mt;           // m16 pixel tiles a warp
  int ck;           // input channels a chunk, 8·wk
  int chunks;
  int rw;           // staged input row pitch, tw + 8: the halo at column 3, the row's values from column 4
  int plane;        // staged input plane pitch in words, ≥ (th + 2)·rw, ≡ 8 (mod 16)
  int pco;          // staged weight row pitch (one output channel's ck·9 values) in words, ≡ 4 (mod 8)
  int xv, wv;       // values a staging copy: 4 (16 bytes) where rows are 16-byte aligned, else 1
  int xu, wu;       // copies a staged input row (2 halo + tw / xv) and a weight row (ck·9 / wv)
  int co_tiles, row_tiles, col_tiles;
  int smem_floats;
};

// The least m ≥ n with m ≡ 8 (mod 16): four rows of pitch m start on four distinct bank octets.
int pad_to_octet(int n) { return n + ((8 - n % 16) % 16 + 16) % 16; }

// K4_NO_STAGE (a breakdown build): the copies are not issued, and the k loop
// multiplies whatever shared memory holds.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
#ifndef K4_NO_STAGE
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
#endif
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool live) {
#ifndef K4_NO_STAGE
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(live ? 4 : 0));
#endif
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

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

  // Fragment rows g and g + 8 of each m16 tile: the offset of the pixel's 3×3
  // window in a staged plane (its top-left halo value sits at column pc + 3),
  // and the pixel's index in the output plane (-1: past the tile or the
  // image, computed on and not stored).
  const int np = t.th * t.tw;
  int a_off[MT][2], y_pix[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = (wm * MT + mt) * 16 + g + 8 * hh;
      const int pr = p / t.tw, pc = p - pr * t.tw;
      a_off[mt][hh] = p < np ? pr * t.rw + pc + 3 : 0;
      y_pix[mt][hh] = p < np && r0 + pr < h && c0 + pc < wd ? (r0 + pr) * wd + c0 + pc : -1;
    }

  const long long hw = (long long)h * wd;
  const float* xg = x + ((long long)b * channels + (long long)grp * cg) * hw;
  const float* wg = w + ((long long)grp * cg + co0) * cg * 9;

  // Staging walks the chunk's copies in steps of kGemmThreads: input copies
  // [ci][th + 2][xu] (a halo value, or xv values of the row), then weight
  // copies [co][wu]. Each thread's first copy and the step are split into
  // those radices once, so each next copy follows by adds and carries.
  const int th2 = t.th + 2, n_x = t.ck * th2 * t.xu, n_w = t.nco * t.wu;
  const int x_row = threadIdx.x / t.xu, x_cc = threadIdx.x - x_row * t.xu;
  const int x_ci = x_row / th2, x_rr = x_row - x_ci * th2;
  const int sx_rows = kGemmThreads / t.xu, sx_cc = kGemmThreads - sx_rows * t.xu;
  const int sx_ci = sx_rows / th2, sx_rr = sx_rows - sx_ci * th2;
  const int w_co = threadIdx.x / t.wu, w_j = threadIdx.x - w_co * t.wu;
  const int sw_co = kGemmThreads / t.wu, sw_j = kGemmThreads - sw_co * t.wu;

  const auto stage_chunk = [&](int chunk, float* buf) {
    const int ci0 = chunk * t.ck;
    int ci = x_ci, rr = x_rr, cc = x_cc;
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
      cc += sx_cc;
      rr += sx_rr;
      ci += sx_ci;
      if (cc >= t.xu) { cc -= t.xu; ++rr; }
      if (rr >= th2) { rr -= th2; ++ci; }
    }
    // weights as stored, [co][ci·9 + tap]: the chunk's ck·9 values of each output channel are contiguous
    float* ws = buf + t.ck * t.plane;
    int co = w_co, j = w_j;
    for (int i = threadIdx.x; i < n_w; i += kGemmThreads) {
      const int f0 = ci0 * 9 + t.wv * j;  // the copy's first value in the row of co
      const int valid = co0 + co < cg ? min(max(cg * 9 - f0, 0), t.wv) : 0;  // values below ci = C/G
      const float* src = valid > 0 ? wg + (long long)co * cg * 9 + f0 : w;
      if (t.wv == 4) {
        cp_async16(ws + co * t.pco + 4 * j, src, 4 * valid);
      } else {
        cp_async4(ws + co * t.pco + j, src, valid > 0);
      }
      j += sw_j;
      co += sw_co;
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

  // The k split: slices 1 .. wk-1 leave their sums in shared memory (free
  // after the last barrier), slice 0 adds them in slice order and stores.
  if (t.wk > 1) {
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
    if (ks > 0) return;
    for (int s = 1; s < t.wk; ++s) {
      const float* src = smem + ((s - 1) * wm_count + wm) * kFrag + lane;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += src[((mt * NT + nt) * 4 + e) * 32];
    }
  }

  float* yg = y + ((long long)b * channels + (long long)grp * cg + co0) * hw;
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
          if (co0 + co < cg) yg[co * hw + y_pix[mt][hh]] = acc[mt][nt][2 * hh + e];
        }
    }
}

// x16, w16: whether x and w are 16-byte aligned.
GemmTiling pick_gemm_tiling(int batch, int groups, int cg, int h, int wd, int sms, bool x16, bool w16) {
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
  t.rw = t.tw + 8;
  t.plane = pad_to_octet((t.th + 2) * t.rw);
  t.pco = 9 * t.ck + 4;
  t.xv = x16 && wd % 4 == 0 && t.tw % 4 == 0 ? 4 : 1;
  t.wv = w16 && cg % 4 == 0 ? 4 : 1;
  t.xu = 2 + t.tw / t.xv;
  t.wu = 9 * t.ck / t.wv;
  t.co_tiles = ceil_div(cg, t.nco);
  t.row_tiles = ceil_div(h, t.th);
  t.col_tiles = ceil_div(wd, t.tw);
  const int staging = (t.chunks > 1 ? 2 : 1) * (t.ck * t.plane + t.nco * t.pco);  // one buffer for one chunk
  const int reduction = (t.wk - 1) * (kWarps / t.wk) * t.mt * (t.nco / 8) * 4 * 32;
  t.smem_floats = staging > reduction ? staging : reduction;
  return t;
}

template <int MT, int NT>
cudaError_t launch_tf32(const float* x, const float* w, float* y, int batch, int channels, int h, int wd,
                        int groups, const GemmTiling& t, cudaStream_t stream) {
  const auto kernel = grouped_conv3x3_tf32_kernel<MT, NT>;
  const int smem = t.smem_floats * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(t.row_tiles * t.col_tiles, groups * t.co_tiles, batch);
  kernel<<<grid, kGemmThreads, smem, stream>>>(x, w, y, channels, h, wd, channels / groups, t);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_tf32_nt(const float* x, const float* w, float* y, int batch, int channels, int h, int wd,
                           int groups, const GemmTiling& t, cudaStream_t stream) {
  switch (t.nco) {
    case 8: return launch_tf32<MT, 1>(x, w, y, batch, channels, h, wd, groups, t, stream);
    case 16: return launch_tf32<MT, 2>(x, w, y, batch, channels, h, wd, groups, t, stream);
    case 32: return launch_tf32<MT, 4>(x, w, y, batch, channels, h, wd, groups, t, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_f32(const void* xv, const void* wv, void* yv, int batch, int channels, int h, int wd,
                       int groups, const GemmTiling& t, cudaStream_t stream) {
  const float* x = static_cast<const float*>(xv);
  const float* w = static_cast<const float*>(wv);
  float* y = static_cast<float*>(yv);
  switch (t.mt) {
    case 1: return launch_tf32_nt<1>(x, w, y, batch, channels, h, wd, groups, t, stream);
    case 2: return launch_tf32_nt<2>(x, w, y, batch, channels, h, wd, groups, t, stream);
    case 3: return launch_tf32_nt<3>(x, w, y, batch, channels, h, wd, groups, t, stream);
    case 4: return launch_tf32_nt<4>(x, w, y, batch, channels, h, wd, groups, t, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x: contiguous (batch, channels, h, w); weight: contiguous
// (channels, channels / groups, 3, 3); y: contiguous like x. dtype 0 is
// float32 (3xTF32 on the tensor cores), 1 is bfloat16 (FMA units), all
// three tensors. sms: the card's SM count, for the tiling.
extern "C" int grouped_conv3x3(const void* x, const void* w, void* y, int batch, int channels,
                               int h, int wd, int groups, int dtype, int sms, void* stream) {
  if (batch < 1 || batch > 65535 || channels < 1 || h < 1 || wd < 1 || groups < 1 ||
      channels % groups != 0 || sms < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const GemmTiling t = pick_gemm_tiling(batch, groups, channels / groups, h, wd, sms,
                                          reinterpret_cast<uintptr_t>(x) % 16 == 0,
                                          reinterpret_cast<uintptr_t>(w) % 16 == 0);
    if ((long long)groups * t.co_tiles > 65535) return cudaErrorInvalidValue;
    return launch_f32(x, w, y, batch, channels, h, wd, groups, t, s);
  }
  if (dtype == 1) {
    const Tiling t = pick_tiling(batch, groups, channels / groups, h, wd, sms);
    if ((long long)groups * t.co_tiles > 65535 || t.cic < 1) return cudaErrorInvalidValue;
    return launch<__nv_bfloat16>(x, w, y, batch, channels, h, wd, groups, t, s);
  }
  return cudaErrorInvalidValue;
}

// The f32 route's tiling for these arguments and 16-byte aligned tensors:
// out = {nco, th, tw, wk, mt, plane, pco, smem bytes}.
extern "C" int grouped_conv3x3_f32_tiling(int batch, int channels, int h, int wd, int groups, int sms,
                                          int* out) {
  if (batch < 1 || channels < 1 || h < 1 || wd < 1 || groups < 1 || channels % groups != 0 || sms < 1)
    return cudaErrorInvalidValue;
  const GemmTiling t = pick_gemm_tiling(batch, groups, channels / groups, h, wd, sms, true, true);
  const int fields[] = {t.nco, t.th, t.tw, t.wk, t.mt, t.plane, t.pco, t.smem_floats * (int)sizeof(float)};
  for (int i = 0; i < 8; ++i) out[i] = fields[i];
  return cudaSuccess;
}
