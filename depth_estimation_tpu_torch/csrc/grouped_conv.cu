// K4: grouped 3×3 convolution, stride 1, zero padding 1, NCHW, f32 or bf16
// in and out, f32 accumulation.
//
// Replaces depth_estimation_tpu/ops/pallas/grouped_conv.py::_kernel (the
// Pallas shifted-matmul kernel behind grouped_conv3x3_pallas): the stride-1
// conv2 of every ResNeXt-101 32x8d bottleneck of MiDaS v2.1, 30 launches a
// frame.
//
// Bound on the H100: every layer does 2·H·W·C·(C/G)·9 = 113 MFLOP at a
// 192×256 network input, over 2.7–6.4 MB of input, output and weights, so
// layer 1 (48×64, C/G = 8) is bound by bytes and layers 2–4 by operations,
// about 1.7–1.9 µs each at 3.35 TB/s and 67 TFLOP/s f32.
//
// Design: the TPU kernel padded the input in HBM, computed two wrap-around
// columns per row and built 128-lane block-diagonal weight tiles for the MXU.
// None of that is needed here. One block owns one image, one group, a tile
// of that group's output channels (a multiple of 4) and a tile of output
// rows and columns. It loops over the group's input channels in chunks that
// fit 48 KB of shared memory: each pass stages the chunk's weights as
// [ci][tap][co] and the chunk's input planes for the tile plus a one-pixel
// halo, writing zeros outside the image, so nothing is padded in device
// memory. Each thread keeps 4 output channels × 4 neighbouring pixels of a
// row in registers and, per input channel and kernel row, reads 6 input
// values and 3 float4s of weights for 48 FMAs. bf16 is widened to f32 as it
// is staged and rounded once at the store.
//
// The small maps of layers 3–4 (12×16 and 6×8) hold few outputs per group,
// so a block whose threads each own 16 outputs would be one warp or less,
// and its staging loads would run one after another. So the host first
// splits the output tile (channels or rows, whichever duplicates less
// staging) until the grid has two blocks per SM, and then gives each block
// up to 16 slices of threads over the same outputs, each slice summing its
// own share of the input channels (a split of the reduction, K); the slices'
// sums meet in shared memory, which also lays the outputs out so the stores
// run along rows. Every thread stages 8 values per round, loads first, so 8
// loads are in flight. The FMA units do the work; mma/wgmma and TMA are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
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

}  // namespace

// x: contiguous (batch, channels, h, w); weight: contiguous
// (channels, channels / groups, 3, 3); y: contiguous like x. dtype 0 is
// float32, 1 is bfloat16 (all three tensors). sms: the card's SM count, for
// the tiling.
extern "C" int grouped_conv3x3(const void* x, const void* w, void* y, int batch, int channels,
                               int h, int wd, int groups, int dtype, int sms, void* stream) {
  if (batch < 1 || batch > 65535 || channels < 1 || h < 1 || wd < 1 || groups < 1 ||
      channels % groups != 0 || sms < 1)
    return cudaErrorInvalidValue;
  const Tiling t = pick_tiling(batch, groups, channels / groups, h, wd, sms);
  if ((long long)groups * t.co_tiles > 65535 || t.cic < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, y, batch, channels, h, wd, groups, t, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, y, batch, channels, h, wd, groups, t, s);
  return cudaErrorInvalidValue;
}
