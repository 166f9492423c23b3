// K2 (fused preprocess) and K3 (plane resize): entry points over one tiled,
// two-pass separable-resize kernel template staged in shared memory.
//
// Replaces depth_estimation_tpu/ops/pallas/resize.py::_preprocess_kernel
// (u8 BGR frame → RGB, /255, cubic Wh·X·Wwᵀ, per-channel normalize) and
// ::_resize_kernel (Wh·D·Wwᵀ on f32 planes: the bicubic upsample of the depth
// map back to the source size). K3's u8 route also does the stream's
// wrap-around cast (ops/postprocess.py::wraparound_u8, six elementwise
// kernels when it ran on its own), as the JAX frame program's one XLA program
// does.
//
// Bound on the H100: bytes. At the main paths' shapes K2 reads 0.9 MB of u8
// and writes 2.4 MB (DPT_Large, 3×384×512) or 0.6 MB (MiDaS, 3×192×256) of
// f32; K3 reads 0.8 or 0.2 MB of f32 and writes 1.2 MB of f32 (or 0.3 MB of
// u8) at 480×640. Against 16 multiply-adds an output value that is a few FLOP
// a byte. At about 1 µs of bytes, the launch (about 2 µs) and the latency of
// a block's dependent steps are most of a launch.
//
// Design. The TPU kernels ran both resizes as dense matmuls on the MXU; here
// the band of those matrices is used, as tables of 4 (source index, weight)
// taps an output row or column (ops/kernels/resize.py::band_taps: indices
// non-decreasing, pads at the last nonzero column). A block owns th output
// rows × tw output columns of one image, every channel
// (ops/kernels/resize.py::tiling picks them: at batch 1 one wave of one to
// two blocks an SM, which timed best on the H100). In four steps, with a
// barrier after each of the first three:
// 1. Taps. Each thread loads the taps of its 4 output columns (tw/4 apart)
//    into registers; warp 0 puts the tile's row taps in shared memory and finds,
//    by warp min/max, the tile's input window: the rows and columns its taps
//    read.
// 2. Staging. The window goes to shared memory by 16-byte cp.async copies,
//    neighbouring threads on neighbouring addresses, each row from the
//    16-byte boundary at or below its first byte; where a row or the data
//    pointer is not 16-byte aligned, by ordinary loads. A frame byte is
//    loaded once for all three channels.
// 3. Vertical pass. For each tile row and window column, every channel's
//    4-tap sum, into an f32 intermediate in shared memory.
// 4. Horizontal pass and epilogue. Each thread makes 4 outputs of a row from
//    4 intermediate taps each, for every (channel, row) pair it owns, with
//    the column taps held in registers. Its outputs are tw/4 columns apart,
//    so a warp's lanes make neighbouring outputs: their reads of the
//    intermediate fall on neighbouring words (at K3's 0.8 ratio four
//    consecutive outputs a thread put four lanes on one bank, and timed
//    slower at every main-path shape), and each store instruction writes 32
//    neighbouring values, 128 bytes of f32 or 32 of u8. K2's BGR→RGB flip is
//    the choice of output plane; its /255 and normalization are one
//    multiply-add, acc·(1/(255·std_c)) + (−mean_c/std_c), with the constants
//    worked out on the host. The u8 route stores (int)trunc(v) & 255.
// Against what held the kernel it replaces back: no division (that kernel
// made 17 correctly rounded divisions an output value); the 16 taps of an
// output come from shared memory, not from 16 single-byte gathers; the frame
// is read once, not once a channel; tap indices are read once a block, so no
// pixel load waits on an index load in the passes; 32-bit offsets inside an
// image, 64-bit only for its base; a warp's stores are 32 neighbouring values.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;  // at most 64 registers: four blocks an SM
constexpr int kMaxTileH = 32;  // warp 0 loads the tile's row taps, one a lane

enum Epilogue { kNormalize, kStoreF32, kStoreU8 };

struct Params {
  const unsigned char* x;  // (images, h_in, w_in, C) values of In, contiguous
  void* out;               // K2: (images, 3, h_out, w_out) f32; K3: (images, h_out, w_out) f32 or u8
  const int4* h_idx;       // (h_out) 4 source rows each
  const float4* h_w;       // (h_out) their weights
  const int4* w_idx;       // (w_out) 4 source columns each
  const float4* w_w;       // (w_out) their weights
  int h_in, w_in, h_out, w_out;
  int th, tw;              // the output tile: tw is 32, 64 or 128
  int rows;                // staged rows a block has room for
  int in_pitch;            // bytes a staged row, a multiple of 16
  int mid_pitch;           // floats a row of the intermediate
  int aligned;             // rows and pointer 16-byte aligned: stage by 16-byte copies
  int flip;                // K2: output channel c from input channel 2 - c
  float scale[3], bias[3];  // K2: output channel c is acc * scale[c] + bias[c]
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ float pick(const float (&a)[3], int c) { return c == 0 ? a[0] : c == 1 ? a[1] : a[2]; }

template <typename In, int C, int kEpi>
__global__ void __launch_bounds__(kThreads, kMinBlocks) separable_resize_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int window[4];  // first and last staged row, first and last staged column
  int4* s_hidx = reinterpret_cast<int4*>(smem);
  float4* s_hw = reinterpret_cast<float4*>(smem + 16 * p.th);
  unsigned char* s_in = smem + 32 * p.th;
  float* s_mid = reinterpret_cast<float*>(s_in + p.rows * p.in_pitch);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * p.th, c0 = blockIdx.x * p.tw;
  const int th = min(p.th, p.h_out - r0), tw = min(p.tw, p.w_out - c0);
  const int gshift = __ffs(p.tw) - 3;  // log2(tw / 4)
  const int cs = 1 << gshift;            // a thread's 4 outputs are tw/4 columns apart,
  const int cb = tid & (cs - 1);         // from tile column cb
  const bool live = cb < tw;

  // 1. taps
  int4 ci[4];
  float4 cw[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (cb + k * cs < tw) {
      ci[k] = __ldg(p.w_idx + c0 + cb + k * cs);
      cw[k] = __ldg(p.w_w + c0 + cb + k * cs);
    } else {  // past the image: a copy of a column inside it, weight 0
      ci[k] = k ? ci[k - 1] : make_int4(0, 0, 0, 0);
      cw[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (warp == 0) {  // lanes 0 .. tw/4 - 1 hold every column of the tile
    int rlo = INT_MAX, rhi = INT_MIN, clo = INT_MAX, chi = INT_MIN;
    if (lane < th) {
      const int4 i = __ldg(p.h_idx + r0 + lane);
      s_hidx[lane] = i;
      s_hw[lane] = __ldg(p.h_w + r0 + lane);
      rlo = i.x;
      rhi = i.w;
    }
    if (live) {
      clo = min(min(ci[0].x, ci[1].x), min(ci[2].x, ci[3].x));
      chi = max(max(ci[0].w, ci[1].w), max(ci[2].w, ci[3].w));
    }
    rlo = __reduce_min_sync(0xffffffffu, rlo);
    rhi = __reduce_max_sync(0xffffffffu, rhi);
    clo = __reduce_min_sync(0xffffffffu, clo);
    chi = __reduce_max_sync(0xffffffffu, chi);
    if (lane == 0) {
      window[0] = rlo;
      window[1] = rhi;
      window[2] = clo;
      window[3] = chi;
    }
  }
  __syncthreads();

  // 2. staging: bytes [sb, se) of each window row
  constexpr int kPix = C * static_cast<int>(sizeof(In));
  const int rlo = window[0], nr = window[1] - rlo + 1, clo = window[2], nc = window[3] - clo + 1;
  const int row_bytes = p.w_in * kPix;
  const int sb = (clo * kPix) & ~15;
  const int se = min(((window[3] + 1) * kPix + 15) & ~15, row_bytes);
  if (nr > p.rows || se - sb > p.in_pitch || nc > p.mid_pitch) return;  // tiling() sizes these: never
  const unsigned char* src = p.x + static_cast<size_t>(blockIdx.z) * p.h_in * row_bytes + rlo * row_bytes + sb;
  if (p.aligned) {
    const int chunks = (se - sb) >> 4;
    for (int r = warp; r < nr; r += kWarps)
      for (int k = lane; k < chunks; k += 32) cp_async16(s_in + r * p.in_pitch + 16 * k, src + r * row_bytes + 16 * k);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    const int n = (se - sb) / static_cast<int>(sizeof(In));
    for (int r = warp; r < nr; r += kWarps)
      for (int k = lane; k < n; k += 32)
        reinterpret_cast<In*>(s_in + r * p.in_pitch)[k] = reinterpret_cast<const In*>(src + r * row_bytes)[k];
  }
  __syncthreads();

  // 3. vertical pass: items (r, j) of th rows × nc window columns, walked by adds and carries
  {
    const int off = clo * kPix - sb;  // bytes from a staged row's start to window column clo
    const int dr = kThreads / nc, dj = kThreads - dr * nc;
    int r = tid / nc, j = tid - r * nc;
    for (int i = tid; i < th * nc; i += kThreads) {
      const int4 hi = s_hidx[r];
      const float4 hw = s_hw[r];
      const unsigned char* col = s_in + off + j * kPix;
      const In* x0 = reinterpret_cast<const In*>(col + (hi.x - rlo) * p.in_pitch);
      const In* x1 = reinterpret_cast<const In*>(col + (hi.y - rlo) * p.in_pitch);
      const In* x2 = reinterpret_cast<const In*>(col + (hi.z - rlo) * p.in_pitch);
      const In* x3 = reinterpret_cast<const In*>(col + (hi.w - rlo) * p.in_pitch);
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        float v = hw.x * to_f32(x0[ch]);
        v = fmaf(hw.y, to_f32(x1[ch]), v);
        v = fmaf(hw.z, to_f32(x2[ch]), v);
        v = fmaf(hw.w, to_f32(x3[ch]), v);
        s_mid[(ch * p.th + r) * p.mid_pitch + j] = v;
      }
      j += dj;
      r += dr;
      if (j >= nc) {
        j -= nc;
        ++r;
      }
    }
  }
  __syncthreads();

  // 4. horizontal pass and epilogue: (channel, row) pairs tid / (tw/4), + slots, ...
  if (!live) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ci[k].x -= clo;
    ci[k].y -= clo;
    ci[k].z -= clo;
    ci[k].w -= clo;
  }
  const int slots = kThreads >> gshift;
  const size_t plane = static_cast<size_t>(p.h_out) * p.w_out;
  for (int pr = tid >> gshift; pr < C * th; pr += slots) {
    const int ch = C == 1 ? 0 : pr / th;
    const int r = pr - ch * th;
    const float* m = s_mid + (ch * p.th + r) * p.mid_pitch;
    float acc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[k] = cw[k].x * m[ci[k].x];
      acc[k] = fmaf(cw[k].y, m[ci[k].y], acc[k]);
      acc[k] = fmaf(cw[k].z, m[ci[k].z], acc[k]);
      acc[k] = fmaf(cw[k].w, m[ci[k].w], acc[k]);
    }
    const int o = (r0 + r) * p.w_out + c0 + cb;  // inside one output plane
    if (kEpi == kStoreU8) {
      unsigned char* dst = static_cast<unsigned char*>(p.out) + blockIdx.z * plane + o;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (cb + k * cs < tw) dst[k * cs] = static_cast<unsigned char>(__float2int_rz(acc[k]) & 255);
    } else {
      float* dst = static_cast<float*>(p.out) + o;
      if (kEpi == kNormalize) {
        const int oc = p.flip ? C - 1 - ch : ch;
        const float s = pick(p.scale, oc), t = pick(p.bias, oc);
        dst += (static_cast<size_t>(blockIdx.z) * C + oc) * plane;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = fmaf(acc[k], s, t);
      } else {
        dst += blockIdx.z * plane;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (cb + k * cs < tw) dst[k * cs] = acc[k];
    }
  }
}

Params make_params(const void* x, void* out, int h_in, int w_in, int h_out, int w_out, const void* h_idx,
                   const void* h_w, const void* w_idx, const void* w_w, int th, int tw, int rows, int in_pitch,
                   int mid_pitch, int aligned) {
  Params p{};
  p.x = static_cast<const unsigned char*>(x);
  p.out = out;
  p.h_idx = static_cast<const int4*>(h_idx);
  p.h_w = static_cast<const float4*>(h_w);
  p.w_idx = static_cast<const int4*>(w_idx);
  p.w_w = static_cast<const float4*>(w_w);
  p.h_in = h_in;
  p.w_in = w_in;
  p.h_out = h_out;
  p.w_out = w_out;
  p.th = th;
  p.tw = tw;
  p.rows = rows;
  p.in_pitch = in_pitch;
  p.mid_pitch = mid_pitch;
  p.aligned = aligned;
  return p;
}

bool bad_launch(int images, const Params& p, int channels, int smem) {
  return images < 1 || images > 65535 || p.h_in < 1 || p.w_in < 1 || p.h_out < 1 || p.w_out < 1 ||
         (p.tw != 32 && p.tw != 64 && p.tw != 128) || p.th < 1 || p.th > kMaxTileH ||
         (p.h_out + p.th - 1) / p.th > 65535 || p.rows < 1 || p.in_pitch < 16 || p.in_pitch % 16 ||
         p.mid_pitch < 1 || smem < 32 * p.th + p.rows * p.in_pitch + 4 * channels * p.th * p.mid_pitch;
}

template <typename In, int C, int kEpi>
cudaError_t launch(const Params& p, int images, int smem, cudaStream_t stream) {
  if (bad_launch(images, p, C, smem)) return cudaErrorInvalidValue;
  const auto kernel = separable_resize_kernel<In, C, kEpi>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.w_out + p.tw - 1) / p.tw, (p.h_out + p.th - 1) / p.th, images);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// K2. x: contiguous (B, h_in, w_in, 3) uint8 BGR (bgr=1) or RGB; out:
// contiguous (B, 3, h_out, w_out) float32, resize(x)·scale_c + bias_c, that is
// (x/255 resized − mean_c) / std_c. Taps: (h_out, 4) and (w_out, 4) int32
// indices and float32 weights; th … aligned: ops/kernels/resize.py::tiling.
extern "C" int preprocess_u8(const void* x, void* out, int batch, int h_in, int w_in, int h_out, int w_out, int bgr,
                             const void* h_idx, const void* h_w, const void* w_idx, const void* w_w, int th,
                             int tw, int rows, int in_pitch, int mid_pitch, int smem_bytes, int aligned, float s0,
                             float s1, float s2, float b0, float b1, float b2, void* stream) {
  Params p = make_params(x, out, h_in, w_in, h_out, w_out, h_idx, h_w, w_idx, w_w, th, tw, rows, in_pitch,
                         mid_pitch, aligned);
  p.flip = bgr;
  p.scale[0] = s0;
  p.scale[1] = s1;
  p.scale[2] = s2;
  p.bias[0] = b0;
  p.bias[1] = b1;
  p.bias[2] = b2;
  return launch<uint8_t, 3, kNormalize>(p, batch, smem_bytes, static_cast<cudaStream_t>(stream));
}

// K3. x: contiguous (planes, h_in, w_in) float32; out: contiguous
// (planes, h_out, w_out) float32, or uint8 (u8=1) holding (int)trunc(v) & 255.
extern "C" int resize_f32(const void* x, void* out, int planes, int h_in, int w_in, int h_out, int w_out, int u8,
                          const void* h_idx, const void* h_w, const void* w_idx, const void* w_w, int th, int tw,
                          int rows, int in_pitch, int mid_pitch, int smem_bytes, int aligned, void* stream) {
  const Params p = make_params(x, out, h_in, w_in, h_out, w_out, h_idx, h_w, w_idx, w_w, th, tw, rows, in_pitch,
                               mid_pitch, aligned);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return u8 ? launch<float, 1, kStoreU8>(p, planes, smem_bytes, s) : launch<float, 1, kStoreF32>(p, planes, smem_bytes, s);
}
