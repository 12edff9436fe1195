// Kernel B2, symmetric per-tensor int8 activation quantization, for Hopper
// (sm_90a): plain C entry points loaded with ctypes by
// tpu_pose_torch/ops/cuda_kernels.py (act_scale_cuda, quantize_act_cuda,
// quantize_im2col_cuda).
//
// Replaces tpu_pose/ops/pallas_kernels.py:quantize_act_pallas (the Pallas
// TPU kernel, body _quantize_kernel), which the JAX forward computes as
// tpu_pose/models/cpm.py:_quantize_act inside _conv_q. Computes the same
// functions as the plain versions in tpu_pose_torch/ops/quantize.py, bit
// for bit:
//   scale = a_scale                          (static, calibrated), or
//   scale = max(max|x| / 127, 1e-12)         (dynamic; act_scale),
//   q     = clip(round_half_even(x / scale), -127, 127) as int8
//                                            (quantize_act),
//   rows  = im2col(pad_SAME(q), k) for one tile of a conv's output rows
//                                            (quantize_im2col).
// float32 and bf16 values are widened to float32 first; int8 values are
// taken as already quantized by the im2col entry.
//
// Exactness: x / scale is an IEEE division (no --use_fast_math; nvcc's
// default -prec-div=true), never a multiply by 1/scale, and rintf rounds
// half to even like jnp.round / torch.round (roundf would round half away
// from zero). The abs-max is exact in any order (max is associative), and
// so is the scale: x -> max(x / 127, 1e-12) is monotone, so the largest
// per-block scale is the scale of the largest |x|.
//
// What bounds them on an H100 SXM (3.35 TB/s HBM, 50 MB L2): memory
// traffic. A quantize pass reads the input once and writes one byte per
// value. The im2col gather writes k*k bytes per input value: on the int8
// path at batch 16 the 28 convs with k > 1 write 22 GB of rows per chunk
// of 16 frames (6.6 ms at 3.35 TB/s), and their inputs are a few hundred
// MB. Its bound is the tile's rows written once plus the rows of the input
// that the tile reads, read once, over 3.35 TB/s.
//
// Design against that bound.
// - act_scale and quantize_act are grid-stride loops over 16-byte vector
//   loads (4 float32 or 8 bf16 values per thread and step), with enough
//   blocks to fill the 132 SMs several times over. The scale pass reduces
//   each block with warp shuffles (__reduce_max_sync on the float's bit
//   pattern, which orders like the value for |x| >= 0 and puts NaN above
//   +inf, so that it propagates like jnp.max), derives the block's scale
//   and combines blocks with one atomicMax per block into a float that the
//   wrapper has zeroed: the scale never goes through the host.
// - quantize_im2col fuses the quantization into the gather that feeds
//   the int8 GEMM, so that neither an int8 copy of the activation nor a
//   padded copy is written. One block takes a band of th output rows by tw
//   output columns of one image. It stages the input band it reads,
//   (th + k - 1) x (tw + k - 1) x C values, from device memory once
//   (16-byte loads where the channel run allows, zeros outside the image:
//   the SAME padding), quantizes each value once and keeps the int8 band
//   in shared memory. Then it writes the band's output rows, one
//   contiguous run of tw * K_pad bytes per output row of the band: each
//   thread keeps one chunk column of the rows, and a warp's stores are
//   consecutive chunks. For C a multiple of 16 a chunk is 16 bytes read
//   from shared memory at one offset from a per-layer K -> (kh, kw, c)
//   table; otherwise (the images, C = 3) a chunk is 8 bytes gathered one
//   by one at offsets from a per-byte table. A thread reads its chunk's
//   offsets once and keeps them in registers for all the pixels it
//   writes. The input is read through its strides with a unit channel
//   stride, so the int8 path's NCHW views of NHWC memory go in without a
//   copy.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3: PERF.md keeps
// the numbers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;
// Shared memory a gather block stages its band in, at most: four blocks
// fit on an SM's 228 KB. A band of a single output row may need more
// (k = 11, C = 128 at tw = 32: 59 KB), up to the card's 227 KB a block.
constexpr int kBandBytes = 45 * 1024;
constexpr int kMaxTileCols = 32;
constexpr int kGatherThreads = 512;
// Rows a gather block writes, about: enough blocks to fill the card
// several times over even for a tile of C = 3 images (248-byte rows).
constexpr int kBlockRowBytes = 64 * 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// |x| as the bit pattern of a non-negative float: orders like the value.
template <typename T>
__device__ __forceinline__ unsigned abs_bits(T v) {
  return __float_as_uint(fabsf(to_float(v)));
}

__device__ __forceinline__ int8_t quantize_one(float v, float s) {
  const float r = rintf(v / s);
  return (int8_t)fminf(fmaxf(r, -127.0f), 127.0f);
}

__device__ __forceinline__ int8_t quantize_one(__nv_bfloat16 v, float s) {
  return quantize_one(__bfloat162float(v), s);
}

// int8 values are already quantized.
__device__ __forceinline__ int8_t quantize_one(int8_t v, float) { return v; }

// Bytes of one thread's V int8 results, stored with one V-byte write.
template <int V>
struct alignas(V) Bytes {
  int8_t v[V];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
scale_kernel(const T* __restrict__ x, int64_t n, unsigned* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  const int64_t nvec = n / V;
  const int64_t step = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  unsigned m = 0u;
  for (int64_t i = tid; i < nvec; i += step) {
    const uint4 raw = __ldg(xv + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) m = max(m, abs_bits(e[j]));
  }
  for (int64_t i = nvec * V + tid; i < n; i += step)
    m = max(m, abs_bits(x[i]));

  __shared__ unsigned red[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  m = __reduce_max_sync(0xffffffffu, m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = __reduce_max_sync(0xffffffffu, lane < kWarps ? red[lane] : 0u);
    if (lane == 0) {
      const float d = __uint_as_float(m) / 127.0f;
      const float s = (d != d) ? d : fmaxf(d, 1e-12f);  // NaN propagates
      atomicMax(out, __float_as_uint(s));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int64_t n,
                const float* __restrict__ scale, int8_t* __restrict__ q) {
  constexpr int V = 16 / sizeof(T);
  const float s = *scale;
  const int64_t nvec = n / V;
  const int64_t step = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  Bytes<V>* qv = reinterpret_cast<Bytes<V>*>(q);
  for (int64_t i = tid; i < nvec; i += step) {
    const uint4 raw = __ldg(xv + i);
    const T* e = reinterpret_cast<const T*>(&raw);
    Bytes<V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) o.v[j] = quantize_one(e[j], s);
    qv[i] = o;
  }
  for (int64_t i = nvec * V + tid; i < n; i += step)
    q[i] = quantize_one(x[i], s);
}

int grid_for(int64_t n, int vec) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n / vec + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  return (int)(want < 1 ? 1 : (want < cap ? want : cap));
}

// ---------------------------------------------------------------------------
// quantize_im2col
// ---------------------------------------------------------------------------

struct Im2col {
  const void* x;
  int64_t sb, sh, sw;       // element strides of (B, H, W); channels: 1
  int h, w, c, k;
  int b0, h0, h1;           // the tile: images b0.., output rows h0..h1
  int th, tw;               // a block's band of output rows and columns
  int band_cols;            // tw + k - 1
  int band_bytes;           // (th + k - 1) * band_cols * c, rounded to 16
  int k_real, k_pad;
  const float* scale;
  int8_t* out;              // (tile rows, k_pad), 16-byte aligned
};

// Stage the band of output rows oh0.., columns ow0.. as int8 in smem,
// laid out (row, col, channel) with zeros outside the image. LOADV input
// values per load (16 bytes), or 1.
template <typename T, int LOADV>
__device__ __forceinline__ void stage_band(const Im2col& a, int img, int oh0,
                                           int ow0, float s, int8_t* band) {
  const int p = a.k / 2;
  const int rows = a.th + a.k - 1;
  const int cv = a.c / LOADV;  // vectors per pixel
  const int per_row = a.band_cols * cv;
  const T* x = reinterpret_cast<const T*>(a.x) + (int64_t)img * a.sb;
  for (int i = threadIdx.x; i < rows * per_row; i += kGatherThreads) {
    const int r = i / per_row;
    const int rem = i - r * per_row;
    const int col = rem / cv;
    const int v = rem - col * cv;
    const int ih = oh0 - p + r;
    const int iw = ow0 - p + col;
    Bytes<LOADV> o;
    if (ih >= 0 && ih < a.h && iw >= 0 && iw < a.w) {
      const T* src = x + ih * a.sh + iw * a.sw + v * LOADV;
      if constexpr (LOADV == 1) {
        o.v[0] = quantize_one(src[0], s);
      } else {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < LOADV; ++j) o.v[j] = quantize_one(e[j], s);
      }
    } else {
#pragma unroll
      for (int j = 0; j < LOADV; ++j) o.v[j] = 0;
    }
    *reinterpret_cast<Bytes<LOADV>*>(band + (r * a.band_cols + col) * a.c +
                                     v * LOADV) = o;
  }
}

// CHUNK = 16: K_pad = K_real and C % 16 == 0; table[j] is the band offset
// of the 16 bytes of chunk j relative to the output pixel's window corner.
// CHUNK = 8: table[o] is the offset of byte o, or -1 for the zero columns
// K_real..K_pad.
template <typename T, int LOADV, int CHUNK>
__global__ void __launch_bounds__(kGatherThreads)
im2col_kernel(const Im2col a) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* band = smem;
  int* table = reinterpret_cast<int*>(smem + a.band_bytes);
  const int img = a.b0 + blockIdx.z;
  const int oh0 = a.h0 + blockIdx.y * a.th;
  const int ow0 = blockIdx.x * a.tw;
  const int kc = a.k * a.c;
  const int row_stride = a.band_cols * a.c;

  const int entries = CHUNK == 16 ? a.k_pad / 16 : a.k_pad;
  for (int j = threadIdx.x; j < entries; j += kGatherThreads) {
    const int o = CHUNK == 16 ? j * 16 : j;
    const int kh = o / kc;
    table[j] = o < a.k_real ? kh * row_stride + (o - kh * kc) : -1;
  }
  const float s = sizeof(T) == 1 ? 1.0f : *a.scale;
  stage_band<T, LOADV>(a, img, oh0, ow0, s, band);
  __syncthreads();

  // Thread t writes chunk columns j = t % cpr, + kGatherThreads, ... of
  // output pixels t / cpr, + R, ... (R = pixels a step covers), so that a
  // warp's stores are consecutive and a thread looks its chunk's offsets
  // up once.
  const int cpr = a.k_pad / CHUNK;  // chunks per output row
  const int R = cpr < kGatherThreads ? kGatherThreads / cpr : 1;
  if (threadIdx.x >= R * cpr) return;
  const int tw = min(a.tw, a.w - ow0);
  const int th = min(a.th, a.h1 - oh0);
  for (int j = threadIdx.x % cpr; j < cpr; j += kGatherThreads) {
    int off[CHUNK == 16 ? 1 : 8];
    if constexpr (CHUNK == 16) {
      off[0] = table[j];
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) off[t] = table[j * 8 + t];
    }
    for (int ph = 0; ph < th; ++ph) {
      const int64_t row0 =
          ((int64_t)blockIdx.z * (a.h1 - a.h0) + (oh0 + ph - a.h0)) * a.w +
          ow0;
      int8_t* dst = a.out + row0 * a.k_pad + (int64_t)j * CHUNK;
      const int8_t* src_row = band + ph * row_stride;
      for (int pw = threadIdx.x / cpr; pw < tw; pw += R) {
        const int8_t* corner = src_row + pw * a.c;
        if constexpr (CHUNK == 16) {
          *reinterpret_cast<uint4*>(dst + (int64_t)pw * a.k_pad) =
              *reinterpret_cast<const uint4*>(corner + off[0]);
        } else {
          Bytes<8> o;
#pragma unroll
          for (int t = 0; t < 8; ++t)
            o.v[t] = off[t] < 0 ? (int8_t)0 : corner[off[t]];
          *reinterpret_cast<Bytes<8>*>(dst + (int64_t)pw * a.k_pad) = o;
        }
      }
    }
  }
}

template <typename T, int LOADV, int CHUNK>
int launch_im2col(const Im2col& a, dim3 grid, size_t smem, cudaStream_t st) {
  auto kernel = im2col_kernel<T, LOADV, CHUNK>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kGatherThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_im2col(const Im2col& a, dim3 grid, size_t smem, bool vec_in,
                    bool chunk16, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec_in && chunk16) return launch_im2col<T, V, 16>(a, grid, smem, st);
  if (vec_in) return launch_im2col<T, V, 8>(a, grid, smem, st);
  if (chunk16) return launch_im2col<T, 1, 16>(a, grid, smem, st);
  return launch_im2col<T, 1, 8>(a, grid, smem, st);
}

}  // namespace

// x: n contiguous values, float32 (is_bf16 = 0) or bf16 (is_bf16 = 1),
// 16-byte aligned. scale: one float, zeroed by the caller; receives
// max(max|x| / 127, 1e-12) (through atomicMax on its bit pattern).
// Launches on `stream`; returns cudaGetLastError() (0 = success).
extern "C" int quantize_act_scale(const void* x, int is_bf16, int64_t n,
                                  float* scale, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* out = reinterpret_cast<unsigned*>(scale);
  if (is_bf16)
    scale_kernel<__nv_bfloat16><<<grid_for(n, 8), kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, n, out);
  else
    scale_kernel<float><<<grid_for(n, 4), kThreads, 0, st>>>(
        (const float*)x, n, out);
  return (int)cudaGetLastError();
}

// q[i] = clip(rint(x[i] / *scale), -127, 127) for n contiguous values
// (16-byte aligned, as q). Same stream and return rules.
extern "C" int quantize_act_q(const void* x, int is_bf16, int64_t n,
                              const float* scale, int8_t* q, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    quantize_kernel<__nv_bfloat16><<<grid_for(n, 8), kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, n, scale, q);
  else
    quantize_kernel<float><<<grid_for(n, 4), kThreads, 0, st>>>(
        (const float*)x, n, scale, q);
  return (int)cudaGetLastError();
}

// The im2col rows of the tile (images b0..b1, output rows h0..h1) of a
// SAME, stride-1 k x k conv over x (B, h, w, c) with element strides
// (sb, sh, sw, 1), quantized with *scale, written to out: (b1 - b0) *
// (h1 - h0) * w rows of k_pad bytes, K ordered (kh, kw, c), zeros in
// k*k*c..k_pad. dtype: 0 float32, 1 bf16, 2 int8 (already quantized;
// scale is not read). out must be 16-byte aligned. Same stream and return
// rules; cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int quantize_act_im2col(const void* x, int dtype, int64_t h,
                                   int64_t w, int64_t c, int64_t sb,
                                   int64_t sh, int64_t sw, int64_t k,
                                   int64_t b0, int64_t b1, int64_t h0,
                                   int64_t h1, int64_t k_pad,
                                   const float* scale, int8_t* out,
                                   void* stream) {
  const int64_t k_real = k * k * c;
  if (dtype < 0 || dtype > 2 || h <= 0 || w <= 0 || c <= 0 || k <= 0 ||
      k % 2 == 0 || b0 < 0 || b1 <= b0 || h0 < 0 || h1 <= h0 || h1 > h ||
      k_pad < k_real || k_pad % 8 || w * k_pad > 0x7fffffff ||
      (uintptr_t)out % 16 || b1 - b0 > 65535)
    return (int)cudaErrorInvalidValue;
  const int size = dtype == 2 ? 1 : (dtype == 1 ? 2 : 4);
  Im2col a;
  a.x = x;
  a.sb = sb;
  a.sh = sh;
  a.sw = sw;
  a.h = (int)h;
  a.w = (int)w;
  a.c = (int)c;
  a.k = (int)k;
  a.b0 = (int)b0;
  a.h0 = (int)h0;
  a.h1 = (int)h1;
  a.k_real = (int)k_real;
  a.k_pad = (int)k_pad;
  a.scale = scale;
  a.out = out;
  // Columns: bands of at most kMaxTileCols, evened out; rows: about
  // kBlockRowBytes of output, as many as fit kBandBytes, at least one.
  const int nbx = (int)((w + kMaxTileCols - 1) / kMaxTileCols);
  a.tw = (int)((w + nbx - 1) / nbx);
  a.band_cols = a.tw + a.k - 1;
  const int64_t row_bytes = (int64_t)a.band_cols * c;
  int64_t th = kBandBytes / row_bytes - (k - 1);
  const int64_t th_out = kBlockRowBytes / ((int64_t)a.tw * k_pad);
  th = th < th_out ? th : th_out;
  th = th < 1 ? 1 : (th > h1 - h0 ? h1 - h0 : th);
  a.th = (int)th;
  a.band_bytes = (int)(((th + k - 1) * row_bytes + 15) / 16 * 16);
  const bool chunk16 = c % 16 == 0 && k_pad == k_real;
  const size_t smem =
      a.band_bytes + sizeof(int) * (chunk16 ? k_pad / 16 : k_pad);
  int dev = 0, max_smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      smem > (size_t)max_smem)
    return (int)cudaErrorInvalidValue;
  const int lv = 16 / size;
  const bool vec_in = c % lv == 0 && (sw * size) % 16 == 0 &&
                      (sh * size) % 16 == 0 && (sb * size) % 16 == 0 &&
                      (uintptr_t)x % 16 == 0;
  const dim3 grid((unsigned)nbx, (unsigned)((h1 - h0 + th - 1) / th),
                  (unsigned)(b1 - b0));
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_im2col<float>(a, grid, smem, vec_in, chunk16, st);
  if (dtype == 1)
    return dispatch_im2col<__nv_bfloat16>(a, grid, smem, vec_in, chunk16, st);
  return dispatch_im2col<int8_t>(a, grid, smem, vec_in, chunk16, st);
}

extern "C" const char* quantize_act_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
