// Symmetric per-tensor int8 activation quantization for Hopper (sm_90a),
// plain C entry points loaded with ctypes by
// tpu_pose_torch/ops/cuda_kernels.py:quantize_act_cuda.
//
// Replaces tpu_pose/ops/pallas_kernels.py:quantize_act_pallas (the Pallas
// TPU kernel, body _quantize_kernel), which the JAX forward computes as
// tpu_pose/models/cpm.py:_quantize_act. Computes the same function as the
// plain version tpu_pose_torch/ops/quantize.py:quantize_act, bit for bit:
//   scale = a_scale                          (static, calibrated), or
//   scale = max(max|x| / 127, 1e-12)         (dynamic),
//   q     = clip(round_half_even(x / scale), -127, 127) as int8,
// elementwise over a contiguous tensor of n float32 or bf16 values (the
// caller passes the NHWC activation its im2col reads, so q comes out in
// that layout). bf16 values are widened to float32 first.
//
// Exactness: x / scale is an IEEE division (no --use_fast_math; nvcc's
// default -prec-div=true), never a multiply by 1/scale, and rintf rounds
// half to even like jnp.round / torch.round (roundf would round half away
// from zero). The abs-max is exact in any order (max is associative).
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, 50 MB L2): memory
// traffic. One quantize pass reads the input once and writes one byte per
// value: at batch 16 the 184x184x128 bf16 trunk input is 139 MB in and
// 69 MB out, 62 us at 3.35 TB/s; the f32 images (26 MB in, 6.5 MB out)
// 9.7 us; a 46x46x128 bf16 stage input 8.7 MB in, 4.3 MB out, 3.9 us,
// where a launch costs about as much. The dynamic scale adds one more
// read of the input (the abs-max pass); a tensor larger than the L2 then
// comes from HBM twice (trunk: 103 us).
//
// Measured by chip_smoke.py (NVIDIA H100 80GB HBM3, 700.00 W; device time
// per call in a CUDA graph, L2 flushed): trunk 89 us static, 138 us
// dynamic; images 15 us; stage 11.5 us, of which an empty graph replay
// alone takes 3.1 us. PERF.md keeps the current numbers.
//
// Design against that bound: both passes are grid-stride loops over
// 16-byte vector loads (4 float32 or 8 bf16 values per thread and step),
// with enough blocks to fill the 132 SMs several times over. The abs-max
// pass reduces each block with warp shuffles (__reduce_max_sync on the
// float's bit pattern, which orders like the value for |x| >= 0, and puts
// NaN above +inf so that it propagates like jnp.max) and then combines
// blocks with one atomicMax per block into a one-float scratch that the
// wrapper has zeroed. The quantize pass reads the scale (or the abs-max)
// from device memory, so nothing goes back to the host between the two.
//
// Making it fast is later work: fold the quantize into the previous
// layer's epilogue, so that the bf16 activation is never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// |x| as the bit pattern of a non-negative float: orders like the value.
template <typename T>
__device__ __forceinline__ unsigned abs_bits(T v) {
  return __float_as_uint(fabsf(to_float(v)));
}

// Bytes of one thread's V int8 results, stored with one V-byte write.
template <int V>
struct alignas(V) Bytes {
  int8_t v[V];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, int64_t n, unsigned* __restrict__ out) {
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
    if (lane == 0) atomicMax(out, m);
  }
}

__device__ __forceinline__ int8_t quantize_one(float v, float s) {
  const float r = rintf(v / s);
  return (int8_t)fminf(fmaxf(r, -127.0f), 127.0f);
}

// scale_src: the static scale, or (dynamic != 0) the abs-max, from which
// every thread derives the scale; block 0 stores it to scale_out.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int64_t n,
                const float* __restrict__ scale_src, int dynamic,
                float* __restrict__ scale_out, int8_t* __restrict__ q) {
  constexpr int V = 16 / sizeof(T);
  float s = *scale_src;
  if (dynamic) {
    const float d = s / 127.0f;
    s = (d != d) ? d : fmaxf(d, 1e-12f);  // NaN propagates, as jnp.maximum
    if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = s;
  }
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
    for (int j = 0; j < V; ++j) o.v[j] = quantize_one(to_float(e[j]), s);
    qv[i] = o;
  }
  for (int64_t i = nvec * V + tid; i < n; i += step)
    q[i] = quantize_one(to_float(x[i]), s);
}

int grid_for(int64_t n, int vec) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n / vec + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  return (int)(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

// x: n contiguous values, float32 (is_bf16 = 0) or bf16 (is_bf16 = 1),
// 16-byte aligned. amax: one float, zeroed by the caller; receives
// max|x| (as its bit pattern, through atomicMax). Launches on `stream`;
// returns cudaGetLastError() (0 = success).
extern "C" int quantize_act_absmax(const void* x, int is_bf16, int64_t n,
                                   float* amax, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* out = reinterpret_cast<unsigned*>(amax);
  if (is_bf16)
    absmax_kernel<__nv_bfloat16><<<grid_for(n, 8), kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, n, out);
  else
    absmax_kernel<float><<<grid_for(n, 4), kThreads, 0, st>>>(
        (const float*)x, n, out);
  return (int)cudaGetLastError();
}

// q[i] = clip(rint(x[i] / s), -127, 127) for n values. s = *scale_src
// (static), or with dynamic != 0, s = max(*scale_src / 127, 1e-12) where
// *scale_src is quantize_act_absmax's result; s is then also stored to
// *scale_out. q: n int8, 16-byte aligned. Same stream and return rules.
extern "C" int quantize_act_q(const void* x, int is_bf16, int64_t n,
                              const float* scale_src, int dynamic,
                              float* scale_out, int8_t* q, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    quantize_kernel<__nv_bfloat16><<<grid_for(n, 8), kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, n, scale_src, dynamic, scale_out, q);
  else
    quantize_kernel<float><<<grid_for(n, 4), kThreads, 0, st>>>(
        (const float*)x, n, scale_src, dynamic, scale_out, q);
  return (int)cudaGetLastError();
}

extern "C" const char* quantize_act_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
