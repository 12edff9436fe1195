// Soft-argmax heatmap decode for Hopper (sm_90a), plain C entry point
// loaded with ctypes by tpu_pose_torch/ops/cuda_kernels.py.
//
// Replaces tpu_pose/ops/pallas_kernels.py:soft_argmax_pallas (the Pallas
// TPU kernel, body _softargmax_kernel). Computes the same function as the
// plain version tpu_pose_torch/ops/softargmax.py:soft_argmax: for every
// (image b, part p) belief map x (the background channel is never used)
//   m = max(x),  e = exp(beta * (x - m)),
//   joint = (sum(e * col) / sum(e) * stride, sum(e * row) / sum(e) * stride),
//   conf  = m.
// Cell-corner convention: cell (row, col) is pixel (col*stride, row*stride);
// no stride/2 is added.
//
// What bounds it on an H100: memory traffic, and at the main path's
// shapes launch latency. It reads the 14 part maps, B*46*46*14*4 bytes:
// 0.95 MB at B = 8, i.e. 0.28 us at HBM's 3.35 TB/s, far below the few
// microseconds a launch costs; 15.2 MB at B = 128, i.e. 4.5 us. The exps
// (B*14*2116 of them) are negligible next to the card's float32 rate.
//
// Design against that bound: one pass. One block of 256 threads per
// (b, p) map. Every value is read from device memory once, and each
// thread carries an online softmax state (running max m, and sum(e),
// sum(e*col), sum(e*row) relative to it). A thread loads its 9 cells of a
// 46 x 46 map at once, rescales its sums once for their max
// (exp(beta * (m_old - m_new))) and then takes their exps independently;
// rows and columns are stepped, not divided out per value. States merge
// the same way, rescaling only the one with the smaller max, in warp
// shuffles and then once across warps through shared memory, so a block
// synchronizes once. The block reads the map through its strides:
// - NHWC memory, what both paths' CPMs give (their convs keep the
//   channels-last layout of the NHWC input), at a 60-byte stride (15
//   floats per pixel): the 14 blocks of an image read the same lines,
//   which the last conv has just written, so they come from L2;
// - a map stored as one contiguous run (an NHWC view of NCHW memory):
//   coalesced. Designs
//   that read pixels with their channels contiguous (one 1024-thread
//   block per image keeping one channel's state per thread, or a thread
//   block cluster of 2-8 blocks per image merging through distributed
//   shared memory) were measured slower at the int8 path's 16 images per
//   chunk: an image's work then sits on one SM or waits on the cluster.
// Special values follow the plain version: a NaN in a map makes its
// joint and conf NaN (the max propagates NaN), a -inf value weighs 0, and
// the initial state (m = -inf, sums 0) merges without producing NaN.
//
// Full-precision expf on purpose (no --use_fast_math, no __expf): the
// reference tolerance (rtol 1e-5) and the exact delta-peak decode need it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Loads a thread issues before using them: a 46 x 46 map in one round.
constexpr int kBatch = 9;

// Max that propagates NaN, like jnp.max / torch.amax.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

struct State {
  float m, s, sx, sy;
};

__device__ __forceinline__ State empty_state() {
  return {-INFINITY, 0.f, 0.f, 0.f};
}

// Step (row, col) on by `q` rows and `rm` columns (rm < w).
__device__ __forceinline__ void step_cell(int& row, int& col, int q, int rm,
                                          int w) {
  col += rm;
  row += q;
  if (col >= w) {
    col -= w;
    ++row;
  }
}

// Only the state with the smaller max is rescaled, so one exp; a NaN max
// makes the factor, and so the sums, NaN.
__device__ __forceinline__ State merge(const State& a, const State& b,
                                       float beta) {
  const float m = nan_max(a.m, b.m);
  const bool a_hi = a.m == m;
  const float lo_m = a_hi ? b.m : a.m;
  const float r = lo_m == m ? 1.f : expf(beta * (lo_m - m));
  const float ra = a_hi ? 1.f : r, rb = a_hi ? r : 1.f;
  return {m, a.s * ra + b.s * rb, a.sx * ra + b.sx * rb,
          a.sy * ra + b.sy * rb};
}

__device__ __forceinline__ State warp_merge(State st, float beta) {
  for (int o = 16; o > 0; o >>= 1) {
    const State other = {__shfl_xor_sync(0xffffffffu, st.m, o),
                         __shfl_xor_sync(0xffffffffu, st.s, o),
                         __shfl_xor_sync(0xffffffffu, st.sx, o),
                         __shfl_xor_sync(0xffffffffu, st.sy, o)};
    st = merge(st, other, beta);
  }
  return st;
}

__device__ __forceinline__ void finish(const State& st, float stride,
                                       float* joint, float* conf) {
  joint[0] = st.sx / st.s * stride;
  joint[1] = st.sy / st.s * stride;
  *conf = st.m;
}

// Push the cells n = first, first + step, ... < count of one map into
// the state, K at a time: K loads in flight, one rescale for their max,
// then K independent exps. (row, col) of cell n is stepped along, once
// for the loads and again for the sums, so that no index is kept per
// value.
template <int K>
__device__ __forceinline__ void push_cells(State& st, const float* base,
                                           int first, int step, int count,
                                           int w, int64_t sh, int64_t sw,
                                           float beta) {
  const int q = step / w, rm = step - q * w;
  int row = first / w, col = first - row * w;
  for (int n0 = first; n0 < count; n0 += K * step) {
    const int row0 = row, col0 = col;
    float v[K];
    float m = st.m;
#pragma unroll
    for (int u = 0; u < K; ++u) {
      v[u] = n0 + u * step < count ? base[row * sh + col * sw] : -INFINITY;
      step_cell(row, col, q, rm, w);
    }
#pragma unroll
    for (int u = 0; u < K; ++u) m = nan_max(m, v[u]);
    if (m != st.m) {  // a new max (or NaN): rescale what was summed
      const float r = expf(beta * (st.m - m));
      st.s *= r;
      st.sx *= r;
      st.sy *= r;
      st.m = m;
    }
    row = row0;
    col = col0;
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const float e = v[u] == -INFINITY ? 0.f : expf(beta * (v[u] - m));
      st.s += e;
      st.sx += e * (float)col;
      st.sy += e * (float)row;
      step_cell(row, col, q, rm, w);
    }
  }
}

// One block per (b, p) map, any strides.
__global__ void __launch_bounds__(kThreads)
soft_argmax_kernel(const float* __restrict__ x, float* __restrict__ joints,
                   float* __restrict__ conf, int parts, int h, int w,
                   int64_t sb, int64_t sh, int64_t sw, int64_t sc, float beta,
                   float stride) {
  const int map = blockIdx.x;  // b * parts + p
  const int b = map / parts;
  const float* base = x + b * sb + (map - b * parts) * sc;
  State st = empty_state();
  push_cells<kBatch>(st, base, threadIdx.x, kThreads, h * w, w, sh,
                        sw, beta);
  st = warp_merge(st, beta);

  __shared__ State red[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = st;
  __syncthreads();
  if (warp == 0) {
    st = warp_merge(lane < kThreads / 32 ? red[lane] : empty_state(),
                    beta);
    if (lane == 0) finish(st, stride, joints + 2 * map, conf + map);
  }
}

}  // namespace

// heatmaps: (batch, h, w, parts + 1) float32 with element strides
// (sb, sh, sw, sc); channel `parts` (the background) is not read.
// joints: (batch, parts, 2) and conf: (batch, parts), both contiguous.
// Launches on `stream`; returns cudaGetLastError() (0 = success).
extern "C" int soft_argmax_f32(const float* heatmaps, float* joints,
                               float* conf, int64_t batch, int64_t parts,
                               int64_t h, int64_t w, int64_t sb, int64_t sh,
                               int64_t sw, int64_t sc, float beta,
                               float stride, void* stream) {
  const int64_t maps = batch * parts;
  if (batch <= 0 || parts <= 0 || maps > 0x7fffffff || h <= 0 || w <= 0 ||
      h * w > 0x7fffffff - kThreads * kBatch)
    return (int)cudaErrorInvalidValue;
  soft_argmax_kernel<<<(unsigned)maps, kThreads, 0, (cudaStream_t)stream>>>(
      heatmaps, joints, conf, (int)parts, (int)h, (int)w, sb, sh, sw, sc,
      beta, stride);
  return (int)cudaGetLastError();
}

extern "C" const char* soft_argmax_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
