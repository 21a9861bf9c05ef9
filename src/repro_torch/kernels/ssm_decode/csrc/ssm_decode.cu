// Mamba-2 single-token decode for Hopper (sm_90a): the state update and its
// read-out for every (slot, head) in one launch, the fp32 state updated in
// place.
//
// Replaces no TPU kernel: the JAX package leaves this recurrence to XLA
// (src/repro/models/ssm.py :: ssm_decode). It was added because the plain
// PyTorch version (kernels/ssm_decode/ref.py) makes about seven passes over
// every slot's state a layer (write the input term; read and write the
// state for the decay; read both and write for the add; read it again for
// the read-out), for live and idle slots alike, and in a served hybrid
// model's decode step those passes were a third of the device's time.
//
// What it computes, for slot s and head h of a live slot (ngroups = 1: B
// and C are shared across heads), in fp32:
//   decay = exp(-dt[s,h] * A[h])
//   state[s,h,p,n] = decay * state[s,h,p,n] + dt[s,h] * x[s,h,p] * B[s,n]
//   y[s,h,p] = sum_n state[s,h,p,n] * C[s,n] + D[h] * x[s,h,p]
// y is stored in x's type. A slot whose `active` flag is false keeps its
// state untouched (neither read nor written) and gets y = 0; a null
// `active` means every slot is live.
//
// Bound on an H100: memory. A live (slot, head) reads and writes its P x N
// fp32 state once, 8 * P * N bytes, against ~4 flops an element: the least
// time is 8 * live slots * H * P * N bytes / 3.35 TB/s (0.080 ms a layer
// with all 32 slots of Granite 4.0-H's 128 x 64 x 128 heads live).
//
// Design. One block per (slot, head), grid (H, S), 256 threads; an idle
// slot's blocks only zero their y and leave. A state row of N floats is
// N / 4 chunks of 16 bytes; G = min(32, next power of two >= N / 4)
// neighbouring lanes take a row, each K = ceil(N / 4 / G) chunks of it
// (G = 32, K = 1 at N = 128: one warp a row, 512 contiguous bytes), so
// every load and store is a coalesced 128-bit access. Each thread first
// issues the loads of 8 / K rows, then updates and stores them, which keeps
// enough bytes in flight to cover the memory's latency. The loads and
// stores are streaming (evict-first: ld.global.cs / st.global.cs), so the
// state passing through does not push the layer's weights out of L2. The
// read-out sums each lane's products in a fixed order and then the row's G
// lanes by a fixed xor-shuffle tree: no atomics, so one input always gives
// the same bits (a captured step replays bitwise the eager one).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 256;
constexpr int kInFlight = 8;   // 16-byte loads a thread issues before using them

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// G lanes a row, K chunks of 4 floats a lane; T the type of x, B, C and y.
template <typename T, int G, int K>
__global__ void __launch_bounds__(kThreads)
ssm_decode_kernel(float* __restrict__ state, const T* __restrict__ x, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ D,
                  const uint8_t* __restrict__ active, T* __restrict__ y, int H, int P, int N,
                  long long x_stride, long long b_stride, long long c_stride) {
  constexpr int kRowsPerPass = kThreads / G;   // rows the block covers at once
  constexpr int kUnroll = kInFlight / K;       // passes whose loads are in flight together
  const int head = blockIdx.x;
  const int slot = blockIdx.y;
  const long long sh = static_cast<long long>(slot) * H + head;
  T* ys = y + sh * P;
  if (active != nullptr && !active[slot]) {
    for (int p = threadIdx.x; p < P; p += kThreads) ys[p] = from_f<T>(0.f);
    return;
  }
  const float d = dt[sh];
  const float decay = expf(-d * A[head]);
  const float skip = D[head];
  const int lane = threadIdx.x % G;   // the lane's place in its row
  const int row0 = threadIdx.x / G;
  const int chunks = N / 4;
  const T* xs = x + slot * x_stride + static_cast<long long>(head) * P;
  const T* bs = Bm + slot * b_stride;
  const T* cs = Cm + slot * c_stride;

  // this lane's columns of B and C, the same for every row it takes
  float b[K][4], c[K][4];
  bool on[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int ch = lane + k * G;
    on[k] = ch < chunks;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[k][j] = on[k] ? to_f(bs[4 * ch + j]) : 0.f;
      c[k][j] = on[k] ? to_f(cs[4 * ch + j]) : 0.f;
    }
  }

  float4* hs = reinterpret_cast<float4*>(state + sh * P * N);
  for (int base = 0; base < P; base += kRowsPerPass * kUnroll) {
    float4 v[kUnroll][K];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + row0 + u * kRowsPerPass;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        v[u][k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < P && on[k]) v[u][k] = __ldcs(hs + r * chunks + lane + k * G);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + row0 + u * kRowsPerPass;
      const float xr = r < P ? to_f(xs[r]) : 0.f;
      const float dx = d * xr;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float4 t = v[u][k];
        t.x = decay * t.x + dx * b[k][0];
        t.y = decay * t.y + dx * b[k][1];
        t.z = decay * t.z + dx * b[k][2];
        t.w = decay * t.w + dx * b[k][3];
        if (r < P && on[k]) {
          __stcs(hs + r * chunks + lane + k * G, t);
          acc += t.x * c[k][0];
          acc += t.y * c[k][1];
          acc += t.z * c[k][2];
          acc += t.w * c[k][3];
        }
      }
      // the row's G lanes are neighbours: a fixed tree over them
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0 && r < P) ys[r] = from_f<T>(acc + skip * xr);
    }
  }
}

template <typename T, int G, int K>
cudaError_t launch(void* state, const void* x, const void* Bm, const void* Cm, const void* dt,
                   const void* A, const void* D, const void* active, void* y, int S, int H,
                   int P, int N, long long xs, long long bs, long long cs, cudaStream_t s) {
  ssm_decode_kernel<T, G, K><<<dim3(H, S), kThreads, 0, s>>>(
      static_cast<float*>(state), static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(D), static_cast<const uint8_t*>(active), static_cast<T*>(y), H,
      P, N, xs, bs, cs);
  return cudaGetLastError();
}

// The row's lanes from N: G = min(32, next power of two >= N / 4), K = 2
// only past 32 chunks.
template <typename T>
cudaError_t dispatch(void* state, const void* x, const void* Bm, const void* Cm, const void* dt,
                     const void* A, const void* D, const void* active, void* y, int S, int H,
                     int P, int N, long long xs, long long bs, long long cs, cudaStream_t s) {
  const int chunks = N / 4;
#define SD_ARGS state, x, Bm, Cm, dt, A, D, active, y, S, H, P, N, xs, bs, cs, s
  if (chunks <= 1) return launch<T, 1, 1>(SD_ARGS);
  if (chunks <= 2) return launch<T, 2, 1>(SD_ARGS);
  if (chunks <= 4) return launch<T, 4, 1>(SD_ARGS);
  if (chunks <= 8) return launch<T, 8, 1>(SD_ARGS);
  if (chunks <= 16) return launch<T, 16, 1>(SD_ARGS);
  if (chunks <= 32) return launch<T, 32, 1>(SD_ARGS);
  return launch<T, 32, 2>(SD_ARGS);
#undef SD_ARGS
}

}  // namespace

// state: (S, H, P, N) fp32, contiguous, 16-byte aligned, updated in place;
// x: (S, H, P) with row stride x_stride (elements), (H, P) packed; B, C:
// (S, N) with row strides b_stride, c_stride, N packed; x, B, C and y of
// one type (dtype 0 = float32, 1 = bfloat16); dt: (S, H) fp32; A, D: (H,)
// fp32; active: (S,) bool or null (every slot live); y: (S, H, P), packed.
// N a multiple of 4, at most 256. Returns cudaGetLastError() after the
// launch.
extern "C" int ssm_decode_launch(void* state, const void* x, const void* B, const void* C,
                                 const void* dt, const void* A, const void* D,
                                 const void* active, void* y, int S, int H, int P, int N,
                                 long long x_stride, long long b_stride, long long c_stride,
                                 int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S < 1 || H < 1 || P < 1 || N < 4 || N % 4 || N > kMaxN || S > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(state) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch<float>(state, x, B, C, dt, A, D, active, y, S, H, P, N, x_stride, b_stride,
                          c_stride, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(state, x, B, C, dt, A, D, active, y, S, H, P, N, x_stride,
                                  b_stride, c_stride, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
