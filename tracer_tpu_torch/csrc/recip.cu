// Approximate reciprocal for Hopper (sm_90a): K5.
//
//   approx_reciprocal_kernel  replaces _kernel in benchmarks/measure_recip.py
//                             (pl.reciprocal(x, approx=True), the probe of
//                             the TPU's approximate reciprocal)       (K5)
//
// y[i] = an approximation of 1 / x[i]. The point of K5 is the hardware
// instruction itself: the error it measures bounds what a kernel that
// trades the IEEE divide for it may lose. So the reciprocal is the PTX
// instruction named directly, rcp.approx.ftz.f32, which is one MUFU.RCP on
// the special-function unit. The .ftz form is the bare instruction; plain
// rcp.approx.f32 wraps it in code that scales subnormal inputs and
// results. The probe's inputs (|x| in [2^-20, 2^21)) and the intersector's
// determinants (|a| >= 1e-5) never come near the subnormal range, so the
// flush changes nothing measured, and .ftz is what the intersection kernel
// issues where it trades the divide for it (csrc/intersect.cu).
//
// Bound by bytes: each element is read once (4 B) and written once (4 B),
// one MUFU op per element, so device memory sets the pace past the L2
// (8 B x n over 3.35 TB/s); inside the 50 MB L2, the launch and the host
// work around it do. The design follows from that:
// - 16-byte accesses: each thread loads float4s (ld.global.nc.v4), issues
//   four rcp.approx per float4 and stores float4s, so a warp moves 512 B
//   per instruction pair instead of 128 B.
// - One contiguous tile per block: a block of kThreads threads handles
//   kThreads x kUnroll float4 (4 KB), thread t the float4s t, t + kThreads,
//   ...; all kUnroll loads are in flight before the first store. The grid
//   covers the tiles (a grid-stride loop only past 2^30 blocks), as
//   PyTorch's own elementwise kernels do: capping the grid at a few blocks
//   per SM with a grid-stride loop measured 8% slower past the L2.
// - The ragged parts run here, not in a plain version: a scalar head up to
//   the first 16-byte boundary of x (an offset view such as x[1:]), and a
//   scalar tail of fewer than four elements. The float4 body needs x and y
//   at the same offset from a 16-byte boundary; the wrapper allocates y so
//   (ops/recip.py), and a launch whose pointers differ there runs a scalar
//   loop over every element.
// - 32-bit indices wherever n < 2^30; 64-bit beyond.
// - A lean launch: it asks the runtime nothing (the grid depends on n
//   alone), so a call is the launch and cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 2;
constexpr int kTile = kThreads * kUnroll;   // float4 per block and tile
constexpr long long kMaxGrid = 1LL << 30;

__device__ __forceinline__ float rcp_approx(float x) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ float4 rcp_approx4(float4 a) {
    return make_float4(rcp_approx(a.x), rcp_approx(a.y), rcp_approx(a.z),
                       rcp_approx(a.w));
}

// head: elements before the first 16-byte boundary of x (0..3, at most n),
// or n when x and y sit at different offsets from one.
template <typename I>
__global__ void __launch_bounds__(kThreads)
approx_reciprocal_kernel(const float* __restrict__ x, float* __restrict__ y,
                         I n, I head) {
    if (head == n) {
        const I stride = (I)gridDim.x * blockDim.x;
        for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < n;
             i += stride)
            y[i] = rcp_approx(__ldg(x + i));
        return;
    }
    const I vecs = (n - head) / 4;
    const I tail = head + 4 * vecs;
    if (blockIdx.x == 0) {
        if ((I)threadIdx.x < head) y[threadIdx.x] = rcp_approx(__ldg(x + threadIdx.x));
        if ((I)threadIdx.x < n - tail)
            y[tail + threadIdx.x] = rcp_approx(__ldg(x + tail + threadIdx.x));
    }
    const float4* __restrict__ xv = reinterpret_cast<const float4*>(x + head);
    float4* __restrict__ yv = reinterpret_cast<float4*>(y + head);
    const I tiles = (vecs + kTile - 1) / kTile;
    for (I tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const I i = tile * kTile + threadIdx.x;
        if (i + (kUnroll - 1) * kThreads < vecs) {
            float4 a[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) a[u] = __ldg(xv + i + u * kThreads);
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) yv[i + u * kThreads] = rcp_approx4(a[u]);
        } else {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                if (i + u * kThreads < vecs)
                    yv[i + u * kThreads] = rcp_approx4(__ldg(xv + i + u * kThreads));
            }
        }
    }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns 0 or a cudaError_t (cudaGetLastError()
// after the launch). ptr: x, y; in: n. n == 0 launches nothing.
int approx_reciprocal_launch(const void* const* ptr, const long long* in,
                             int n_ptr, int n_int, void* stream) {
    if (n_ptr != 2 || n_int != 1 || in[0] < 0)
        return (int)cudaErrorInvalidValue;
    const float* x = (const float*)ptr[0];
    float* y = (float*)ptr[1];
    const long long n = in[0];
    if (n == 0) return 0;
    const uintptr_t mis = (uintptr_t)x % 16;
    const bool vec = mis == (uintptr_t)y % 16 && mis % 4 == 0;
    const long long head = vec ? (long long)((16 - mis) % 16 / 4) : n;
    const long long h = head < n ? head : n;
    const long long blocks = vec ? ((n - h) / 4 + kTile - 1) / kTile
                                 : (n + kThreads - 1) / kThreads;
    const int grid = (int)(blocks < 1 ? 1 : blocks < kMaxGrid ? blocks : kMaxGrid);
    cudaStream_t s = (cudaStream_t)stream;
    if (n < (1LL << 30)) {  // indices stay below 2^31
        approx_reciprocal_kernel<int><<<grid, kThreads, 0, s>>>(
            x, y, (int)n, (int)(vec ? h : n));
    } else {
        approx_reciprocal_kernel<long long><<<grid, kThreads, 0, s>>>(
            x, y, n, vec ? h : n);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
