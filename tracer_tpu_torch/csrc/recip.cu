// Approximate reciprocal for Hopper (sm_90a): K5.
//
//   approx_reciprocal_kernel  replaces _kernel in benchmarks/measure_recip.py
//                             (pl.reciprocal(x, approx=True), the probe of
//                             the TPU's approximate reciprocal)       (K5)
//
// y[i] = an approximation of 1 / x[i], one thread per element, grid-stride.
// The point of K5 is the hardware instruction itself: the error it measures
// bounds what a kernel that trades the IEEE divide for it may lose. So the
// reciprocal is the PTX instruction named directly, rcp.approx.ftz.f32,
// which is one MUFU.RCP on the special-function unit. The .ftz form is the
// bare instruction; plain rcp.approx.f32 wraps it in code that scales
// subnormal inputs and results. The probe's inputs (|x| in [2^-20, 2^21))
// and the intersector's determinants (|a| >= 1e-5) never come near the
// subnormal range, so the flush changes nothing measured, and .ftz is what
// a redesigned intersection kernel would issue.
//
// Bound by bytes: each element is read once (4 B) and written once (4 B),
// one MUFU op per element, so device memory sets the pace (8 B x n over
// 3.35 TB/s). The grid-stride loop keeps the reads and writes coalesced
// (neighbouring threads on neighbouring words) with a grid of a few blocks
// per SM, enough to keep the memory system busy.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
approx_reciprocal_kernel(const float* __restrict__ x, float* __restrict__ y,
                         long long n) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        float r;
        asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__ldg(x + i)));
        y[i] = r;
    }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns 0 or a cudaError_t (cudaGetLastError() after
// the launch). n == 0 launches nothing.
int approx_reciprocal_launch(const float* x, float* y, long long n,
                             void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    int dev = 0, sms = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err) return err;
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
    if (err) return err;
    const long long blocks = (n + kThreads - 1) / kThreads;
    const long long cap = (long long)sms * kBlocksPerSm;
    const int grid = (int)(blocks < cap ? blocks : cap);
    approx_reciprocal_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        x, y, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
