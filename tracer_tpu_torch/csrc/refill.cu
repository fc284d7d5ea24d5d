// The pool's refill, for Hopper (sm_90a): K13.
//
//   refill_kernel   one thread a lane: an idle lane takes the next work item
//                   while items are left; a starting lane draws the camera
//                   sample of its item (stream, wavelength and channel, the
//                   jittered thin-lens primary ray) and resets its path;
//                   every other lane passes through; with the scanning
//                   transmitter, the fan's 8 sectors off every lane's
//                   primary ray
//
// It replaces no TPU kernel: the JAX package leaves the refill to XLA
// (tracer_tpu/engine/integrator.py:581, tracer_tpu/models/camera.py:107,
// :132, :185), which fuses it. Eager PyTorch ran it as ~440 passes over the
// P lanes an iteration (~600 with the fan), the camera sample drawn for
// every lane and selected. The plain version is engine/refill.py's (_plain,
// fresh_samples; models/camera.draw_wavelength and primary_ray;
// ops/shapes.disk_sectors_v); each step below is the plain step of the same
// name, in the same order of operations.
//
// Bound: bytes. A lane reads its rank and the lane state it passes on (~90
// B) and writes the lane state (~90 B; 288 B more with the fan); the camera
// operand is a hundred bytes the L1 keeps. The camera sample is drawn on
// the starting lanes alone.
//
// Arithmetic: f32 as the plain version's PyTorch ops compute it on the card
// (the helpers of csrc/torch_f32.cuh): each product __fmul_rn; a tensor
// divided by a python float is PyTorch's product with the float's f32
// reciprocal; sqrtf, cosf, sinf and rsqrtf as PyTorch's kernels call them;
// ndtri is torch.special.ndtri's float algorithm as ATen's jiterator source
// writes it (ATen/native/cuda/Math.cuh), its multiply-adds contracted as
// NVRTC contracts them. The hashes and the threefry pair in uint32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "torch_f32.cuh"

namespace {

constexpr int kRefillBlock = 256;
constexpr int kSectors = 8;   // camera.TRANSMITTER_SECTORS

// the camera operand (engine/refill.camera_operand): the ray basis, the
// jitter's and the fan's radii, then the channels' mu and sigma rows
constexpr int kLowerLeft = 0, kHorizontal = 3, kVertical = 6, kU = 9,
              kV = 12, kLensRadius = 15, kOrigin = 16, kOffsetRadius = 19,
              kTransRadius = 20, kMu = 21;

// the plain version's python constants, as PyTorch casts them to f32
constexpr float kThetaScale = (float)(2.0 * 3.141592653589793 / 0.9999);
constexpr uint32_t kSaltWavelength = 0x3C6EF372u;   // camera._SALT_WAVELENGTH

// ---------------------------------------------------------------------------
// ops/rng.py

// one full PCG step as a stateless hash
__device__ __forceinline__ uint32_t hash_u32(uint32_t x) { return next_u32(x); }

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

// salted_pair: threefry2x32, 20 rounds, keys (salt, 0x9E3779B9)
__device__ __forceinline__ void salted_pair(uint32_t state, uint32_t salt,
                                            uint32_t& b0, uint32_t& b1) {
    const uint32_t ks[3] = {salt, 0x9E3779B9u,
                            salt ^ 0x9E3779B9u ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    uint32_t x0 = state + ks[0], x1 = 0x85EBCA6Bu + ks[1];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            x0 += x1;
            x1 = rotl(x1, rot[i % 2][k]) ^ x0;
        }
        x0 += ks[(i + 1) % 3];
        x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
    }
    b0 = x0;
    b1 = x1;
}

// ---------------------------------------------------------------------------
// torch.special.ndtri on the card (ATen/native/cuda/Math.cuh, ndtri_string):
// Cephes' ndtri in f32, polevl's multiply-add and y + y * r as fused
// multiply-adds, as NVRTC compiles the jiterator's source

template <int kLen>
__device__ __forceinline__ float polevl(float x, const float (&a)[kLen]) {
    float result = 0.f;
#pragma unroll
    for (int i = 0; i < kLen; ++i) result = fmaf(result, x, a[i]);
    return result;
}

__device__ __forceinline__ float ndtri(float y0) {
    const float zero = 0.f, one = 1.f;
    if (y0 == zero) return -INFINITY;
    if (y0 == one) return INFINITY;
    if (y0 < zero || y0 > one) return NAN;
    bool code = true;
    float y = y0;
    if (y > one - (float)0.13533528323661269189) {
        y = one - y;
        code = false;
    }
    if (y > (float)0.13533528323661269189) {
        const float p0[5] = {
            (float)-5.99633501014107895267E1, (float)9.80010754185999661536E1,
            (float)-5.66762857469070293439E1, (float)1.39312609387279679503E1,
            (float)-1.23916583867381258016E0};
        const float q0[9] = {
            (float)1.00000000000000000000E0,  (float)1.95448858338141759834E0,
            (float)4.67627912898881538453E0,  (float)8.63602421390890590575E1,
            (float)-2.25462687854119370527E2, (float)2.00260212380060660359E2,
            (float)-8.20372256168333339912E1, (float)1.59056225126211695515E1,
            (float)-1.18331621121330003142E0};
        const float s2pi = (float)2.50662827463100050242E0;
        y = y - 0.5f;
        const float y2 = y * y;
        float x = fmaf(y, y2 * polevl(y2, p0) / polevl(y2, q0), y);
        return x * s2pi;
    }
    float x = sqrtf(-2.f * logf(y));
    const float x0 = x - (logf(x) / x);
    const float z = one / x;
    float x1;
    if (x < 8.f) {
        const float p1[9] = {
            (float)4.05544892305962419923E0,   (float)3.15251094599893866154E1,
            (float)5.71628192246421288162E1,   (float)4.40805073893200834700E1,
            (float)1.46849561928858024014E1,   (float)2.18663306850790267539E0,
            (float)-1.40256079171354495875E-1, (float)-3.50424626827848203418E-2,
            (float)-8.57456785154685413611E-4};
        const float q1[9] = {
            (float)1.00000000000000000000E0,   (float)1.57799883256466749731E1,
            (float)4.53907635128879210584E1,   (float)4.13172038254672030440E1,
            (float)1.50425385692907503408E1,   (float)2.50464946208309415979E0,
            (float)-1.42182922854787788574E-1, (float)-3.80806407691578277194E-2,
            (float)-9.33259480895457427372E-4};
        x1 = z * polevl(z, p1) / polevl(z, q1);
    } else {
        const float p2[9] = {
            (float)3.23774891776946035970E0,  (float)6.91522889068984211695E0,
            (float)3.93881025292474443415E0,  (float)1.33303460815807542389E0,
            (float)2.01485389549179081538E-1, (float)1.23716634817820021358E-2,
            (float)3.01581553508235416007E-4, (float)2.65806974686737550832E-6,
            (float)6.23974539184983293730E-9};
        const float q2[9] = {
            (float)1.00000000000000000000E0,  (float)6.02427039364742014255E0,
            (float)3.67983563856160859403E0,  (float)1.37702099489081330271E0,
            (float)2.16236993594496635890E-1, (float)1.34204006088543189037E-2,
            (float)3.28014464682127739104E-4, (float)2.89247864745380683936E-6,
            (float)6.79019408009981274425E-9};
        x1 = z * polevl(z, p2) / polevl(z, q2);
    }
    x = x0 - x1;
    return !code ? x : -x;
}

// ---------------------------------------------------------------------------
// The kernel's operands

struct RefillArgs {
    int lanes;                         // P
    long long total, n, w, full_h, row0;
    int n_channels;
    float fan_cos[kSectors + 1], fan_sin[kSectors + 1];
    const long long *rank, *next_item, *item, *state, *seed, *nonce;
    const bool* active;
    const int *bounce, *chan;
    const float *o, *d, *po, *pd, *wavelen, *cum_dist, *sample_rad,
        *sample_min_d, *cam;
    long long *next_out, *item_out, *state_out;
    bool* active_out;
    int *bounce_out, *chan_out;
    float *o_out, *d_out, *po_out, *pd_out, *wavelen_out, *cum_out, *rad_out,
        *min_d_out;
    float* sectors;                    // (8, 9, P), or null without the fan
};

__device__ __forceinline__ V3 get3(const float* p, long long n, int i) {
    return {__ldg(p + i), __ldg(p + n + i), __ldg(p + 2 * n + i)};
}
__device__ __forceinline__ V3 cam3(const float* cam, int k) {
    return {__ldg(cam + k), __ldg(cam + k + 1), __ldg(cam + k + 2)};
}

struct Fresh {
    uint32_t state;
    float wavelen;
    int channel;
    V3 origin, dir;
};

// fresh_samples: the camera sample of work item `item`
__device__ __forceinline__ Fresh fresh_sample(const RefillArgs& a,
                                              long long item) {
    const float* cam = a.cam;
    long long s = item / a.n;
    long long pix = item - s * a.n;
    float jx = (float)(pix % a.w);
    float iy = ((float)a.full_h - ((float)(pix / a.w) + (float)a.row0)) - 1.f;

    // make_streams_per_lane(seed, nonce + s, pix + row0 * w)
    uint32_t frame = (uint32_t)__ldg(a.nonce) + (uint32_t)s;
    uint32_t base = hash_u32((uint32_t)__ldg(a.seed) ^ hash_u32(frame));
    uint32_t st = hash_u32((uint32_t)(pix + a.row0 * a.w) ^ base);

    // draw_wavelength: the salted pair, then the main stream twice
    Fresh f;
    uint32_t b0, b1;
    salted_pair(st, kSaltWavelength, b0, b1);
    next_u32(st);
    next_u32(st);
    f.state = st;
    f.channel = (int)(b0 % (uint32_t)a.n_channels);
    float p = mul((float)(b1 >> 8), kUnitF);
    float mu = __ldg(cam + kMu + f.channel);
    float sigma = __ldg(cam + kMu + a.n_channels + f.channel);
    f.wavelen = mu + mul(sigma, ndtri(clamp_min(p, 1e-12f)));

    // primary_ray, from the state the wavelength left (which it hands on)
    float ox = next_unit(st), oy = next_unit(st);
    float off = __ldg(cam + kOffsetRadius);
    float x = mul(jx + mul(ox, off), 1.f / (float)a.w);
    float y = mul(iy + mul(oy, off), 1.f / (float)a.full_h);
    float theta = mul(ox, kThetaScale);
    float lr = sqrtf(oy);
    float lx = mul(lr, cosf(theta)), ly = mul(lr, sinf(theta));
    float lens = __ldg(cam + kLensRadius);
    V3 lens_offset = scale(mul(lens, lx), cam3(cam, kU)) +
                     scale(mul(lens, ly), cam3(cam, kV));
    f.origin = cam3(cam, kOrigin) + lens_offset;
    V3 target = (cam3(cam, kLowerLeft) + scale(x, cam3(cam, kHorizontal))) +
                scale(y, cam3(cam, kVertical));
    f.dir = normalize(target - f.origin);
    return f;
}

// shapes.disk_sectors_v of one lane, stacked as direct.stack_sectors does:
// sector k's rows a (the camera origin), b = v_{k+1}, c = v_k on the rim
__device__ __forceinline__ void fan(const RefillArgs& a, int i, V3 normal) {
    const long long p = a.lanes;
    V3 c = cross(normal, V3{0.f, 1.f, 0.f});
    float cq = dot(c, c);
    V3 safe = scale(rsqrtf(clamp_min(cq, 1e-30f)), c);
    V3 right = cq == 0.f ? V3{1.f, 0.f, 0.f} : safe;
    V3 up = normalize(cross(right, normal));
    V3 origin = cam3(a.cam, kOrigin);
    float radius = __ldg(a.cam + kTransRadius);
    V3 rim[kSectors + 1];
#pragma unroll
    for (int k = 0; k <= kSectors; ++k) {
        V3 v = scale(a.fan_cos[k], right) + scale(a.fan_sin[k], up);
        rim[k] = origin + scale(radius, v);
    }
#pragma unroll
    for (int k = 0; k < kSectors; ++k) {
        float* row = a.sectors + (long long)k * 9 * p;
        put3(row, p, i, origin);
        put3(row + 3 * p, p, i, rim[k + 1]);
        put3(row + 6 * p, p, i, rim[k]);
    }
}

template <bool kFan>
__global__ void __launch_bounds__(kRefillBlock)
    refill_kernel(const RefillArgs a) {
    int i = blockIdx.x * kRefillBlock + threadIdx.x;
    if (i >= a.lanes) return;
    const long long p = a.lanes;
    long long next_item = __ldg(a.next_item);
    if (i == 0)
        a.next_out[0] = min(next_item + __ldg(a.rank + p - 1), a.total);
    // the r-th idle lane takes item next_item + r while items are left
    bool active = a.active[i];
    long long cand = next_item + __ldg(a.rank + i) - 1;
    bool start = !active && cand < a.total;
    long long item = start ? cand : __ldg(a.item + i);
    a.item_out[i] = item;
    a.active_out[i] = active || start;
    V3 po, pd;
    if (start) {
        Fresh f = fresh_sample(a, item);
        po = f.origin;
        pd = f.dir;
        a.state_out[i] = (long long)f.state;
        a.wavelen_out[i] = f.wavelen;
        a.chan_out[i] = f.channel;
        a.bounce_out[i] = 0;
        a.cum_out[i] = 0.f;
        a.rad_out[i] = 0.f;
        a.min_d_out[i] = INFINITY;
        put3(a.o_out, p, i, po);
        put3(a.d_out, p, i, pd);
    } else {
        po = get3(a.po, p, i);
        pd = get3(a.pd, p, i);
        a.state_out[i] = __ldg(a.state + i);
        a.wavelen_out[i] = __ldg(a.wavelen + i);
        a.chan_out[i] = __ldg(a.chan + i);
        a.bounce_out[i] = __ldg(a.bounce + i);
        a.cum_out[i] = __ldg(a.cum_dist + i);
        a.rad_out[i] = __ldg(a.sample_rad + i);
        a.min_d_out[i] = __ldg(a.sample_min_d + i);
        put3(a.o_out, p, i, get3(a.o, p, i));
        put3(a.d_out, p, i, get3(a.d, p, i));
    }
    put3(a.po_out, p, i, po);
    put3(a.pd_out, p, i, pd);
    if (kFan) fan(a, i, pd);
}

}  // namespace

extern "C" {

// ptr: rank, next_item, active, item, state, bounce, o, d, po, pd, wavelen,
// chan, cum_dist, sample_rad, sample_min_d, cam, seed, nonce, then the 15
// outputs in the op's order (next_item, active, item, state, bounce, o, d,
// po, pd, wavelen, chan, cum_dist, sample_rad, sample_min_d, sectors; the
// sectors null without the fan); in: P, total, n, w, full_h, row0, the
// channels, then the fan's cosines and sines of its 9 angles as f32 bits.
int refill_launch(const void* const* ptr, const long long* in, int n_ptr,
                  int n_int, void* stream) {
    if (n_ptr != 33 || n_int != 7 + 2 * (kSectors + 1))
        return (int)cudaErrorInvalidValue;
    RefillArgs a;
    a.lanes = (int)in[0];
    a.total = in[1];
    a.n = in[2];
    a.w = in[3];
    a.full_h = in[4];
    a.row0 = in[5];
    a.n_channels = (int)in[6];
    for (int k = 0; k <= kSectors; ++k) {
        uint32_t c = (uint32_t)in[7 + 2 * k], s = (uint32_t)in[8 + 2 * k];
        memcpy(&a.fan_cos[k], &c, 4);
        memcpy(&a.fan_sin[k], &s, 4);
    }
    auto in_l = [&](int k) { return static_cast<const long long*>(ptr[k]); };
    auto in_i = [&](int k) { return static_cast<const int*>(ptr[k]); };
    auto in_f = [&](int k) { return static_cast<const float*>(ptr[k]); };
    a.rank = in_l(0);
    a.next_item = in_l(1);
    a.active = static_cast<const bool*>(ptr[2]);
    a.item = in_l(3);
    a.state = in_l(4);
    a.bounce = in_i(5);
    a.o = in_f(6);
    a.d = in_f(7);
    a.po = in_f(8);
    a.pd = in_f(9);
    a.wavelen = in_f(10);
    a.chan = in_i(11);
    a.cum_dist = in_f(12);
    a.sample_rad = in_f(13);
    a.sample_min_d = in_f(14);
    a.cam = in_f(15);
    a.seed = in_l(16);
    a.nonce = in_l(17);
    void* const* out = const_cast<void* const*>(ptr + 18);
    a.next_out = static_cast<long long*>(out[0]);
    a.active_out = static_cast<bool*>(out[1]);
    a.item_out = static_cast<long long*>(out[2]);
    a.state_out = static_cast<long long*>(out[3]);
    a.bounce_out = static_cast<int*>(out[4]);
    a.o_out = static_cast<float*>(out[5]);
    a.d_out = static_cast<float*>(out[6]);
    a.po_out = static_cast<float*>(out[7]);
    a.pd_out = static_cast<float*>(out[8]);
    a.wavelen_out = static_cast<float*>(out[9]);
    a.chan_out = static_cast<int*>(out[10]);
    a.cum_out = static_cast<float*>(out[11]);
    a.rad_out = static_cast<float*>(out[12]);
    a.min_d_out = static_cast<float*>(out[13]);
    a.sectors = static_cast<float*>(out[14]);
    if (a.lanes <= 0) return 0;
    dim3 grid((a.lanes + kRefillBlock - 1) / kRefillBlock);
    cudaStream_t st = (cudaStream_t)stream;
    if (a.sectors)
        refill_kernel<true><<<grid, kRefillBlock, 0, st>>>(a);
    else
        refill_kernel<false><<<grid, kRefillBlock, 0, st>>>(a);
    return (int)cudaGetLastError();
}

}  // extern "C"
