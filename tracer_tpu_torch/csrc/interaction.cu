// The closest hit's surface interaction, for Hopper (sm_90a): K16.
//
//   interaction_kernel<kLbvh>  one thread a lane: from the closest-hit
//                              query's answer, the winning triangle tested
//                              again exactly, its material id and its
//                              material row at the lane's hero wavelength
//
// It replaces no TPU kernel: the JAX package leaves this arithmetic to XLA
// (tracer_tpu/models/scene.py closest_interaction, tracer_tpu/ops/
// intersect.py:481, tracer_tpu/ops/materials.py), which fuses it. Eager
// PyTorch ran it as ~250 passes over the lanes a bounce, each a launch from
// the host, many of them on strided views of the gathered rows. The plain
// version is engine/interaction.py's (_plain: models/scene.closest_interaction
// after the query as it was, over ops/intersect._reintersect or the LBVH's
// re-test, ops/shapes.hit_triangle_v and ops/materials.at_wavelength_rows),
// in the same order of operations.
//
// The query's answer picks the template: the dense accel's (best_t,
// best_i) of K1/K2, its rows (T, 10) [9 vertex floats | material id as f32],
// the re-test at tmax (1 + REINTERSECT_SLACK); or the LBVH's leaf of K14,
// its leaves (n, 3, 3) in Morton order, the re-test at tmax, the material id
// tri_mat[perm[leaf]]. A lane the query missed tests triangle 0 (its pos and
// normal are that test's, as the plain version's are) and takes material 0
// (dense) or tri_mat[0] (LBVH).
//
// Bound: bytes. A lane reads its ray, tmax, wavelength and the query's
// answer (~40 B) and writes its interaction (~53 B); the winning triangle's
// row and its material's 28 floats come from the L2 (the box's few rows)
// or from the device's memory once a lane (a big scene's).
//
// Arithmetic: f32 as the plain version's PyTorch ops compute it on the card
// (csrc/torch_f32.cuh): each product __fmul_rn, IEEE divides, rsqrtf in the
// normalize; a tensor divided by a python float is PyTorch's product with
// the float's f32 reciprocal; the material id's f32 to int64 conversion
// truncates, as .long() does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "torch_f32.cuh"

namespace {

constexpr int kInteractionBlock = 128;
constexpr int kMatRow = 28;   // ops/materials.py: the (M, 28) rows
// ref_ix - (wavelen - 589.0) / 10000.0: the dispersion term
constexpr float kDispersionWl = 589.f;
constexpr float kInvDispersion = 1.f / 10000.f;

struct InteractionArgs {
    long long n;
    const float* tris;      // dense (T, 10) rows; LBVH (n_leaves, 3, 3)
    const int* perm;        // LBVH (n_leaves,): input index of leaf i
    const int* tri_mat;     // LBVH (T,): material id by input index
    const float* mat_rows;  // (M, 28)
    Lanes tmax, wavelen;    // (N,)
    Lanes3 o, d;            // (3, N)
    const float* best_t;    // dense (N,)
    const int* best_i;      // dense (N,)
    const long long* leaf;  // LBVH (N,), -1 on a miss
    float slack;            // dense: 1 + REINTERSECT_SLACK
    bool* ok;
    float *t, *pos, *normal;  // (N,), (3, N), (3, N)
    float* mat;  // (6, N): color, roughness, metalness, ref_ix, opacity,
                 // emission
};

template <bool kLbvh>
__global__ void __launch_bounds__(kInteractionBlock)
    interaction_kernel(const InteractionArgs a) {
    const long long i = (long long)blockIdx.x * kInteractionBlock + threadIdx.x;
    if (i >= a.n) return;
    const long long n = a.n;
    const V3 o = at3(a.o, i), d = at3(a.d, i);
    float tmax = at<float>(a.tmax, i);
    // the query's answer: found, and the row it names (0 where none)
    bool found;
    long long row;
    if (kLbvh) {
        const long long leaf = __ldg(a.leaf + i);
        found = leaf >= 0;
        row = found ? leaf : 0;
    } else {
        found = isfinite(__ldg(a.best_t + i));
        row = found ? __ldg(a.best_i + i) : 0;
        tmax = mul(tmax, a.slack);
    }
    const float* p = a.tris + row * (kLbvh ? 9 : 10);
    const V3 ta = {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
    const V3 tb = {__ldg(p + 3), __ldg(p + 4), __ldg(p + 5)};
    const V3 tc = {__ldg(p + 6), __ldg(p + 7), __ldg(p + 8)};
    // hit_triangle_v: pos and normal of this test, whatever the query said
    float t;
    V3 nrm;
    const bool hit = triangle_t(tmax, o, d, ta, tb, tc, t, nrm);
    const bool ok = found && hit;
    put3(a.pos, n, i, o + scale(hit ? t : 0.f, d));
    put3(a.normal, n, i, normalize(nrm));
    a.ok[i] = ok;
    a.t[i] = ok ? t : INFINITY;
    const long long mat =
        kLbvh ? (long long)__ldg(a.tri_mat + (ok ? __ldg(a.perm + row) : 0))
              : (long long)(ok ? __ldg(p + 9) : 0.f);
    // materials.at_wavelength_rows
    const float* m = a.mat_rows + kMatRow * mat;
    const float wl = at<float>(a.wavelen, i);
    a.mat[i] = lookup_pairs(wl, m, 1);
    a.mat[n + i] = __ldg(m + 12);
    a.mat[2 * n + i] = __ldg(m + 13);
    a.mat[3 * n + i] = __ldg(m + 14) - mul(wl - kDispersionWl, kInvDispersion);
    a.mat[4 * n + i] = __ldg(m + 15);
    a.mat[5 * n + i] = lookup_pairs(wl, m + 16, 1);
}

}  // namespace

extern "C" {

// ptr: tris, perm, tri_mat, mat_rows, tmax, wavelen, o, d, best_t, best_i,
// leaf (perm, tri_mat and leaf null on the dense accel, best_t and best_i
// null on the LBVH: a leaf picks the LBVH's template), then the outputs ok,
// t, pos, normal, mat; in: n, the strides of tmax and wavelen, those of o
// and d (row, lane), the dense re-test's tmax scale as its f32 bits. N == 0
// launches nothing.
int interaction_launch(const void* const* ptr, const long long* in,
                       int n_ptr, int n_int, void* stream) {
    if (n_ptr != 16 || n_int != 8) return (int)cudaErrorInvalidValue;
    InteractionArgs a;
    a.n = in[0];
    a.tris = static_cast<const float*>(ptr[0]);
    a.perm = static_cast<const int*>(ptr[1]);
    a.tri_mat = static_cast<const int*>(ptr[2]);
    a.mat_rows = static_cast<const float*>(ptr[3]);
    a.tmax = Lanes{ptr[4], in[1]};
    a.wavelen = Lanes{ptr[5], in[2]};
    a.o = Lanes3{static_cast<const float*>(ptr[6]), in[3], in[4]};
    a.d = Lanes3{static_cast<const float*>(ptr[7]), in[5], in[6]};
    a.best_t = static_cast<const float*>(ptr[8]);
    a.best_i = static_cast<const int*>(ptr[9]);
    a.leaf = static_cast<const long long*>(ptr[10]);
    const uint32_t bits = (uint32_t)in[7];
    memcpy(&a.slack, &bits, sizeof a.slack);
    void* const* out = const_cast<void* const*>(ptr + 11);
    a.ok = static_cast<bool*>(out[0]);
    a.t = static_cast<float*>(out[1]);
    a.pos = static_cast<float*>(out[2]);
    a.normal = static_cast<float*>(out[3]);
    a.mat = static_cast<float*>(out[4]);
    if (a.n <= 0) return 0;
    const dim3 grid(
        (unsigned)((a.n + kInteractionBlock - 1) / kInteractionBlock));
    cudaStream_t st = (cudaStream_t)stream;
    if (a.leaf != nullptr)
        interaction_kernel<true><<<grid, kInteractionBlock, 0, st>>>(a);
    else
        interaction_kernel<false><<<grid, kInteractionBlock, 0, st>>>(a);
    return (int)cudaGetLastError();
}

}  // extern "C"
