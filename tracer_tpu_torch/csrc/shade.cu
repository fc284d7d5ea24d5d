// The shading of one bounce around its shadow query, for Hopper (sm_90a):
// K6 and K7.
//
//   shade_prepare_kernel  NEE + MIS up to the shadow query and the BSDF step
//                         of a bounce (K6)
//   shade_finish_kernel   occlusion, the light count, emission and the
//                         hit / miss / ambient select (K7)
//
// They replace no TPU kernel: the JAX package leaves this arithmetic to XLA
// (tracer_tpu/engine/direct.py, tracer_tpu/engine/integrator.py:85-118),
// which fuses it. Eager PyTorch runs it as ~1,750 elementwise passes over
// the lanes a bounce, each a launch from the host: that dispatch, not the
// intersection kernels, set the pace of every benchmark cell. The plain
// version is engine/shade.py's (engine/direct.estimate_direct_prepare /
// estimate_direct_finish and the BSDF step); each function below is the
// plain function of the same name, in the same order of operations.
//
// Bound: bytes and the lanes' transcendentals. One thread a lane reads each
// operand once (~80 B: the interaction, the ray, the wavelength, the rng
// word) and writes each result once (~110 B: the rng word, the next ray, the
// 2N packed shadow rays, two carried terms and a flag byte); the light table
// and the transmitter's emission are a few hundred bytes the L2 keeps. The
// uber material's lobes are evaluated once for the light sample, and for
// each of the two BSDF samples only the lobe the lane takes, after every
// uniform the plain version draws has been drawn.
//
// Arithmetic: f32 as the plain version's PyTorch ops compute it on the card
// (the helpers of csrc/torch_f32.cuh).
// Each product is __fmul_rn, so that no multiply and add contract into an
// FMA that rounds once where the ops round twice; divides and square roots
// are IEEE (no fast math); the math functions are those PyTorch's kernels
// call (expf, logf, cosf, sinf, acosf, powf, rsqrtf); a division by a tensor
// x of a python 1.0 is PyTorch's reciprocal, 1.0f / x. clamp_min and clamp
// pass NaN on as PyTorch's do. The rng is the PCG chain of ops/rng.py in
// uint32, over the int64 words the pool keeps in [0, 2^32).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "torch_f32.cuh"

namespace {

constexpr int kShadeBlock = 128;

// the plain version's python constants, as PyTorch casts them to f32
constexpr float kPi = (float)3.141592653589793;
constexpr float kTwoPi = (float)6.283185307179586;
constexpr float kInvPi = (float)(1.0 / 3.141592653589793);
constexpr float kUniformF = (float)(1.0 / 16777216.0);   // rng._UNIFORM_F
constexpr float kAcneEps = 0.001f;                        // shapes.ACNE_EPS
constexpr float kOcclusionEps = 0.01f;                    // direct.py
constexpr float kF32Highest = 3.4028234663852886e38f;     // shapes.F32_HIGHEST
constexpr float kAlphaScale = 1.62142f;
constexpr float kEpsRoughness = 0.004f;

constexpr int kPdfImpossible = 0, kPdfDelta = 1, kPdfNonzero = 2;
constexpr float kKindPoint = 0.f, kKindFrustum = 2.f;
constexpr int kBfL = 1, kBfB = 2, kBoth = 4, kHit = 8, kMiss = 16;

// ---------------------------------------------------------------------------
// ops/shapes.py

// mkray_adjust_acne_v: the origin offset along the normal to wi's side
__device__ __forceinline__ void mkray(V3 pos, V3 normal, V3 wi, V3& o, V3& d) {
    o = pos + scale(kAcneEps, scale(sign(dot(wi, normal)), normal));
    d = normalize(wi);
}

// hit_triangle_v's ok and pos
__device__ __forceinline__ bool hit_triangle(float tmax, V3 o, V3 d, V3 a,
                                             V3 b, V3 c, V3& pos) {
    float t;
    V3 n;
    bool ok = triangle_t(tmax, o, d, a, b, c, t, n);
    pos = o + scale(ok ? t : 0.f, d);
    return ok;
}

// ---------------------------------------------------------------------------
// ops/materials.py, in the local frame

struct Mat {
    float color, roughness, metalness, ref_ix, opacity;
};

struct Onb {
    V3 t, b, n;
};

__device__ __forceinline__ Onb make_onb(V3 n) {
    bool use_x = fabsf(n.x) > fabsf(n.z);
    V3 b = use_x ? V3{-n.y, n.x, 0.f} : V3{0.f, -n.z, n.y};
    b = normalize(b);
    return {cross(b, n), b, n};
}
__device__ __forceinline__ V3 world_to_local(const Onb& f, V3 w) {
    return {dot(w, f.t), dot(w, f.b), dot(w, f.n)};
}
__device__ __forceinline__ V3 local_to_world(const Onb& f, V3 w) {
    return (scale(w.x, f.t) + scale(w.y, f.b)) + scale(w.z, f.n);
}

__device__ __forceinline__ bool same_hemisphere(V3 w, V3 u) {
    return mul(w.z, u.z) > 0.f;
}
__device__ __forceinline__ float tan2_theta(V3 w) {
    float c2 = mul(w.z, w.z);
    return clamp_min(1.f - c2, 0.f) / c2;
}
__device__ __forceinline__ V3 reflect(V3 w, V3 n) {
    return scale(mul(2.f, dot(w, n)), n) - w;
}
__device__ __forceinline__ float beckmann_alpha(float roughness) {
    return mul(kAlphaScale, clamp_min(roughness, kEpsRoughness));
}
__device__ __forceinline__ float fresnel_reflectance(V3 wo, const Mat& m) {
    float q = (1.f - m.ref_ix) / (m.ref_ix + 1.f);
    float r0 = mul(q, q);
    return r0 + mul(1.f - r0, powf(1.f - wo.z, 5.f));
}

__device__ __forceinline__ float microfacet_distribution(float alpha, V3 wh) {
    float t2 = tan2_theta(wh);
    float c2 = mul(wh.z, wh.z);
    float d = expf(-t2 / mul(alpha, alpha)) /
              mul(mul(mul(mul(kPi, alpha), alpha), c2), c2);
    return isinf(t2) || isnan(t2) ? 0.f : d;
}

__device__ __forceinline__ float lambda_beckmann(float alpha, V3 w) {
    float abs_tan = sqrtf(clamp_min(tan2_theta(w), 0.f));
    float a = 1.f / mul(alpha, abs_tan);
    float lam = ((1.f - mul(1.259f, a)) + mul(mul(0.396f, a), a)) /
                (mul(3.535f, a) + mul(mul(2.181f, a), a));
    lam = a >= 1.6f ? 0.f : lam;
    return isinf(abs_tan) || isnan(abs_tan) ? 0.f : lam;
}

__device__ __forceinline__ float dielectric_reflection_bsdf(V3 wo, V3 wi,
                                                            const Mat& m) {
    V3 wh = normalize(wi + wo);
    float alpha = beckmann_alpha(m.roughness);
    float g = 1.f / ((lambda_beckmann(alpha, wo) + 1.f) +
                     lambda_beckmann(alpha, wi));
    float f = mul(microfacet_distribution(alpha, wh), g);
    return f / mul(mul(4.f, wo.z), wi.z);
}

__device__ __forceinline__ float dielectric_reflection_pdf(V3 wo, V3 wi,
                                                           const Mat& m) {
    V3 wh = normalize(wo + wi);
    float alpha = beckmann_alpha(m.roughness);
    float pdf_wh = mul(microfacet_distribution(alpha, wh), fabsf(wh.z));
    float pdf = pdf_wh / mul(4.f, dot(wo, wh));
    return same_hemisphere(wo, wi) ? pdf : 0.f;
}

// uber_bsdf and uber_pdf of one (wo, wi) pair
__device__ __forceinline__ void uber_eval(V3 wo, V3 wi, const Mat& m,
                                          float& bsdf, float& pdf) {
    float fresnel = fresnel_reflectance(wo, m);
    float refl_bsdf = dielectric_reflection_bsdf(wo, wi, m);
    float reflectance = wo.z <= 0.f ? 0.f : fresnel;
    float refr_bsdf = lerp(0.f, mul(m.color, kInvPi), m.opacity);
    float diel_bsdf = lerp(refr_bsdf, refl_bsdf, reflectance);
    bsdf = lerp(diel_bsdf, mul(m.color, refl_bsdf), m.metalness);

    float refl_pdf = dielectric_reflection_pdf(wo, wi, m);
    float diffuse_pdf = same_hemisphere(wo, wi) ? mul(wi.z, kInvPi) : 0.f;
    float refr_pdf = lerp(0.f, diffuse_pdf, m.opacity);
    float blended = lerp(refr_pdf, refl_pdf, fresnel);
    float diel_pdf = wo.z <= 0.f ? refr_pdf : blended;
    pdf = lerp(refl_pdf, diel_pdf, m.metalness);
}

struct Sample {
    V3 wi;  // world space
    float bsdf, pdf;
    int kind;
};

// sample_dir: uber_sample_dir's seven uniforms, then the lobe the lane takes
__device__ __forceinline__ Sample sample_dir(uint32_t& s, V3 wo_world,
                                             const Onb& f, const Mat& m) {
    V3 wo = world_to_local(f, wo_world);
    float p_metal = next_unit(s);
    float p_fresnel = next_unit(s);
    float p_opacity = next_unit(s);
    float u0 = next_unit(s), u1 = next_unit(s);          // Beckmann wh
    float u_theta = mul((float)(next_u32(s) >> 8), kUniformF);
    float u_r = next_unit(s);                            // the unit disk

    bool metal_branch = p_metal < m.metalness;
    bool from_inside = wo.z <= 0.f;
    float fresnel = fresnel_reflectance(wo, m);
    bool refl_branch = !metal_branch && !from_inside && p_fresnel < fresnel;
    bool use_reflection = metal_branch || refl_branch;
    bool diffuse_branch = !use_reflection && p_opacity < m.opacity;

    Sample out;
    if (use_reflection) {
        // dielectric_reflection_sample (_sample_beckmann_wh)
        float log_sample = logf(1.f - u0);
        float alpha = beckmann_alpha(m.roughness);
        float t2 = mul(mul(-alpha, alpha), log_sample);
        float phi = mul(mul(u1, 2.f), kPi);
        float ct = 1.f / sqrtf(t2 + 1.f);
        float st = sqrtf(clamp_min(1.f - mul(ct, ct), 0.f));
        V3 wh = {mul(st, cosf(phi)), mul(st, sinf(phi)), ct};
        wh = same_hemisphere(wo, wh) ? wh : -wh;
        float pdf_wh = mul(microfacet_distribution(alpha, wh), fabsf(ct));
        bool bad = isinf(log_sample);
        if (bad) {
            wh = V3{0.f, 0.f, 0.f};
            pdf_wh = 0.f;
        }
        V3 wi = reflect(wo, wh);
        float pdf = pdf_wh / mul(4.f, dot(wo, wh));
        int kind = pdf_wh > 0.f ? kPdfNonzero : kPdfImpossible;
        bool ok = same_hemisphere(wo, wi);
        float bsdf_r = ok ? dielectric_reflection_bsdf(wo, wi, m) : 0.f;
        out.wi = ok ? wi : V3{0.f, 0.f, 0.f};
        out.bsdf = metal_branch ? mul(m.color, bsdf_r) : bsdf_r;
        out.pdf = ok ? pdf : 0.f;
        out.kind = ok ? kind : kPdfImpossible;
    } else if (diffuse_branch) {
        // cosine_sample_hemisphere (in_unit_disk_xy)
        float theta = 0.f + mul(u_theta, kTwoPi);
        float r = __fsqrt_rn(u_r);
        float dx = mul(r, cosf(theta)), dy = mul(r, sinf(theta));
        float sin2t = mul(dx, dx) + mul(dy, dy);
        float z = sqrtf(clamp_min(1.f - sin2t, 0.f));
        out.wi = V3{dx, dy, z};
        out.bsdf = mul(m.color, kInvPi);
        out.pdf = mul(z, kInvPi);
        out.kind = kPdfNonzero;
    } else {
        // transmission_sample (refract)
        bool entering = wo.z > 0.f;
        V3 n = entering ? V3{0.f, 0.f, 1.f} : V3{-0.f, -0.f, -1.f};
        float eta = entering ? 1.f / m.ref_ix : m.ref_ix;
        float cos_i = dot(n, wo);
        float sin2_i = clamp_min(1.f - mul(cos_i, cos_i), 0.f);
        float sin2_t = mul(mul(eta, eta), sin2_i);
        bool tir = sin2_t >= 1.f;
        float cos_t = sqrtf(clamp_min(1.f - sin2_t, 0.f));
        V3 wt = scale(-eta, wo) + scale(mul(eta, cos_i) - cos_t, n);
        V3 wi = tir ? reflect(wo, n) : wt;
        out.wi = wi;
        out.bsdf = 1.f / clamp_min(fabsf(wi.z), 1e-12f);
        out.pdf = 0.f;
        out.kind = kPdfDelta;
    }
    out.wi = local_to_world(f, out.wi);
    return out;
}

// ---------------------------------------------------------------------------
// engine/direct.py

struct Light {
    float kind, theta, em;
    V3 a, b, c;
};

__device__ __forceinline__ float incident_radiance(const Light& L, V3 hitp,
                                                   V3 lightp) {
    V3 v = lightp - hitp;
    V3 wi = normalize(v);
    float dist_sq = clamp_min(dot(v, v), 1e-30f);
    V3 lnormal = normalize(cross(L.b - L.a, L.c - L.a));
    float cos_l = dot(-wi, lnormal);
    float diffuse = clamp_min(mul(L.em, cos_l) / dist_sq, 0.f);
    bool inside = acosf(clamp(cos_l, -1.f, 1.f)) <= L.theta;
    float direct = L.em / dist_sq;
    return L.kind == kKindFrustum ? (inside ? direct : 0.f)
           : L.kind == kKindPoint ? direct
                                  : diffuse;
}

// _shadow_ray: returns backface
__device__ __forceinline__ bool shadow_ray(V3 pos, V3 normal, V3 lightp,
                                           V3& o, V3& d, float& tmax) {
    V3 v = lightp - pos;
    V3 w = normalize(v);
    bool backface = dot(w, normal) <= 0.f;
    mkray(pos, normal, w, o, d);
    tmax = norm(v) - kOcclusionEps;
    return backface;
}

// ---------------------------------------------------------------------------
// The kernels' operands

struct PrepareArgs {
    int n;
    Lanes state, alive, ok, t, color, roughness, metalness, ref_ix, opacity,
        wavelen, cum_dist;
    Lanes3 pos, normal, d;
    const float* light_table;  // (n_scene, 23)
    int n_scene;
    const float* sectors;      // (n_trans, 9, N or 1)
    const float* trans_theta;  // 0-d
    const float* trans_emission;  // (6, 2)
    int n_trans;
    long long sec_s0, sec_s1, sec_s2;
    float trans_kind;
    long long* state_out;
    bool *hit, *scatters;
    float *o_new, *d_new, *cum_out, *rec_out;
    float *sh_tmax, *sh_o, *sh_d;  // (2N,), (3, 2N), (3, 2N)
    float* terms;                  // (2, N)
    uint8_t* flags;
};

// select_lane_light: the lane's light, li < n_scene a row of the table,
// li >= n_scene the sector li - n_scene of the transmitter
template <bool kTrans>
__device__ __forceinline__ Light select_light(const PrepareArgs& a,
                                              uint32_t& s, int i, float wl) {
    int n_lights = a.n_scene + (kTrans ? a.n_trans : 0);
    int li = (int)(next_u32(s) % (uint32_t)n_lights);
    Light L;
    if (a.n_scene > 0) {
        const float* row = a.light_table + 23 * min(li, a.n_scene - 1);
        L.a = V3{__ldg(row), __ldg(row + 1), __ldg(row + 2)};
        L.b = V3{__ldg(row + 3), __ldg(row + 4), __ldg(row + 5)};
        L.c = V3{__ldg(row + 6), __ldg(row + 7), __ldg(row + 8)};
        L.em = lookup_pairs(wl, row + 9, 1);
        L.theta = __ldg(row + 21);
        L.kind = __ldg(row + 22);
    } else {
        L.a = L.b = L.c = V3{0.f, 0.f, 0.f};
        L.em = L.theta = L.kind = 0.f;
    }
    if (kTrans && li >= a.n_scene) {
        int ti = min(max(li - a.n_scene, 0), a.n_trans - 1);
        const float* sec = a.sectors + ti * a.sec_s0 + (long long)i * a.sec_s2;
        float r[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) r[k] = __ldg(sec + k * a.sec_s1);
        L.a = V3{r[0], r[1], r[2]};
        L.b = V3{r[3], r[4], r[5]};
        L.c = V3{r[6], r[7], r[8]};
        L.kind = a.trans_kind;
        L.theta = __ldg(a.trans_theta);
        L.em = lookup_pairs(wl, a.trans_emission, 1);
    }
    return L;
}

template <bool kLights, bool kTrans>
__global__ void __launch_bounds__(kShadeBlock)
    shade_prepare_kernel(const PrepareArgs a) {
    int i = blockIdx.x * kShadeBlock + threadIdx.x;
    if (i >= a.n) return;
    const long long n = a.n;
    uint32_t s = (uint32_t)at<long long>(a.state, i);
    bool alive = at<uint8_t>(a.alive, i), ok = at<uint8_t>(a.ok, i);
    bool hit = alive && ok, miss = alive && !ok;
    V3 pos = at3(a.pos, i), normal = at3(a.normal, i);
    V3 wo = -at3(a.d, i);
    Mat m = {at<float>(a.color, i), at<float>(a.roughness, i),
             at<float>(a.metalness, i), at<float>(a.ref_ix, i),
             at<float>(a.opacity, i)};
    Onb f = make_onb(normal);
    int flags = (hit ? kHit : 0) | (miss ? kMiss : 0);
    float light_part = 0.f, bsdf_part = 0.f;
    float tmax0 = 0.f, tmax1 = 0.f;
    V3 o0 = {0.f, 0.f, 0.f}, d0 = o0, o1 = o0, d1 = o0;

    if (kLights) {
        // estimate_direct_prepare
        Light L = select_light<kTrans>(a, s, i, at<float>(a.wavelen, i));
        bool is_point = L.kind == kKindPoint;
        V3 e1 = L.b - L.a, e2 = L.c - L.a;
        float area = mul(norm(cross(e1, e2)), 0.5f);
        float inv_area = 1.f / clamp_min(area, 1e-30f);

        float u = next_unit(s), v = next_unit(s);   // in_triangle
        float su = __fsqrt_rn(u);
        float bu = 1.f - su, bv = mul(v, su);
        V3 lightp = is_point ? L.a : (L.a + scale(bu, e1)) + scale(bv, e2);
        V3 wi_l = normalize(lightp - pos);
        float in_radiance = incident_radiance(L, pos, lightp);
        float light_pdf = is_point ? 1.f : inv_area;

        float bsdf_l, scattering_pdf;
        uber_eval(world_to_local(f, wo), world_to_local(f, wi_l), m, bsdf_l,
                  scattering_pdf);
        float f_l = mul(bsdf_l, fabsf(dot(wi_l, normal)));
        float weight_l = light_pdf / (light_pdf + scattering_pdf);

        Sample b = sample_dir(s, wo, f, m);
        V3 o_b, d_b, lh_pos;
        mkray(pos, normal, b.wi, o_b, d_b);
        bool hit_ok = hit_triangle(kF32Highest, o_b, d_b, L.a, L.b, L.c,
                                   lh_pos);

        V3 so_l, sd_l, so_b, sd_b;
        float st_l, st_b;
        bool bf_l = shadow_ray(pos, normal, lightp, so_l, sd_l, st_l);
        bool bf_b = shadow_ray(pos, normal, lh_pos, so_b, sd_b, st_b);
        float in_rad_b = incident_radiance(L, pos, lh_pos);

        bool live_l = !bf_l && light_pdf != 0.f && in_radiance != 0.f &&
                      f_l != 0.f && weight_l != 0.f && hit;
        bool live_b = !is_point && hit_ok && !bf_b && in_rad_b != 0.f &&
                      (b.kind == kPdfDelta || b.kind == kPdfNonzero) &&
                      b.bsdf != 0.f && hit;
        bool b_only = live_b && !live_l, both = live_b && live_l;
        tmax0 = live_l || live_b ? (b_only ? st_b : st_l) : 0.f;
        tmax1 = both ? st_b : 0.f;
        o0 = select(b_only, so_b, so_l);
        d0 = select(b_only, sd_b, sd_l);
        o1 = so_b;
        d1 = sd_b;

        light_part = light_pdf == 0.f || in_radiance == 0.f
                         ? 0.f
                         : mul(mul(f_l, weight_l), in_radiance) / light_pdf;
        float f_b = mul(b.bsdf, fabsf(dot(b.wi, normal)));
        float weight_b = b.pdf / (b.pdf + inv_area);
        float contrib =
            b.kind == kPdfDelta ? mul(f_b, in_rad_b)
            : b.kind == kPdfNonzero
                ? mul(mul(f_b, in_rad_b), weight_b) / clamp_min(b.pdf, 1e-30f)
                : 0.f;
        bsdf_part = is_point || !hit_ok ? 0.f : contrib;
        flags |= (bf_l ? kBfL : 0) | (bf_b ? kBfB : 0) | (both ? kBoth : 0);
    }
    a.sh_tmax[i] = tmax0;
    a.sh_tmax[n + i] = tmax1;
    put3(a.sh_o, 2 * n, i, o0);
    put3(a.sh_o + n, 2 * n, i, o1);
    put3(a.sh_d, 2 * n, i, d0);
    put3(a.sh_d + n, 2 * n, i, d1);
    a.terms[i] = light_part;
    a.terms[n + i] = bsdf_part;
    a.flags[i] = (uint8_t)flags;

    float cum = at<float>(a.cum_dist, i);
    cum = hit ? cum + at<float>(a.t, i) : cum;
    a.cum_out[i] = cum;
    a.rec_out[i] = hit ? cum : INFINITY;

    // the BSDF step: sample, unit-weight Russian roulette, the next ray
    Sample b = sample_dir(s, wo, f, m);
    float pdf = b.kind == kPdfDelta ? 1.f : b.kind == kPdfNonzero ? b.pdf : 0.f;
    float p_terminate = 1.f - mul(b.bsdf, fabsf(dot(normal, b.wi))) / pdf;
    float u = next_unit(s);
    a.scatters[i] = hit && pdf != 0.f && !(u < p_terminate);
    V3 o_new, d_new;
    mkray(pos, normal, b.wi, o_new, d_new);
    put3(a.o_new, n, i, o_new);
    put3(a.d_new, n, i, d_new);
    a.hit[i] = hit;
    a.state_out[i] = (long long)s;
}

struct FinishArgs {
    int n;
    const bool* blocked;  // (2N,)
    const float* terms;   // (2, N)
    const uint8_t* flags;
    Lanes emission, ambient, first;
    int first_mode;  // -1: first per lane, 1: every lane, 0: none
    int n_lights;
    float* out;
};

__global__ void __launch_bounds__(kShadeBlock)
    shade_finish_kernel(const FinishArgs a) {
    int i = blockIdx.x * kShadeBlock + threadIdx.x;
    if (i >= a.n) return;
    int fl = a.flags[i];
    float direct = 0.f;
    if (a.n_lights > 0) {
        bool b0 = a.blocked[i];
        bool occ = (fl & kBfL) || b0;
        bool occ_b = (fl & kBfB) || ((fl & kBoth) ? a.blocked[a.n + i] : b0);
        direct = mul((occ ? 0.f : a.terms[i]) + (occ_b ? 0.f : a.terms[a.n + i]),
                     (float)a.n_lights);
    }
    float em = at<float>(a.emission, i);
    float lit = a.first_mode < 0 ? direct + (at<uint8_t>(a.first, i) ? em : 0.f)
                : a.first_mode  ? direct + em
                                : direct;
    a.out[i] = (fl & kHit) ? lit : (fl & kMiss) ? at<float>(a.ambient, i) : 0.f;
}

}  // namespace

extern "C" {

int shade_block() { return kShadeBlock; }

// ptr: state, alive, ok, t, color, roughness, metalness, ref_ix, opacity,
// wavelen, cum_dist, pos, normal, d, light_table, sectors, trans_theta,
// trans_emission, then the 12 outputs; in: n, the strides of the eleven
// (N,) operands, those of the three (3, N) ones (row, lane), n_scene,
// n_trans, the sectors' strides (sector, row, lane), trans_kind.
int shade_prepare_launch(const void* const* ptr, const long long* in,
                         int n_ptr, int n_int, void* stream) {
    if (n_ptr != 30 || n_int != 24) return (int)cudaErrorInvalidValue;
    PrepareArgs a;
    a.n = (int)in[0];
    Lanes* one[] = {&a.state, &a.alive, &a.ok, &a.t, &a.color, &a.roughness,
                    &a.metalness, &a.ref_ix, &a.opacity, &a.wavelen,
                    &a.cum_dist};
    for (int k = 0; k < 11; ++k) *one[k] = Lanes{ptr[k], in[1 + k]};
    Lanes3* three[] = {&a.pos, &a.normal, &a.d};
    for (int k = 0; k < 3; ++k)
        *three[k] = Lanes3{static_cast<const float*>(ptr[11 + k]),
                           in[12 + 2 * k], in[13 + 2 * k]};
    a.light_table = static_cast<const float*>(ptr[14]);
    a.n_scene = (int)in[18];
    a.sectors = static_cast<const float*>(ptr[15]);
    a.trans_theta = static_cast<const float*>(ptr[16]);
    a.trans_emission = static_cast<const float*>(ptr[17]);
    a.n_trans = (int)in[19];
    a.sec_s0 = in[20];
    a.sec_s1 = in[21];
    a.sec_s2 = in[22];
    a.trans_kind = (float)in[23];
    void* const* out = const_cast<void* const*>(ptr + 18);
    a.state_out = static_cast<long long*>(out[0]);
    a.hit = static_cast<bool*>(out[1]);
    a.scatters = static_cast<bool*>(out[2]);
    a.o_new = static_cast<float*>(out[3]);
    a.d_new = static_cast<float*>(out[4]);
    a.cum_out = static_cast<float*>(out[5]);
    a.rec_out = static_cast<float*>(out[6]);
    a.sh_tmax = static_cast<float*>(out[7]);
    a.sh_o = static_cast<float*>(out[8]);
    a.sh_d = static_cast<float*>(out[9]);
    a.terms = static_cast<float*>(out[10]);
    a.flags = static_cast<uint8_t*>(out[11]);
    if (a.n <= 0) return 0;
    dim3 grid((a.n + kShadeBlock - 1) / kShadeBlock);
    cudaStream_t st = (cudaStream_t)stream;
    if (a.n_scene + a.n_trans == 0)
        shade_prepare_kernel<false, false><<<grid, kShadeBlock, 0, st>>>(a);
    else if (a.n_trans == 0)
        shade_prepare_kernel<true, false><<<grid, kShadeBlock, 0, st>>>(a);
    else
        shade_prepare_kernel<true, true><<<grid, kShadeBlock, 0, st>>>(a);
    return (int)cudaGetLastError();
}

// ptr: blocked, terms, flags, emission, ambient, first (or null), out; in:
// n, the strides of emission, ambient and first, first_mode, n_lights.
int shade_finish_launch(const void* const* ptr, const long long* in,
                        int n_ptr, int n_int, void* stream) {
    if (n_ptr != 7 || n_int != 6) return (int)cudaErrorInvalidValue;
    FinishArgs a;
    a.n = (int)in[0];
    a.blocked = static_cast<const bool*>(ptr[0]);
    a.terms = static_cast<const float*>(ptr[1]);
    a.flags = static_cast<const uint8_t*>(ptr[2]);
    a.emission = Lanes{ptr[3], in[1]};
    a.ambient = Lanes{ptr[4], in[2]};
    a.first = Lanes{ptr[5], in[3]};
    a.first_mode = (int)in[4];
    a.n_lights = (int)in[5];
    a.out = static_cast<float*>(const_cast<void*>(ptr[6]));
    if (a.n <= 0) return 0;
    dim3 grid((a.n + kShadeBlock - 1) / kShadeBlock);
    shade_finish_kernel<<<grid, kShadeBlock, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

}  // extern "C"
