// The shading stages of a depth, one pass each: shade_hit, nee_prep,
// nee_accum and scatter (+ Russian roulette).
//
// Not a pl.pallas_call.  Each kernel replaces XLA's fusion of one stage
// of the JAX engine's compiled depth (render/engine.py:222-229, the
// per-depth jit, or one jit per stage at :354-358): the stage functions
// of cuda_raytracer_tpu/render/bounce.py make_stage_fns, which XLA turns
// into a few loop fusions that read each lane's inputs once:
//   shade_hit  bounce.py:71-84: ops/shade.py compute_hits (:290-410),
//              emission_at_hits (:730) and env_miss_radiance (:498);
//   nee_prep   bounce.py:86-91: sample_light (:412-485) and
//              nee_shadow_rays (:506-575), every light kind;
//   nee_accum  bounce.py:93-97;
//   scatter    bounce.py:99-110: ops/shade.py scatter (:577-728), and the
//              roulette of run_depth (bounce.py:236-246) where the depth
//              runs it.
// The plain PyTorch versions are ops/shade_stages.py's *_plain: the op
// chains of ops/shade.py as the stages compose them.  Each kernel follows
// its plain version's op order one rounding at a time (built with
// -fmad=false, no fast math): every constant the plain version folds in
// Python double is the float32 of that double here (2 pi, pi, the
// environment's solid angle, which the wrapper passes), products and
// sums in the plain version's order, torch's remainder, the .long()
// truncation and clamp of a texel index, torch.searchsorted's left side,
// _pow5 as x * (x2 * x2), _norm's clamp at 1e-20, and NaN through every
// clamp, min and max as torch propagates it.
//
// One thread per lane; the draws come in as arrays, made by the uniform
// kernel (rng.cu) before each launch.  Per-prim rows (shade_packed, [P,
// 32] f32), per-BSDF tables and the light's parameters are read through
// the read-only cache; the light's index and kind and every flag are
// kernel parameters, fixed per call, so a captured CUDA graph replays a
// launch as it is.  Nothing syncs with the host and nothing allocates.
//
// Bound on the H100: bytes.  Per lane (15,360,000 lanes a fast frame)
// shade_hit reads o, d, t, prim, valid, importance, light and
// count_emission (58 B) and writes the hit record and light (86 B);
// nee_prep reads pt, n, bsdf, valid, importance and u (53 B) and writes
// wi, max_t, li and ok (29 B); nee_accum 37 B in, 12 B out; scatter + roulette
// reads the hit record, importance and three draws (98 B) and writes o,
// d, importance, valid and count_emission (38 B).  A few hundred float
// operations per lane against 49-144 B is far below the card's FP32 rate
// over its memory rate (67 TFLOP/s / 3.35 TB/s, 20 per byte).  The
// design does what the bound asks: each input read once, each output
// written once, no [N, 32] gather of the prim row and no [N, 3]
// temporary in device memory (the plain versions write one per op).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rt_common.cuh"

#define SBLOCK 256

// scene/bsdf.py and render/flatscene.py
#define BSDF_DIFFUSE 0
#define BSDF_MIRROR 1
#define BSDF_REFRACTION 2
#define BSDF_GLASS 3
#define BSDF_EMISSION 4
#define LIGHT_AREA 0
#define LIGHT_POINT 1
#define LIGHT_DIRECTIONAL 2
#define LIGHT_HEMISPHERE 3
#define LIGHT_SPOT 4
#define LIGHT_ENV 5

// float32(math.pi) and float32(2.0 * math.pi), as torch casts a Python
// scalar operand
#define PI_F 3.14159265358979323846f
#define TWO_PI_F 6.28318530717958647692f

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 ld3(const float* p, long long i,
                                  long long stride) {
  const float* q = p + i * stride;
  return V3{__ldg(q), __ldg(q + 1), __ldg(q + 2)};
}
__device__ __forceinline__ void st3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return V3{a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return V3{a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return V3{a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 divs(V3 a, float s) {
  return V3{a.x / s, a.y / s, a.z / s};
}
__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
// _dot: (a * b).sum(-1)
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
// torch.linalg.cross
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
// torch.linalg.vector_norm over the last axis
__device__ __forceinline__ float vnorm(V3 a) {
  return sqrtf((a.x * a.x + a.y * a.y) + a.z * a.z);
}
// _norm: v / sqrt(clamp_min(dot(v, v), 1e-20))
__device__ __forceinline__ V3 normalize(V3 v) {
  return divs(v, sqrtf(nan_max(dot(v, v), 1e-20f)));
}
// torch.clamp(x, lo, hi)
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return nan_min(nan_max(x, lo), hi);
}
__device__ __forceinline__ float amax3(V3 a) {
  return nan_max(nan_max(a.x, a.y), a.z);
}
// _local_to_world: v0 * dpdu + v1 * dpdv + v2 * n
__device__ __forceinline__ V3 to_world(V3 v, V3 dpdu, V3 dpdv, V3 n) {
  return add(add(scale(dpdu, v.x), scale(dpdv, v.y)), scale(n, v.z));
}
// _spherical_sample: theta = acos(2u - 1)
__device__ __forceinline__ V3 spherical(float u0, float u1) {
  const float cos_t = 2.0f * u0 - 1.0f;
  const float sin_t = sqrtf(nan_max(1.0f - cos_t * cos_t, 0.0f));
  const float phi = TWO_PI_F * u1;
  return V3{sin_t * cosf(phi), sin_t * sinf(phi), cos_t};
}
__device__ __forceinline__ long long lane_index() {
  return (long long)blockIdx.x * SBLOCK + threadIdx.x;
}

// ---------------------------------------------------------------------------
// shade_hit
// ---------------------------------------------------------------------------

struct ShadeHitArgs {
  long long n;
  const float* o;
  long long o_stride;  // row stride in floats: 0 for the camera's expand
  const float* d;
  long long d_stride;
  const float* t;
  const int* prim;
  const uint8_t* valid;
  const float* importance;
  long long imp_stride;
  const float* light;
  long long light_stride;
  const uint8_t* count_emission;
  const float* shade_packed;  // [P, 32]
  long long num_prims;
  const int* bsdf_fn;
  const float* bsdf_radiance;
  const float* env_map;  // [H, W, 3]
  long long env_h, env_w;
  // outputs
  uint8_t* valid_out;
  float* pt;
  float* nrm;
  float* dpdu;
  float* dpdv;
  float* wo_local;
  long long* bsdf;
  float* t_out;
  uint8_t* backface;
  float* light_out;  // written where emission
  int emission;  // not reference_compat: emission, and the map where has_env
  int has_env;
  float origin_eps;
};

// env_radiance: the texel along a unit direction
__device__ __forceinline__ V3 env_lookup(const float* env_map, long long h,
                                         long long w, V3 d) {
  const float theta = acosf(clampf(d.y, -1.0f, 1.0f));
  // torch.remainder(atan2(z, x), 2 pi): fmod, plus the divisor where the
  // result's sign differs from the (positive) divisor's
  float phi = fmodf(atan2f(d.z, d.x), TWO_PI_F);
  if (phi < 0.0f) phi += TWO_PI_F;
  long long iy = (long long)(theta / PI_F * (float)h);
  long long ix = (long long)(phi / TWO_PI_F * (float)w);
  iy = iy < 0 ? 0 : (iy > h - 1 ? h - 1 : iy);
  ix = ix < 0 ? 0 : (ix > w - 1 ? w - 1 : ix);
  return ld3(env_map, iy * w + ix, 3);
}

__global__ void __launch_bounds__(SBLOCK) shade_hit_kernel(ShadeHitArgs a) {
  const long long i = lane_index();
  if (i >= a.n) return;
  const long long p = a.prim[i];
  const bool valid = p >= 0;
  const long long pidx = p < 0 ? 0 : (p > a.num_prims - 1 ? a.num_prims - 1 : p);
  const float t = a.t[i];
  const float t_s = valid ? t : 1.0f;
  const V3 o = ld3(a.o, i, a.o_stride);
  const V3 d = ld3(a.d, i, a.d_stride);
  const V3 pt_raw = add(o, scale(d, t_s));

  const float* row = a.shade_packed + pidx * 32;
  const V3 v0 = ld3(row, 0, 0), v1 = ld3(row + 3, 0, 0),
           v2 = ld3(row + 6, 0, 0);
  const bool is_sphere = __ldg(row + 9) > 0.5f;
  const V3 n0 = ld3(row + 10, 0, 0), n1 = ld3(row + 13, 0, 0),
           n2 = ld3(row + 16, 0, 0);
  const long long bsdf = (long long)__ldg(row + 19);

  // triangle: barycentric vertex-normal interpolation
  const float total =
      nan_max(vnorm(cross(sub(v0, v1), sub(v1, v2))), 1e-20f);
  const float bC = vnorm(cross(sub(v0, pt_raw), sub(v1, pt_raw))) / total;
  const float bA = vnorm(cross(sub(v1, pt_raw), sub(v2, pt_raw))) / total;
  const float bB = vnorm(cross(sub(v2, pt_raw), sub(v0, pt_raw))) / total;
  const V3 n_tri =
      normalize(add(add(scale(n0, bA), scale(n1, bB)), scale(n2, bC)));
  const V3 n_sph = normalize(sub(pt_raw, v0));
  V3 n = is_sphere ? n_sph : n_tri;
  const bool backface = dot(n, d) >= 0.0f;
  n = scale(n, backface ? -1.0f : 1.0f);
  const V3 pt = sub(pt_raw, scale(d, a.origin_eps));

  // make_frame: guide y unless the normal is near-horizontal-down
  const bool use_y = (n.y < 1e-4f) && (n.y > -0.999f);
  const V3 guide = use_y ? V3{0.0f, 1.0f, 0.0f} : V3{1.0f, 0.0f, 0.0f};
  const V3 dpdu = normalize(cross(guide, n));
  const V3 dpdv = normalize(cross(dpdu, n));
  const V3 md = neg(d);
  const V3 wo = normalize(V3{dot(dpdu, md), dot(dpdv, md), dot(n, md)});

  a.valid_out[i] = valid;
  st3(a.pt, i, pt);
  st3(a.nrm, i, n);
  st3(a.dpdu, i, dpdu);
  st3(a.dpdv, i, dpdv);
  st3(a.wo_local, i, wo);
  a.bsdf[i] = bsdf;
  a.t_out[i] = valid ? t : INFINITY;
  a.backface[i] = backface;

  if (a.emission) {
    const V3 imp = ld3(a.importance, i, a.imp_stride);
    const bool ce = a.count_emission[i];
    V3 l = ld3(a.light, i, a.light_stride);
    // emission_at_hits
    const bool emit = valid && ce && __ldg(a.bsdf_fn + bsdf) == BSDF_EMISSION;
    const V3 rad = ld3(a.bsdf_radiance, bsdf, 3);
    l = add(l, emit ? mul(imp, rad) : V3{0.0f, 0.0f, 0.0f});
    if (a.has_env) {
      // env_miss_radiance on escaped counted paths
      const bool miss = a.valid[i] && p < 0 && ce;
      const V3 env = miss ? mul(imp, env_lookup(a.env_map, a.env_h, a.env_w, d))
                          : V3{0.0f, 0.0f, 0.0f};
      l = add(l, env);
    }
    st3(a.light_out, i, l);
  }
}

// ---------------------------------------------------------------------------
// nee_prep
// ---------------------------------------------------------------------------

struct NeePrepArgs {
  long long n;
  const float* pt;
  long long pt_stride;
  const float* nrm;
  long long nrm_stride;
  const long long* bsdf;
  const uint8_t* valid;
  const float* importance;
  long long imp_stride;
  const float* u;  // [N, 2]
  long long u_stride;
  const int* bsdf_fn;
  const float* bsdf_albedo;
  // the light tables ([L, 3] f32, light_area [L]) and the light's row
  const float* light_radiance;
  const float* light_position;
  const float* light_direction;
  const float* light_dim_x;
  const float* light_dim_y;
  const float* light_area;
  long long light;
  const float* env_map;  // [H, W, 3]
  const float* env_cdf;  // [H * W]
  const float* env_pdf;
  long long env_h, env_w;
  // outputs
  float* wi;
  float* max_t;
  float* li;
  uint8_t* ok;
  int kind;  // LIGHT_*
  int two_sided;  // compat_two_sided on an area light
  float weight;
  // float32((2 pi / w) * (pi / h)), folded in double as the plain version
  float env_solid;
};

__global__ void __launch_bounds__(SBLOCK) nee_prep_kernel(NeePrepArgs a) {
  const long long i = lane_index();
  if (i >= a.n) return;
  const V3 pt = ld3(a.pt, i, a.pt_stride);
  const float u0 = a.u[i * a.u_stride], u1 = a.u[i * a.u_stride + 1];
  const long long L = a.light;
  const V3 rad = ld3(a.light_radiance, L, 3);
  V3 lop, wi;
  float dist;
  // sample_light
  switch (a.kind) {
    case LIGHT_AREA: {
      const V3 pos = ld3(a.light_position, L, 3);
      const V3 ldir = ld3(a.light_direction, L, 3);
      const V3 dx = ld3(a.light_dim_x, L, 3), dy = ld3(a.light_dim_y, L, 3);
      const float area = __ldg(a.light_area + L);
      const V3 lpt = add(add(pos, scale(dx, u0 - 0.5f)), scale(dy, u1 - 0.5f));
      const V3 dvec = sub(lpt, pt);
      const float cos_theta = dot(dvec, ldir);
      const float sq = nan_max(dot(dvec, dvec), 1e-12f);
      dist = sqrtf(sq);
      wi = divs(dvec, dist);
      const float pdf = sq / (area * nan_max(fabsf(cos_theta), 1e-8f));
      // one-sided: emits only where cos(theta) < 0
      lop = divs(cos_theta < 0.0f ? rad : V3{0.0f, 0.0f, 0.0f}, pdf);
      break;
    }
    case LIGHT_POINT: {
      const V3 dvec = sub(ld3(a.light_position, L, 3), pt);
      dist = sqrtf(nan_max(dot(dvec, dvec), 1e-12f));
      wi = divs(dvec, dist);
      lop = rad;
      break;
    }
    case LIGHT_DIRECTIONAL:
      wi = ld3(a.light_direction, L, 3);
      lop = rad;
      dist = INFINITY;
      break;
    case LIGHT_HEMISPHERE: {
      const float r = sqrtf(nan_max(1.0f - u0 * u0, 0.0f));
      const float phi = TWO_PI_F * u1;
      wi = V3{r * cosf(phi), u0, r * sinf(phi)};
      lop = scale(rad, TWO_PI_F);
      dist = INFINITY;
      break;
    }
    case LIGHT_SPOT: {
      const V3 ldir = ld3(a.light_direction, L, 3);
      const float angle = __ldg(a.light_area + L);  // radians, full cone
      const V3 dvec = sub(ld3(a.light_position, L, 3), pt);
      dist = sqrtf(nan_max(dot(dvec, dvec), 1e-12f));
      wi = divs(dvec, dist);
      const bool inside = dot(neg(wi), ldir) >= cosf(angle / 2.0f);
      lop = inside ? rad : V3{0.0f, 0.0f, 0.0f};
      break;
    }
    default: {  // LIGHT_ENV: the wrapper refuses any other kind
      // torch.searchsorted(env_cdf, u0), left side, then the clamp
      const long long hw = a.env_h * a.env_w;
      long long lo = 0, hi = hw;
      while (lo < hi) {
        const long long mid = lo + ((hi - lo) >> 1);
        if (!(__ldg(a.env_cdf + mid) >= u0)) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const long long idx = lo > hw - 1 ? hw - 1 : lo;
      const long long iy = idx / a.env_w, ix = idx % a.env_w;
      const float theta = ((float)iy + 0.5f) / (float)a.env_h * PI_F;
      const float phi = ((float)ix + 0.5f) / (float)a.env_w * 2.0f * PI_F;
      const float st = sinf(theta);
      wi = V3{st * cosf(phi), cosf(theta), st * sinf(phi)};
      const float solid = a.env_solid * nan_max(st, 1e-8f);
      const float pdf = nan_max(__ldg(a.env_pdf + idx) / solid, 1e-12f);
      lop = divs(ld3(a.env_map, idx, 3), pdf);
      dist = INFINITY;
      break;
    }
  }
  // nee_shadow_rays
  if (a.two_sided) {
    const V3 ldir = ld3(a.light_direction, L, 3);
    const V3 lpt = add(pt, scale(wi, dist));
    const float cos_theta = dot(sub(lpt, pt), ldir);
    const float sq = nan_max(dist * dist, 1e-12f);
    const float pdf = sq / (__ldg(a.light_area + L) *
                            nan_max(fabsf(cos_theta), 1e-8f));
    lop = divs(rad, pdf);
  }
  const long long b = a.bsdf[i];
  const V3 albedo = ld3(a.bsdf_albedo, b, 3);
  const V3 n = ld3(a.nrm, i, a.nrm_stride);
  const float cos_surf = fabsf(dot(n, wi));
  const V3 imp = ld3(a.importance, i, a.imp_stride);
  const float c = cos_surf / PI_F;
  V3 li = scale(mul(scale(mul(imp, albedo), c), lop), a.weight);
  const bool ok = a.valid[i] && __ldg(a.bsdf_fn + b) == BSDF_DIFFUSE &&
                  dist > 1e-2f && cos_surf > 1e-2f;
  if (!ok) li = V3{0.0f, 0.0f, 0.0f};
  st3(a.wi, i, wi);
  // infinite light distances -> the finite no-limit sentinel
  a.max_t[i] = nan_min(dist, T_NO_LIMIT);
  st3(a.li, i, li);
  a.ok[i] = ok;
}

// ---------------------------------------------------------------------------
// nee_accum
// ---------------------------------------------------------------------------

struct NeeAccumArgs {
  long long n;
  const float* light;
  long long light_stride;
  const float* t_s;
  const int* prim_s;
  const float* max_t;
  const float* li;
  long long li_stride;
  const uint8_t* ok;
  float* light_out;
  int reference_compat;  // a pass also needs prim_s >= 0
  float shadow_eps;
};

__global__ void __launch_bounds__(SBLOCK) nee_accum_kernel(NeeAccumArgs a) {
  const long long i = lane_index();
  if (i >= a.n) return;
  bool pass = a.t_s[i] > a.max_t[i] - a.shadow_eps;
  if (a.reference_compat) pass = pass && a.prim_s[i] >= 0;
  const V3 l = ld3(a.light, i, a.light_stride);
  const V3 add_ = (a.ok[i] && pass) ? ld3(a.li, i, a.li_stride)
                                    : V3{0.0f, 0.0f, 0.0f};
  st3(a.light_out, i, add(l, add_));
}

// ---------------------------------------------------------------------------
// scatter (+ roulette)
// ---------------------------------------------------------------------------

#define SAMPLE_UNIFORM 0
#define SAMPLE_COSINE 1
#define SAMPLE_FOLD 2  // w_shared: a uniform sphere direction per lane's u

struct ScatterArgs {
  long long n;
  const float* pt;
  long long pt_stride;
  const float* nrm;
  long long nrm_stride;
  const float* dpdu;
  long long dpdu_stride;
  const float* dpdv;
  long long dpdv_stride;
  const float* wo_local;
  long long wo_stride;
  const long long* bsdf;
  const uint8_t* valid;
  const uint8_t* backface;
  const float* importance;
  long long imp_stride;
  const float* u;  // [N, 2]: the hemisphere draw, or the shared draw
  long long u_stride;
  const float* u_fresnel;  // [N]
  const float* u_rr;  // [N], or null: no roulette at this depth
  const int* bsdf_fn;
  const float* bsdf_albedo;
  const float* bsdf_radiance;
  const float* bsdf_ior;
  // outputs
  float* o_out;
  float* d_out;
  float* imp_out;
  uint8_t* valid_out;
  uint8_t* count_emission;
  int mode;  // SAMPLE_*
  float origin_eps;
};

__global__ void __launch_bounds__(SBLOCK) scatter_kernel(ScatterArgs a) {
  const long long i = lane_index();
  if (i >= a.n) return;
  const long long b = a.bsdf[i];
  const int fn = __ldg(a.bsdf_fn + b);
  const V3 albedo = ld3(a.bsdf_albedo, b, 3);
  const float ior = __ldg(a.bsdf_ior + b);
  const V3 n = ld3(a.nrm, i, a.nrm_stride);
  const V3 dpdu = ld3(a.dpdu, i, a.dpdu_stride);
  const V3 dpdv = ld3(a.dpdv, i, a.dpdv_stride);
  const V3 wo = ld3(a.wo_local, i, a.wo_stride);
  const float u0 = a.u[i * a.u_stride], u1 = a.u[i * a.u_stride + 1];

  // ---- diffuse ----
  V3 d_dif, thr_dif;
  if (a.mode == SAMPLE_FOLD) {
    const V3 w = spherical(u0, u1);
    d_dif = scale(w, dot(w, n) >= 0.0f ? 1.0f : -1.0f);
    thr_dif = scale(albedo, 2.0f * fabsf(dot(d_dif, n)));
  } else if (a.mode == SAMPLE_COSINE) {
    const float r = sqrtf(u0);
    const float phi = TWO_PI_F * u1;
    const V3 dl = V3{r * cosf(phi), r * sinf(phi), sqrtf(1.0f - u0)};
    thr_dif = albedo;
    d_dif = to_world(dl, dpdu, dpdv, n);
  } else {
    const V3 s = spherical(u0, u1);
    d_dif = to_world(V3{s.x, s.y, fabsf(s.z)}, dpdu, dpdv, n);
    thr_dif = scale(albedo, 2.0f * fabsf(dot(d_dif, n)));
  }

  // ---- mirror ----
  const V3 d_mir = to_world(V3{-wo.x, -wo.y, wo.z}, dpdu, dpdv, n);

  // ---- refraction / glass (a backface hit means the ray exits) ----
  const float cos_o = clampf(wo.z, 1e-6f, 1.0f);
  const float eta = a.backface[i] ? ior : 1.0f / ior;
  const float sin2_t = (eta * eta) * nan_max(1.0f - cos_o * cos_o, 0.0f);
  const bool tir = sin2_t >= 1.0f;
  const float cos_t = sqrtf(nan_max(1.0f - sin2_t, 0.0f));
  const V3 d_refr =
      tir ? d_mir
          : to_world(V3{-eta * wo.x, -eta * wo.y, -cos_t}, dpdu, dpdv, n);
  // Fresnel (Schlick) for the glass lobe choice
  float r0 = (1.0f - ior) / (1.0f + ior);
  r0 = r0 * r0;
  const float x = 1.0f - cos_o;
  const float x2 = x * x;
  const float fres = tir ? 1.0f : r0 + (1.0f - r0) * (x * (x2 * x2));
  const bool pick_reflect = a.u_fresnel[i] < fres;
  const float rs = tir ? 1.0f : eta * eta;
  const V3 albedo_rs = scale(albedo, rs);

  // ---- select by tag ----
  V3 d_new, thr;
  if (fn == BSDF_DIFFUSE) {
    d_new = d_dif;
    thr = thr_dif;
  } else if (fn == BSDF_MIRROR) {
    d_new = d_mir;
    thr = albedo;
  } else if (fn == BSDF_REFRACTION) {
    d_new = d_refr;
    thr = tir ? albedo : albedo_rs;
  } else {
    d_new = pick_reflect ? d_mir : d_refr;
    thr = pick_reflect ? ld3(a.bsdf_radiance, b, 3) : albedo_rs;
  }
  const bool is_delta =
      fn == BSDF_MIRROR || fn == BSDF_REFRACTION || fn == BSDF_GLASS;
  // emitters terminate the path
  const bool is_emit = fn == BSDF_EMISSION;
  if (is_emit) thr = V3{0.0f, 0.0f, 0.0f};
  V3 imp = mul(ld3(a.importance, i, a.imp_stride), thr);
  // transmissive lobes offset through the surface
  const bool transmit = (fn == BSDF_REFRACTION && !tir) ||
                        (fn == BSDF_GLASS && !pick_reflect && !tir);
  const V3 offs = transmit ? scale(n, -a.origin_eps) : scale(n, a.origin_eps);
  const V3 o_new = add(ld3(a.pt, i, a.pt_stride), offs);
  bool valid = a.valid[i] && !is_emit && amax3(imp) > 0.0f;
  if (a.u_rr) {
    // Russian roulette: survive with p = max(importance), reweight by 1/p
    const float p = clampf(amax3(imp), 0.05f, 1.0f);
    valid = valid && a.u_rr[i] < p;
    imp = divs(imp, p);
  }
  st3(a.o_out, i, o_new);
  st3(a.d_out, i, d_new);
  st3(a.imp_out, i, imp);
  a.valid_out[i] = valid;
  a.count_emission[i] = is_delta;
}

// ---------------------------------------------------------------------------
// C interface: one launch each on the caller's stream; nothing for n <= 0
// ---------------------------------------------------------------------------

static unsigned blocks_for(long long n) {
  return (unsigned)((n + SBLOCK - 1) / SBLOCK);
}

extern "C" int shade_hit(const ShadeHitArgs* a, void* stream) {
  if (a->n > 0)
    shade_hit_kernel<<<blocks_for(a->n), SBLOCK, 0, (cudaStream_t)stream>>>(
        *a);
  return (int)cudaGetLastError();
}

extern "C" int nee_prep(const NeePrepArgs* a, void* stream) {
  if (a->n > 0)
    nee_prep_kernel<<<blocks_for(a->n), SBLOCK, 0, (cudaStream_t)stream>>>(
        *a);
  return (int)cudaGetLastError();
}

extern "C" int nee_accum(const NeeAccumArgs* a, void* stream) {
  if (a->n > 0)
    nee_accum_kernel<<<blocks_for(a->n), SBLOCK, 0, (cudaStream_t)stream>>>(
        *a);
  return (int)cudaGetLastError();
}

extern "C" int scatter(const ScatterArgs* a, void* stream) {
  if (a->n > 0)
    scatter_kernel<<<blocks_for(a->n), SBLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// sizeof each argument block, for the wrapper's layout check
extern "C" long long shade_args_size(int which) {
  switch (which) {
    case 0: return (long long)sizeof(ShadeHitArgs);
    case 1: return (long long)sizeof(NeePrepArgs);
    case 2: return (long long)sizeof(NeeAccumArgs);
    default: return (long long)sizeof(ScatterArgs);
  }
}
