// The shading of a depth: the four stages (shade_hit, nee_prep, nee_accum
// and scatter + Russian roulette), one kernel each, and the fused chain
// the frame runs on the card, one kernel between two traces.
//
// Not a pl.pallas_call.  Each stage kernel replaces XLA's fusion of one
// stage of the JAX engine's compiled depth (render/engine.py:222-229, the
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
// chains of ops/shade.py as the stages compose them.  Each stage's body
// is a __device__ function (hit_at, emission_at, nee_sample, nee_pass,
// scatter_at) that the stage kernel and the fused chain both call, so the
// two cannot drift.  Each follows its plain version's op order one
// rounding at a time (built with -fmad=false, no fast math): every
// constant the plain version folds in Python double is the float32 of
// that double here (2 pi, pi, the environment's solid angle, which the
// wrapper passes), products and sums in the plain version's order,
// torch's remainder, the .long() truncation and clamp of a texel index,
// torch.searchsorted's left side, _pow5 as x * (x2 * x2), _norm's clamp
// at 1e-20, and NaN through every clamp, min and max as torch propagates
// it.  A recomputed hit or sample is the same function of the same
// inputs, so it has the bits the stage kernels write.
//
// One thread per lane; the draws come in as arrays, made by the uniform
// kernel (rng.cu) before each launch.  Per-prim rows (shade_packed, [P,
// 32] f32), per-BSDF tables and the lights' parameters are read through
// the read-only cache; light indices and kinds, the chain's variant and
// every flag are kernel parameters, fixed per call, so a captured CUDA
// graph replays a launch as it is.  Nothing syncs with the host and
// nothing allocates.
//
// Bound on the H100: bytes.  A few hundred float operations per lane
// against 50-150 B is far below the card's FP32 rate over its memory rate
// (67 TFLOP/s / 3.35 TB/s, 20 per byte).  Per lane, the stage kernels:
// shade_hit reads o, d, t, prim, valid, importance, light and
// count_emission (58 B) and writes the hit record and light (86 B; the
// hit record alone 74 B); nee_prep reads pt, n, bsdf, valid, importance
// and u (53 B) and writes wi, max_t, li and ok (29 B); nee_accum 37 B in,
// 12 B out; scatter + roulette reads the hit record, importance and three
// draws (98 B) and writes o, d, importance, valid and count_emission
// (38 B).  A depth of the fast preset (one area light, one sample, the
// fold, roulette) moves about 410 B a lane through them, 275 at its last
// depth: most of it the hit record and the sample, written by one kernel
// and read back by the next.
//
// The fused chain (gap<F>) keeps both in registers.  A depth makes 1 +
// S*L traces (S samples, L lights) and gets one shading kernel after
// each: only what a trace reads (the shadow ray), what it writes (t,
// prim, t_s, prim_s), the path's carry and the draws reach memory.  The
// hit is recomputed from (o, d, t, prim) and the 14-row prim table, the
// sample's li, max_t and ok from the hit and its draw u.  Per lane, fast
// preset (B read + written; o of depth 0 is the camera's stride-0
// expand, 0 B):
//   after the closest hit (shade_hit_kernel<OPEN|SAMPLE>): o, d, t, prim,
//     importance, light, count_emission, u (65) + light, the shadow ray's
//     o, d, max_t, ok (41): 106 B (94 at depth 0);
//   after the shadow trace, scattering (nee_accum_kernel<ACCUM|SCATTER>):
//     o, d, t, prim, importance, light, u, t_s, the scatter draws (u,
//     u_fresnel, u_rr: 84) + light, o, d, importance, valid,
//     count_emission (50): 134 B (118 at depth 0: no o, no roulette);
//   a depth: 240 B against 410.
// At each gap the sample accumulated next is either recomputed there (8 B
// of u read again) or stored here and read back (li 12 B written and
// read, max_t and ok 5 B read): recomputing costs the hit too (o, d, t,
// prim, importance: 44 B) unless the gap recomputes it anyway.  So a gap
// that draws a sample stores its li (STORE) only where the gap that
// accumulates it does not scatter nor draw another: the last sample of
// the last depth.  There, fast preset: OPEN|SAMPLE|STORE 118 B, then
// ACCUM|STORED reads light, t_s, max_t, li, ok and writes light, 45 B:
// 163 B against 106 + 80 = 186 recomputing, and 275 through the stages.
// A frame of the fast preset: about 855 B a lane against about 1,500.
// Each further sample of a depth (nee_accum_kernel<ACCUM|SAMPLE>) reads
// o, d, t, prim, importance, light, both draws, t_s (76) and writes
// light, the ray's d, max_t and ok (29: its o is the first sample's
// pt, written once): 105 B, against nee_prep + nee_accum's 131.

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


#define ZERO3 (V3{0.0f, 0.0f, 0.0f})

// ---------------------------------------------------------------------------
// the stages' bodies
// ---------------------------------------------------------------------------

// A lane's hit record (ops/shade.py HitRecord), in registers
struct Hit {
  V3 pt, n, dpdu, dpdv, wo;
  long long bsdf;
  float t;  // the hit's t, inf where none
  bool valid, backface;
};

// compute_hits: the record of ray (o, d) at its closest hit (t, prim p)
__device__ __forceinline__ Hit hit_at(V3 o, V3 d, float t, long long p,
                                      const float* shade_packed,
                                      long long num_prims,
                                      float origin_eps) {
  Hit h;
  h.valid = p >= 0;
  const long long pidx = p < 0 ? 0 : (p > num_prims - 1 ? num_prims - 1 : p);
  const float t_s = h.valid ? t : 1.0f;
  const V3 pt_raw = add(o, scale(d, t_s));

  const float* row = shade_packed + pidx * 32;
  const V3 v0 = ld3(row, 0, 0);
  const bool is_sphere = __ldg(row + 9) > 0.5f;
  h.bsdf = (long long)__ldg(row + 19);
  // the plain version computes both normals and selects; a lane computes
  // only the one it takes (the same ops, so the same bits)
  V3 n;
  if (is_sphere) {
    n = normalize(sub(pt_raw, v0));
  } else {
    // triangle: barycentric vertex-normal interpolation
    const V3 v1 = ld3(row + 3, 0, 0), v2 = ld3(row + 6, 0, 0);
    const V3 n0 = ld3(row + 10, 0, 0), n1 = ld3(row + 13, 0, 0),
             n2 = ld3(row + 16, 0, 0);
    const float total =
        nan_max(vnorm(cross(sub(v0, v1), sub(v1, v2))), 1e-20f);
    const float bC = vnorm(cross(sub(v0, pt_raw), sub(v1, pt_raw))) / total;
    const float bA = vnorm(cross(sub(v1, pt_raw), sub(v2, pt_raw))) / total;
    const float bB = vnorm(cross(sub(v2, pt_raw), sub(v0, pt_raw))) / total;
    n = normalize(add(add(scale(n0, bA), scale(n1, bB)), scale(n2, bC)));
  }
  h.backface = dot(n, d) >= 0.0f;
  h.n = scale(n, h.backface ? -1.0f : 1.0f);
  h.pt = sub(pt_raw, scale(d, origin_eps));

  // make_frame: guide y unless the normal is near-horizontal-down
  const bool use_y = (h.n.y < 1e-4f) && (h.n.y > -0.999f);
  const V3 guide = use_y ? V3{0.0f, 1.0f, 0.0f} : V3{1.0f, 0.0f, 0.0f};
  h.dpdu = normalize(cross(guide, h.n));
  h.dpdv = normalize(cross(h.dpdu, h.n));
  const V3 md = neg(d);
  h.wo = normalize(V3{dot(h.dpdu, md), dot(h.dpdv, md), dot(h.n, md)});
  h.t = h.valid ? t : INFINITY;
  return h;
}

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

// emission_at_hits, then env_miss_radiance where the scene has a map
// (``valid``, the carry's, read only then): light ``l`` plus what a
// counted path (``ce``) picks up at hit ``h`` of prim ``p`` along ``d``
__device__ __forceinline__ V3 emission_at(V3 l, const Hit& h, long long p,
                                          V3 d, V3 imp, bool ce,
                                          const int* bsdf_fn,
                                          const float* bsdf_radiance,
                                          const uint8_t* valid, long long i,
                                          bool has_env, const float* env_map,
                                          long long env_h, long long env_w) {
  const bool emit =
      h.valid && ce && __ldg(bsdf_fn + h.bsdf) == BSDF_EMISSION;
  const V3 rad = ld3(bsdf_radiance, h.bsdf, 3);
  l = add(l, emit ? mul(imp, rad) : ZERO3);
  if (has_env) {
    // env_miss_radiance on escaped counted paths
    const bool miss = valid[i] && p < 0 && ce;
    l = add(l, miss ? mul(imp, env_lookup(env_map, env_h, env_w, d))
                    : ZERO3);
  }
  return l;
}

// The light tables ([L, 3] f32, light_area [L]) and the environment's
struct Lights {
  const float* radiance;
  const float* position;
  const float* direction;
  const float* dim_x;
  const float* dim_y;
  const float* area;
  const float* env_map;  // [H, W, 3]
  const float* env_cdf;  // [H * W]
  const float* env_pdf;
  long long env_h, env_w;
  // float32((2 pi / w) * (pi / h)), folded in double as the plain version
  float env_solid;
};

// One NEE sample of a lane: its shadow ray's direction and length, the
// light it carries where it passes (0 where not ok), and ok
struct Sample {
  V3 wi;
  float max_t;
  V3 li;
  bool ok;
};

// sample_light, then nee_shadow_rays: the sample toward light ``L`` (of
// kind ``kind``) from the uniforms (u0, u1) at the hit (pt, n, BSDF b,
// valid) of a path with importance ``imp``
__device__ __forceinline__ Sample nee_sample(
    V3 pt, V3 n, long long b, bool valid, V3 imp, float u0, float u1,
    long long L, int kind, int two_sided, float weight, const Lights& lt,
    const int* bsdf_fn, const float* bsdf_albedo) {
  const V3 rad = ld3(lt.radiance, L, 3);
  V3 lop, wi;
  float dist;
  // sample_light
  switch (kind) {
    case LIGHT_AREA: {
      const V3 pos = ld3(lt.position, L, 3);
      const V3 ldir = ld3(lt.direction, L, 3);
      const V3 dx = ld3(lt.dim_x, L, 3), dy = ld3(lt.dim_y, L, 3);
      const float area = __ldg(lt.area + L);
      const V3 lpt = add(add(pos, scale(dx, u0 - 0.5f)), scale(dy, u1 - 0.5f));
      const V3 dvec = sub(lpt, pt);
      const float cos_theta = dot(dvec, ldir);
      const float sq = nan_max(dot(dvec, dvec), 1e-12f);
      dist = sqrtf(sq);
      wi = divs(dvec, dist);
      const float pdf = sq / (area * nan_max(fabsf(cos_theta), 1e-8f));
      // one-sided: emits only where cos(theta) < 0
      lop = divs(cos_theta < 0.0f ? rad : ZERO3, pdf);
      break;
    }
    case LIGHT_POINT: {
      const V3 dvec = sub(ld3(lt.position, L, 3), pt);
      dist = sqrtf(nan_max(dot(dvec, dvec), 1e-12f));
      wi = divs(dvec, dist);
      lop = rad;
      break;
    }
    case LIGHT_DIRECTIONAL:
      wi = ld3(lt.direction, L, 3);
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
      const V3 ldir = ld3(lt.direction, L, 3);
      const float angle = __ldg(lt.area + L);  // radians, full cone
      const V3 dvec = sub(ld3(lt.position, L, 3), pt);
      dist = sqrtf(nan_max(dot(dvec, dvec), 1e-12f));
      wi = divs(dvec, dist);
      const bool inside = dot(neg(wi), ldir) >= cosf(angle / 2.0f);
      lop = inside ? rad : ZERO3;
      break;
    }
    default: {  // LIGHT_ENV: the wrappers refuse any other kind
      // torch.searchsorted(env_cdf, u0), left side, then the clamp
      const long long hw = lt.env_h * lt.env_w;
      long long lo = 0, hi = hw;
      while (lo < hi) {
        const long long mid = lo + ((hi - lo) >> 1);
        if (!(__ldg(lt.env_cdf + mid) >= u0)) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const long long idx = lo > hw - 1 ? hw - 1 : lo;
      const long long iy = idx / lt.env_w, ix = idx % lt.env_w;
      const float theta = ((float)iy + 0.5f) / (float)lt.env_h * PI_F;
      const float phi = ((float)ix + 0.5f) / (float)lt.env_w * 2.0f * PI_F;
      const float st = sinf(theta);
      wi = V3{st * cosf(phi), cosf(theta), st * sinf(phi)};
      const float solid = lt.env_solid * nan_max(st, 1e-8f);
      const float pdf = nan_max(__ldg(lt.env_pdf + idx) / solid, 1e-12f);
      lop = divs(ld3(lt.env_map, idx, 3), pdf);
      dist = INFINITY;
      break;
    }
  }
  // nee_shadow_rays
  if (two_sided) {
    const V3 ldir = ld3(lt.direction, L, 3);
    const V3 lpt = add(pt, scale(wi, dist));
    const float cos_theta = dot(sub(lpt, pt), ldir);
    const float sq = nan_max(dist * dist, 1e-12f);
    const float pdf = sq / (__ldg(lt.area + L) *
                            nan_max(fabsf(cos_theta), 1e-8f));
    lop = divs(rad, pdf);
  }
  const V3 albedo = ld3(bsdf_albedo, b, 3);
  const float cos_surf = fabsf(dot(n, wi));
  const float c = cos_surf / PI_F;
  Sample s;
  s.li = scale(mul(scale(mul(imp, albedo), c), lop), weight);
  s.ok = valid && __ldg(bsdf_fn + b) == BSDF_DIFFUSE && dist > 1e-2f &&
         cos_surf > 1e-2f;
  if (!s.ok) s.li = ZERO3;
  s.wi = wi;
  // infinite light distances -> the finite no-limit sentinel
  s.max_t = nan_min(dist, T_NO_LIMIT);
  return s;
}

// nee_accum's test: the shadow ray of a sample (max_t) reached its light
// (its trace's t_s; under reference_compat it must also have hit a prim,
// whose index is read only where the distance test passes)
__device__ __forceinline__ bool nee_pass(float t_s, float max_t,
                                         const int* prim_s, long long i,
                                         int reference_compat,
                                         float shadow_eps) {
  bool pass = t_s > max_t - shadow_eps;
  if (reference_compat) pass = pass && prim_s[i] >= 0;
  return pass;
}

#define SAMPLE_UNIFORM 0
#define SAMPLE_COSINE 1
#define SAMPLE_FOLD 2  // w_shared: a uniform sphere direction per lane's u

// The per-BSDF tables
struct Bsdfs {
  const int* fn;
  const float* albedo;
  const float* radiance;
  const float* ior;
};

// The next path segment of a lane: scatter's and the roulette's outputs
struct Path {
  V3 o, d, imp;
  bool valid, ce;
};

// scatter (+ roulette on its draw ``u_rr`` where ``has_rr``): the next
// direction at hit ``h`` of a path with importance ``imp_in``, from the
// hemisphere (or shared) uniforms (u0, u1) and the Fresnel pick's ``u_f``
__device__ __forceinline__ Path scatter_at(const Hit& h, V3 imp_in, float u0,
                                           float u1, float u_f, bool has_rr,
                                           float u_rr, int mode,
                                           const Bsdfs& bs,
                                           float origin_eps) {
  const long long b = h.bsdf;
  const int fn = __ldg(bs.fn + b);
  const V3 albedo = ld3(bs.albedo, b, 3);
  const float ior = __ldg(bs.ior + b);
  const V3 n = h.n, dpdu = h.dpdu, dpdv = h.dpdv, wo = h.wo;

  // the plain version computes every lobe and selects by tag; a lane
  // computes only the lobe it takes (the same ops, so the same bits)
  V3 d_new, thr;
  bool transmit = false;
  if (fn == BSDF_DIFFUSE) {
    if (mode == SAMPLE_FOLD) {
      const V3 w = spherical(u0, u1);
      d_new = scale(w, dot(w, n) >= 0.0f ? 1.0f : -1.0f);
      thr = scale(albedo, 2.0f * fabsf(dot(d_new, n)));
    } else if (mode == SAMPLE_COSINE) {
      const float r = sqrtf(u0);
      const float phi = TWO_PI_F * u1;
      const V3 dl = V3{r * cosf(phi), r * sinf(phi), sqrtf(1.0f - u0)};
      thr = albedo;
      d_new = to_world(dl, dpdu, dpdv, n);
    } else {
      const V3 s = spherical(u0, u1);
      d_new = to_world(V3{s.x, s.y, fabsf(s.z)}, dpdu, dpdv, n);
      thr = scale(albedo, 2.0f * fabsf(dot(d_new, n)));
    }
  } else {
    // ---- mirror ----
    const V3 d_mir = to_world(V3{-wo.x, -wo.y, wo.z}, dpdu, dpdv, n);
    if (fn == BSDF_MIRROR) {
      d_new = d_mir;
      thr = albedo;
    } else {
      // ---- refraction / glass (a backface hit means the ray exits);
      // an emitter takes the glass lobe, with a weight of 0 below ----
      const float cos_o = clampf(wo.z, 1e-6f, 1.0f);
      const float eta = h.backface ? ior : 1.0f / ior;
      const float sin2_t =
          (eta * eta) * nan_max(1.0f - cos_o * cos_o, 0.0f);
      const bool tir = sin2_t >= 1.0f;
      const float cos_t = sqrtf(nan_max(1.0f - sin2_t, 0.0f));
      const V3 d_refr =
          tir ? d_mir
              : to_world(V3{-eta * wo.x, -eta * wo.y, -cos_t}, dpdu, dpdv,
                         n);
      const float rs = tir ? 1.0f : eta * eta;
      const V3 albedo_rs = scale(albedo, rs);
      if (fn == BSDF_REFRACTION) {
        d_new = d_refr;
        thr = tir ? albedo : albedo_rs;
        transmit = !tir;
      } else {
        // Fresnel (Schlick) for the glass lobe choice
        float r0 = (1.0f - ior) / (1.0f + ior);
        r0 = r0 * r0;
        const float x = 1.0f - cos_o;
        const float x2 = x * x;
        const float fres = tir ? 1.0f : r0 + (1.0f - r0) * (x * (x2 * x2));
        const bool pick_reflect = u_f < fres;
        d_new = pick_reflect ? d_mir : d_refr;
        thr = pick_reflect ? ld3(bs.radiance, b, 3) : albedo_rs;
        transmit = fn == BSDF_GLASS && !pick_reflect && !tir;
      }
    }
  }
  const bool is_delta =
      fn == BSDF_MIRROR || fn == BSDF_REFRACTION || fn == BSDF_GLASS;
  // emitters terminate the path
  const bool is_emit = fn == BSDF_EMISSION;
  if (is_emit) thr = ZERO3;
  V3 imp = mul(imp_in, thr);
  // transmissive lobes offset through the surface
  const V3 offs = transmit ? scale(n, -origin_eps) : scale(n, origin_eps);
  Path q;
  q.o = add(h.pt, offs);
  bool valid = h.valid && !is_emit && amax3(imp) > 0.0f;
  if (has_rr) {
    // Russian roulette: survive with p = max(importance), reweight by 1/p
    const float p = clampf(amax3(imp), 0.05f, 1.0f);
    valid = valid && u_rr < p;
    imp = divs(imp, p);
  }
  q.d = d_new;
  q.imp = imp;
  q.valid = valid;
  q.ce = is_delta;
  return q;
}

// ---------------------------------------------------------------------------
// the stage kernels
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

__global__ void __launch_bounds__(SBLOCK) shade_hit_kernel(ShadeHitArgs a) {
  const long long i = lane_index();
  if (i >= a.n) return;
  const long long p = a.prim[i];
  const V3 d = ld3(a.d, i, a.d_stride);
  const Hit h = hit_at(ld3(a.o, i, a.o_stride), d, a.t[i], p,
                       a.shade_packed, a.num_prims, a.origin_eps);
  a.valid_out[i] = h.valid;
  st3(a.pt, i, h.pt);
  st3(a.nrm, i, h.n);
  st3(a.dpdu, i, h.dpdu);
  st3(a.dpdv, i, h.dpdv);
  st3(a.wo_local, i, h.wo);
  a.bsdf[i] = h.bsdf;
  a.t_out[i] = h.t;
  a.backface[i] = h.backface;
  if (a.emission) {
    const V3 l = emission_at(
        ld3(a.light, i, a.light_stride), h, p, d,
        ld3(a.importance, i, a.imp_stride), a.count_emission[i], a.bsdf_fn,
        a.bsdf_radiance, a.valid, i, a.has_env, a.env_map, a.env_h, a.env_w);
    st3(a.light_out, i, l);
  }
}

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
  const Lights lt{a.light_radiance, a.light_position, a.light_direction,
                  a.light_dim_x, a.light_dim_y, a.light_area, a.env_map,
                  a.env_cdf, a.env_pdf, a.env_h, a.env_w, a.env_solid};
  const Sample s = nee_sample(
      ld3(a.pt, i, a.pt_stride), ld3(a.nrm, i, a.nrm_stride), a.bsdf[i],
      a.valid[i], ld3(a.importance, i, a.imp_stride), a.u[i * a.u_stride],
      a.u[i * a.u_stride + 1], a.light, a.kind, a.two_sided, a.weight, lt,
      a.bsdf_fn, a.bsdf_albedo);
  st3(a.wi, i, s.wi);
  a.max_t[i] = s.max_t;
  st3(a.li, i, s.li);
  a.ok[i] = s.ok;
}

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
  const bool pass = nee_pass(a.t_s[i], a.max_t[i], a.prim_s, i,
                             a.reference_compat, a.shadow_eps);
  const V3 l = ld3(a.light, i, a.light_stride);
  const V3 add_ = (a.ok[i] && pass) ? ld3(a.li, i, a.li_stride) : ZERO3;
  st3(a.light_out, i, add(l, add_));
}

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
  Hit h;
  h.bsdf = a.bsdf[i];
  h.n = ld3(a.nrm, i, a.nrm_stride);
  h.dpdu = ld3(a.dpdu, i, a.dpdu_stride);
  h.dpdv = ld3(a.dpdv, i, a.dpdv_stride);
  h.wo = ld3(a.wo_local, i, a.wo_stride);
  h.backface = a.backface[i];
  h.pt = ld3(a.pt, i, a.pt_stride);
  h.valid = a.valid[i];
  const Bsdfs bs{a.bsdf_fn, a.bsdf_albedo, a.bsdf_radiance, a.bsdf_ior};
  const Path q = scatter_at(h, ld3(a.importance, i, a.imp_stride),
                            a.u[i * a.u_stride], a.u[i * a.u_stride + 1],
                            a.u_fresnel[i], a.u_rr != nullptr,
                            a.u_rr ? a.u_rr[i] : 0.0f, a.mode, bs,
                            a.origin_eps);
  st3(a.o_out, i, q.o);
  st3(a.d_out, i, q.d);
  st3(a.imp_out, i, q.imp);
  a.valid_out[i] = q.valid;
  a.count_emission[i] = q.ce;
}

// ---------------------------------------------------------------------------
// the fused chain: one kernel after each trace of a depth
// ---------------------------------------------------------------------------

// What a gap does (the template flag F of its kernel):
#define G_OPEN 1      // after the closest-hit trace: the emission and the
                      // environment's miss radiance (where emission is on)
#define G_ACCUM 2     // accumulate the sample whose shadow trace just ran,
                      // recomputed from the hit and its draw ...
#define G_STORED 4    // ... or read as the gap before stored it (no hit)
#define G_SAMPLE 8    // draw the next sample's shadow ray
#define G_STORE 16    // ... and store its li for an ACCUM|STORED gap
#define G_SCATTER 32  // scatter + roulette: the next path segment

// One NEE sample of the chain: its light and its uniforms
struct NeeDraw {
  const float* u;  // [N, 2]
  long long u_stride;
  long long light;
  int kind;  // LIGHT_*
  int two_sided;  // compat_two_sided on an area light
  float weight;
};

struct GapArgs {
  long long n;
  // the depth's rays and their closest hits
  const float* o;
  long long o_stride;  // 0 for the camera's expand
  const float* d;
  long long d_stride;
  const float* t;
  const int* prim;
  const uint8_t* valid;  // the carry's: the environment's miss test
  const float* importance;
  long long imp_stride;
  const float* light;
  long long light_stride;
  const uint8_t* count_emission;
  // the sample accumulated (ACCUM): its shadow trace's t_s and prim_s,
  // and (STORED) its max_t, li and ok as the gap before wrote them
  const float* t_s;
  const int* prim_s;
  const float* max_t;
  const float* li;
  long long li_stride;
  const uint8_t* ok;
  NeeDraw acc;  // the sample accumulated (ACCUM, not STORED)
  NeeDraw smp;  // the sample drawn (SAMPLE)
  // scatter's uniforms (SCATTER)
  const float* u;  // [N, 2]: the hemisphere draw, or the shared draw
  long long u_stride;
  const float* u_fresnel;  // [N]
  const float* u_rr;  // [N], or null: no roulette at this depth
  // tables
  const float* shade_packed;  // [P, 32]
  long long num_prims;
  const int* bsdf_fn;
  const float* bsdf_albedo;
  const float* bsdf_radiance;
  const float* bsdf_ior;
  const float* light_radiance;
  const float* light_position;
  const float* light_direction;
  const float* light_dim_x;
  const float* light_dim_y;
  const float* light_area;
  const float* env_map;  // [H, W, 3]
  const float* env_cdf;  // [H * W]
  const float* env_pdf;
  long long env_h, env_w;
  // outputs
  float* light_out;  // ACCUM, or OPEN where emission
  float* s_o;  // the shadow ray (SAMPLE; its o, the hit's pt, under OPEN)
  float* s_d;
  float* s_max_t;
  float* s_li;  // STORE
  uint8_t* s_ok;
  float* o_out;  // the next segment (SCATTER)
  float* d_out;
  float* imp_out;
  uint8_t* valid_out;
  uint8_t* ce_out;
  int variant;  // the entry of GAP_VARIANTS launched
  int emission;  // not reference_compat: emission, and the map where has_env
  int has_env;
  int reference_compat;
  int mode;  // SAMPLE_*
  float origin_eps;
  float shadow_eps;
  // float32((2 pi / w) * (pi / h)), folded in double as the plain version
  float env_solid;
};

template <int F>
__device__ __forceinline__ void gap(const GapArgs& a) {
  const long long i = lane_index();
  if (i >= a.n) return;
  if (F & G_STORED) {
    const bool take =
        __ldg(a.ok + i) && nee_pass(__ldg(a.t_s + i), __ldg(a.max_t + i),
                                    a.prim_s, i, a.reference_compat,
                                    a.shadow_eps);
    st3(a.light_out, i,
        add(ld3(a.light, i, a.light_stride),
            take ? ld3(a.li, i, a.li_stride) : ZERO3));
    return;
  }
  // every input first, through the read-only cache: the loads are in
  // flight together ahead of the arithmetic, and no store comes between
  const long long p = __ldg(a.prim + i);
  const float t = __ldg(a.t + i);
  const V3 o = ld3(a.o, i, a.o_stride), d = ld3(a.d, i, a.d_stride);
  const V3 imp = ld3(a.importance, i, a.imp_stride);
  const bool emission = (F & G_OPEN) && a.emission;
  const bool has_light = (F & G_ACCUM) || emission;
  V3 l = has_light ? ld3(a.light, i, a.light_stride) : ZERO3;
  const bool ce = emission && __ldg(a.count_emission + i);
  float t_s = 0.0f, ua0 = 0.0f, ua1 = 0.0f, us0 = 0.0f, us1 = 0.0f;
  float u0 = 0.0f, u1 = 0.0f, u_f = 0.0f, u_rr = 0.0f;
  if (F & G_ACCUM) {
    t_s = __ldg(a.t_s + i);
    ua0 = __ldg(a.acc.u + i * a.acc.u_stride);
    ua1 = __ldg(a.acc.u + i * a.acc.u_stride + 1);
  }
  if (F & G_SAMPLE) {
    us0 = __ldg(a.smp.u + i * a.smp.u_stride);
    us1 = __ldg(a.smp.u + i * a.smp.u_stride + 1);
  }
  if (F & G_SCATTER) {
    u0 = __ldg(a.u + i * a.u_stride);
    u1 = __ldg(a.u + i * a.u_stride + 1);
    u_f = __ldg(a.u_fresnel + i);
    if (a.u_rr) u_rr = __ldg(a.u_rr + i);
  }

  const Lights lt{a.light_radiance, a.light_position, a.light_direction,
                  a.light_dim_x, a.light_dim_y, a.light_area, a.env_map,
                  a.env_cdf, a.env_pdf, a.env_h, a.env_w, a.env_solid};
  const Hit h =
      hit_at(o, d, t, p, a.shade_packed, a.num_prims, a.origin_eps);
  if (emission)
    l = emission_at(l, h, p, d, imp, ce, a.bsdf_fn, a.bsdf_radiance,
                    a.valid, i, a.has_env, a.env_map, a.env_h, a.env_w);
  if (F & G_ACCUM) {
    const NeeDraw& k = a.acc;
    const Sample s = nee_sample(h.pt, h.n, h.bsdf, h.valid, imp, ua0, ua1,
                                k.light, k.kind, k.two_sided, k.weight, lt,
                                a.bsdf_fn, a.bsdf_albedo);
    const bool take = s.ok && nee_pass(t_s, s.max_t, a.prim_s, i,
                                       a.reference_compat, a.shadow_eps);
    l = add(l, take ? s.li : ZERO3);
  }
  if (F & G_SAMPLE) {
    const NeeDraw& k = a.smp;
    const Sample s = nee_sample(h.pt, h.n, h.bsdf, h.valid, imp, us0, us1,
                                k.light, k.kind, k.two_sided, k.weight, lt,
                                a.bsdf_fn, a.bsdf_albedo);
    // a depth's shadow rays share their origin: written by its first
    if (F & G_OPEN) st3(a.s_o, i, h.pt);
    st3(a.s_d, i, s.wi);
    a.s_max_t[i] = s.max_t;
    a.s_ok[i] = s.ok;
    if (F & G_STORE) st3(a.s_li, i, s.li);
  }
  if (F & G_SCATTER) {
    const Bsdfs bs{a.bsdf_fn, a.bsdf_albedo, a.bsdf_radiance, a.bsdf_ior};
    const Path q = scatter_at(h, imp, u0, u1, u_f, a.u_rr != nullptr, u_rr,
                              a.mode, bs, a.origin_eps);
    st3(a.o_out, i, q.o);
    st3(a.d_out, i, q.d);
    st3(a.imp_out, i, q.imp);
    a.valid_out[i] = q.valid;
    a.ce_out[i] = q.ce;
  }
  if (has_light) st3(a.light_out, i, l);
}

// Each gap's kernel carries the word of the stage it opens: shade_hit
// after a depth's closest-hit trace, nee_accum after a shadow trace
template <int F>
__global__ void __launch_bounds__(SBLOCK) shade_hit_kernel(GapArgs a) {
  gap<F>(a);
}
template <int F>
__global__ void __launch_bounds__(SBLOCK) nee_accum_kernel(GapArgs a) {
  gap<F>(a);
}

// The chain's variants: (index, flags, kernel), the order of
// ops/shade_stages.py GAPS
#define GAP_VARIANTS(X)                                \
  X(0, G_OPEN | G_SAMPLE, shade_hit_kernel)            \
  X(1, G_OPEN | G_SAMPLE | G_STORE, shade_hit_kernel)  \
  X(2, G_OPEN | G_SCATTER, shade_hit_kernel)           \
  X(3, G_OPEN, shade_hit_kernel)                       \
  X(4, G_ACCUM | G_SAMPLE, nee_accum_kernel)           \
  X(5, G_ACCUM | G_SAMPLE | G_STORE, nee_accum_kernel) \
  X(6, G_ACCUM | G_SCATTER, nee_accum_kernel)          \
  X(7, G_ACCUM | G_STORED, nee_accum_kernel)

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

// the gap kernel of variant a->variant; -1 for no such variant
extern "C" int shade_gap(const GapArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  switch (a->variant) {
#define GAP_LAUNCH(v, f, k)                                           \
  case v:                                                             \
    k<f><<<blocks_for(a->n), SBLOCK, 0, (cudaStream_t)stream>>>(*a);  \
    break;
    GAP_VARIANTS(GAP_LAUNCH)
#undef GAP_LAUNCH
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

// sizeof each argument block, for the wrapper's layout check
extern "C" long long shade_args_size(int which) {
  switch (which) {
    case 0: return (long long)sizeof(ShadeHitArgs);
    case 1: return (long long)sizeof(NeePrepArgs);
    case 2: return (long long)sizeof(NeeAccumArgs);
    case 3: return (long long)sizeof(ScatterArgs);
    default: return (long long)sizeof(GapArgs);
  }
}
