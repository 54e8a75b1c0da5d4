// Forward path-tracing megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel tracer/pallas/kernels.py:_kernel, persistent
// brute branch (the forward path of tracer/pallas/megakernel.py:
// render_frame_pallas), and computes what it computes: per pixel, for the
// global samples sample_start .. sample_start+spp-1, a jittered primary
// ray, then up to max_depth bounces of brute nearest hit + miss/emission
// + the fixed 8-draw material scatter (+ optional Russian roulette), and
// the RAW radiance sum of those samples. Same wang_hash streams, same
// draw order and same tex2D_cpu bilinear sampling as the plain PyTorch
// version (tracer_torch/render/renderer.py:render_frame).
//
// Design: one thread per pixel and one loop per thread, each pass one
// bounce. The thread carries its path (sample s, depth, ray, throughput,
// radiance, seed); when the path ends (a miss, an absorb, a roulette kill
// or max_depth) the same pass folds its radiance into the pixel sum and
// starts sample s+1 from its own seed. This is the TPU kernel's per-lane
// path regeneration (tracer/pallas/kernels.py:181-193, :303-312): a lane
// whose path ends early starts its next sample at once instead of waiting
// for the longest path of its warp, so the warp's passes are the longest
// lane's total bounces over all its samples, not the sum over samples of
// each sample's longest path. Samples fold in ascending s, so every
// (pixel, sample) keeps its draws and the pixel sum the renderer's grouping.
//
// The scene's spheres and planes are array-of-records float4 tables
// (tracer_torch/kernels/pack.py, offsets in common.cuh): a sphere is one
// float4, a plane five. In the SMEM instantiations the block copies them
// into shared memory at its start, and the nearest-hit loop reads one
// broadcast float4 per sphere and up to five per plane, where scalar rows
// took four and 17 loads; a scene above the wrapper's
// TABLE_SHARED_BYTES_MAX reads the same records from global memory with
// float4 __ldg. The materials stay in the struct-of-arrays join table
// (each lane gathers only its winner's column); the texture is one
// [th, tw, 3] float32 layer in global memory.
//
// What bounds it on this card: FP32 ALU work, about 199 ray-primitive
// tests per nearest-hit query on the canonical scene, each a few dozen
// FLOPs, and the lanes a warp leaves idle: threads finish their samples
// at different times, and take different material branches. Not bytes:
// the tables are ~10 KB.
//
// Record mode (RECORD, entry mode 1) replaces the same TPU kernel with
// record_idx=True (tracer/pallas/kernels.py:411-452, entry tracer/pallas/
// megakernel.py:render_frame_pallas_record): the same paths, plus the
// tapes the backward kernel replays. Each (sample, bounce) a path reaches
// stores its slot directly: the winner index into idx_tape[(s*D + d)*N +
// pixel] and, for a textured hit, the texture fields into
// tex_tape[((f*spp + s)*D + d)*N + pixel], field-major (fields 0-2 texel,
// 3-5 tw*dT/dpx, 6-8 -th*dT/dpy, 9-12 x0, y0, fu, fv). The wrapper fills
// the tapes with their neutral values first (-1; 1 for the texel fields,
// 0 for the rest), so misses and unreached slots cost no store; the TPU's
// masked accumulate over the whole tape has no counterpart. What bounds
// it: the forward's FP32 work plus the tape prefill and stores, 4 bytes
// per slot and field. With regeneration the lanes of a warp hold
// different (sample, depth) slots, so a warp's tape stores no longer
// coalesce; the layout is the backward kernel's interface and stays.
//
// Cluster-culled mode (CLUSTERED, entry mode 2) replaces the same TPU
// kernel with cluster_k > 0: its nearest hit tracer/pallas/culling.py:
// _intersect_clustered (and _intersect_culled, which finds the same hit
// with other TPU visiting mechanics). Primitives are grouped into clusters
// of at most K (tracer_torch/kernels/cluster.py); per bounce each thread
// slab-tests its own ray against every cluster box and runs the sphere or
// plane test of the brute block on the primitives of the clusters it may
// hit, reading their records through the clusters' slot indices. Culling
// is per ray, not per 128-ray bundle as on the TPU, so the answer does not
// depend on the launch layout. Clusters and slots are visited in
// ascending order with strict <, so ties go to the lowest (cluster, slot),
// as in the TPU's legacy intersector. The slab's upper bound stays
// K_INFINITY, as on the TPU. What bounds it: FP32 work, C slab tests per
// bounce (every thread reads the same box at the same time, so the box
// loads are broadcasts from L1) plus the primitive tests of the visited
// clusters; divergence between threads that visit different clusters.
//
// All three run one bounce loop, trace_pixel<RECORD, CLUSTERED, SMEM,
// COUNT>, and call the same sphere_t / plane_hit; only the nearest-hit
// block's loop and the tape stores are chosen at compile time. The
// counted instantiations (COUNT; the debug_iters counterpart of
// tracer/pallas/kernels.py:62, :107-110) add up the launch's nearest-hit
// queries, hits, cluster visits, primitive tests, warp passes and the
// active lanes of each pass (__popc(__activemask())); timed launches take
// the uncounted ones.
//
// Float semantics: IEEE division and sqrtf (no --use_fast_math); nvcc's
// default FMA contraction is kept, so a ray on a razor-edge tie (polyhedron
// border quads) may take another path than in the plain version — callers
// compare frames by the fraction of agreeing pixels and the frame mean.
// Built with -fmad=false, every instantiation runs the float operations of
// the plain version in its order.

#include "common.cuh"

namespace {

constexpr float K_INFINITY = 1e32f;
constexpr int THREADS = 128;
constexpr int COUNTS = 6;  // COUNT's counters, see Launch::counts
static_assert(P_NX == 0 && P_D == 3 && P_BX == 4 && P_PTYPE == 7 && P_UX == 8 && P_VX == 12 &&
                  P_WX == 16 && S_RADIUS == 3,
              "plane_hit and sphere_t read the records in this order");

__device__ __forceinline__ float ld(const float* p, int row, int n, int k) {
  return __ldg(p + (size_t)row * n + k);
}
__device__ __forceinline__ V3 ld3(const float* p, int row, int n, int k) {
  return make_v3(ld(p, row, n, k), ld(p, row + 1, n, k), ld(p, row + 2, n, k));
}
__device__ __forceinline__ V3 xyz(float4 q) { return make_v3(q.x, q.y, q.z); }

// Everything one launch reads and writes (filled by the C entry point).
struct Launch {
  const float4* sph;  // [num_s] records (SphereRow)
  const float4* pla;  // [num_p * PLANE_F4] records (PlaneRow)
  int num_s, num_p;
  const float* join;  // [J_ROWS, num_s + num_p]
  const float* tex;   // [th, tw, 3] or nullptr
  int th, tw;
  const float* cam;   // [C_ROWS]
  float* out;         // [width * height, 3] raw sums
  int width, height, spp, max_depth;
  uint32_t sample_start;
  int reference_quirk, rr_start;
  int* idx_tape;      // RECORD: [spp * max_depth, npx]
  float* tex_tape;    // RECORD: [tape_f * spp * max_depth, npx] or nullptr
  int tape_f;
  const float* boxes;  // CLUSTERED: [6, num_clusters] lo x, y, z, hi x, y, z
  const int* slots;    // CLUSTERED: [num_clusters * k], -1 pads a cluster's end
  int num_clusters, k;
  // COUNT: [COUNTS] sums over the launch: nearest-hit queries, hits,
  // clusters visited, primitives tested, warp passes, active lanes
  unsigned long long* counts;
};

// The primitive records, in shared memory (SMEM) or read through the
// read-only cache.
template <bool SMEM>
struct Prims {
  const float4* sph;
  const float4* pla;
  int num_s, num_p;
  __device__ __forceinline__ float4 sphere(int k) const {
    if constexpr (SMEM) return sph[k]; else return __ldg(sph + k);
  }
  __device__ __forceinline__ float4 plane(int k, int q) const {
    if constexpr (SMEM) return pla[k * PLANE_F4 + q]; else return __ldg(pla + k * PLANE_F4 + q);
  }
};

// ---- texture: reference tex2D_cpu (include/materials.h:20-51) ----

// The bilinear texel at (u, v). With TAPE, also the recording tape's
// fields: the texel's exact d/du and d/dv (bilinear is separately linear
// in px and py) as tw*dT/dpx and -th*dT/dpy, and the addressing (x0, y0,
// fu, fv).
template <bool TAPE>
__device__ __forceinline__ V3 sample_bilinear(const float* tex, int th, int tw, float u, float v,
                                              V3* d_u, V3* d_v, float* addr) {
  u = u - floorf(u);
  v = v - floorf(v);
  float px = u * (float)tw;
  float py = (1.0f - v) * (float)th;
  // truncation == floor for px >= 0; float rounding can land on tw
  int x0 = min(max((int)px, 0), tw - 1);
  int y0 = min(max((int)py, 0), th - 1);
  int x1 = (x0 + 1) % tw;
  int y1 = (y0 + 1) % th;
  float dx = px - (float)x0;
  float dy = py - (float)y0;
  const float* r0 = tex + (size_t)y0 * tw * 3;
  const float* r1 = tex + (size_t)y1 * tw * 3;
  float out[3], gu[3], gv[3];
  for (int c = 0; c < 3; ++c) {
    float c00 = __ldg(r0 + x0 * 3 + c), c10 = __ldg(r0 + x1 * 3 + c);
    float c01 = __ldg(r1 + x0 * 3 + c), c11 = __ldg(r1 + x1 * 3 + c);
    float top = c00 * (1.0f - dx) + c10 * dx;
    float bot = c01 * (1.0f - dx) + c11 * dx;
    out[c] = top * (1.0f - dy) + bot * dy;
    if constexpr (TAPE) {
      gu[c] = ((1.0f - dy) * (c10 - c00) + dy * (c11 - c01)) * (float)tw;
      gv[c] = (bot - top) * -(float)th;
    }
  }
  if constexpr (TAPE) {
    *d_u = make_v3(gu[0], gu[1], gu[2]);
    *d_v = make_v3(gv[0], gv[1], gv[2]);
    addr[0] = (float)x0;
    addr[1] = (float)y0;
    addr[2] = dx;
    addr[3] = dy;
  }
  return make_v3(out[0], out[1], out[2]);
}

// ---- nearest hit: the primitive tests of both nearest-hit blocks ----

// Sphere k's nearest valid root (sphere.h:24-53): the near root, else the
// far one, within [T_MIN, T_MAX]; K_INFINITY for none.
template <bool SMEM>
__device__ __forceinline__ float sphere_t(const Prims<SMEM>& P, int k, V3 o, V3 d, float a,
                                          float inv_a) {
  const float4 s = P.sphere(k);
  const V3 oc = sub(o, xyz(s));
  const float r = s.w;
  const float half_b = dot(oc, d);
  const float c = dot(oc, oc) - r * r;
  const float disc = half_b * half_b - a * c;
  if (!(disc >= 0.0f)) return K_INFINITY;
  const float sq = sqrtf(disc);
  const float t_near = (-half_b - sq) * inv_a;
  if (t_near >= T_MIN && t_near <= T_MAX) return t_near;
  const float t_far = (-half_b + sq) * inv_a;
  if (t_far >= T_MIN && t_far <= T_MAX) return t_far;
  return K_INFINITY;
}

// Plane k (plane.h:57-96): true, with *best, *alpha and *beta set to its
// root and planar coordinates, if its root is valid, nearer than *best and
// inside the quad, ellipse or triangle.
template <bool SMEM>
__device__ __forceinline__ bool plane_hit(const Prims<SMEM>& P, int k, V3 o, V3 d, float* best,
                                          float* alpha_out, float* beta_out) {
  const float4 nd = P.plane(k, 0);  // normal, d
  const V3 nrm = xyz(nd);
  const float denom = dot(nrm, d);
  if (!(fabsf(denom) >= DENOM_EPS)) return false;
  const float root = (nd.w - dot(nrm, o)) / denom;
  if (!(root >= T_MIN && root <= T_MAX) || !(root < *best)) return false;
  const float4 bt = P.plane(k, 1);  // base, type
  const V3 phv = sub(add(o, scale(d, root)), xyz(bt));
  const V3 w = xyz(P.plane(k, 4));
  const float alpha = dot(w, cross(phv, xyz(P.plane(k, 3))));
  const float beta_uv = dot(w, cross(xyz(P.plane(k, 2)), phv));
  const int ptype = (int)bt.w;
  bool inside;
  if (ptype == QUAD) {
    inside = alpha >= 0.0f && alpha <= 1.0f && beta_uv >= 0.0f && beta_uv <= 1.0f;
  } else if (ptype == ELLIPSE) {
    const float ea = alpha - 0.5f, eb = beta_uv - 0.5f;
    inside = ea * ea + eb * eb <= 0.25f;
  } else {
    inside = alpha >= 0.0f && beta_uv >= 0.0f && alpha + beta_uv <= 1.0f;
  }
  if (!inside) return false;
  *best = root;
  *alpha_out = alpha;
  *beta_out = beta_uv;
  return true;
}

// The slab test's inverse direction, |d| guarded at 1e-30 (culling.py:33-38).
__device__ __forceinline__ float guarded_inv(float x) {
  return 1.0f / (fabsf(x) < 1e-30f ? (x < 0.0f ? -1e-30f : 1e-30f) : x);
}

// ---- the bounce loop ----

// One pixel's samples: the raw radiance sum into L.out[lin], one bounce
// per pass of one loop (see the note at the top). With RECORD, every
// reached slot also stores its winner into the index tape and, for a
// textured hit, its tape_f texture fields into the texture tape. With
// CLUSTERED, the nearest hit visits the clusters instead of every
// primitive. With COUNT, the launch's work is added to L.counts.
template <bool RECORD, bool CLUSTERED, bool SMEM, bool COUNT>
__device__ __forceinline__ void trace_pixel(const Launch& L, const Prims<SMEM>& P, int lin) {
  const int width = L.width, max_depth = L.max_depth, num_s = P.num_s, num_p = P.num_p;
  const int npx = width * L.height;
  const int i = lin % width;  // column
  const int j = lin / width;  // row
  const int n = num_s + num_p;
  const float* __restrict__ join = L.join;

  const V3 cam_o = ld3(L.cam, C_OX, 1, 0);
  const V3 p00 = ld3(L.cam, C_P00X, 1, 0);
  const V3 du = ld3(L.cam, C_DUX, 1, 0);
  const V3 dv = ld3(L.cam, C_DVX, 1, 0);
  const V3 bg = ld3(L.cam, C_BGR, 1, 0);

  // pixel center (camera.cuh:97-109) and base seed (camera.cu:25)
  const V3 pc = add(add(p00, scale(du, (float)i)), scale(dv, (float)j));
  const uint32_t w32 = (uint32_t)width;
  const uint32_t base = wang_hash(L.reference_quirk ? (uint32_t)i * w32 + (uint32_t)j
                                                    : (uint32_t)j * w32 + (uint32_t)i);

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  uint32_t cnt[COUNTS] = {0, 0, 0, 0, 0, 0};  // COUNT's (dead code without it)
  // the lane's path: sample s at bounce `depth`, ray (o, d), throughput
  // beta, radiance fin, RNG state seed; `ended` starts the next sample
  int s = -1, depth = 0;
  uint32_t seed = 0;
  V3 o = cam_o, d = cam_o, beta = zero3(), fin = zero3();
  bool ended = true;
  for (;;) {
    if (ended) {
      if (s >= 0) {  // fold the finished sample (the renderer's grouping)
        acc_r += fin.x;
        acc_g += fin.y;
        acc_b += fin.z;
      }
      if (++s == L.spp) break;
      seed = wang_hash(base + L.sample_start + (uint32_t)s);
      const float ox = rand01(seed) - 0.5f;  // x before y
      const float oy = rand01(seed) - 0.5f;
      o = cam_o;
      d = sub(add(add(pc, scale(du, ox)), scale(dv, oy)), cam_o);
      beta = make_v3(1.0f, 1.0f, 1.0f);
      fin = zero3();
      depth = 0;
      ended = false;
    }
    if constexpr (COUNT) {
      ++cnt[0];
      const unsigned active = __activemask();
      if ((int)(threadIdx.x & 31) == __ffs(active) - 1) {
        ++cnt[4];
        cnt[5] += __popc(active);
      }
    }

    const float a = dot(d, d);
    const float inv_a = 1.0f / a;
    float best = K_INFINITY;
    int widx = -1;
    float best_alpha = 0.0f, best_beta = 0.0f;
    if constexpr (CLUSTERED) {
      // -- clustered nearest hit: the ray's own slab test against each
      //    cluster box (culling.py:40-60), then the primitives of the
      //    clusters it passes; strict < in (cluster, slot) order
      const float ivx = guarded_inv(d.x), ivy = guarded_inv(d.y), ivz = guarded_inv(d.z);
      const int nc = L.num_clusters;
      const float* __restrict__ boxes = L.boxes;
      for (int c = 0; c < nc; ++c) {
        const float tx1 = (__ldg(boxes + c) - o.x) * ivx;
        const float tx2 = (__ldg(boxes + 3 * nc + c) - o.x) * ivx;
        const float ty1 = (__ldg(boxes + nc + c) - o.y) * ivy;
        const float ty2 = (__ldg(boxes + 4 * nc + c) - o.y) * ivy;
        const float tz1 = (__ldg(boxes + 2 * nc + c) - o.z) * ivz;
        const float tz2 = (__ldg(boxes + 5 * nc + c) - o.z) * ivz;
        const float tmin = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)),
                                 fmaxf(fminf(tz1, tz2), T_MIN));
        const float tmax = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)),
                                 fminf(fmaxf(tz1, tz2), K_INFINITY));
        if (!(tmax > tmin)) continue;
        if constexpr (COUNT) ++cnt[2];
        const int* slot = L.slots + (size_t)c * L.k;
        for (int q = 0; q < L.k; ++q) {
          const int prim = __ldg(slot + q);
          if (prim < 0) break;  // padding fills a cluster's last slots
          if constexpr (COUNT) ++cnt[3];
          if (prim < num_s) {
            const float t = sphere_t(P, prim, o, d, a, inv_a);
            if (t < best) {
              best = t;
              widx = prim;
            }
          } else if (plane_hit(P, prim - num_s, o, d, &best, &best_alpha, &best_beta)) {
            widx = prim;
          }
        }
      }
    } else {
      // -- brute nearest hit: spheres then planes, strict < (lowest index
      //    wins ties), as tracer_torch/render/hit.py's argmin
      for (int k = 0; k < num_s; ++k) {
        const float t = sphere_t(P, k, o, d, a, inv_a);
        if (t < best) {
          best = t;
          widx = k;
        }
      }
      for (int k = 0; k < num_p; ++k) {
        if (plane_hit(P, k, o, d, &best, &best_alpha, &best_beta)) widx = num_s + k;
      }
    }

    if (widx < 0) {
      // miss: background, the path ends (camera.cu:226-229); the tape
      // keeps its -1
      fin = add(fin, mul(beta, bg));
      ended = true;
      continue;
    }
    if constexpr (COUNT) ++cnt[1];
    const size_t slot = ((size_t)s * max_depth + depth) * npx + lin;
    if constexpr (RECORD) L.idx_tape[slot] = widx;

    // -- winner record (sphere.h:46-51, plane.h:84-94)
    const V3 p = add(o, scale(d, best));
    V3 outward;
    float tu, tv;
    if (widx < num_s) {
      const float4 sw = P.sphere(widx);
      outward = sub(p, xyz(sw));
      const float r = sw.w;
      outward = make_v3(outward.x / r, outward.y / r, outward.z / r);
      // sphere UVs from the outward normal (sphere.h:16-22)
      const float theta = acosf(fminf(fmaxf(outward.y, -1.0f), 1.0f));
      const float phi = atan2f(-outward.z, outward.x) + PI_F;
      tu = phi / TWO_PI_F;
      tv = theta / PI_F;
    } else {
      outward = xyz(P.plane(widx - num_s, 0));
      tu = best_alpha;
      tv = best_beta;
    }
    const bool front = dot(d, outward) < 0.0f;
    const V3 nrm = front ? outward : neg(outward);

    const int mtype = (int)ld(join, J_MTYPE, n, widx);
    V3 albedo = ld3(join, J_ALB0, n, widx);
    if (L.tex != nullptr && ld(join, J_TEX_ID, n, widx) >= 0.0f) {
      if constexpr (RECORD) {
        V3 t_du, t_dv;
        float addr[4];
        const V3 texel = sample_bilinear<true>(L.tex, L.th, L.tw, tu, tv, &t_du, &t_dv, addr);
        albedo = mul(albedo, texel);
        const float fields[13] = {texel.x, texel.y, texel.z, t_du.x, t_du.y, t_du.z,
                                  t_dv.x, t_dv.y, t_dv.z, addr[0], addr[1], addr[2], addr[3]};
        const size_t field_stride = (size_t)L.spp * max_depth * npx;
        for (int f = 0; f < L.tape_f; ++f) L.tex_tape[f * field_stride + slot] = fields[f];
      } else {
        albedo = mul(albedo, sample_bilinear<false>(L.tex, L.th, L.tw, tu, tv, nullptr, nullptr,
                                                    nullptr));
      }
    }
    // emission before scatter (camera.cu:237-238)
    fin = add(fin, mul(beta, ld3(join, J_EMI0, n, widx)));

    // -- the fixed 8-draw budget (tracer_torch/materials/scatter.py)
    const float u_choice = rand01(seed);
    V3 hemi = rand_unit_vector(seed);
    if (!(dot(hemi, nrm) > 0.0f)) hemi = neg(hemi);
    const V3 ball_dir = rand_unit_vector(seed);
    const V3 ball = scale(ball_dir, cbrtf(rand01(seed)));
    const float u_refl = rand01(seed);
    const float u_rr = rand01(seed);

    const V3 ud = scale(d, 1.0f / sqrtf(fmaxf(a, 1e-30f)));
    const bool hemi_zero = fabsf(hemi.x) < NEAR_ZERO_EPS && fabsf(hemi.y) < NEAR_ZERO_EPS &&
                           fabsf(hemi.z) < NEAR_ZERO_EPS;
    const V3 lam_dir = hemi_zero ? nrm : hemi;

    bool ok;
    V3 new_o = p, new_d, att = albedo;
    if (mtype == LAMBERTIAN) {  // materials.h:73-79
      ok = true;
      new_d = lam_dir;
    } else if (mtype == METAL) {  // materials.h:81-95
      const float fuzz = ld(join, J_FUZZ, n, widx);
      if (u_choice < METAL_SPECULAR_P) {
        new_d = add(reflect(ud, nrm), scale(ball, fuzz));
        ok = dot(new_d, nrm) > 0.0f;
      } else {
        new_d = lam_dir;
        ok = true;
      }
    } else if (mtype == DIELECTRIC) {  // materials.h:97-133
      const float ir = ld(join, J_IR, n, widx);
      const float ratio = front ? 1.0f / ir : ir;
      const float cos_t = fminf(-dot(ud, nrm), 1.0f);
      const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
      const bool cannot_refract = ratio * sin_t > 1.0f;
      float r0 = (1.0f - ratio) / (1.0f + ratio);
      r0 = r0 * r0;
      const float x = 1.0f - cos_t;
      const float x2 = x * x;
      const float refl_p = r0 + (1.0f - r0) * (x2 * x2 * x);
      if (cannot_refract || refl_p > u_refl) {
        new_d = reflect(ud, nrm);
      } else {
        const V3 perp = scale(add(ud, scale(nrm, cos_t)), ratio);
        const float par = -sqrtf(fabsf(1.0f - dot(perp, perp)));
        new_d = add(perp, scale(nrm, par));
      }
      // Beer-Lambert absorption on back-face exit, then survival roulette
      if (front) {
        att = make_v3(1.0f, 1.0f, 1.0f);
      } else {
        const V3 od = sub(p, o);
        const float dist = sqrtf(dot(od, od));
        att = make_v3(expf(-ld(join, J_ABS0, n, widx) * dist),
                      expf(-ld(join, J_ABS1, n, widx) * dist),
                      expf(-ld(join, J_ABS2, n, widx) * dist));
      }
      const float p_rr = fmaxf(att.x, fmaxf(att.y, att.z));
      ok = u_rr <= p_rr;
      att = scale(att, 1.0f / fmaxf(p_rr, 1e-30f));
      const float side = dot(new_d, nrm) > 0.0f ? 1.0f : -1.0f;
      new_o = add(p, scale(nrm, DIELECTRIC_OFFSET * side));
    } else {  // DIFFUSE_LIGHT absorbs (materials.h:135-137)
      ok = false;
      new_d = lam_dir;
    }
    if (!ok) {
      ended = true;
      continue;
    }
    beta = mul(beta, att);
    o = new_o;
    d = new_d;

    if (L.rr_start >= 0) {
      // throughput Russian roulette: one extra draw on every live bounce
      const float u_t = rand01(seed);
      const float pr = fminf(fmaxf(fmaxf(beta.x, fmaxf(beta.y, beta.z)), RR_MIN_P), 1.0f);
      if (depth >= L.rr_start) {
        if (u_t >= pr) {
          ended = true;
          continue;
        }
        beta = scale(beta, 1.0f / pr);
      }
    }
    ended = ++depth == max_depth;
  }
  float* px = L.out + (size_t)lin * 3;
  px[0] = acc_r;
  px[1] = acc_g;
  px[2] = acc_b;
  if constexpr (COUNT) {
    for (int c = 0; c < COUNTS; ++c) {
      if (cnt[c] != 0) atomicAdd(L.counts + c, (unsigned long long)cnt[c]);
    }
  }
}

// ---- the kernel ----

// K1 (RECORD = CLUSTERED = false), K1-rec (RECORD) and K1-cl (CLUSTERED).
// With SMEM the block first stages the records in dynamic shared memory.
template <bool RECORD, bool CLUSTERED, bool SMEM, bool COUNT>
__global__ void __launch_bounds__(THREADS) trace_kernel(const Launch L) {
  extern __shared__ float4 records[];
  Prims<SMEM> P{L.sph, L.pla, L.num_s, L.num_p};
  if constexpr (SMEM) {
    const int n4 = L.num_s * SPHERE_F4 + L.num_p * PLANE_F4;
    const int ns4 = L.num_s * SPHERE_F4;
    for (int q = threadIdx.x; q < n4; q += blockDim.x) {
      if (q < ns4) {
        records[q] = __ldg(L.sph + q);
      } else {
        records[q] = __ldg(L.pla + (q - ns4));
      }
    }
    __syncthreads();
    P.sph = records;
    P.pla = records + ns4;
  }
  const int lin = blockIdx.x * blockDim.x + threadIdx.x;
  if (lin >= L.width * L.height) return;  // ragged last block
  trace_pixel<RECORD, CLUSTERED, SMEM, COUNT>(L, P, lin);
}

template <bool RECORD, bool CLUSTERED, bool SMEM, bool COUNT>
int launch(const Launch& L, cudaStream_t st) {
  const int blocks = (L.width * L.height + THREADS - 1) / THREADS;
  const size_t bytes = SMEM ? sizeof(float4) * ((size_t)L.num_s * SPHERE_F4 +
                                                (size_t)L.num_p * PLANE_F4) : 0;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(trace_kernel<RECORD, CLUSTERED, SMEM, COUNT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  trace_kernel<RECORD, CLUSTERED, SMEM, COUNT><<<blocks, THREADS, bytes, st>>>(L);
  return static_cast<int>(cudaGetLastError());
}

template <bool RECORD, bool CLUSTERED>
int launch_mode(const Launch& L, bool smem, cudaStream_t st) {
  if (L.counts != nullptr) {
    return smem ? launch<RECORD, CLUSTERED, true, true>(L, st)
                : launch<RECORD, CLUSTERED, false, true>(L, st);
  }
  return smem ? launch<RECORD, CLUSTERED, true, false>(L, st)
              : launch<RECORD, CLUSTERED, false, false>(L, st);
}

}  // namespace

// Plain C entry point, loaded with ctypes by tracer_torch/kernels/megakernel.py.
// mode 0 renders (K1), 1 records (K1-rec: idx_tape [spp*max_depth,
// width*height] and tex_tape [tape_f*spp*max_depth, width*height], nullptr
// when tex is, come filled with their neutral values; tape_f is 9 or 13),
// 2 renders cluster-culled (K1-cl: boxes [6, num_clusters] and slots
// [num_clusters * k] as tracer_torch/kernels/cluster.py packs them). sph
// and pla are 16-byte aligned record tables (tracer_torch/kernels/pack.py);
// shared_tables stages them in shared memory. counts is nullptr (the
// uncounted kernels) or COUNTS zeroed counters (the counted ones).
// rr_start < 0 turns roulette off; tex == nullptr renders untextured.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() so a refused launch reaches the caller.
extern "C" int tracer_megakernel_launch(
    int mode, const float* sph, int num_s, const float* pla, int num_p, const float* join,
    const float* tex, int th, int tw, const float* cam, float* out,
    int width, int height, int spp, int max_depth, unsigned int sample_start,
    int reference_quirk, int rr_start, int* idx_tape, float* tex_tape, int tape_f,
    const float* boxes, const int* slots, int num_clusters, int k, int shared_tables,
    unsigned long long* counts, void* stream) {
  const Launch L{reinterpret_cast<const float4*>(sph), reinterpret_cast<const float4*>(pla),
                 num_s, num_p, join, tex, th, tw, cam, out, width, height, spp, max_depth,
                 sample_start, reference_quirk, rr_start, idx_tape, tex_tape, tape_f,
                 boxes, slots, num_clusters, k, counts};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool smem = shared_tables != 0;
  switch (mode) {
    case 0: return launch_mode<false, false>(L, smem, st);
    case 1: return launch_mode<true, false>(L, smem, st);
    case 2: return launch_mode<false, true>(L, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
