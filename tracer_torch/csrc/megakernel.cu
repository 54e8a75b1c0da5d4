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
// Design: one thread per pixel, looping over its samples; the bounce loop
// breaks when the path misses or dies, as the reference's own per-thread
// CUDA loop did (this replaces the TPU's per-lane path regeneration). The
// scene lives in SoA float32 tables in global memory
// (tracer_torch/kernels/pack.py), read through the read-only cache;
// the texture is one [th, tw, 3] float32 layer in global memory.
//
// What bounds it on this card: FP32 ALU work — about 199 ray-primitive
// tests per bounce on the canonical scene, each a few dozen FLOPs — and
// warp divergence (threads of a warp finish paths at different depths and
// take different material branches), not bytes: the tables are ~25 KB and
// stay cached. This first version does nothing about that yet (no shared
// memory staging, no ray sorting, no path regeneration).
//
// Record mode (record_kernel, entry tracer_megakernel_record) replaces the
// same TPU kernel with record_idx=True (tracer/pallas/kernels.py:411-452,
// entry tracer/pallas/megakernel.py:render_frame_pallas_record): the same
// paths, plus the tapes the backward kernel replays. Each (sample, bounce)
// a path reaches stores its slot directly: the winner index into
// idx_tape[(s*D + d)*N + pixel] and, for a textured hit, the texture fields
// into tex_tape[((f*spp + s)*D + d)*N + pixel], field-major (fields 0-2
// texel, 3-5 tw*dT/dpx, 6-8 -th*dT/dpy, 9-12 x0, y0, fu, fv). The wrapper
// fills the tapes with their neutral values first (-1; 1 for the texel
// fields, 0 for the rest), so misses and unreached slots cost no store;
// the TPU's masked accumulate over the whole tape has no counterpart.
// What bounds it: the forward's FP32 work plus the tape stores, 4 bytes
// per slot and field, written once and coalesced (neighbouring threads
// hold neighbouring pixels). Both kernels run one bounce loop,
// trace_pixel<RECORD>: the tape stores sit under `if constexpr`, so
// render_kernel compiles to the loop without them.
//
// Float semantics: IEEE division and sqrtf (no --use_fast_math); nvcc's
// default FMA contraction is kept, so a ray on a razor-edge tie (polyhedron
// border quads) may take another path than in the plain version — callers
// compare frames by the fraction of agreeing pixels and the frame mean.

#include "common.cuh"

namespace {

constexpr float K_INFINITY = 1e32f;

__device__ __forceinline__ float ld(const float* p, int row, int n, int k) {
  return __ldg(p + (size_t)row * n + k);
}
__device__ __forceinline__ V3 ld3(const float* p, int row, int n, int k) {
  return make_v3(ld(p, row, n, k), ld(p, row + 1, n, k), ld(p, row + 2, n, k));
}

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

// ---- the bounce loop ----

// One pixel's samples: the raw radiance sum into out[lin]. With RECORD,
// every reached slot also stores its winner into idx_tape and, for a
// textured hit, its tape_f texture fields into tex_tape (see the note at
// the top).
template <bool RECORD>
__device__ __forceinline__ void trace_pixel(
    const float* __restrict__ sph, int num_s,
    const float* __restrict__ pla, int num_p,
    const float* __restrict__ join,
    const float* __restrict__ tex, int th, int tw,
    const float* __restrict__ cam,
    float* __restrict__ out,
    int width, int height, int spp, int max_depth,
    uint32_t sample_start, int reference_quirk, int rr_start, int lin,
    int* __restrict__ idx_tape, float* __restrict__ tex_tape, int tape_f) {
  const int npx = width * height;
  const int i = lin % width;  // column
  const int j = lin / width;  // row
  const int n = num_s + num_p;

  const V3 cam_o = ld3(cam, C_OX, 1, 0);
  const V3 p00 = ld3(cam, C_P00X, 1, 0);
  const V3 du = ld3(cam, C_DUX, 1, 0);
  const V3 dv = ld3(cam, C_DVX, 1, 0);
  const V3 bg = ld3(cam, C_BGR, 1, 0);

  // pixel center (camera.cuh:97-109) and base seed (camera.cu:25)
  const V3 pc = add(add(p00, scale(du, (float)i)), scale(dv, (float)j));
  const uint32_t w32 = (uint32_t)width;
  const uint32_t base = wang_hash(reference_quirk ? (uint32_t)i * w32 + (uint32_t)j
                                                  : (uint32_t)j * w32 + (uint32_t)i);

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < spp; ++s) {
    uint32_t seed = wang_hash(base + sample_start + (uint32_t)s);
    const float ox = rand01(seed) - 0.5f;  // x before y
    const float oy = rand01(seed) - 0.5f;
    V3 o = cam_o;
    V3 d = sub(add(add(pc, scale(du, ox)), scale(dv, oy)), cam_o);
    V3 beta = make_v3(1.0f, 1.0f, 1.0f);
    V3 fin = make_v3(0.0f, 0.0f, 0.0f);

    for (int depth = 0; depth < max_depth; ++depth) {
      // -- brute nearest hit: spheres then planes, strict < (lowest index
      //    wins ties), as tracer_torch/render/hit.py's argmin
      const float a = dot(d, d);
      const float inv_a = 1.0f / a;
      float best = K_INFINITY;
      int widx = -1;
      float best_alpha = 0.0f, best_beta = 0.0f;
      for (int k = 0; k < num_s; ++k) {
        const V3 oc = sub(o, ld3(sph, S_CX, num_s, k));
        const float r = ld(sph, S_RADIUS, num_s, k);
        const float half_b = dot(oc, d);
        const float c = dot(oc, oc) - r * r;
        const float disc = half_b * half_b - a * c;
        if (!(disc >= 0.0f)) continue;
        const float sq = sqrtf(disc);
        const float t_near = (-half_b - sq) * inv_a;
        float t = K_INFINITY;
        if (t_near >= T_MIN && t_near <= T_MAX) {
          t = t_near;
        } else {
          const float t_far = (-half_b + sq) * inv_a;
          if (t_far >= T_MIN && t_far <= T_MAX) t = t_far;
        }
        if (t < best) {
          best = t;
          widx = k;
        }
      }
      for (int k = 0; k < num_p; ++k) {
        const V3 nrm = ld3(pla, P_NX, num_p, k);
        const float denom = dot(nrm, d);
        if (!(fabsf(denom) >= DENOM_EPS)) continue;
        const float root = (ld(pla, P_D, num_p, k) - dot(nrm, o)) / denom;
        if (!(root >= T_MIN && root <= T_MAX) || !(root < best)) continue;
        const V3 phv = sub(add(o, scale(d, root)), ld3(pla, P_BX, num_p, k));
        const V3 w = ld3(pla, P_WX, num_p, k);
        const float alpha = dot(w, cross(phv, ld3(pla, P_VX, num_p, k)));
        const float beta_uv = dot(w, cross(ld3(pla, P_UX, num_p, k), phv));
        const int ptype = (int)ld(pla, P_PTYPE, num_p, k);
        bool inside;
        if (ptype == QUAD) {
          inside = alpha >= 0.0f && alpha <= 1.0f && beta_uv >= 0.0f && beta_uv <= 1.0f;
        } else if (ptype == ELLIPSE) {
          const float ea = alpha - 0.5f, eb = beta_uv - 0.5f;
          inside = ea * ea + eb * eb <= 0.25f;
        } else {
          inside = alpha >= 0.0f && beta_uv >= 0.0f && alpha + beta_uv <= 1.0f;
        }
        if (!inside) continue;
        best = root;
        widx = num_s + k;
        best_alpha = alpha;
        best_beta = beta_uv;
      }

      // miss: background, the path ends (camera.cu:226-229); the tape
      // keeps its -1
      if (widx < 0) {
        fin = add(fin, mul(beta, bg));
        break;
      }
      const size_t slot = ((size_t)s * max_depth + depth) * npx + lin;
      if constexpr (RECORD) idx_tape[slot] = widx;

      // -- winner record (sphere.h:46-51, plane.h:84-94)
      const V3 p = add(o, scale(d, best));
      V3 outward;
      float tu, tv;
      if (widx < num_s) {
        outward = sub(p, ld3(sph, S_CX, num_s, widx));
        const float r = ld(sph, S_RADIUS, num_s, widx);
        outward = make_v3(outward.x / r, outward.y / r, outward.z / r);
        // sphere UVs from the outward normal (sphere.h:16-22)
        const float theta = acosf(fminf(fmaxf(outward.y, -1.0f), 1.0f));
        const float phi = atan2f(-outward.z, outward.x) + PI_F;
        tu = phi / TWO_PI_F;
        tv = theta / PI_F;
      } else {
        outward = ld3(pla, P_NX, num_p, widx - num_s);
        tu = best_alpha;
        tv = best_beta;
      }
      const bool front = dot(d, outward) < 0.0f;
      const V3 nrm = front ? outward : neg(outward);

      const int mtype = (int)ld(join, J_MTYPE, n, widx);
      V3 albedo = ld3(join, J_ALB0, n, widx);
      if (tex != nullptr && ld(join, J_TEX_ID, n, widx) >= 0.0f) {
        if constexpr (RECORD) {
          V3 t_du, t_dv;
          float addr[4];
          const V3 texel = sample_bilinear<true>(tex, th, tw, tu, tv, &t_du, &t_dv, addr);
          albedo = mul(albedo, texel);
          const float fields[13] = {texel.x, texel.y, texel.z, t_du.x, t_du.y, t_du.z,
                                    t_dv.x, t_dv.y, t_dv.z, addr[0], addr[1], addr[2], addr[3]};
          const size_t field_stride = (size_t)spp * max_depth * npx;
          for (int f = 0; f < tape_f; ++f) tex_tape[f * field_stride + slot] = fields[f];
        } else {
          albedo = mul(albedo, sample_bilinear<false>(tex, th, tw, tu, tv, nullptr, nullptr,
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
      if (!ok) break;
      beta = mul(beta, att);
      o = new_o;
      d = new_d;

      if (rr_start >= 0) {
        // throughput Russian roulette: one extra draw on every live bounce
        const float u_t = rand01(seed);
        const float pr = fminf(fmaxf(fmaxf(beta.x, fmaxf(beta.y, beta.z)), RR_MIN_P), 1.0f);
        if (depth >= rr_start) {
          if (u_t >= pr) break;
          beta = scale(beta, 1.0f / pr);
        }
      }
    }
    // fold the finished sample into the pixel sum (the renderer's grouping)
    acc_r += fin.x;
    acc_g += fin.y;
    acc_b += fin.z;
  }
  float* px = out + (size_t)lin * 3;
  px[0] = acc_r;
  px[1] = acc_g;
  px[2] = acc_b;
}

// ---- the kernels ----

__global__ void __launch_bounds__(128) render_kernel(
    const float* __restrict__ sph, int num_s,
    const float* __restrict__ pla, int num_p,
    const float* __restrict__ join,
    const float* __restrict__ tex, int th, int tw,
    const float* __restrict__ cam,
    float* __restrict__ out,
    int width, int height, int spp, int max_depth,
    uint32_t sample_start, int reference_quirk, int rr_start) {
  const int lin = blockIdx.x * blockDim.x + threadIdx.x;
  if (lin >= width * height) return;  // ragged last block
  trace_pixel<false>(sph, num_s, pla, num_p, join, tex, th, tw, cam, out, width, height, spp,
                     max_depth, sample_start, reference_quirk, rr_start, lin, nullptr, nullptr,
                     0);
}

__global__ void __launch_bounds__(128) record_kernel(
    const float* __restrict__ sph, int num_s,
    const float* __restrict__ pla, int num_p,
    const float* __restrict__ join,
    const float* __restrict__ tex, int th, int tw,
    const float* __restrict__ cam,
    float* __restrict__ out,
    int width, int height, int spp, int max_depth,
    uint32_t sample_start, int reference_quirk, int rr_start,
    int* __restrict__ idx_tape, float* __restrict__ tex_tape, int tape_f) {
  const int lin = blockIdx.x * blockDim.x + threadIdx.x;
  if (lin >= width * height) return;  // ragged last block
  trace_pixel<true>(sph, num_s, pla, num_p, join, tex, th, tw, cam, out, width, height, spp,
                    max_depth, sample_start, reference_quirk, rr_start, lin, idx_tape, tex_tape,
                    tape_f);
}

}  // namespace

// Plain C entry point, loaded with ctypes by tracer_torch/kernels/megakernel.py.
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// so a refused launch reaches the caller. rr_start < 0 turns roulette off;
// tex == nullptr renders untextured.
extern "C" int tracer_megakernel_render(
    const float* sph, int num_s, const float* pla, int num_p, const float* join,
    const float* tex, int th, int tw, const float* cam, float* out,
    int width, int height, int spp, int max_depth, unsigned int sample_start,
    int reference_quirk, int rr_start, void* stream) {
  const int threads = 128;
  const int pixels = width * height;
  const int blocks = (pixels + threads - 1) / threads;
  render_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      sph, num_s, pla, num_p, join, tex, th, tw, cam, out, width, height, spp, max_depth,
      sample_start, reference_quirk, rr_start);
  return static_cast<int>(cudaGetLastError());
}

// Record mode (record_kernel). idx_tape [spp*max_depth, width*height] and
// tex_tape [tape_f*spp*max_depth, width*height] (nullptr when tex is) come
// filled with their neutral values; tape_f is 9 or 13.
extern "C" int tracer_megakernel_record(
    const float* sph, int num_s, const float* pla, int num_p, const float* join,
    const float* tex, int th, int tw, const float* cam, float* out,
    int width, int height, int spp, int max_depth, unsigned int sample_start,
    int reference_quirk, int rr_start, int* idx_tape, float* tex_tape, int tape_f,
    void* stream) {
  const int threads = 128;
  const int pixels = width * height;
  const int blocks = (pixels + threads - 1) / threads;
  record_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      sph, num_s, pla, num_p, join, tex, th, tw, cam, out, width, height, spp, max_depth,
      sample_start, reference_quirk, rr_start, idx_tape, tex_tape, tape_f);
  return static_cast<int>(cudaGetLastError());
}
