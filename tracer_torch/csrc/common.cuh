// Shared by the CUDA sources of tracer_torch/csrc: the float constants of
// the renderer, the table rows of tracer_torch/kernels/pack.py, the 3-vector
// helpers and the bit-exact RNG streams of tracer.core.rng (reference
// random_utils.h:7-23). kernels/nvcc.py hashes every *.cuh into each
// library's name, so an edit here rebuilds every kernel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float T_MIN = 1e-3f;
constexpr float T_MAX = 1e30f;
constexpr float DENOM_EPS = 1e-8f;
constexpr float NEAR_ZERO_EPS = 1e-8f;
constexpr float RR_MIN_P = 0.05f;
constexpr float METAL_SPECULAR_P = 0.8f;
constexpr float DIELECTRIC_OFFSET = 1e-4f;
constexpr float INV_2_32 = 2.3283064365386963e-10f;  // 2^-32
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;

// Forward tables: must match tracer_torch/kernels/pack.py (a CPU test checks).
// A sphere's and a plane's fields are one row each of an array-of-records
// table, read as float4s: a sphere is one float4 (centre, radius), a plane
// five (normal and d first: the test's early exits read only that one).
enum SphereRow { S_CX, S_CY, S_CZ, S_RADIUS, S_ROWS };
enum PlaneRow {
  P_NX, P_NY, P_NZ, P_D, P_BX, P_BY, P_BZ, P_PTYPE, P_UX, P_UY, P_UZ, P_PAD0,
  P_VX, P_VY, P_VZ, P_PAD1, P_WX, P_WY, P_WZ, P_PAD2, P_ROWS
};
constexpr int SPHERE_F4 = S_ROWS / 4;  // float4s per record
constexpr int PLANE_F4 = P_ROWS / 4;
static_assert(S_ROWS % 4 == 0 && P_ROWS % 4 == 0, "records are whole float4s");
enum JoinRow {
  J_MTYPE, J_FUZZ, J_IR, J_ABS0, J_ABS1, J_ABS2, J_ALB0, J_ALB1, J_ALB2,
  J_EMI0, J_EMI1, J_EMI2, J_TEX_ID, J_ROWS
};
enum CameraRow {
  C_OX, C_OY, C_OZ, C_P00X, C_P00Y, C_P00Z, C_DUX, C_DUY, C_DUZ,
  C_DVX, C_DVY, C_DVZ, C_BGR, C_BGG, C_BGB, C_ROWS
};
// K1-bvh's RTIOW instantiation reads these rows after the camera's C_ROWS:
// the lens basis times its radius, whether there is a lens, the sky's
// bottom and top, whether there is a sky. Must match pack.py RTIOW_ROWS.
enum RtiowRow {
  R_LUX, R_LUY, R_LUZ, R_LVX, R_LVY, R_LVZ, R_LENS_ON,
  R_SBR, R_SBG, R_SBB, R_STR, R_STG, R_STB, R_SKY_ON, R_ROWS
};
// Backward table and camera rows: must match pack.py BWD_ROWS and CAMV_ROWS.
enum TableRow {
  T_CX, T_CY, T_CZ, T_RAD, T_NX, T_NY, T_NZ, T_ISSPH, T_MTYPE, T_FUZZ, T_IR,
  T_ABS0, T_ABS1, T_ABS2, T_ALB0, T_ALB1, T_ALB2, T_EMI0, T_EMI1, T_EMI2, T_TEXID,
  T_PD, T_AX, T_AY, T_AZ, T_BX, T_BY, T_BZ, T_BA, T_BB, T_ROWS
};
enum CamvRow {
  V_P00X, V_P00Y, V_P00Z, V_DUX, V_DUY, V_DUZ, V_DVX, V_DVY, V_DVZ,
  V_OX, V_OY, V_OZ, V_BGR, V_BGG, V_BGB, V_ROWS
};

enum PlaneType { QUAD = 0, ELLIPSE = 1, TRIANGLE = 2 };
// RTIOW_*: the RTIOW book's Lambertian and metal (scene/types.py), rendered
// by K1-bvh's RTIOW instantiation only
enum MaterialType { LAMBERTIAN = 0, METAL = 1, DIELECTRIC = 2, RTIOW_LAMBERTIAN = 4,
                    RTIOW_METAL = 5 };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 make_v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 zero3() { return make_v3(0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return make_v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return make_v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return make_v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return make_v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 neg(V3 a) { return make_v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return make_v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
// v - 2 (v.n) n   (reference include/vec3.h:63)
__device__ __forceinline__ V3 reflect(V3 v, V3 n) { return sub(v, scale(n, 2.0f * dot(v, n))); }

// ---- RNG ----

__device__ __forceinline__ uint32_t wang_hash(uint32_t s) {
  s = (s ^ 61u) ^ (s >> 16);
  s *= 9u;
  s = s ^ (s >> 4);
  s *= 0x27D4EB2Du;
  s = s ^ (s >> 15);
  return s;
}

// u = float(seed) / 2^32 with ONE rounding (as the XLA path's cast)
__device__ __forceinline__ float rand01(uint32_t& s) {
  s = wang_hash(s);
  return __uint2float_rn(s) * INV_2_32;
}

// uniform on the unit sphere: z in [-1, 1), phi in [0, 2pi); 2 draws
__device__ __forceinline__ V3 rand_unit_vector(uint32_t& s) {
  float u1 = rand01(s);
  float u2 = rand01(s);
  float z = 2.0f * u1 - 1.0f;
  float phi = TWO_PI_F * u2;
  float r = sqrtf(fmaxf(0.0f, 1.0f - z * z));
  return make_v3(r * cosf(phi), r * sinf(phi), z);
}

}  // namespace
