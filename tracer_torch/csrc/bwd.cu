// Backward path-tracing kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel tracer/pallas/bwd.py:_bwd_kernel (with its
// per-bounce function _bounce_fn and the shared _shade of
// tracer/pallas/kernel_lib.py) and computes what it computes: for a frame
// recorded by the record-mode megakernel, the cotangents of the packed
// table (dtable [T_ROWS, n]), of the camera rows (dcam [V_ROWS]) and, with
// texture gradients, of every recorded texel (gtex [3, spp*D, N]), given
// the cotangent g_fb on the raw sample sums; plus the replayed frame fb.
// Its plain version is tracer_torch/kernels/replay.py (autograd through
// the same replay), and the test suite holds the two together.
//
// Per pixel and sample: the primary ray is regenerated from the seed
// streams, then each bounce takes its RECORDED winner (no intersection
// search), recomputes t from the winner's geometry (near root with far
// fallback, or the plane root), and shades with the recording kernel's
// draws, roulette and texture tape. The texel is linearised around the
// recorded hit: mult = T + dT/du (u - sg u) + dT/dv (v - sg v), whose
// value is the recorded texel and whose derivative carries d(texel)/d(uv).
//
// CUDA has no autodiff, so the adjoint of one bounce is written out by
// hand in bounce<true>: miss/background, emission, Lambertian, metal
// (fuzz, the 0.8 specular gate), dielectric (refraction, Beer-Lambert
// absorption, survival roulette; the Schlick choice is discrete and has no
// derivative), throughput roulette's 1/p, the NaN-safe sqrt, and the
// texture linearisation with the plane A/B frame and the sphere pole
// sanitisation of tracer/pallas/bwd.py:513-522. Every max/min splits its
// derivative at ties as jnp.maximum and torch.maximum do (half to each
// side), so the kernel differentiates the same function as its plain
// version.
//
// Design: one thread per pixel, looping over its samples; the warps of
// one wave of resident blocks take their next 32 pixels from a counter,
// so that no SM is left with the last pixels of a grid-stride walk. A
// forward replay runs the sample's bounces and keeps each bounce's entry
// state (origin, direction, throughput, seed: 10 floats) in a per-thread
// global scratch [10*D, threads]; it stops where the path dies, since
// every later bounce is the identity. The reverse sweep then walks those
// bounces backwards, recomputing each one from its entry state and
// applying its adjoint. The TPU's one-hot transpose becomes a scatter into
// the winner's column: dtable accumulates per block in shared memory
// (30 rows x 199 primitives = 24 KB for the canonical scene) and is added
// to global memory with one atomicAdd per entry at the end; a table above
// the wrapper's shared-memory limit takes the global-atomic variant
// (SHARED_ACC = false). dcam is reduced per block the same way. Each
// bounce's adjoint collects its winner's column (COLUMN_ROWS values) and
// adds it in one place (add_column): the lanes of a warp that share a
// winner, as many do on the floor quad, sum their columns with shuffles
// and add each row with one atomic, in both accumulator variants.
//
// What bounds it on this card: the tapes are read once (4 bytes per slot
// for the index tape, 4 per slot and field for the texture tape), and the
// forward recompute plus adjoint is a few hundred FP32 operations per
// reached bounce; in practice latency: each bounce's loads wait on its
// winner index, and few warps are resident. __launch_bounds__ caps the
// registers for MIN_BLOCKS resident blocks an SM (128 registers, with
// spills), the fastest of 3, 4 and 5 blocks on the H100. Warps diverge on
// path length and material, as the forward kernel's did before it
// regenerated paths.
//
// Float semantics: IEEE division and sqrtf, and no FMA contraction (the
// build passes -fmad=false for this file): the replay then rounds as its
// plain version does and takes the same discrete decisions (roulette,
// Fresnel choice) on the same tape, where a flipped decision would move a
// gradient by a whole path's contribution. The plain version writes its
// inner products, 1/sqrt and Schlick power in this file's forms, so that
// an ill-conditioned path (a refraction near total internal reflection
// ahead of a long hop onto a noisy texture) gets the same gradient here.
// Atomics add in no fixed order, so dtable and dcam differ from run to run
// in the last bits.

#include "common.cuh"

namespace {

constexpr int STATE_FLOATS = 10;  // o, d, beta, seed per bounce in the scratch
constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 4;  // resident blocks an SM the register budget allows

// d max(a, b) / d a, with jnp.maximum's and torch.maximum's tie rule
__device__ __forceinline__ float dmax(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}
__device__ __forceinline__ float dmin(float a, float b) {
  return a < b ? 1.0f : (a == b ? 0.5f : 0.0f);
}
// derivative of the NaN-safe sqrt (tracer.core.vec._sqrt_grad_safe) at y = sqrt(x)
__device__ __forceinline__ float dsqrt(float y) { return 1.0f / (2.0f * fmaxf(y, 1e-12f)); }

// ---- one bounce: forward, and with ADJ its adjoint ----

struct Ray {
  V3 o, d, beta;
  uint32_t seed;
  bool alive;
};

struct Adj {
  V3 o, d, beta;  // cotangents of the bounce's outputs in, of its inputs out
};

// One bounce's cotangents of its winner's column of dtable: COLUMN_ROWS values,
// each with its row (the rows follow the winner's kind and material).
constexpr int COLUMN_ROWS = 22;

// Adds a bounce's column to acc[row * n + w] with one atomic per row for
// each group of the warp's active lanes that share a winner (the lanes of
// a warp hold neighbouring pixels, which often hit the same primitive).
// __match_any_sync finds the groups. Each group then sums its values, all
// rows together, in ceil(log2(size)) rounds of shuffles: in each round
// every lane adds the values of the next peer above it that is still in
// the sum, and the peers at odd positions leave it (the tree of
// Westphal's reduce_peers). The group's lowest lane adds the sums.
__device__ __forceinline__ void add_column(float* acc, int n, int w, const int (&row)[COLUMN_ROWS],
                                           float (&v)[COLUMN_ROWS]) {
  const unsigned m = __activemask();
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(m, w);
  int rel = __popc(peers & ((1u << lane) - 1u));  // position among the peers
  const bool lowest = rel == 0;
  unsigned above = peers & ~((2u << lane) - 1u);  // the peers above this lane
  while (__any_sync(m, above != 0u)) {
    const int next = __ffs(above);
    const int src = next ? next - 1 : lane;
#pragma unroll
    for (int k = 0; k < COLUMN_ROWS; ++k) {
      const float t = __shfl_sync(m, v[k], src);
      if (next) v[k] += t;
    }
    above &= ~__ballot_sync(m, rel & 1);
    rel >>= 1;
  }
  if (lowest) {
#pragma unroll
    for (int k = 0; k < COLUMN_ROWS; ++k) {
      if (v[k] != 0.0f) atomicAdd(acc + (size_t)row[k] * n + w, v[k]);
    }
  }
}

template <bool ADJ>
__device__ void bounce(const float* __restrict__ table, int n, int w, V3 bg,
                       const float* tm, int tape_f, bool want_tex, int depth, int rr_start,
                       Ray& ray, V3& fin, Adj& g, V3 g_f, V3& g_bg, float* acc, float* g_tm) {
  const V3 o = ray.o, d = ray.d, b = ray.beta;
  if (w < 0) {  // miss: background, the path ends (camera.cu:226-229)
    fin = add(fin, mul(b, bg));
    ray.alive = false;
    if (ADJ) {
      g.beta = add(g.beta, mul(g_f, bg));
      g_bg = add(g_bg, mul(g_f, b));
    }
    return;
  }
  auto T = [&](int row) { return __ldg(table + (size_t)row * n + w); };
  const V3 c = make_v3(T(T_CX), T(T_CY), T(T_CZ));
  const float rad = T(T_RAD);
  const V3 pn = make_v3(T(T_NX), T(T_NY), T(T_NZ));
  const bool is_sph = T(T_ISSPH) > 0.5f;
  const float mtype = T(T_MTYPE);

  // -- t of the recorded winner (bwd.py:450-467)
  const float a = dot(d, d);
  float t, half_b = 0.0f, sq = 0.0f, inv_a = 0.0f, c_q = 0.0f, sgn_s = 0.0f, sd = 1.0f;
  bool dpos = false, denom_ok = false;
  V3 oc = zero3();
  if (is_sph) {
    oc = sub(o, c);
    half_b = dot(oc, d);
    c_q = dot(oc, oc) - rad * rad;
    const float disc = half_b * half_b - a * c_q;
    dpos = disc >= 0.0f;
    sq = sqrtf(dpos ? disc : 1.0f);
    inv_a = 1.0f / a;
    const float t_near = (-half_b - sq) * inv_a;
    const bool near_ok = dpos && t_near >= T_MIN && t_near <= T_MAX;
    sgn_s = near_ok ? -1.0f : 1.0f;
    t = near_ok ? t_near : (-half_b + sq) * inv_a;
  } else {
    const float denom = dot(pn, d);
    denom_ok = fabsf(denom) >= DENOM_EPS;
    sd = denom_ok ? denom : 1.0f;
    t = (T(T_PD) - dot(pn, o)) / sd;
  }

  // -- texture tape: multiplier, linearised around the recorded hit
  const bool textured = tape_f > 0 && T(T_TEXID) > -0.5f;
  V3 mult = make_v3(1.0f, 1.0f, 1.0f);
  if (tape_f > 0) {
    mult = (want_tex && !textured) ? make_v3(1.0f, 1.0f, 1.0f) : make_v3(tm[0], tm[1], tm[2]);
  }
  const V3 alb = make_v3(T(T_ALB0), T(T_ALB1), T(T_ALB2));
  const V3 albedo = mul(alb, mult);

  // -- _shade (kernel_lib.py:724-963)
  const V3 p = add(o, scale(d, t));
  const float inv_rad = 1.0f / rad;
  const V3 on = is_sph ? scale(sub(p, c), inv_rad) : pn;
  const bool front = dot(d, on) < 0.0f;
  const float sgn = front ? 1.0f : -1.0f;
  const V3 nrm = scale(on, sgn);
  const V3 em = make_v3(T(T_EMI0), T(T_EMI1), T(T_EMI2));
  fin = add(fin, mul(b, em));

  uint32_t seed = ray.seed;
  const float u_choice = rand01(seed);
  V3 hemi = rand_unit_vector(seed);
  const V3 ball_dir = rand_unit_vector(seed);
  const V3 ball = scale(ball_dir, cbrtf(rand01(seed)));
  const float u_refl = rand01(seed);
  const float u_rr = rand01(seed);
  if (!(dot(hemi, nrm) > 0.0f)) hemi = scale(hemi, -1.0f);

  const float am = fmaxf(a, 1e-30f);
  const float inv_dlen = 1.0f / sqrtf(am);
  const V3 ud = scale(d, inv_dlen);
  const bool hemi_nz = fabsf(hemi.x) >= NEAR_ZERO_EPS || fabsf(hemi.y) >= NEAR_ZERO_EPS ||
                       fabsf(hemi.z) >= NEAR_ZERO_EPS;
  const V3 lam = hemi_nz ? hemi : nrm;
  const float uddn = dot(ud, nrm);
  const V3 refl = sub(ud, scale(nrm, 2.0f * uddn));
  const float fuzz = T(T_FUZZ);
  const V3 r = add(refl, scale(ball, fuzz));
  const bool spec = u_choice < METAL_SPECULAR_P;

  const float ir = T(T_IR);
  const float ratio = front ? 1.0f / ir : ir;
  const float cos_t = fminf(-uddn, 1.0f);
  const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
  const bool cannot = ratio * sin_t > 1.0f;
  float r0 = (1.0f - ratio) / (1.0f + ratio);
  r0 = r0 * r0;
  const float x1 = 1.0f - cos_t;
  const float x2 = x1 * x1;
  const float refl_p = r0 + (1.0f - r0) * (x2 * x2 * x1);
  const bool choose_refl = cannot || refl_p > u_refl;
  const V3 wv = add(ud, scale(nrm, cos_t));
  const V3 perp = scale(wv, ratio);
  const float y1 = 1.0f - dot(perp, perp);
  const float sy = sqrtf(fabsf(y1));
  const float par = -sy;
  const V3 die = choose_refl ? refl : add(perp, scale(nrm, par));
  const V3 od = sub(p, o);
  const float dist = sqrtf(dot(od, od));
  const V3 ab = make_v3(T(T_ABS0), T(T_ABS1), T(T_ABS2));
  const V3 tr = front ? make_v3(1.0f, 1.0f, 1.0f)
                      : make_v3(expf(-ab.x * dist), expf(-ab.y * dist), expf(-ab.z * dist));
  const float q_rr = fmaxf(tr.y, tr.z);
  const float p_rr = fmaxf(tr.x, q_rr);
  const bool die_ok = u_rr <= p_rr;
  const float inv_p = 1.0f / fmaxf(p_rr, 1e-30f);
  const V3 da = scale(tr, inv_p);
  const float die_sgn = dot(die, nrm) > 0.0f ? DIELECTRIC_OFFSET : -DIELECTRIC_OFFSET;

  const bool is_lam = mtype == 0.0f, is_met = mtype == 1.0f, is_die = mtype == 2.0f;
  const bool ok = is_lam || (is_met && (!spec || dot(r, nrm) > 0.0f)) || (is_die && die_ok);
  bool live = ok;
  V3 b1 = b;
  if (live) {
    const V3 at = is_die ? da : albedo;
    b1 = mul(b, at);
    ray.o = is_die ? add(p, scale(nrm, die_sgn)) : p;
    ray.d = is_lam ? lam : (is_met ? (spec ? r : lam) : die);
  }
  // throughput roulette: one extra draw on every bounce
  bool rr_scaled = false;
  float m_rr = 0.0f, pr = 1.0f;
  if (rr_start >= 0) {
    const float u_t = rand01(seed);
    m_rr = fmaxf(b1.x, fmaxf(b1.y, b1.z));
    pr = fminf(fmaxf(m_rr, RR_MIN_P), 1.0f);
    if (live && depth >= rr_start) {
      if (u_t >= pr) {
        live = false;
      } else {
        rr_scaled = true;
      }
    }
  }
  ray.beta = rr_scaled ? scale(b1, 1.0f / pr) : b1;
  ray.seed = seed;
  ray.alive = live;
  if (!ADJ) return;

  // ================= adjoint =================
  // g.{o,d,beta} hold the cotangents of (ray.o, ray.d, ray.beta) out.
  V3 G_b1 = g.beta;
  if (rr_scaled) {
    const float inv_pr = 1.0f / pr;
    G_b1 = scale(g.beta, inv_pr);
    const float g_pr = -dot(g.beta, b1) * inv_pr * inv_pr;
    const float y = fmaxf(m_rr, RR_MIN_P);
    const float g_m = g_pr * dmin(y, 1.0f) * dmax(m_rr, RR_MIN_P);
    const float qb = fmaxf(b1.y, b1.z);
    const float wq = dmax(qb, b1.x);
    G_b1 = add(G_b1, make_v3(g_m * dmax(b1.x, qb), g_m * wq * dmax(b1.y, b1.z),
                             g_m * wq * dmax(b1.z, b1.y)));
  }
  // scatter update (only where live before roulette, i.e. ok)
  V3 go = zero3(), gd = zero3(), gb = zero3();
  V3 G_p = zero3(), G_nrm = zero3(), G_ud = zero3(), G_albedo = zero3();
  float g_uddn = 0.0f, g_a = 0.0f, g_t = 0.0f, g_rad = 0.0f, g_num = 0.0f;
  V3 G_c = zero3(), G_pn = zero3();
  // the winner's material and texture-frame cotangents, added in one go
  // at the end: ir or fuzz, the absorption, and the plane's d(u), d(v)
  float g_mat = 0.0f, g_du_pl = 0.0f, g_dv_pl = 0.0f;
  V3 g_abs = zero3();
  if (ok) {
    const V3 G_no = g.o, G_nd = g.d;
    const V3 at = is_die ? da : albedo;
    gb = mul(G_b1, at);
    const V3 G_at = mul(G_b1, b);
    V3 G_lam = zero3(), G_r = zero3(), G_refl = zero3();
    if (is_lam) {
      G_lam = G_nd;
      G_p = add(G_p, G_no);
      G_albedo = G_at;
    } else if (is_met) {
      if (spec) G_r = G_nd; else G_lam = G_nd;
      G_p = add(G_p, G_no);
      G_albedo = G_at;
    } else {  // dielectric
      const V3 G_die = G_nd;
      G_p = add(G_p, G_no);
      G_nrm = add(G_nrm, scale(G_no, die_sgn));
      if (choose_refl) {
        G_refl = G_die;
      } else {
        V3 G_perp = G_die;
        const float g_par = dot(G_die, nrm);
        G_nrm = add(G_nrm, scale(G_die, par));
        const float sgn_y = y1 > 0.0f ? 1.0f : (y1 < 0.0f ? -1.0f : 0.0f);
        const float g_y1 = -g_par * dsqrt(sy) * sgn_y;
        G_perp = add(G_perp, scale(perp, -2.0f * g_y1));
        const float g_ratio = dot(G_perp, wv);
        const V3 G_w = scale(G_perp, ratio);
        G_ud = add(G_ud, G_w);
        const float g_cos = dot(G_w, nrm);
        G_nrm = add(G_nrm, scale(G_w, cos_t));
        g_uddn += -g_cos * dmin(-uddn, 1.0f);
        g_mat = front ? -g_ratio / (ir * ir) : g_ratio;
      }
      if (!front) {  // Beer-Lambert: da = tr / max(p_rr, 1e-30)
        const V3 G_da = G_at;
        V3 G_tr = scale(G_da, inv_p);
        const float g_inv_p = dot(G_da, tr);
        const float g_prr = g_inv_p * -inv_p * inv_p * dmax(p_rr, 1e-30f);
        const float wq = dmax(q_rr, tr.x);
        G_tr = add(G_tr, make_v3(g_prr * dmax(tr.x, q_rr), g_prr * wq * dmax(tr.y, tr.z),
                                 g_prr * wq * dmax(tr.z, tr.y)));
        const V3 G_e = mul(G_tr, tr);  // d exp(x) = exp(x) dx
        g_abs = make_v3(-G_e.x * dist, -G_e.y * dist, -G_e.z * dist);
        const float g_dist = -dot(G_e, ab);
        const V3 G_od = scale(od, 2.0f * g_dist * dsqrt(dist));
        G_p = add(G_p, G_od);
        go = sub(go, G_od);
      }
    }
    if (!hemi_nz) G_nrm = add(G_nrm, G_lam);
    if (is_met && spec) {
      G_refl = add(G_refl, G_r);
      g_mat = dot(G_r, ball);
    }
    // refl = ud - 2 (ud.n) n
    G_ud = add(G_ud, G_refl);
    g_uddn += -2.0f * dot(G_refl, nrm);
    G_nrm = add(G_nrm, scale(G_refl, -2.0f * uddn));
  } else {
    go = g.o;
    gd = g.d;
    gb = G_b1;
  }
  // uddn = ud . n; ud = d / sqrt(max(a, 1e-30))
  G_ud = add(G_ud, scale(nrm, g_uddn));
  G_nrm = add(G_nrm, scale(ud, g_uddn));
  gd = add(gd, scale(G_ud, inv_dlen));
  g_a += dot(G_ud, d) * -0.5f * inv_dlen * inv_dlen * inv_dlen * dmax(a, 1e-30f);

  // emission
  gb = add(gb, mul(g_f, em));

  // normal: nrm = on * sgn
  const V3 G_on = scale(G_nrm, sgn);
  if (is_sph) {
    G_p = add(G_p, scale(G_on, inv_rad));
    G_c = sub(G_c, scale(G_on, inv_rad));
    g_rad += -dot(G_on, sub(p, c)) * inv_rad * inv_rad;
  } else {
    G_pn = add(G_pn, G_on);
  }

  // albedo = alb * mult, mult linearised in (u, v)
  if (tape_f > 0) {
    const V3 G_mult = mul(G_albedo, alb);
    if (want_tex && textured) {
      g_tm[0] = G_mult.x;
      g_tm[1] = G_mult.y;
      g_tm[2] = G_mult.z;
    }
    const float g_du = G_mult.x * tm[3] + G_mult.y * tm[4] + G_mult.z * tm[5];
    const float g_dv = G_mult.x * tm[6] + G_mult.y * tm[7] + G_mult.z * tm[8];
    if (g_du != 0.0f || g_dv != 0.0f) {
      const V3 h = p;  // o + t d, as the replay recomputes it
      V3 G_h = zero3();
      if (is_sph) {
        const bool sph_tex = textured;
        const float inv_r = inv_rad;
        const V3 ont = scale(sub(h, c), inv_r);
        const float r2 = ont.x * ont.x + ont.z * ont.z;
        V3 G_ont = zero3();
        if (sph_tex && r2 > 1e-12f) {  // u = (atan2(-z, x) + pi) / 2pi
          const float k = g_du / (TWO_PI_F * r2);
          G_ont.x += k * ont.z;
          G_ont.z += -k * ont.x;
        }
        if (sph_tex) {  // v = acos(clip(y, -1+1e-6, 1-1e-6)) / pi
          const float lo = -1.0f + 1e-6f, hi = 1.0f - 1e-6f;
          const float y_lo = fmaxf(ont.y, lo);
          const float ys = fminf(y_lo, hi);
          G_ont.y += g_dv * (-1.0f / (PI_F * sqrtf(1.0f - ys * ys))) * dmax(ont.y, lo) *
                     dmin(y_lo, hi);
        }
        G_h = scale(G_ont, inv_r);
        G_c = sub(G_c, G_h);
        g_rad += -dot(G_ont, sub(h, c)) * inv_r * inv_r;
      } else {  // u = A.h - A.base, v = B.h - B.base
        const V3 A = make_v3(T(T_AX), T(T_AY), T(T_AZ));
        const V3 B = make_v3(T(T_BX), T(T_BY), T(T_BZ));
        g_du_pl = g_du;
        g_dv_pl = g_dv;
        G_h = add(scale(A, g_du), scale(B, g_dv));
      }
      G_p = add(G_p, G_h);  // h and p are both o + t d
    }
  }

  // p = o + t d
  go = add(go, G_p);
  g_t += dot(G_p, d);
  gd = add(gd, scale(G_p, t));

  // t
  if (is_sph) {
    float g_half_b = -g_t * inv_a;
    const float g_sq = sgn_s * g_t * inv_a;
    const float g_inv_a = g_t * (-half_b + sgn_s * sq);
    g_a += -g_inv_a * inv_a * inv_a;
    const float g_disc = dpos ? g_sq * dsqrt(sq) : 0.0f;
    g_half_b += 2.0f * half_b * g_disc;
    g_a += -c_q * g_disc;
    const float g_cq = -a * g_disc;
    V3 G_oc = scale(oc, 2.0f * g_cq);
    g_rad += -2.0f * rad * g_cq;
    G_oc = add(G_oc, scale(d, g_half_b));
    gd = add(gd, scale(oc, g_half_b));
    go = add(go, G_oc);
    G_c = sub(G_c, G_oc);
  } else {
    g_num = g_t / sd;
    G_pn = sub(G_pn, scale(o, g_num));
    go = sub(go, scale(pn, g_num));
    if (denom_ok) {
      const float g_sd = -g_t * t / sd;
      G_pn = add(G_pn, scale(d, g_sd));
      gd = add(gd, scale(pn, g_sd));
    }
  }
  // a = d . d
  gd = add(gd, scale(d, 2.0f * g_a));

  // the winner's column of dtable
  const V3 g_geo = is_sph ? G_c : G_pn;
  const V3 h = p;
  const int rows[COLUMN_ROWS] = {
      T_EMI0, T_EMI1, T_EMI2, T_ALB0, T_ALB1, T_ALB2,
      is_sph ? T_CX : T_NX, is_sph ? T_CY : T_NY, is_sph ? T_CZ : T_NZ, is_sph ? T_RAD : T_PD,
      is_die ? T_IR : T_FUZZ, T_ABS0, T_ABS1, T_ABS2,
      T_AX, T_AY, T_AZ, T_BA, T_BX, T_BY, T_BZ, T_BB};
  float vals[COLUMN_ROWS] = {
      g_f.x * b.x, g_f.y * b.y, g_f.z * b.z,
      G_albedo.x * mult.x, G_albedo.y * mult.y, G_albedo.z * mult.z,
      g_geo.x, g_geo.y, g_geo.z, is_sph ? g_rad : g_num,
      g_mat, g_abs.x, g_abs.y, g_abs.z,
      g_du_pl * h.x, g_du_pl * h.y, g_du_pl * h.z, -g_du_pl,
      g_dv_pl * h.x, g_dv_pl * h.y, g_dv_pl * h.z, -g_dv_pl};
  add_column(acc, n, w, rows, vals);

  g.o = go;
  g.d = gd;
  g.beta = gb;
}

__device__ __forceinline__ void save(float* scratch, size_t stride, size_t tid, int depth,
                                     const Ray& ray) {
  float* s = scratch + (size_t)depth * STATE_FLOATS * stride + tid;
  const float v[STATE_FLOATS] = {ray.o.x, ray.o.y, ray.o.z, ray.d.x, ray.d.y, ray.d.z,
                                 ray.beta.x, ray.beta.y, ray.beta.z, __uint_as_float(ray.seed)};
  for (int k = 0; k < STATE_FLOATS; ++k) s[k * stride] = v[k];
}

__device__ __forceinline__ Ray load(const float* scratch, size_t stride, size_t tid, int depth) {
  const float* s = scratch + (size_t)depth * STATE_FLOATS * stride + tid;
  Ray r;
  r.o = make_v3(s[0], s[stride], s[2 * stride]);
  r.d = make_v3(s[3 * stride], s[4 * stride], s[5 * stride]);
  r.beta = make_v3(s[6 * stride], s[7 * stride], s[8 * stride]);
  r.seed = __float_as_uint(s[9 * stride]);
  r.alive = true;
  return r;
}

// One pixel: replay its samples, accumulate cotangents. acc: dtable
// accumulator (shared or global), g_cam: this thread's camera cotangents.
__device__ void bwd_pixel(const float* __restrict__ table, int n, const float* cam,
                          const int* __restrict__ idx, const float* __restrict__ gfb,
                          const float* __restrict__ tape, int tape_f, bool want_tex,
                          int width, int npx, int pix, int spp, int max_depth, int row_offset,
                          uint32_t sample_start, int quirk, int rr_start, float* acc,
                          float* g_cam, float* __restrict__ fb, float* __restrict__ gtex,
                          float* scratch, size_t stride, size_t tid) {
  const int i = pix % width;
  const int j = pix / width + row_offset;
  const uint32_t w32 = (uint32_t)width;
  const uint32_t base = wang_hash(quirk ? (uint32_t)i * w32 + (uint32_t)j
                                        : (uint32_t)j * w32 + (uint32_t)i);
  const V3 p00 = make_v3(cam[V_P00X], cam[V_P00Y], cam[V_P00Z]);
  const V3 du = make_v3(cam[V_DUX], cam[V_DUY], cam[V_DUZ]);
  const V3 dv = make_v3(cam[V_DVX], cam[V_DVY], cam[V_DVZ]);
  const V3 o0 = make_v3(cam[V_OX], cam[V_OY], cam[V_OZ]);
  const V3 bg = make_v3(cam[V_BGR], cam[V_BGG], cam[V_BGB]);
  const V3 g_f = make_v3(gfb[(size_t)pix * 3], gfb[(size_t)pix * 3 + 1], gfb[(size_t)pix * 3 + 2]);
  const V3 pc = add(add(p00, scale(du, (float)i)), scale(dv, (float)j));
  const size_t rows = (size_t)spp * max_depth;
  const size_t field = rows * npx;
  V3 fb_acc = zero3();
  V3 g_bg = zero3();
  float tm[13];
  for (int s = 0; s < spp; ++s) {
    Ray ray;
    ray.seed = wang_hash(base + sample_start + (uint32_t)s);
    const float offx = rand01(ray.seed) - 0.5f;
    const float offy = rand01(ray.seed) - 0.5f;
    ray.o = o0;
    ray.d = sub(add(add(pc, scale(du, offx)), scale(dv, offy)), o0);
    ray.beta = make_v3(1.0f, 1.0f, 1.0f);
    ray.alive = true;
    V3 fin = zero3();
    Adj g;
    g.o = g.d = g.beta = zero3();
    float g_tm[3];
    // forward replay: keep each reached bounce's entry state
    int nb = 0;
    for (int depth = 0; depth < max_depth && ray.alive; ++depth) {
      const size_t slot = ((size_t)s * max_depth + depth) * npx + pix;
      save(scratch, stride, tid, depth, ray);
      for (int f = 0; f < tape_f; ++f) tm[f] = __ldg(tape + f * field + slot);
      bounce<false>(table, n, __ldg(idx + slot), bg, tm, tape_f, want_tex, depth, rr_start,
                    ray, fin, g, g_f, g_bg, acc, g_tm);
      nb = depth + 1;
    }
    fb_acc = add(fb_acc, fin);
    // reverse sweep
    for (int depth = nb - 1; depth >= 0; --depth) {
      const size_t slot = ((size_t)s * max_depth + depth) * npx + pix;
      Ray r = load(scratch, stride, tid, depth);
      for (int f = 0; f < tape_f; ++f) tm[f] = __ldg(tape + f * field + slot);
      g_tm[0] = g_tm[1] = g_tm[2] = 0.0f;
      V3 fin_unused = zero3();
      bounce<true>(table, n, __ldg(idx + slot), bg, tm, tape_f, want_tex, depth, rr_start,
                   r, fin_unused, g, g_f, g_bg, acc, g_tm);
      if (want_tex) {
        for (int c = 0; c < 3; ++c) gtex[c * field + slot] = g_tm[c];
      }
    }
    // primary ray: o = o0, d = pc + offx du + offy dv - o0
    const V3 gd = g.d;
    g_cam[V_OX] += g.o.x - gd.x;
    g_cam[V_OY] += g.o.y - gd.y;
    g_cam[V_OZ] += g.o.z - gd.z;
    g_cam[V_P00X] += gd.x;
    g_cam[V_P00Y] += gd.y;
    g_cam[V_P00Z] += gd.z;
    const float fi = (float)i + offx, fj = (float)j + offy;
    g_cam[V_DUX] += fi * gd.x;
    g_cam[V_DUY] += fi * gd.y;
    g_cam[V_DUZ] += fi * gd.z;
    g_cam[V_DVX] += fj * gd.x;
    g_cam[V_DVY] += fj * gd.y;
    g_cam[V_DVZ] += fj * gd.z;
  }
  g_cam[V_BGR] += g_bg.x;
  g_cam[V_BGG] += g_bg.y;
  g_cam[V_BGB] += g_bg.z;
  fb[(size_t)pix * 3] = fb_acc.x;
  fb[(size_t)pix * 3 + 1] = fb_acc.y;
  fb[(size_t)pix * 3 + 2] = fb_acc.z;
}

template <bool SHARED_ACC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) bwd_kernel(
    const float* __restrict__ table, int n, const float* __restrict__ camv,
    const int* __restrict__ idx, const float* __restrict__ gfb,
    const float* __restrict__ tape, int tape_f, int want_tex, int width, int npx, int spp,
    int max_depth, int row_offset, uint32_t sample_start, int quirk, int rr_start,
    float* __restrict__ dtable, float* __restrict__ dcam, float* __restrict__ fb,
    float* __restrict__ gtex, float* __restrict__ scratch, int* __restrict__ next) {
  extern __shared__ float sh[];
  float* cam_acc = sh;  // [V_ROWS]
  float* acc = SHARED_ACC ? sh + V_ROWS : dtable;
  const int nsh = V_ROWS + (SHARED_ACC ? T_ROWS * n : 0);
  for (int k = threadIdx.x; k < nsh; k += blockDim.x) sh[k] = 0.0f;
  __syncthreads();

  float cam[V_ROWS], g_cam[V_ROWS];
  for (int k = 0; k < V_ROWS; ++k) {
    cam[k] = __ldg(camv + k);
    g_cam[k] = 0.0f;
  }
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  // each warp takes the next 32 pixels from the launch's counter until
  // none are left, so the resident blocks end together
  const int lane = threadIdx.x & 31;
  for (;;) {
    int first = 0;
    if (lane == 0) first = atomicAdd(next, 32);
    first = __shfl_sync(0xffffffffu, first, 0);
    if (first >= npx) break;
    if (first + lane < npx) {
      bwd_pixel(table, n, cam, idx, gfb, tape, tape_f, want_tex != 0, width, npx, first + lane,
                spp, max_depth, row_offset, sample_start, quirk, rr_start, acc, g_cam, fb, gtex,
                scratch, stride, tid);
    }
  }
  for (int k = 0; k < V_ROWS; ++k) {
    if (g_cam[k] != 0.0f) atomicAdd(cam_acc + k, g_cam[k]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nsh; k += blockDim.x) {
    const float v = sh[k];
    if (v == 0.0f) continue;
    if (k < V_ROWS) {
      atomicAdd(dcam + k, v);
    } else {
      atomicAdd(dtable + (k - V_ROWS), v);
    }
  }
}

}  // namespace

// Dynamic shared memory of one block: dcam's and, with shared_acc, dtable's
// accumulators.
static size_t shared_bytes(int shared_acc, int n) {
  return sizeof(float) * (V_ROWS + (shared_acc ? (size_t)T_ROWS * n : 0));
}

// Resident blocks an SM of THREADS threads each, for the accumulator
// variant and table width the wrapper will launch, into *blocks_per_sm.
extern "C" int tracer_bwd_occupancy(int shared_acc, int n, int* blocks_per_sm) {
  const size_t bytes = shared_bytes(shared_acc, n);
  cudaError_t e;
  if (shared_acc) {
    e = cudaFuncSetAttribute(bwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, bwd_kernel<true>, THREADS,
                                                        bytes);
    }
  } else {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, bwd_kernel<false>, THREADS,
                                                      bytes);
  }
  return static_cast<int>(e);
}

// Plain C entry point, loaded with ctypes by tracer_torch/kernels/bwd.py.
// dtable [T_ROWS, n], dcam [V_ROWS], fb [npx, 3] and gtex [3*spp*D, npx]
// come zeroed; scratch holds STATE_FLOATS*max_depth rows of blocks*THREADS
// floats (threads must be THREADS). shared_acc picks the shared-memory
// dtable accumulator (the wrapper checks that the table fits). next is a
// zeroed counter from which each warp takes its next 32 pixels. Launches
// on `stream`, does not synchronise, and returns cudaGetLastError().
extern "C" int tracer_bwd(const float* table, int n, const float* camv, const int* idx,
                          const float* gfb, const float* tape, int tape_f, int want_tex,
                          int width, int npx, int spp, int max_depth, int row_offset,
                          unsigned int sample_start, int quirk, int rr_start, int shared_acc,
                          float* dtable, float* dcam, float* fb, float* gtex, float* scratch,
                          int blocks, int threads, int scratch_rows, void* stream,
                          int* next) {
  if (scratch_rows < STATE_FLOATS * max_depth || threads != THREADS || next == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shared_acc) {
    const size_t bytes = shared_bytes(1, n);
    cudaError_t e = cudaFuncSetAttribute(bwd_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    bwd_kernel<true><<<blocks, threads, bytes, st>>>(
        table, n, camv, idx, gfb, tape, tape_f, want_tex, width, npx, spp, max_depth,
        row_offset, sample_start, quirk, rr_start, dtable, dcam, fb, gtex, scratch, next);
  } else {
    bwd_kernel<false><<<blocks, threads, shared_bytes(0, n), st>>>(
        table, n, camv, idx, gfb, tape, tape_f, want_tex, width, npx, spp, max_depth,
        row_offset, sample_start, quirk, rr_start, dtable, dcam, fb, gtex, scratch, next);
  }
  return static_cast<int>(cudaGetLastError());
}
