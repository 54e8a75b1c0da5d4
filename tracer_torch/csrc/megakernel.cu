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
// version (tracer_torch/render/renderer.py:render_frame). row_offset (the
// TPU kernel's params slot 15, every mode) shifts the launch's rows to the
// image rows of a band, as the TPU kernel's row band under shard_map does:
// the seeds, pixel centres and jitter are the whole image's, so bands of
// one frame give the rows of its one launch bit for bit.
//
// Design: one loop per thread, each pass one bounce, over pixels that the
// thread takes from a launch-wide pool. The thread carries its path
// (sample s, depth, ray, throughput, radiance, seed); when the path ends
// (a miss, an absorb, a roulette kill or max_depth) the same pass folds
// its radiance into the pixel sum and starts sample s+1 from its own seed.
// This is the TPU kernel's per-lane path regeneration (tracer/pallas/
// kernels.py:181-193, :303-312): a lane whose path ends early starts its
// next sample at once instead of waiting for the longest path of its warp.
// When the pixel's last sample ends, the same pass stores the pixel's sums
// and takes the next pixel from the pool, so a lane whose pixel is done
// does not wait for the slowest pixel of its warp either: a warp's passes
// are the bounces of the pixels its lanes took, spread over its 32 lanes,
// plus the launch's tail. The grid is one wave of the blocks the card holds
// at once for the instantiation and its shared bytes (a block for each
// THREADS pixels of a smaller band); a thread's first pixel is blockIdx.x *
// THREADS + threadIdx.x, and pixel gridDim.x * THREADS + c comes from the
// launch's zeroed counter (Launch::next), which each group of lanes that
// refill in one pass bumps with one warp-aggregated atomicAdd. A lane
// leaves when the counter has passed the band; the passes in which a lane
// of the warp has left are its tail (COUNT's drained_passes). Every pixel
// is still rendered by one lane, sample 0 to spp - 1 in ascending s, and
// its sums and tape slots are written once, so every (pixel, sample) keeps
// its draws and the pixel sum the renderer's grouping: which lane renders
// a pixel, and when, changes nothing in the frame or the tapes.
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
// Object cull (ISECT == BRUTE: K1, K1-rec, K1-ref mode 4, and so the row
// bands). A scene may list its objects (Scene.groups: one per polyhedron),
// each as an index range of spheres and one of planes; pack.py:pack_groups
// gives each a ball around its primitives, staged with the primitive
// records. Once a query, each lane tests its ray against every ball with
// no square root and no new division: oc = o - c, b = oc.d, l = oc -
// d (b / a) (oc's part across the ray, with the query's 1/a), rr = R +
// A |oc|^2, and the ball may be reached iff |l|^2 <= rr^2 (the line meets
// it) and (b <= 0 or |oc|^2 <= rr^2) (its far root is not behind the
// origin); the results are the bits of a register. The sphere loop then
// runs over the sphere table in ascending order and jumps past the range
// of each group whose bit is clear, and the plane loop likewise; a
// primitive outside every group (the floor, the point lights, every
// primitive of a scene built another way) is always tested. With no
// groups the loops are the plain ones.
// Why the answer is brute's, bit for bit: a primitive's test (sphere_t,
// plane_hit) does not depend on the others, so leaving out primitives
// that cannot report a hit changes nothing, and the tests that remain
// run in brute's order with its strict <, so the winner, best, alpha and
// beta are brute's, ties included. So the ball has to hold, for an
// origin at any distance D = |oc|, every point at which a primitive of
// the group can report a hit, rounding included, and the test's own
// rounding. With e = 2^-24 and R0 the primitives' tight radius:
// - R = R0 (1 + 2^-10) + 2^-16 |c| + B is the radius at D = 0: 2^-10 R0
//   covers the test's rounding near the ball, 2^-16 |c| a few ulps of
//   absolute coordinates;
// - sphere_t's b^2 - a c is off by at most about 20 e a D^2 (D from the
//   sphere's centre), so it reports a rounding-only hit on a line up to
//   10 e D^2 / r beyond a sphere of radius r, or from an origin up to
//   14 e D^2 / r outside it: the radius grows by 2^-18 (D + R0)^2 / r_min,
//   r_min the group's smallest sphere;
// - plane_hit's hit point p = o + t d and its alpha and beta, and l, are
//   off by a few e (D + R0 + |c|), times 1 / sin of a plane's corner
//   angle (its u and v): the radius grows by 2^-18 k (D + R0 + |c|), k
//   one plus the group's largest 1 / sin;
// both grow by at most A D^2 + B (pack_groups bounds (D + R0)^2 and D by
// D^2 and constants), so no rounding-only hit lies outside rr, from an
// origin at any distance: a far origin only makes the ball larger.
// DIELECTRIC_OFFSET (1e-4) moves an origin off a face, not a hit point, so
// it needs no room: the test takes any origin, inside the ball or out. A
// zero or non-finite direction or origin fails the ball test and hits
// nothing in brute's tests either. tests/test_torch_groups.py replays the
// plain renderer's queries through a float32 copy of the test, and grazes
// small spheres on a ball's surface from far away.
// The mask is each lane's own: a lane tests its own primitives, and the
// lanes of a warp that need different groups run the same loop body at
// different indices, so a warp pass costs its busiest lane's tests. The
// warp's union of the masks (every lane testing what any lane needs, the
// reads broadcast) was 1.13-1.16x slower on config.txt (PERF.md, section 6).
//
// What bounds it on this card: FP32 ALU work, the ray-primitive tests per
// nearest-hit query (199 on the canonical scene without the cull), each a
// few dozen FLOPs, and the lanes a warp leaves idle: threads take
// different material branches and, with the cull, test different numbers
// of primitives, and at the launch's end the pool runs dry. Not bytes: the
// tables are ~10 KB.
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
// of at most K (tracer_torch/kernels/cluster.py) by a median split, whose
// binary tree the kernel walks without a stack: the nodes are stored in
// preorder, lower half first, so the leaves come in ascending cluster id,
// and each node holds its box and the index of the node after its
// subtree. Per bounce each thread slab-tests its own ray against node i;
// if the test fails, or the box's entry lies beyond the running nearest
// hit by more than PRUNE allows, it jumps past the subtree, else it goes
// to node i + 1. At a leaf it stops walking and runs the sphere or plane
// test of the brute block on the primitives of the leaf's cluster (read
// through its slot indices), so that the lanes of a warp that reached
// leaves at different steps test their primitives together.
// Rounding is monotone, so a node's slab interval holds its children's:
// a leaf is reached exactly where the flat loop over every cluster box
// would have tested it, unless the running best proves that none of its
// primitives can win. Culling is per ray, not per 128-ray bundle as on the
// TPU, so the answer does not depend on the launch layout. Leaves and
// slots are met in ascending order with strict <, so ties go to the lowest
// (cluster, slot), as in the TPU's legacy intersector; the slab's upper
// bound stays K_INFINITY, as on the TPU. The node records are staged in
// shared memory with the primitive records (NSMEM) when the wrapper's
// threshold allows. What bounds it: FP32 work, a few dozen node tests and
// the primitive tests of the reached leaves per bounce; divergence, since
// the threads of a warp walk different paths.
//
// BVH mode (ISECT == BVH, entry mode 3) replaces tracer/bvh/traverse.py:
// traverse, which tracer runs in XLA (a lax.while_loop; there is no Pallas
// kernel): the nearest hit walks the scene's BVH, split by surface area
// (tracer_torch/bvh/builder.py) over child-pair records (kernels/pack.py:
// pack_bvh; the node layout of Aila and Laine, HPG 2009): the record of an
// internal node is four float4s holding both children's boxes and, for
// each, its record and split axis or, for a leaf, -1 and its primitive id
// (spheres first); record 0 holds the root. Each pass of the walk visits a
// record or tests a leaf, then pops while no node is pending. A visit
// issues the record's four loads at once and slab-tests both children over
// (T_MIN, best): the near child (the left one when d[axis] >= 0) is next
// if it passes, and a far child that passes is pushed with its entry
// distance tmin, or is next when near failed. A pop skips an entry whose
// tmin is no longer below best. A leaf accepts its primitive at t <= best
// (a tie goes to the primitive visited later).
// This is the plain version's walk (tracer_torch/bvh/traverse.py: pop,
// slab-test over (T_MIN, closest), push far, then near), decision for
// decision: a child's slab interval does not depend on best, and fminf is
// exact, so min(slab max, best) > tmin holds exactly when slab max > tmin
// and best > tmin. Near is tested against the best its pop would see
// (nothing runs between that pop and the parent's test), far against a
// best no smaller than at its pop, where the pop's check completes the
// test. So the same leaves are tested in the same order against the same
// best, the winner is the plain version's, ties included, and the node
// tests (the root, then two a visit) equal the plain walk's pops. The
// stack holds at most depth - 1 (node, tmin) pairs. The slab test takes
// the unguarded 1/d of tracer/geometry/aabb.py and culls a box when any of
// its six plane distances is NaN (0 x inf: an origin on a face, a zero
// direction component), where jnp.minimum and torch.minimum propagate the
// NaN that fminf and fmaxf would drop. The records share K1-cl's staging
// (NSMEM).
// What bounds it on this card: instruction issue and the lanes a warp
// leaves idle, not the records' latency. A visit halves the dependent
// fetches of the pop-a-node walk but runs two slab tests, and a warp takes
// as many passes as its longest walk, so the same work costs about the
// same on the canonical scene; deeper trees (the sphere fields) gain from
// the culled children no longer pushed. Measured against other forms
// (PERF.md, PR 10): walking each lane to its next leaf and testing the
// warp's leaves together (while-while, as K1-cl) was 1.15-1.28x slower,
// since a leaf here is one cheap primitive test and the lanes wait at each
// leaf for the warp's longest walk to its next one; `||` in the NaN cull
// compiled to a chain of branches, `|` keeps it straight (1.09-1.19x); a shared
// memory stack laid out [slot][THREADS] was no faster than local memory,
// and the bank-spread permutation of the shared records was slower.

// Stratified jitter (Launch::strat_k = k > 0; tracer/pallas/kernels.py:
// 318-325, :533-541): sample s_g = sample_start + s lands in cell (s_g mod
// k, floor(s_g / k)) of a k x k sub-pixel grid, offset (cell + u) / k -
// 0.5, in float32; the same two draws, so the rest of the stream is
// unchanged. k is the whole frame's, passed to every sample chunk.
//
// Reference stream (REF, entry modes 4 and 5; K1-ref): the counterpart of
// tracer's XLA renderer with rng_mode="reference" (tracer/render/
// integrator.py:75 with tracer/materials/scatter.py:scatter_reference),
// not of a Pallas kernel: tracer's megakernel has no reference stream. In
// place of the fixed 8-draw block each thread runs the reference binary's
// own scatter (materials.h:70-140, random_utils.h:25-42): a lambertian
// bounce draws a hemisphere direction by rejection, a metal one a gate and
// then a ball point (specular) or a hemisphere direction (diffuse), a
// dielectric one its reflectance draw only when refraction is possible and
// then its roulette draw, a light none. The rejection loop takes at most
// MAX_REJECTION_TRIES tries of three draws of -1 + 2u (2u is exact, so a
// contraction cannot change the sum) and tests x*x + y*y + z*z < 1 with
// one rounding a step in that order, as the plain version
// (tracer_torch/core/rng.py) does: an accept decision steers the rest of
// the stream. The tries per lane are geometric (1.9 on average), so the
// lanes of a warp diverge in the loop; the stream is per lane and stays so.
// Brute force (mode 4) and BVH (mode 5); the camera jitter, stratify,
// row_offset and the nearest-hit blocks are K1's and K1-bvh's. What bounds
// it: K1's FP32 work and about 5.7 hashes a lambertian bounce in place of
// 8, with no sincosf or cbrtf, against the loop's divergence.
//
// The RTIOW book's estimator (RTIOW, entry mode 6; K1-bvh only, on the
// fixed stream): Shirley's "Ray Tracing in One Weekend" (book 1, v3.2.3)
// final scene asks for three things the reference's scenes do not, each
// off unless the launch's tables ask for it (RtiowRow, after the camera's
// rows). A thin lens (section 12.2): with a lens, two draws after the
// jitter's place the ray's origin on a disk of the lens's radius (r =
// sqrt(u1), theta = 2 pi u2 over the lens basis), and the ray still passes
// through the jittered point of the viewport, which the host places at the
// focus distance. A sky (section 4.2): a miss adds beta * lerp(bottom, top,
// 0.5 (unit(d).z + 1)) in place of beta * bg. The book's two materials
// (section 9): RTIOW_LAMBERTIAN scatters along n + the unit direction of
// the budget's ball draw (n where the sum is near zero), RTIOW_METAL
// reflects plus fuzz times the ball with no specular gate, killed below the
// surface; both in the budget's draw slots, so the stream is unchanged.
// The flag is a template parameter, as REF is, so the other instantiations
// compile the code they compiled before it. What bounds it on the book's
// scene: paths end by escaping to the sky after a few bounces, so lane
// regeneration and divergence across the material branches set the pace.
//
// All of them run one bounce loop, trace_pixels<RECORD, ISECT, SMEM, NSMEM,
// COUNT, REF, RTIOW>, and call the same sphere_t / plane_hit; only the
// nearest-hit block's loop, the tape stores and the scatter's stream are
// chosen at compile time.
// The counted instantiations (COUNT; the debug_iters counterpart of
// tracer/pallas/kernels.py:62, :107-110) add up the launch's nearest-hit
// queries, hits, leaves reached, primitive tests, warp passes, the active
// lanes of each pass (__popc(__activemask())), node tests (K1-cl's and
// K1-bvh's walks), camera samples started, the warp passes in which some
// lane scatters and those among them whose scattering lanes take more than
// one material branch (__match_any_sync over the material code), and the
// warp passes in which some lane of the warp has found the pool empty
// (drained: a flag a warp in shared memory); timed launches take the
// uncounted ones. Which lane takes which pixel depends on the order in
// which lanes reach the counter, so the warp-level counters (passes,
// active lanes, the scattering, mixed and drained passes) vary from launch
// to launch; the others depend on the pixels' paths alone.
//
// Float semantics: IEEE division and sqrtf (no --use_fast_math); nvcc's
// default FMA contraction is kept, so a ray on a razor-edge tie (polyhedron
// border quads) may take another path than in the plain version — callers
// compare frames by the fraction of agreeing pixels and the frame mean.
// Built with -fmad=false, every instantiation runs the float operations of
// the plain version in its order.

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace {

constexpr float K_INFINITY = 1e32f;
constexpr int THREADS = 128;
constexpr int COUNTS = 11;  // COUNT's counters, see Launch::counts
// the nearest-hit block of trace_pixels: every primitive (K1, K1-rec), the
// cluster tree's walk (K1-cl) or the BVH's (K1-bvh)
enum Isect { BRUTE = 0, CLUSTERED = 1, BVH = 2 };
constexpr int BVH_STACK = 32;  // the BVH walk's stack (bvh.h:23); the wrapper checks the depth
// float4s a node record: K1-cl's (lo, skip), (hi, cluster); K1-bvh's child pair;
// the brute kernels' object group (pack_groups)
template <int ISECT>
constexpr int NODE_F4 = ISECT == BVH ? 4 : ISECT == BRUTE ? 3 : 2;
constexpr int BVH_NONE = -1;  // the BVH walk's `next` when no node is pending
// The walk skips a subtree whose box's entry exceeds best * PRUNE: a
// primitive's root rounds below the entry of a box that holds it by about
// 2^-24 x its distance over its size (a sphere hit where it touches its
// box), so a margin of 2^-12 keeps every box that may hold the winner up
// to a distance of 4096 radii, at the cost of boxes whose entry lies within
// 0.025% behind the nearest hit. tests/cluster_walk.py reads this value.
constexpr float PRUNE = 1.000244140625f;  // 1 + 2^-12
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
  // CLUSTERED: [num_nodes * 2] (lo, skip), (hi, cluster) records; BVH:
  // [num_nodes * 4] child-pair records (kernels/pack.py:pack_bvh); BRUTE:
  // [num_nodes * 3] object groups' (ball, ranges, growth) records (pack_groups)
  const float4* nodes;
  const int* slots;    // CLUSTERED: [clusters * k], -1 pads a cluster's end
  int num_nodes, k;
  int strat_k;         // stratified jitter's grid size k, 0 for uniform jitter
  int row_offset;      // the image row of the launch's first row: a band of `height`
                       // rows of a taller image keeps the image's seeds and camera rays
  // COUNT: [COUNTS] sums over the launch: nearest-hit queries, hits,
  // leaves reached (BRUTE: groups whose ball a query entered), primitives
  // tested, warp passes, active lanes, node tests, samples started, warp
  // passes that scatter, those with mixed material branches, warp passes
  // after a lane of the warp found the pool empty
  unsigned long long* counts;
  int* next;  // the pixel pool: zeroed; pixel gridDim.x * THREADS + c is the c-th taken
};

// The primitive records and (BRUTE) the object groups' records, in shared
// memory (SMEM) or read through the read-only cache.
template <bool SMEM>
struct Prims {
  const float4* sph;
  const float4* pla;
  int num_s, num_p;
  const float4* grp = nullptr;  // BRUTE: [num_g * 3] (ball, ranges, growth) records
  int num_g = 0;
  __device__ __forceinline__ float4 sphere(int k) const {
    if constexpr (SMEM) return sph[k]; else return __ldg(sph + k);
  }
  __device__ __forceinline__ float4 plane(int k, int q) const {
    if constexpr (SMEM) return pla[k * PLANE_F4 + q]; else return __ldg(pla + k * PLANE_F4 + q);
  }
  __device__ __forceinline__ float4 group(int g, int q) const {
    if constexpr (SMEM) return grp[3 * g + q]; else return __ldg(grp + 3 * g + q);
  }
  // the first index of group g's range of spheres (LO 0) or planes (LO 2),
  // or of its end (LO 1, 3); -1 past the last group
  template <int LO>
  __device__ __forceinline__ int bound(int g) const {
    if (g >= num_g) return -1;
    const float4 r = group(g, 1);
    return __float_as_int(LO == 0 ? r.x : LO == 1 ? r.y : LO == 2 ? r.z : r.w);
  }
};

// The brute block's walk over one table (LO 0 spheres, 2 planes): at k ==
// at, the first index of group g's range, the walk enters the range if
// bit g of `use` is set and else jumps past it, then takes the next group.
template <int LO, bool SMEM>
__device__ __forceinline__ void skip_groups(const Prims<SMEM>& P, unsigned use, int& k, int& g,
                                            int& at) {
  while (k == at) {
    if (!((use >> g) & 1u)) k = P.template bound<LO + 1>(g);
    at = P.template bound<LO>(++g);
  }
}

// The cluster tree's or the BVH's node records (kernels/cluster.py,
// kernels/pack.py:pack_bvh), in shared memory (NSMEM) or read through the
// read-only cache.
template <bool NSMEM>
struct Nodes {
  const float4* rec;
  __device__ __forceinline__ float4 lo(int i) const {
    if constexpr (NSMEM) return rec[2 * i]; else return __ldg(rec + 2 * i);
  }
  __device__ __forceinline__ float4 hi(int i) const {
    if constexpr (NSMEM) return rec[2 * i + 1]; else return __ldg(rec + 2 * i + 1);
  }
  // float4 q of K1-bvh's child-pair record i
  __device__ __forceinline__ float4 quad(int i, int q) const {
    if constexpr (NSMEM) return rec[4 * i + q]; else return __ldg(rec + 4 * i + q);
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
// root and planar coordinates, if its root is valid, nearer than *best
// (with LE, not farther: the BVH's t <= closest) and inside the quad,
// ellipse or triangle.
template <bool SMEM, bool LE = false>
__device__ __forceinline__ bool plane_hit(const Prims<SMEM>& P, int k, V3 o, V3 d, float* best,
                                          float* alpha_out, float* beta_out) {
  const float4 nd = P.plane(k, 0);  // normal, d
  const V3 nrm = xyz(nd);
  const float denom = dot(nrm, d);
  if (!(fabsf(denom) >= DENOM_EPS)) return false;
  const float root = (nd.w - dot(nrm, o)) / denom;
  if (!(root >= T_MIN && root <= T_MAX) || !(LE ? root <= *best : root < *best)) return false;
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

// The BVH walk's slab test of a child's box over (T_MIN, best), with the
// plain version's unguarded 1/d (iv) and its NaN cull; *tmin gets the
// box's entry distance.
__device__ __forceinline__ bool bvh_box(float4 lo, float4 hi, V3 o, V3 iv, float best,
                                        float* tmin) {
  const float tx1 = (lo.x - o.x) * iv.x;
  const float tx2 = (hi.x - o.x) * iv.x;
  const float ty1 = (lo.y - o.y) * iv.y;
  const float ty2 = (hi.y - o.y) * iv.y;
  const float tz1 = (lo.z - o.z) * iv.z;
  const float tz2 = (hi.z - o.z) * iv.z;
  // | and not ||: six predicates, no branches
  const bool nan6 = isnan(tx1) | isnan(tx2) | isnan(ty1) | isnan(ty2) | isnan(tz1) | isnan(tz2);
  *tmin = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fmaxf(fminf(tz1, tz2), T_MIN));
  const float tmax = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fminf(fmaxf(tz1, tz2), best));
  return !nan6 && tmax > *tmin;
}

// A child of a BVH record as the walk's node code: an internal node as its
// record << 2 | its split axis, a leaf as -2 - its primitive id.
__device__ __forceinline__ int bvh_child(float4 lo, float4 hi) {
  const int axis = __float_as_int(lo.w), id = __float_as_int(hi.w);
  return axis < 0 ? -2 - id : (id << 2) | axis;
}

// The slab test's inverse direction, |d| guarded at 1e-30 (culling.py:33-38).
__device__ __forceinline__ float guarded_inv(float x) {
  return 1.0f / (fabsf(x) < 1e-30f ? (x < 0.0f ? -1e-30f : 1e-30f) : x);
}

// ---- the reference stream (REF; tracer_torch/core/rng.py) ----

constexpr int MAX_REJECTION_TRIES = 16;  // rng.MAX_REJECTION_TRIES

// (x*x + y*y) + z*z with one rounding a step, as the plain version sums it
__device__ __forceinline__ float len2_rn(V3 v) {
  return __fadd_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)), __fmul_rn(v.z, v.z));
}

// A point in the unit ball by the reference's rejection loop (random_utils.h:
// 25-32), at most MAX_REJECTION_TRIES tries; a lane that accepts none returns
// the zero vector with its seed 3 * MAX_REJECTION_TRIES draws on, as tracer's
// code does.
__device__ __forceinline__ V3 rand_in_unit_sphere_ref(uint32_t& s) {
  for (int t = 0; t < MAX_REJECTION_TRIES; ++t) {
    const float x = -1.0f + 2.0f * rand01(s);
    const float y = -1.0f + 2.0f * rand01(s);
    const float z = -1.0f + 2.0f * rand01(s);
    const V3 c = make_v3(x, y, z);
    if (len2_rn(c) < 1.0f) return c;
  }
  return zero3();
}

// unit_vector(random_in_unit_sphere) (random_utils.h:34) flipped into the
// hemisphere of nrm (:36-42); a zero or near-zero result becomes nrm
// (materials.h:76)
__device__ __forceinline__ V3 hemisphere_dir_ref(uint32_t& s, V3 nrm) {
  const V3 p = rand_in_unit_sphere_ref(s);
  V3 h = scale(p, 1.0f / sqrtf(fmaxf(len2_rn(p), 1e-24f)));
  if (!(dot(h, nrm) > 0.0f)) h = neg(h);
  const bool zero = fabsf(h.x) < NEAR_ZERO_EPS && fabsf(h.y) < NEAR_ZERO_EPS &&
                    fabsf(h.z) < NEAR_ZERO_EPS;
  return zero ? nrm : h;
}

// The dielectric's scatter (materials.h:97-133) in K1's float forms, for
// both streams: a statement list over trace_pixels' locals (it reads p, o,
// ud, nrm, front, join, n and widx, and sets new_d, att, new_o and ok).
// U_REFL and U_RR are the reflectance and roulette uniforms: the fixed
// stream passes the ones it drew; REF passes rand01(seed) for both, and the
// || evaluates the first only when refraction is possible (materials.h:109),
// as the reference binary draws. A macro, not an inlined function, so that
// the fixed instantiations compile the same tokens as before REF existed:
// a __forceinline__ function in their place changed the registers and
// spills ptxas gave two of them.
#define DIELECTRIC_SCATTER(U_REFL, U_RR)                                     \
  const float ir = ld(join, J_IR, n, widx);                                \
  const float ratio = front ? 1.0f / ir : ir;                              \
  const float cos_t = fminf(-dot(ud, nrm), 1.0f);                          \
  const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));            \
  const bool cannot_refract = ratio * sin_t > 1.0f;                        \
  float r0 = (1.0f - ratio) / (1.0f + ratio);                              \
  r0 = r0 * r0;                                                            \
  const float x = 1.0f - cos_t;                                            \
  const float x2 = x * x;                                                  \
  const float refl_p = r0 + (1.0f - r0) * (x2 * x2 * x);                   \
  if (cannot_refract || refl_p > U_REFL) {                                 \
    new_d = reflect(ud, nrm);                                              \
  } else {                                                                 \
    const V3 perp = scale(add(ud, scale(nrm, cos_t)), ratio);              \
    const float par = -sqrtf(fabsf(1.0f - dot(perp, perp)));               \
    new_d = add(perp, scale(nrm, par));                                    \
  }                                                                        \
  /* Beer-Lambert absorption on back-face exit, then survival roulette */  \
  if (front) {                                                             \
    att = make_v3(1.0f, 1.0f, 1.0f);                                       \
  } else {                                                                 \
    const V3 od = sub(p, o);                                               \
    const float dist = sqrtf(dot(od, od));                                 \
    att = make_v3(expf(-ld(join, J_ABS0, n, widx) * dist),                 \
                  expf(-ld(join, J_ABS1, n, widx) * dist),                 \
                  expf(-ld(join, J_ABS2, n, widx) * dist));                \
  }                                                                        \
  const float p_rr = fmaxf(att.x, fmaxf(att.y, att.z));                    \
  ok = U_RR <= p_rr;                                                       \
  att = scale(att, 1.0f / fmaxf(p_rr, 1e-30f));                            \
  const float side = dot(new_d, nrm) > 0.0f ? 1.0f : -1.0f;                \
  new_o = add(p, scale(nrm, DIELECTRIC_OFFSET * side));

// ---- the bounce loop ----

// A lane's pixels, first `lin`, then those it takes from the pool: each
// pixel's samples, the raw radiance sum into L.out[pixel], one bounce per
// pass of one loop (see the note at the top). With RECORD, every
// reached slot also stores its winner into the index tape and, for a
// textured hit, its tape_f texture fields into the texture tape. With
// ISECT CLUSTERED the nearest hit walks the cluster tree N, with BVH the
// BVH N, instead of testing every primitive. With COUNT, the launch's
// work is added to L.counts. With REF, the scatter draws the reference
// stream, with RTIOW the ray generation, the miss and the scatter take the
// RTIOW book's lens, sky and materials (see the note at the top). With
// COUNT, `drained` is the warp's flag: set once a lane of it found the
// pool empty.
template <bool RECORD, int ISECT, bool SMEM, bool NSMEM, bool COUNT, bool REF, bool RTIOW>
__device__ __forceinline__ void trace_pixels(const Launch& L, const Prims<SMEM>& P,
                                             const Nodes<NSMEM>& N, int lin,
                                             volatile unsigned* drained) {
  const int width = L.width, max_depth = L.max_depth, num_s = P.num_s, num_p = P.num_p;
  const int npx = width * L.height;
  // the pool's pixels left after the grid's first ones (< 0 for a band
  // smaller than the grid)
  const int pool = npx - (int)gridDim.x * THREADS;
  if (lin >= npx) {  // a ragged last block: the pool is empty too
    if constexpr (COUNT) *drained = 1u;
    return;
  }
  const int n = num_s + num_p;
  const float* __restrict__ join = L.join;

  const V3 cam_o = ld3(L.cam, C_OX, 1, 0);
  const V3 du = ld3(L.cam, C_DUX, 1, 0);
  const V3 dv = ld3(L.cam, C_DVX, 1, 0);
  const V3 bg = ld3(L.cam, C_BGR, 1, 0);
  // RTIOW: the lens and the sky (RtiowRow, after the camera's rows)
  V3 lens_u = zero3(), lens_v = zero3(), sky_bot = zero3(), sky_top = zero3();
  bool lens_on = false, sky_on = false;
  if constexpr (RTIOW) {
    const float* ext = L.cam + C_ROWS;
    lens_u = ld3(ext, R_LUX, 1, 0);
    lens_v = ld3(ext, R_LVX, 1, 0);
    lens_on = ld(ext, R_LENS_ON, 1, 0) != 0.0f;
    sky_bot = ld3(ext, R_SBR, 1, 0);
    sky_top = ld3(ext, R_STR, 1, 0);
    sky_on = ld(ext, R_SKY_ON, 1, 0) != 0.0f;
  }

  // pixel lin's center (camera.cuh:97-109) and base seed (camera.cu:25)
  V3 pc;
  uint32_t base;
  const auto at_pixel = [&]() {
    const int i = lin % width;  // column
    const int j = lin / width + L.row_offset;  // image row (lin counts within the band)
    pc = add(add(ld3(L.cam, C_P00X, 1, 0), scale(du, (float)i)), scale(dv, (float)j));
    const uint32_t w32 = (uint32_t)width;
    base = wang_hash(L.reference_quirk ? (uint32_t)i * w32 + (uint32_t)j
                                       : (uint32_t)j * w32 + (uint32_t)i);
  };
  at_pixel();

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  uint32_t cnt[COUNTS] = {};  // COUNT's (dead code without it)
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
      if (++s == L.spp) {  // the pixel's sums, then the pool's next pixel
        float* px = L.out + (size_t)lin * 3;
        px[0] = acc_r;
        px[1] = acc_g;
        px[2] = acc_b;
        // one atomicAdd for the lanes that refill together in this pass
        const unsigned group = __activemask();
        const int lane = threadIdx.x & 31, leader = __ffs(group) - 1;
        int c = 0;
        if (lane == leader) c = atomicAdd(L.next, __popc(group));
        c = __shfl_sync(group, c, leader) + __popc(group & ((1u << lane) - 1u));
        if (c >= pool) {
          if constexpr (COUNT) *drained = 1u;
          break;
        }
        lin = npx - pool + c;
        at_pixel();
        acc_r = acc_g = acc_b = 0.0f;
        s = 0;
      }
      if constexpr (COUNT) ++cnt[7];
      seed = wang_hash(base + L.sample_start + (uint32_t)s);
      const float ux = rand01(seed);  // x before y
      const float uy = rand01(seed);
      float ox, oy;
      if (L.strat_k > 0) {  // stratified: cell (s_g mod k, floor(s_g / k))
        const float kf = (float)L.strat_k;
        const float sg = __uint2float_rn(L.sample_start + (uint32_t)s);
        ox = (fmodf(sg, kf) + ux) / kf - 0.5f;
        oy = (floorf(sg / kf) + uy) / kf - 0.5f;
      } else {
        ox = ux - 0.5f;
        oy = uy - 0.5f;
      }
      o = cam_o;
      if constexpr (RTIOW) {
        if (lens_on) {  // two draws after the jitter's: a uniform point on the lens
          const float l1 = rand01(seed);
          const float l2 = rand01(seed);
          const float r = sqrtf(l1);
          const float theta = TWO_PI_F * l2;
          o = add(cam_o, add(scale(lens_u, r * cosf(theta)), scale(lens_v, r * sinf(theta))));
        }
      }
      d = sub(add(add(pc, scale(du, ox)), scale(dv, oy)), o);
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
        if (*drained) ++cnt[10];
      }
    }

    const float a = dot(d, d);
    const float inv_a = 1.0f / a;
    float best = K_INFINITY;
    int widx = -1;
    float best_alpha = 0.0f, best_beta = 0.0f;
    if constexpr (ISECT == BVH) {
      // -- BVH nearest hit: the child-pair walk (see the note at the top);
      //    t <= closest at the leaves, near child first
      const V3 iv = make_v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
      int2 stack[BVH_STACK];  // (node code, tmin bits), in local memory
      int sp = 0;
      best = T_MAX;  // the walk's closest starts at the interval's end
      float tmin;
      if constexpr (COUNT) ++cnt[6];
      const float4 root_lo = N.quad(0, 0), root_hi = N.quad(0, 1);
      int next = bvh_box(root_lo, root_hi, o, iv, best, &tmin) ? bvh_child(root_lo, root_hi)
                                                                : BVH_NONE;
      // each pass visits a record or tests a leaf, then pops while no node
      // is pending, skipping an entry that no longer starts below best
      for (;;) {
        if (next >= 0) {  // a visit: both children of record next >> 2
          const int rec = next >> 2, axis = next & 3;
          const float4 l_lo = N.quad(rec, 0), l_hi = N.quad(rec, 1);
          const float4 r_lo = N.quad(rec, 2), r_hi = N.quad(rec, 3);
          if constexpr (COUNT) cnt[6] += 2;
          float l_t, r_t;
          const bool l_ok = bvh_box(l_lo, l_hi, o, iv, best, &l_t);
          const bool r_ok = bvh_box(r_lo, r_hi, o, iv, best, &r_t);
          const float da = axis == 0 ? d.x : (axis == 1 ? d.y : d.z);
          const bool left_first = da >= 0.0f;  // near is the left child
          const int l_c = bvh_child(l_lo, l_hi), r_c = bvh_child(r_lo, r_hi);
          const bool far_ok = left_first ? r_ok : l_ok;
          const int far = left_first ? r_c : l_c;
          if (left_first ? l_ok : r_ok) {  // near next, far from the stack
            if (far_ok) stack[sp++] = make_int2(far, __float_as_int(left_first ? r_t : l_t));
            next = left_first ? l_c : r_c;
          } else {
            next = far_ok ? far : BVH_NONE;
          }
        } else if (next != BVH_NONE) {  // a leaf: its one primitive
          const int r = -2 - next;
          next = BVH_NONE;
          if constexpr (COUNT) {
            ++cnt[2];
            ++cnt[3];
          }
          if (r < num_s) {
            const float t = sphere_t(P, r, o, d, a, inv_a);
            if (t <= best) {
              best = t;
              widx = r;
            }
          } else if (plane_hit<SMEM, true>(P, r - num_s, o, d, &best, &best_alpha, &best_beta)) {
            widx = r;
          }
        } else {
          break;  // nothing pending and the stack empty
        }
        while (next == BVH_NONE && sp > 0) {
          const int2 e = stack[--sp];
          if (best > __int_as_float(e.y)) next = e.x;
        }
      }
    } else if constexpr (ISECT == CLUSTERED) {
      // -- clustered nearest hit: the stackless walk of the cluster tree;
      //    each node's slab test is culling.py:40-60's, then the
      //    primitives of the leaves it reaches; strict < in (cluster,
      //    slot) order
      const float ivx = guarded_inv(d.x), ivy = guarded_inv(d.y), ivz = guarded_inv(d.z);
      const int nn = L.num_nodes;
      for (int node = 0;;) {
        // walk to the next leaf to visit, then visit it (while-while: the
        // lanes of a warp test their leaves' primitives together)
        int c = -1;
        while (node < nn) {
          const float4 lo = N.lo(node), hi = N.hi(node);
          if constexpr (COUNT) ++cnt[6];
          const float tx1 = (lo.x - o.x) * ivx;
          const float tx2 = (hi.x - o.x) * ivx;
          const float ty1 = (lo.y - o.y) * ivy;
          const float ty2 = (hi.y - o.y) * ivy;
          const float tz1 = (lo.z - o.z) * ivz;
          const float tz2 = (hi.z - o.z) * ivz;
          const float tmin = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)),
                                   fmaxf(fminf(tz1, tz2), T_MIN));
          const float tmax = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)),
                                   fminf(fmaxf(tz1, tz2), K_INFINITY));
          if (!(tmax > tmin) || tmin > best * PRUNE) {
            node = __float_as_int(lo.w);  // past the subtree
            continue;
          }
          ++node;
          c = __float_as_int(hi.w);  // -1: an internal node, its lower child is next
          if (c >= 0) break;
        }
        if (c < 0) break;  // past the last node
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
      //    wins ties), as tracer_torch/render/hit.py's argmin, past the
      //    object groups whose ball the ray cannot reach (the note at the top)
      unsigned use = 0;  // bit g: the ray may reach group g's ball
      for (int g = 0; g < P.num_g; ++g) {
        const float4 c = P.group(g, 0);  // centre, radius at the centre
        const V3 oc = sub(o, xyz(c));
        const float b = dot(oc, d);
        const V3 l = sub(oc, scale(d, b * inv_a));
        const float oo = dot(oc, oc);
        const float rr = P.group(g, 2).x * oo + c.w;  // grown with the origin's distance
        const float r2 = rr * rr;
        if (dot(l, l) <= r2 && (b <= 0.0f || oo <= r2)) use |= 1u << g;
      }
      if constexpr (COUNT) {  // groups entered; every primitive but the skipped ranges'
        cnt[2] += __popc(use);
        cnt[3] += num_s + num_p;
        for (int g = 0; g < P.num_g; ++g) {
          if (!((use >> g) & 1u)) {
            cnt[3] -= P.template bound<1>(g) - P.template bound<0>(g) +
                      P.template bound<3>(g) - P.template bound<2>(g);
          }
        }
      }
      int g = 0, at = P.template bound<0>(0);
      for (int k = 0;; ++k) {
        skip_groups<0>(P, use, k, g, at);
        if (k >= num_s) break;
        const float t = sphere_t(P, k, o, d, a, inv_a);
        if (t < best) {
          best = t;
          widx = k;
        }
      }
      g = 0;
      at = P.template bound<2>(0);
      for (int k = 0;; ++k) {
        skip_groups<2>(P, use, k, g, at);
        if (k >= num_p) break;
        if (plane_hit(P, k, o, d, &best, &best_alpha, &best_beta)) widx = num_s + k;
      }
    }

    if (widx < 0) {
      // miss: background (RTIOW: or the sky), the path ends (camera.cu:
      // 226-229); the tape keeps its -1
      V3 miss = bg;
      if constexpr (RTIOW) {
        if (sky_on) {
          const float uz = d.z * (1.0f / sqrtf(fmaxf(a, 1e-30f)));
          const float t = 0.5f * (uz + 1.0f);
          miss = add(scale(sky_bot, 1.0f - t), scale(sky_top, t));
        }
      }
      fin = add(fin, mul(beta, miss));
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
    if constexpr (COUNT) {  // a warp pass that scatters; mixed: lanes of several materials
      const unsigned sc = __activemask();
      const unsigned same = __match_any_sync(sc, mtype);
      if ((int)(threadIdx.x & 31) == __ffs(sc) - 1) {
        ++cnt[8];
        if (same != sc) ++cnt[9];
      }
    }

    if constexpr (REF) {
      // -- the reference stream's scatter (scatter.py:scatter_reference), then
      //    the bounce's tail as below, without the fixed stream's roulette (the
      //    fixed instantiations compile the code below this block unchanged)
      bool ok;
      V3 new_o = p, new_d, att = albedo;
      const V3 ud = scale(d, 1.0f / sqrtf(fmaxf(a, 1e-30f)));
      if (mtype == LAMBERTIAN) {  // materials.h:73-79
        new_d = hemisphere_dir_ref(seed, nrm);
        ok = true;
      } else if (mtype == METAL) {  // materials.h:81-95
        if (rand01(seed) < METAL_SPECULAR_P) {
          const V3 ball = rand_in_unit_sphere_ref(seed);
          new_d = add(reflect(ud, nrm), scale(ball, ld(join, J_FUZZ, n, widx)));
          ok = dot(new_d, nrm) > 0.0f;
        } else {
          new_d = hemisphere_dir_ref(seed, nrm);
          ok = true;
        }
      } else if (mtype == DIELECTRIC) {  // materials.h:97-133
        DIELECTRIC_SCATTER(rand01(seed), rand01(seed))
      } else {  // DIFFUSE_LIGHT absorbs, no draws (materials.h:135-137)
        ok = false;
      }
      if (!ok) {
        ended = true;
        continue;
      }
      beta = mul(beta, att);
      o = new_o;
      d = new_d;
      ended = ++depth == max_depth;
      continue;
    }
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
    if (RTIOW && mtype == RTIOW_LAMBERTIAN) {  // n + unit vector (RTIOW section 9.4)
      const V3 s_dir = add(nrm, ball_dir);
      const bool s_zero = fabsf(s_dir.x) < NEAR_ZERO_EPS && fabsf(s_dir.y) < NEAR_ZERO_EPS &&
                          fabsf(s_dir.z) < NEAR_ZERO_EPS;
      new_d = s_zero ? nrm : s_dir;
      ok = true;
    } else if (RTIOW && mtype == RTIOW_METAL) {  // no specular gate (RTIOW section 9.6)
      new_d = add(reflect(ud, nrm), scale(ball, ld(join, J_FUZZ, n, widx)));
      ok = dot(new_d, nrm) > 0.0f;
    } else if (mtype == LAMBERTIAN) {  // materials.h:73-79
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
      DIELECTRIC_SCATTER(u_refl, u_rr)
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
  if constexpr (COUNT) {
    for (int c = 0; c < COUNTS; ++c) {
      if (cnt[c] != 0) atomicAdd(L.counts + c, (unsigned long long)cnt[c]);
    }
  }
}

#undef DIELECTRIC_SCATTER

// ---- the kernel ----

// K1 (RECORD = false, ISECT = BRUTE), K1-rec (RECORD), K1-cl (ISECT =
// CLUSTERED), K1-bvh (ISECT = BVH; RTIOW, the book's estimator) and K1-ref
// (REF, ISECT BRUTE or BVH).
// With SMEM the block first stages the primitive records in dynamic shared
// memory, with NSMEM the node records (after them), in one loop; a BRUTE
// block with SMEM stages its group records in the node records' place.
// The grid is one wave of resident blocks (launch), so a block stages its
// records once for all the pixels its lanes take from the pool.
template <bool RECORD, int ISECT, bool SMEM, bool NSMEM, bool COUNT, bool REF, bool RTIOW>
__global__ void __launch_bounds__(THREADS) trace_kernel(const Launch L) {
  extern __shared__ float4 records[];
  Prims<SMEM> P{L.sph, L.pla, L.num_s, L.num_p};
  Nodes<NSMEM> N{L.nodes};
  constexpr bool GSMEM = SMEM && ISECT == BRUTE;  // the group records in shared memory
  if constexpr (ISECT == BRUTE) {
    P.grp = L.nodes;
    P.num_g = L.num_nodes;
  }
  if constexpr (SMEM || NSMEM) {
    const int ns4 = SMEM ? L.num_s * SPHERE_F4 : 0;
    const int np4 = ns4 + (SMEM ? L.num_p * PLANE_F4 : 0);
    const int n4 = np4 + (NSMEM || GSMEM ? NODE_F4<ISECT> * L.num_nodes : 0);
    for (int q = threadIdx.x; q < n4; q += blockDim.x) {
      if (q < ns4) {
        records[q] = __ldg(L.sph + q);
      } else if (q < np4) {
        records[q] = __ldg(L.pla + (q - ns4));
      } else {
        records[q] = __ldg(L.nodes + (q - np4));
      }
    }
    __syncthreads();
    if constexpr (SMEM) {
      P.sph = records;
      P.pla = records + ns4;
    }
    if constexpr (NSMEM) N.rec = records + np4;
    if constexpr (GSMEM) P.grp = records + np4;
  }
  volatile unsigned* drained = nullptr;  // COUNT: the warp's flag (trace_pixels)
  if constexpr (COUNT) {
    __shared__ unsigned warp_drained[THREADS / 32];
    if ((threadIdx.x & 31) == 0) warp_drained[threadIdx.x >> 5] = 0u;
    __syncwarp();
    drained = warp_drained + (threadIdx.x >> 5);
  }
  trace_pixels<RECORD, ISECT, SMEM, NSMEM, COUNT, REF, RTIOW>(
      L, P, N, blockIdx.x * THREADS + threadIdx.x, drained);
}

// One wave of `kernel`'s blocks with `bytes` of dynamic shared memory on
// the current device: resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) times the SMs, queried
// once per kernel, device and shared size.
int wave_blocks(const void* kernel, size_t bytes, int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> waves;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const std::lock_guard<std::mutex> hold(mu);
  const auto key = std::make_tuple(kernel, dev, bytes);
  auto it = waves.find(key);
  if (it == waves.end()) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    it = waves.emplace(key, per_sm * sms).first;
  }
  *blocks = it->second;
  return 0;
}

template <bool RECORD, int ISECT, bool SMEM, bool NSMEM, bool COUNT, bool REF = false,
          bool RTIOW = false>
int launch(const Launch& L, cudaStream_t st) {
  const auto kernel = trace_kernel<RECORD, ISECT, SMEM, NSMEM, COUNT, REF, RTIOW>;
  const bool stage_nodes = NSMEM || (SMEM && ISECT == BRUTE);  // the kernel's GSMEM
  const size_t bytes = sizeof(float4) * ((SMEM ? (size_t)L.num_s * SPHERE_F4 +
                                                     (size_t)L.num_p * PLANE_F4 : 0) +
                                         (stage_nodes ? NODE_F4<ISECT> * (size_t)L.num_nodes : 0));
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int wave = 0;
  const int e = wave_blocks(reinterpret_cast<const void*>(kernel), bytes, &wave);
  if (e != 0) return e;
  const int blocks = std::min((L.width * L.height + THREADS - 1) / THREADS, wave);
  kernel<<<blocks, THREADS, bytes, st>>>(L);
  return static_cast<int>(cudaGetLastError());
}

template <bool RECORD, int ISECT, bool NSMEM, bool RTIOW = false>
int launch_mode(const Launch& L, bool smem, cudaStream_t st) {
  if (L.counts != nullptr) {
    return smem ? launch<RECORD, ISECT, true, NSMEM, true, false, RTIOW>(L, st)
                : launch<RECORD, ISECT, false, NSMEM, true, false, RTIOW>(L, st);
  }
  return smem ? launch<RECORD, ISECT, true, NSMEM, false, false, RTIOW>(L, st)
              : launch<RECORD, ISECT, false, NSMEM, false, false, RTIOW>(L, st);
}

// K1-ref's uncounted instantiations; its one counted instantiation (brute,
// records in global memory, for any scene) is launched by the entry point.
template <int ISECT, bool NSMEM>
int launch_ref(const Launch& L, bool smem, cudaStream_t st) {
  return smem ? launch<false, ISECT, true, NSMEM, false, true>(L, st)
              : launch<false, ISECT, false, NSMEM, false, true>(L, st);
}

}  // namespace

// Plain C entry point, loaded with ctypes by tracer_torch/kernels/megakernel.py.
// mode 0 renders (K1), 1 records (K1-rec: idx_tape [spp*max_depth,
// width*height] and tex_tape [tape_f*spp*max_depth, width*height], nullptr
// when tex is or tape_f is 0, come filled with their neutral values; tape_f
// is 0, 3, 9 or 13),
// 2 renders cluster-culled (K1-cl: nodes [num_nodes, 2] float4 records and
// slots [clusters * k] as tracer_torch/kernels/cluster.py packs them), 3
// renders through the BVH (K1-bvh: nodes [num_nodes, 4] float4 child-pair
// records as tracer_torch/kernels/pack.py:pack_bvh packs them; the tree's
// depth at most BVH_STACK), 4 and 5 render modes 0 and 3 on the reference stream
// (K1-ref: rng_mode="reference"; counted in mode 4 only; rr_start is
// ignored), 6 renders mode 3 with the RTIOW book's estimator (cam holds
// C_ROWS + R_ROWS rows: the lens and the sky after the camera's). In the
// brute modes 0, 1 and 4, nodes [num_nodes, 3] float4 are the scene's
// object groups as tracer_torch/kernels/pack.py:pack_groups
// packs them (num_nodes 0: no groups, every primitive tested). sph and pla
// are 16-byte aligned record tables (tracer_torch/kernels/pack.py);
// shared_tables stages them in shared memory (with a brute mode's groups),
// shared_nodes the nodes of modes 2, 3, 5 and 6. strat_k > 0 stratifies the
// jitter over a strat_k x strat_k grid (every mode). row_offset >= 0 makes the launch the
// band of rows row_offset .. row_offset + height - 1 of a taller image (every
// mode): out and the tapes stay band-sized, seeds and rays are the image's.
// counts is nullptr (the uncounted kernels) or COUNTS zeroed counters (the
// counted ones). next is one zeroed int, the launch's pixel pool (every
// mode; a launch uses it up, so each launch takes a fresh one).
// rr_start < 0 turns roulette off; tex == nullptr renders untextured.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() so a refused launch reaches the caller.
extern "C" int tracer_megakernel_launch(
    int mode, const float* sph, int num_s, const float* pla, int num_p, const float* join,
    const float* tex, int th, int tw, const float* cam, float* out,
    int width, int height, int spp, int max_depth, unsigned int sample_start,
    int reference_quirk, int rr_start, int* idx_tape, float* tex_tape, int tape_f,
    const float* nodes, const int* slots, int num_nodes, int k, int shared_tables,
    int shared_nodes, int strat_k, int row_offset, unsigned long long* counts, int* next,
    void* stream) {
  if (next == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Launch L{reinterpret_cast<const float4*>(sph), reinterpret_cast<const float4*>(pla),
                 num_s, num_p, join, tex, th, tw, cam, out, width, height, spp, max_depth,
                 sample_start, reference_quirk, rr_start, idx_tape, tex_tape, tape_f,
                 reinterpret_cast<const float4*>(nodes), slots, num_nodes, k, strat_k, row_offset,
                 counts, next};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool smem = shared_tables != 0;
  switch (mode) {
    case 0: return launch_mode<false, BRUTE, false>(L, smem, st);
    case 1: return launch_mode<true, BRUTE, false>(L, smem, st);
    case 2: return shared_nodes != 0 ? launch_mode<false, CLUSTERED, true>(L, smem, st)
                                     : launch_mode<false, CLUSTERED, false>(L, smem, st);
    case 3: return shared_nodes != 0 ? launch_mode<false, BVH, true>(L, smem, st)
                                     : launch_mode<false, BVH, false>(L, smem, st);
    case 4: return counts != nullptr ? launch<false, BRUTE, false, false, true, true>(L, st)
                                     : launch_ref<BRUTE, false>(L, smem, st);
    case 5:
      if (counts != nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return shared_nodes != 0 ? launch_ref<BVH, true>(L, smem, st)
                               : launch_ref<BVH, false>(L, smem, st);
    case 6: return shared_nodes != 0 ? launch_mode<false, BVH, true, true>(L, smem, st)
                                     : launch_mode<false, BVH, false, true>(L, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
