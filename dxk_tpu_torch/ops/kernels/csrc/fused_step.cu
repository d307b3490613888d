// Fused physics step for NVIDIA Hopper (sm_90a): narrowphase + contact prep +
// joint prep + the whole iterated constraint solve in one kernel.
//
// Replaces the JAX package's TPU kernel
//   dxk_tpu/ops/pallas/fused_step.py::_fused_step_batched (body _fused_core)
// for scenes whose pair groups are any of the 15 pairs of sphere, capsule,
// cylinder, box and hull, with joints of all six types (distance, ball,
// fixed, hinge, cone-twist, slider), in the averaged ("jacobi") solve mode
// with joint prep in the kernel.
// The plain PyTorch version of the same function is
// ops/kernels/fused_step.py::_fused_core; this file follows it operation for
// operation, so the two agree to rounding.
//
// What bounds it on an H100: latency, not bytes or operations. One env reads
// ~0.6k floats and writes ~0.8k, runs a branch-heavy narrowphase over ~150
// pair rows and then `iters` rounds of short, dependent joint and contact
// solves whose work fits one warp (13 joints and ~6 live pair rows per env in
// the ragdoll scene, 16 joints of each type in the constraint zoo). Each round
// is a chain of loads, a few dozen flops and a barrier, so the card is kept
// busy by having many envs in flight, each on as few lanes as its work needs:
//   * envs are packed several to a block, each on a team of whole warps
//     (FusedTables.launch_plan picks envs per block and warps per env from
//     the scene's shared memory and the batch: one warp per env at large
//     batch, up to eight when the batch would leave SMs idle). Inside the
//     iteration loop a team meets only itself: __syncwarp for one warp, a
//     named barrier for several; no block-wide barrier follows the staging
//     of the block's one copy of the static inverse masses;
//   * shared memory holds what the solve rewrites (body velocities, joint
//     rows and impulses, one joint pass's deltas, inverse inertias) and the
//     live lists, a few KB per env; the contact points' 30 fields and the
//     row deltas live in the wrapper's device-memory scratch, written and
//     read for live rows and points only (a handful per env, L1/L2 resident),
//     so shared memory does not grow with the point slots and a scene of
//     1,000+ pair rows fits a block;
//   * every lane of a team works: pair rows and then joints are spread over
//     its lanes for the narrowphase and the preps; the team's first warp then
//     lists each phase's live rows in row order (ballot + popc) and each
//     phase's and body's live incidence entries in the static lists' order
//     (a shuffle scan), so contact passes and their per-body sums touch live
//     rows only; joint passes and every per-body sum run across the team;
//   * per-body delta sums walk incidence lists in a fixed order - no atomics,
//     results are reproducible from run to run;
//   * static scene data (pair -> collider/body indices, friction/restitution,
//     joint wiring and parameters, inverse degrees, each hull geometry's local
//     vertices, planes and merged-face topology) comes in as two small device
//     tables, so one compiled library serves any scene of these types;
//   * the hull recipes (a distance GJK, an exact polytope SAT and a
//     reference-face clip) and the cylinder recipes (alternating projections
//     and candidate-axis SATs) run one lane per pair row, out of line, with
//     a polytope side's world vertices and the clip slots in per-thread local
//     memory (hulls of up to VCAP vertices and SCAP / 2 loop points; a scene
//     with larger hulls gets them in the lane's slice of a device-memory
//     hull scratch instead, the same code over pointers); their fixed-count
//     loops stop a row once further rounds could not change its result.
// The file is compiled with -fmad=false: the box-box SAT and manifold reduction
// break ties within 1e-4 relative, and a fused multiply-add can put a value on
// the other side of a tie than the plain version's separately rounded ops.
//
// Not done yet: no cp.async/TMA staging of the inputs, the sequential chain
// still runs on one lane per env, a heavy narrowphase row (hull, cylinder) on
// one lane, no CUDA graph around the host's launches.
//
// Built with -DDXK_PREPPED_JOINTS=1 (and the sphere and cylinder recipes), the
// same kernel also replaces the TPU kernel's two other modes, behind the entry
// point dxk_fused_step_prepped_launch:
//   * joint rows prepared outside the kernel (the JAX package's XLA preps,
//     ops/solver.py; here dxk_tpu_torch/ops/solver.py) come in as one row of
//     floats per env and are copied into the env's joint rows in place of the
//     in-kernel joint prep;
//   * the sequential solve of solver_mode "fused_seq" (_fused_core with
//     sequential=True): after the parallel narrowphase and contact prep, one
//     lane of the env's team walks the whole dependent chain - per iteration
//     each joint in JOINT_ORDER, then every live pair row in phase order with
//     its live points in order, both bodies' velocities stored after each
//     joint and each row. There is no parallelism to take within an env
//     there; the teams of a block walk their envs' chains side by side;
//   * contact rows prepared outside the kernel (the prep-passed pseudo-group of
//     a heightfield scene: one row per collider against the static dummy, 4
//     points each, prepared by dxk_tpu_torch/ops/solver.py's prep_contacts):
//     the row's lane copies the env's live prepared points (eff_n > 0) into
//     their slots of the scratch (a point's 30 floats side by side); these rows
//     (kind PASSED_ROW, the trailing phase) skip the narrowphase, and the
//     solve loops take them like any other row (the kernel's invm[body_a]
//     equals the prep's inv_ma on every live row).
// The other two builds compile none of this code.

#include <cuda_runtime.h>
#include <math.h>

#ifndef DXK_SHAPE_RECIPES
#define DXK_SHAPE_RECIPES 0
#endif
#ifndef DXK_PREPPED_JOINTS
#define DXK_PREPPED_JOINTS 0
#endif

#define DF __device__ __forceinline__
#define DN __device__ __noinline__

namespace {

constexpr float EPSILON = 1e-6f;
constexpr float SAT_TIE_TOL = 1e-4f;
constexpr float REDUCE_TIE_TOL = 1e-4f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float PI_2_F = 1.57079632679489661923f;
constexpr float PI_4_F = 0.78539816339744830962f;
constexpr float TAN_PI_8 = 0.4142135623730950f;
constexpr float DISTANCE_BETA = 0.1f;
constexpr float BALL_BETA = 0.1f;
constexpr float SLIDER_BETA = 0.1f;
constexpr float HINGE_ROTATION_BETA = 0.3f;
constexpr float HINGE_LIMIT_BETA = 0.1f;
constexpr float TWIST_LIMIT_BETA = 0.1f;
constexpr float SLIDER_LIMIT_BETA = 0.1f;
constexpr float DT_THRESHOLD = 1e-5f;

constexpr int POINT_FIELDS = 30;   // 8 vec3 + eff_n, eff_t, bias, fric + 2 impulses
constexpr int STATIC_WIDTH = 31;   // floats per joint in the static table
constexpr int ROW_INTS = 8;

// joint types in JOINT_ORDER (batched_solver.py): packed rows per joint,
// accumulated impulses per joint, controls per joint
constexpr int NJT = 6;
enum { J_DISTANCE, J_BALL, J_FIXED, J_HINGE, J_CONE_TWIST, J_SLIDER };
__host__ __device__ constexpr int joint_rows(int t) {
  return t == J_DISTANCE ? 17 : t == J_BALL ? 18 : t == J_FIXED ? 30
       : t == J_HINGE ? 46 : t == J_CONE_TWIST ? 59 : 58;
}
__host__ __device__ constexpr int joint_accs(int t) {
  return t == J_HINGE ? 2 : t == J_CONE_TWIST ? 4 : t == J_SLIDER ? 2 : 0;
}
__host__ __device__ constexpr int joint_ctls(int t) {
  return t == J_HINGE ? 3 : t == J_CONE_TWIST ? 7 : t == J_SLIDER ? 3 : 0;
}

struct V3 { float x, y, z; };
struct Q4 { float x, y, z, w; };

DF V3 mk(float x, float y, float z) { V3 r; r.x = x; r.y = y; r.z = z; return r; }
DF V3 add(V3 a, V3 b) { return mk(a.x + b.x, a.y + b.y, a.z + b.z); }
DF V3 sub(V3 a, V3 b) { return mk(a.x - b.x, a.y - b.y, a.z - b.z); }
DF V3 muls(V3 a, float s) { return mk(a.x * s, a.y * s, a.z * s); }
DF V3 neg(V3 a) { return mk(-a.x, -a.y, -a.z); }
DF float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
DF V3 cross(V3 a, V3 b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
DF float sqlen(V3 a) { return dot(a, a); }
DF V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }
DF float clipf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }
DF float clamp01(float x) { return clipf(x, 0.0f, 1.0f); }
DF float comp(V3 a, int i) { return i == 0 ? a.x : (i == 1 ? a.y : a.z); }
DF V3 ld3(const float* p) { return mk(p[0], p[1], p[2]); }
DF Q4 ld4(const float* p) { Q4 q; q.x = p[0]; q.y = p[1]; q.z = p[2]; q.w = p[3]; return q; }
DF Q4 conj(Q4 q) { Q4 r; r.x = -q.x; r.y = -q.y; r.z = -q.z; r.w = q.w; return r; }

DF V3 qrot(Q4 q, V3 v) {
  V3 qv = mk(q.x, q.y, q.z);
  V3 t = muls(cross(qv, v), 2.0f);
  return add(add(v, muls(t, q.w)), cross(qv, t));
}
DF V3 qirot(Q4 q, V3 v) { return qrot(conj(q), v); }

DF V3 matvec(const float* m, V3 v) {
  return mk(m[0] * v.x + m[1] * v.y + m[2] * v.z,
            m[3] * v.x + m[4] * v.y + m[5] * v.z,
            m[6] * v.x + m[7] * v.y + m[8] * v.z);
}
DF float inv_nz(float x) { return x != 0.0f ? 1.0f / x : 0.0f; }

// ---- inverse trig: the Cephes atanf polynomial of core/fastmath.py ----------

DF float atan01(float t) {
  bool hi = t > TAN_PI_8;
  float tr = hi ? (t - 1.0f) / (t + 1.0f) : t;
  float z = tr * tr;
  float p = (((8.05374449538e-2f * z - 1.38776856032e-1f) * z
              + 1.99777106478e-1f) * z - 3.33329491539e-1f) * z * tr + tr;
  return hi ? PI_4_F + p : p;
}
DF float fm_atan2(float y, float x) {
  float ax = fabsf(x), ay = fabsf(y);
  float mx = fmaxf(ax, ay);
  float t = fminf(ax, ay) / (mx > 0.0f ? mx : 1.0f);
  float r = atan01(t);
  r = ay > ax ? PI_2_F - r : r;
  r = x < 0.0f ? PI_F - r : r;
  return y < 0.0f ? -r : r;
}
DF float fm_acos(float x) {
  float xc = clipf(x, -1.0f, 1.0f);
  float s = sqrtf(fmaxf((1.0f - xc) * (1.0f + xc), 0.0f));
  return fm_atan2(s, xc);
}

// ---- narrowphase recipes (ops/kernels/cm_narrowphase.py) --------------------

// A / B: each side's world collider params in device memory, the point or
// first end (a3), the second end or half extents (b3) and the rotation (q4)
struct ColSide { const float *a3, *b3, *q4; };

struct Manifold {
  V3 pt[4];
  float dp[4];
  V3 n;
  int mask;      // bit k: point k live
};

DF V3 closest_pt_seg(V3 q, V3 a, V3 b) {
  V3 ab = sub(b, a);
  float t = clamp01(dot(sub(q, a), ab) / fmaxf(sqlen(ab), 1e-12f));
  return add(a, muls(ab, t));
}

DF void closest_seg_seg(V3 p1, V3 q1, V3 p2, V3 q2, V3& c1, V3& c2) {
  V3 d1 = sub(q1, p1), d2 = sub(q2, p2), r = sub(p1, p2);
  float a = sqlen(d1), e = sqlen(d2);
  float f = dot(d2, r), c = dot(d1, r), b = dot(d1, d2);
  float denom = a * e - b * b;
  float s = denom > 1e-12f ? clamp01((b * f - c * e) / denom) : 0.0f;
  float t = (b * s + f) / fmaxf(e, 1e-12f);
  s = t < 0.0f ? clamp01(-c / fmaxf(a, 1e-12f))
               : (t > 1.0f ? clamp01((b - c) / fmaxf(a, 1e-12f)) : s);
  t = clamp01(t);
  if (a <= 1e-12f) s = 0.0f;
  if (e <= 1e-12f) t = 0.0f;
  c1 = add(p1, muls(d1, s));
  c2 = add(p2, muls(d2, t));
}

DF void normalize_or_up(V3 n, V3& out, float& dist, bool& deg) {
  float sq = sqlen(n);
  dist = sqrtf(fmaxf(sq, 0.0f));
  float inv = 1.0f / fmaxf(dist, 1e-30f);
  deg = sq == 0.0f;
  out = deg ? mk(0.0f, 1.0f, 0.0f) : muls(n, inv);
}

DF void sphere_sphere(V3 c1, float r1, V3 c2, float r2,
                      V3& point, float& depth, V3& normal, bool& hit) {
  V3 n = sub(c2, c1);
  float rs = r1 + r2;
  float sq = sqlen(n);
  hit = sq <= rs * rs;
  float dist; bool deg;
  normalize_or_up(n, normal, dist, deg);
  depth = rs - (deg ? 0.0f : dist);
  point = muls(add(add(c1, muls(normal, r1)), sub(c2, muls(normal, r2))), 0.5f);
}

DN void capsule_capsule(V3 aa, V3 ab, float ar, V3 ba, V3 bb, float br, Manifold& o) {
  V3 a_dirv = sub(ab, aa);
  float a_len = sqrtf(fmaxf(sqlen(a_dirv), 0.0f));
  V3 a_dir = muls(a_dirv, 1.0f / fmaxf(a_len, 1e-30f));
  V3 b_dirv = sub(bb, ba);
  float b_len = sqrtf(fmaxf(sqlen(b_dirv), 0.0f));
  V3 b_dir = muls(b_dirv, 1.0f / fmaxf(b_len, 1e-30f));
  float par = dot(a_dir, b_dir);
  bool is_parallel = fabsf(par) > 0.99f;

  // parallel: interval-overlap 2-point manifold
  bool swap = par < 0.0f;
  V3 p_ba = sel(swap, bb, ba), p_bb = sel(swap, ba, bb);
  float b0 = dot(a_dir, sub(p_ba, aa));
  float b1 = dot(a_dir, sub(p_bb, aa));
  float left = fmaxf(0.0f, b0), right = fminf(a_len, b1);
  bool overlaps = right >= left;

  V3 ca0 = add(aa, muls(a_dir, left));
  V3 ca1 = add(aa, muls(a_dir, right));
  V3 cb0 = closest_pt_seg(ca0, p_ba, p_bb);
  V3 cb1 = add(cb0, muls(a_dir, right - left));
  V3 normal2; float d; bool deg;
  normalize_or_up(sub(cb0, ca0), normal2, d, deg);
  deg = d < EPSILON;
  normal2 = deg ? mk(0.0f, 1.0f, 0.0f) : normal2;
  float pen = (ar + br) - (deg ? 0.0f : d);
  bool two_hit = overlaps && (pen >= 0.0f);
  V3 p2_0 = muls(add(ca0, cb0), 0.5f);
  V3 p2_1 = muls(add(ca1, cb1), 0.5f);

  V3 one_pt, one_n; float one_dp; bool one_hit;
  if (is_parallel) {
    // disjoint parallel intervals: end sphere vs end sphere
    bool use_a0 = 0.0f > b1;
    sphere_sphere(sel(use_a0, aa, ab), ar, sel(use_a0, p_bb, p_ba), br,
                  one_pt, one_dp, one_n, one_hit);
  } else {
    V3 c1, c2;
    closest_seg_seg(aa, ab, ba, bb, c1, c2);
    sphere_sphere(c1, ar, c2, br, one_pt, one_dp, one_n, one_hit);
  }
  bool use2 = is_parallel && overlaps;
  o.pt[0] = sel(use2, p2_0, one_pt);
  o.dp[0] = use2 ? pen : one_dp;
  o.n = sel(use2, normal2, one_n);
  bool m0 = use2 ? two_hit : one_hit;
  o.pt[1] = p2_1;
  o.dp[1] = pen;
  bool m1 = use2 && two_hit;
  o.mask = (m0 ? 1 : 0) | (m1 ? 2 : 0);
}

DF void clip_axis(float& t0, float& t1, float p, float d, float h) {
  // p + t*d <= h and >= -h
  #pragma unroll
  for (int si = 0; si < 2; ++si) {
    float sign = si == 0 ? 1.0f : -1.0f;
    float num = sign * h - p;
    float tcross = num / (d == 0.0f ? 1e30f : d);
    bool dpos = (d * sign) > 0.0f;
    bool viol = (sign * p) > h;
    t1 = dpos ? fminf(t1, tcross) : t1;
    t0 = (!dpos && d != 0.0f) ? fmaxf(t0, tcross) : t0;
    t1 = (d == 0.0f && viol) ? -1.0f : t1;
  }
}

DF float face_pen_min(V3 p, V3 bh) {
  float f0 = bh.x - fabsf(clipf(p.x, -bh.x, bh.x));
  float f1 = bh.y - fabsf(clipf(p.y, -bh.y, bh.y));
  float f2 = bh.z - fabsf(clipf(p.z, -bh.z, bh.z));
  return fminf(f0, fminf(f1, f2));
}

DF V3 clip_box(V3 p, V3 bh) {
  return mk(clipf(p.x, -bh.x, bh.x), clipf(p.y, -bh.y, bh.y), clipf(p.z, -bh.z, bh.z));
}

// closest points of segment la-lb and the box of half extents bh: alternating
// projection, fixed 8 rounds (_segment_box_closest_cm)
DF void segment_box_closest(V3 la, V3 lb, V3 bh, V3& s, V3& q) {
  s = muls(add(la, lb), 0.5f);
  for (int it = 0; it < 8; ++it) s = closest_pt_seg(clip_box(s, bh), la, lb);
  q = clip_box(s, bh);
}

// the radius-shifted axis segment clipped to the window of the box face that
// `normal` selects, box-local (_face_clip_segment_cm): two face-projected end
// points, their depths and live flags, and whether the interval is non-empty
struct FaceClip {
  V3 e0p, e1p;
  float dp_e0, dp_e1;
  bool m_e0, m_e1, clip_ok;
};

DF void face_clip_segment(V3 la, V3 lb, float ar, V3 bh, V3 normal, FaceClip& fc) {
  float an0 = fabsf(normal.x), an1 = fabsf(normal.y);
  bool fk0 = an0 > 0.99f;
  bool fk1 = !fk0 && an1 > 0.99f;
  V3 pa = add(la, muls(normal, ar));
  V3 pb = add(lb, muls(normal, ar));
  // side axes (u, v) of face k: (1,2), (0,2), (0,1); face axis k itself
  int iu = fk0 ? 1 : 0;
  int iv = fk0 ? 2 : (fk1 ? 2 : 1);
  int ik = fk0 ? 0 : (fk1 ? 1 : 2);
  float pa_u = comp(pa, iu), pa_v = comp(pa, iv);
  float d_u = comp(pb, iu) - pa_u, d_v = comp(pb, iv) - pa_v;
  float h_u = comp(bh, iu), h_v = comp(bh, iv);
  float t0 = 0.0f, t1 = 1.0f;
  clip_axis(t0, t1, pa_u, d_u, h_u);
  clip_axis(t0, t1, pa_v, d_v, h_v);
  fc.clip_ok = t1 >= t0;

  V3 seg_d = sub(pb, pa);
  V3 e0 = add(pa, muls(seg_d, t0));
  V3 e1 = add(pa, muls(seg_d, t1));
  float face_h = comp(bh, ik), n_k = comp(normal, ik);
  fc.dp_e0 = n_k * comp(e0, ik) + face_h;
  fc.dp_e1 = n_k * comp(e1, ik) + face_h;
  float ref_k = 0.0f + (-n_k * face_h);
  fc.e0p = e0; fc.e1p = e1;
  if (ik == 0) { fc.e0p.x = ref_k; fc.e1p.x = ref_k; }
  else if (ik == 1) { fc.e0p.y = ref_k; fc.e1p.y = ref_k; }
  else { fc.e0p.z = ref_k; fc.e1p.z = ref_k; }
  fc.m_e0 = fc.dp_e0 >= 0.0f;
  fc.m_e1 = fc.dp_e1 >= 0.0f;
}

DN void capsule_box(V3 aa, V3 ab, float ar, V3 bc, V3 bh, Q4 bq, Manifold& o) {
  V3 la = qirot(bq, sub(aa, bc));
  V3 lb = qirot(bq, sub(ab, bc));

  V3 s, q;
  segment_box_closest(la, lb, bh, s, q);
  V3 delta = sub(q, s);
  float d2 = sqlen(delta);
  bool inside = d2 <= 1e-12f;

  float dist = sqrtf(fmaxf(d2, 1e-30f));
  V3 n_shallow = muls(delta, 1.0f / dist);
  float depth_shallow = ar - dist;
  V3 point_shallow = muls(add(add(s, muls(n_shallow, ar)), q), 0.5f);

  // deep: min-translation face of the deeper-inside endpoint
  bool in_a = fabsf(la.x) <= bh.x && fabsf(la.y) <= bh.y && fabsf(la.z) <= bh.z;
  bool in_b = fabsf(lb.x) <= bh.x && fabsf(lb.y) <= bh.y && fabsf(lb.z) <= bh.z;
  float pen_a = face_pen_min(la, bh), pen_b = face_pen_min(lb, bh);
  bool pick_a = in_a && (!in_b || pen_a >= pen_b);
  V3 p_deep = sel(pick_a, la, sel(in_b, lb, s));

  float f0 = bh.x - fabsf(p_deep.x), f1 = bh.y - fabsf(p_deep.y), f2 = bh.z - fabsf(p_deep.z);
  bool k0 = f0 <= f1 && f0 <= f2;
  bool k1 = !k0 && f1 <= f2;
  bool k2 = !k0 && !k1;
  float fmin_ = k0 ? f0 : (k1 ? f1 : f2);
  float s0 = p_deep.x >= 0.0f ? 1.0f : -1.0f;
  float s1 = p_deep.y >= 0.0f ? 1.0f : -1.0f;
  float s2 = p_deep.z >= 0.0f ? 1.0f : -1.0f;
  V3 n_deep = mk(-(k0 ? s0 : 0.0f), -(k1 ? s1 : 0.0f), -(k2 ? s2 : 0.0f));
  float depth_deep = ar + fmin_;

  V3 normal = sel(inside, n_deep, n_shallow);
  float depth = inside ? depth_deep : depth_shallow;
  V3 point = sel(inside, p_deep, point_shallow);
  bool hit = inside || depth_shallow >= 0.0f;

  // parallel-to-face 2-point manifold: the radius-shifted axis segment
  // clipped to the face window
  float an0 = fabsf(normal.x), an1 = fabsf(normal.y), an2 = fabsf(normal.z);
  bool is_face = an0 > 0.99f || an1 > 0.99f || an2 > 0.99f;
  V3 axisv = sub(lb, la);
  V3 axis = muls(axisv, 1.0f / fmaxf(sqrtf(fmaxf(sqlen(axisv), 0.0f)), 1e-30f));
  bool parallel = fabsf(dot(normal, axis)) < 0.01f;
  bool enrich = is_face && parallel;

  FaceClip fc;
  face_clip_segment(la, lb, ar, bh, normal, fc);
  bool use = enrich && fc.clip_ok && (fc.m_e0 || fc.m_e1);
  V3 pt0 = sel(use, sel(fc.m_e0, fc.e0p, fc.e1p), point);
  float dp0 = use ? (fc.m_e0 ? fc.dp_e0 : fc.dp_e1) : depth;
  bool m0 = use ? (fc.m_e0 || fc.m_e1) : hit;
  bool m1 = use && fc.m_e0 && fc.m_e1;
  m0 = m0 && hit;
  m1 = m1 && hit;

  o.pt[0] = add(qrot(bq, pt0), bc);
  o.pt[1] = add(qrot(bq, fc.e1p), bc);
  o.dp[0] = dp0;
  o.dp[1] = fc.dp_e1;
  o.n = qrot(bq, normal);
  o.mask = (m0 ? 1 : 0) | (m1 ? 2 : 0);
}

DF V3 get_tangent(V3 n) {
  bool use_x = fabsf(n.x) >= 0.57735f;
  V3 t = use_x ? mk(n.y, -n.x, 0.0f) : mk(0.0f, n.z, -n.y);
  float ln = sqrtf(fmaxf(sqlen(t), 0.0f));
  return muls(t, 1.0f / fmaxf(ln, 1e-30f));
}

// Sutherland-Hodgman against one plane on an S-slot polygon; returns the new
// vertex count (manifold._clip_one_plane semantics: emit the crossing point,
// then the end vertex when it is inside; points past slot S are dropped, but
// counted, as in _clip_one_plane_cm).
DF int clip_one_plane(const V3* verts, const float* depths, int n, V3 pn, float pd,
                      V3* out_v, float* out_d, int S) {
  int o = 0;
  int n_safe = n > 1 ? n : 1;
  for (int k = 0; k < n; ++k) {
    int nxt = (k + 1) % n_safe;
    V3 sv = verts[k], ev = verts[nxt];
    float sdk = dot(sv, pn) + pd, esd = dot(ev, pn) + pd;
    float sdep = depths[k], ed = depths[nxt];
    bool s_in = sdk > 0.0f, e_in = esd > 0.0f;
    float a_abs = fabsf(sdk);
    float t = a_abs / fmaxf(a_abs + fabsf(esd), 1e-12f);
    if (s_in != e_in) {
      if (o < S) {
        out_v[o] = add(sv, muls(sub(ev, sv), t));
        out_d[o] = sdep + (ed - sdep) * t;
      }
      ++o;
    }
    if (e_in) {
      if (o < S) { out_v[o] = ev; out_d[o] = ed; }
      ++o;
    }
  }
  return o;
}

// first-max-wins argmax with the relative REDUCE_TIE_TOL margin
DF int masked_best(const float* scores, int n) {
  int best = 0;
  float bs = scores[0];
  for (int k = 1; k < n; ++k) {
    float sk = scores[k];
    if (sk > bs + (REDUCE_TIE_TOL * (fabsf(bs) + fabsf(sk)) + 1e-9f)) { bs = sk; best = k; }
  }
  return best;
}

// keep at most 4 of the nf clipped points (_reduce_manifold_cm): extreme along
// a tangent, farthest from it, largest triangle, largest added area; returns
// the count kept
DF int reduce_manifold(const V3* verts, const float* depths, int nf, V3 normal,
                       Manifold& o) {
  if (nf <= 4) {
    for (int k = 0; k < nf; ++k) { o.pt[k] = verts[k]; o.dp[k] = depths[k]; }
    return nf;
  }
  float sc[32];
  V3 search = get_tangent(normal);
  for (int k = 0; k < nf; ++k) sc[k] = dot(verts[k], search);
  int i0 = masked_best(sc, nf);
  V3 p0 = verts[i0];
  for (int k = 0; k < nf; ++k) sc[k] = sqlen(sub(verts[k], p0));
  int i1 = masked_best(sc, nf);
  V3 p1 = verts[i1];
  for (int k = 0; k < nf; ++k)
    sc[k] = 0.5f * dot(cross(sub(p0, verts[k]), sub(p1, verts[k])), normal);
  int i2 = masked_best(sc, nf);
  V3 p2 = verts[i2];
  for (int k = 0; k < nf; ++k) {
    V3 qa = sub(p0, verts[k]), qb = sub(p1, verts[k]), qc = sub(p2, verts[k]);
    float a1 = 0.5f * dot(cross(qa, qb), normal);
    float a2 = 0.5f * dot(cross(qb, qc), normal);
    float a3 = 0.5f * dot(cross(qc, qa), normal);
    sc[k] = fmaxf(fmaxf(a1, a2), a3);
  }
  int i3 = masked_best(sc, nf);
  o.pt[0] = p0; o.dp[0] = depths[i0];
  o.pt[1] = p1; o.dp[1] = depths[i1];
  o.pt[2] = p2; o.dp[2] = depths[i2];
  o.pt[3] = verts[i3]; o.dp[3] = depths[i3];
  return 4;
}

DF void incident_edge_local(V3 h, V3 nl, V3& oa, V3& ob) {
  float p0 = fabsf(nl.x), p1 = fabsf(nl.y), p2 = fabsf(nl.z);
  V3 b_xy = mk(h.x, h.y, -h.z), b_xz = mk(h.x, -h.y, h.z), b_yz = mk(-h.x, h.y, h.z);
  V3 out_b = p0 > p1 ? (p1 > p2 ? b_xy : b_xz) : (p0 > p2 ? b_xy : b_yz);
  V3 s = mk(nl.x < 0.0f ? -1.0f : 1.0f, nl.y < 0.0f ? -1.0f : 1.0f, nl.z < 0.0f ? -1.0f : 1.0f);
  oa = mk(h.x * s.x, h.y * s.y, h.z * s.z);
  ob = mk(out_b.x * s.x, out_b.y * s.y, out_b.z * s.z);
}

DF void first_argmax3(float p0, float p1, float p2, V3& mm) {
  bool m0 = p0 >= p1 && p0 >= p2;
  bool m1 = !m0 && p1 >= p2;
  bool m2 = !m0 && !m1;
  mm = mk(m0 ? 1.0f : 0.0f, m1 ? 1.0f : 0.0f, m2 ? 1.0f : 0.0f);
}

DN void box_box(V3 ac, V3 ah, Q4 aq, V3 bc, V3 bh, Q4 bq, Manifold& o) {
  const V3 basis[3] = {mk(1.0f, 0.0f, 0.0f), mk(0.0f, 1.0f, 0.0f), mk(0.0f, 0.0f, 1.0f)};
  V3 a_ax[3], b_ax[3];
  for (int i = 0; i < 3; ++i) { a_ax[i] = qrot(aq, basis[i]); b_ax[i] = qrot(bq, basis[i]); }
  float R[3][3], absR[3][3], t[3];
  V3 tw = sub(bc, ac);
  bool parallel = false;
  for (int i = 0; i < 3; ++i) {
    t[i] = dot(a_ax[i], tw);
    for (int j = 0; j < 3; ++j) {
      R[i][j] = dot(a_ax[i], b_ax[j]);
      absR[i][j] = fabsf(R[i][j]) + EPSILON;
      parallel = parallel || (absR[i][j] >= 0.99f);
    }
  }
  const float ahv[3] = {ah.x, ah.y, ah.z}, bhv[3] = {bh.x, bh.y, bh.z};

  float cand_s[15];
  V3 cand_n[15];
  bool separated = false;
  for (int i = 0; i < 3; ++i) {
    float pen = ahv[i] + (absR[i][0] * bhv[0] + absR[i][1] * bhv[1] + absR[i][2] * bhv[2])
                - fabsf(t[i]);
    separated = separated || (pen < 0.0f);
    cand_s[i] = pen;
    cand_n[i] = basis[i];
  }
  for (int j = 0; j < 3; ++j) {
    float tB = R[0][j] * t[0] + R[1][j] * t[1] + R[2][j] * t[2];
    float pen = (absR[0][j] * ahv[0] + absR[1][j] * ahv[1] + absR[2][j] * ahv[2]) + bhv[j]
                - fabsf(tB);
    separated = separated || (pen < 0.0f);
    cand_s[3 + j] = pen;
    cand_n[3 + j] = mk(R[0][j], R[1][j], R[2][j]);
  }
  bool any_edge_neg = false;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      V3 axis = i == 0 ? mk(0.0f, -R[2][j], R[1][j])
              : (i == 1 ? mk(R[2][j], 0.0f, -R[0][j]) : mk(-R[1][j], R[0][j], 0.0f));
      int k1 = (i + 1) % 3, k2 = (i + 2) % 3;
      float ra = ahv[k1] * absR[k2][j] + ahv[k2] * absR[k1][j];
      int l1 = (j + 1) % 3, l2 = (j + 2) % 3;
      float rb = bhv[l1] * absR[i][l2] + bhv[l2] * absR[i][l1];
      float dist = fabsf(t[0] * axis.x + t[1] * axis.y + t[2] * axis.z);
      float praw = ra + rb - dist;
      float ln = sqrtf(fmaxf(sqlen(axis), 0.0f));
      float inv_len = 1.0f / fmaxf(ln, 1e-30f);
      any_edge_neg = any_edge_neg || (praw < 0.0f);
      cand_s[6 + 3 * i + j] = parallel ? 3.4e38f : praw * inv_len;
      cand_n[6 + 3 * i + j] = muls(axis, inv_len);
    }
  }
  separated = separated || (!parallel && any_edge_neg);
  bool hit = !separated;

  // argmin over [face_a(3), face_b(3), edges(9)], first min wins within the
  // relative SAT_TIE_TOL margin
  float best_s = cand_s[0];
  int best = 0;
  for (int c = 1; c < 15; ++c) {
    float s = cand_s[c];
    float margin = SAT_TIE_TOL * (fabsf(best_s) + fabsf(s)) + 1e-9f;
    if (s < best_s - margin) { best_s = s; best = c; }
  }
  V3 n_local = cand_n[best];
  bool is_edge = best >= 6;
  bool is_face_b = best >= 3 && best < 6;

  V3 normal = qrot(aq, n_local);
  if (dot(normal, tw) < 0.0f) normal = neg(normal);
  o.n = normal;

  if (is_edge) {
    // closest point between the incident edges
    V3 a0l, a1l, b0l, b1l;
    incident_edge_local(ah, qirot(aq, normal), a0l, a1l);
    incident_edge_local(bh, qirot(bq, neg(normal)), b0l, b1l);
    V3 a0 = add(qrot(aq, a0l), ac), a1 = add(qrot(aq, a1l), ac);
    V3 b0 = add(qrot(bq, b0l), bc), b1 = add(qrot(bq, b1l), bc);
    V3 c1, c2;
    closest_seg_seg(a0, a1, b0, b1, c1, c2);
    o.pt[0] = muls(add(c1, c2), 0.5f);
    o.dp[0] = sqrtf(fmaxf(sqlen(sub(c1, c2)), 0.0f));
    o.mask = hit ? 1 : 0;
    return;
  }

  // face case: clip the incident face against the reference face's side planes
  V3 ref_c = sel(is_face_b, bc, ac), ref_h = sel(is_face_b, bh, ah);
  Q4 ref_q = is_face_b ? bq : aq;
  V3 inc_c = sel(is_face_b, ac, bc), inc_h = sel(is_face_b, ah, bh);
  Q4 inc_q = is_face_b ? aq : bq;
  V3 ref_n = is_face_b ? neg(normal) : normal;

  V3 n_ref_l = qirot(ref_q, ref_n);
  V3 mm;
  first_argmax3(fabsf(n_ref_l.x), fabsf(n_ref_l.y), fabsf(n_ref_l.z), mm);
  V3 e0 = mk(mm.z, mm.x, mm.y);      // one-hot of (m+1)%3
  V3 e1 = mk(mm.y, mm.z, mm.x);      // one-hot of (m+2)%3
  V3 neg_h = neg(ref_h);
  V3 plane_p[4] = {neg_h, neg_h, ref_h, ref_h};
  V3 plane_n[4] = {e0, e1, neg(e0), neg(e1)};

  V3 n_inc_l = qirot(inc_q, ref_n);
  V3 mmi;
  first_argmax3(fabsf(n_inc_l.x), fabsf(n_inc_l.y), fabsf(n_inc_l.z), mmi);
  V3 ei0 = mk(mmi.z, mmi.x, mmi.y), ei1 = mk(mmi.y, mmi.z, mmi.x);
  float nl_m = dot(n_inc_l, mmi);
  float s_inc = nl_m < 0.0f ? 1.0f : -1.0f;
  float d_inc = dot(inc_h, mmi) * s_inc;
  float r0 = dot(inc_h, ei0), r1 = dot(inc_h, ei1);
  V3 base = muls(mmi, d_inc);

  V3 sup_l = mk(n_ref_l.x >= 0.0f ? ref_h.x : -ref_h.x,
                n_ref_l.y >= 0.0f ? ref_h.y : -ref_h.y,
                n_ref_l.z >= 0.0f ? ref_h.z : -ref_h.z);
  V3 sup_w = add(qrot(ref_q, sup_l), ref_c);
  float rp_d = -dot(ref_n, sup_w);

  V3 va[8], vb[8];
  float da[8], db[8];
  const float cs0[4] = {-1.0f, 1.0f, 1.0f, -1.0f}, cs1[4] = {-1.0f, -1.0f, 1.0f, 1.0f};
  for (int c = 0; c < 4; ++c) {
    V3 cl = add(base, add(muls(ei0, cs0[c] * r0), muls(ei1, cs1[c] * r1)));
    va[c] = add(qrot(inc_q, cl), inc_c);
    da[c] = -(dot(va[c], ref_n) + rp_d);
  }
  int nn = 4;
  V3 *vin = va, *vout = vb;
  float *din = da, *dout = db;
  for (int p = 0; p < 4; ++p) {
    V3 nw = qrot(ref_q, plane_n[p]);
    V3 pw = add(qrot(ref_q, plane_p[p]), ref_c);
    int no = clip_one_plane(vin, din, nn, nw, -dot(nw, pw), vout, dout, 8);
    nn = no < 8 ? no : 8;
    V3* tv = vin; vin = vout; vout = tv;
    float* td = din; din = dout; dout = td;
  }
  // drop depth<0 points, project onto the reference plane, compact
  int nf = 0;
  for (int k = 0; k < nn; ++k) {
    if (din[k] >= 0.0f) {
      vout[nf] = add(vin[k], muls(ref_n, din[k]));
      dout[nf] = din[k];
      ++nf;
    }
  }
  int count = reduce_manifold(vout, dout, nf, normal, o);
  hit = hit && nf > 0;
  if (!hit) count = 0;
  o.mask = (1 << count) - 1;
}

// ---- hull recipes (ops/kernels/cm_hull.py, gjk_distance.py, cm_polytope.py) -----
// Static hull data comes once per hull geometry from ftab, in one block per
// hull (FusedTables, "hull block"), floats:
//   vertices 3V | triangle planes 5F (normal, offset, mask) | merged-face
//   normals 3FU | merged-face mask FU | loop points 3 FU LM | edge directions
//   3EU | edge mask EU
// (V, F, FU, LM, EU padded to the scene's largest hull, as the plain version
// iterates them); merged-face loop lengths come from itab. One thread per pair
// row; the recipes are out of line so the other recipes and the solve keep
// their register allocation.

constexpr float BIG = 3.4e38f;
constexpr int VCAP = 32;     // hull vertices of one polytope side held per thread
constexpr int SCAP = 32;     // clip slots 2 LM, LM <= 16

struct HullDims { int V, F, FU, LM, EU; };

// Hulls past those caps (V > VCAP or LM > SCAP / 2) keep the polytope
// recipes' buffers in the wrapper's hull scratch
// (fused_step.hull_scratch_shape): `lanes` slices an env, one for each lane
// of the env's team of `team` threads that takes pair rows (one row after
// another), `floats` a slice: both sides' world vertices, max(V, 8) each
// (a box side has 8), then the clip's two vertex and two depth buffers of
// S = 2 max(LM, 4) slots each. The scratch is a kernel parameter like the
// point scratch, null for a scene within the caps; the recipes get the
// lane's slice as a pointer.
__host__ __device__ inline int hull_lane_floats(const HullDims& h) {
  const int vs = h.V > 8 ? h.V : 8, lm = h.LM > 4 ? h.LM : 4;
  return (h.V > VCAP || h.LM > SCAP / 2) ? 6 * vs + 16 * lm : 0;
}
DF int hull_side_verts(const HullDims& h) { return h.V > 8 ? h.V : 8; }
// lane `tl` of env `env`'s slice of the hull scratch `base` (min(P, T)
// lanes an env, T the team's threads); null without the scratch
DF float* hull_slice(float* base, const HullDims& hd, int env, int P, int T, int tl) {
  if (!base) return nullptr;
  const int lanes = P < T ? P : T;
  return base + ((size_t)env * lanes + tl) * hull_lane_floats(hd);
}

DF int hb_planes(const HullDims& h) { return 3 * h.V; }
DF int hb_pn(const HullDims& h) { return 3 * h.V + 5 * h.F; }
DF int hb_pm(const HullDims& h) { return hb_pn(h) + 3 * h.FU; }
DF int hb_loops(const HullDims& h) { return hb_pm(h) + h.FU; }
DF int hb_ed(const HullDims& h) { return hb_loops(h) + 3 * h.FU * h.LM; }
DF int hb_em(const HullDims& h) { return hb_ed(h) + 3 * h.EU; }
DF int hb_size(const HullDims& h) { return hb_em(h) + h.EU; }

// support over the hull's local vertices, first maximum wins
DF V3 sup_verts(const float* hv, int V, V3 d) {
  V3 best = ld3(hv);
  float bs = dot(best, d);
  for (int i = 1; i < V; ++i) {
    V3 v = ld3(hv + 3 * i);
    float s = dot(v, d);
    if (s > bs) { bs = s; best = v; }
  }
  return best;
}

DF float nz30(float x) { return fabsf(x) > 1e-30f ? x : 1e-30f; }

// closest point to the origin on triangle abc (Ericson 5.1.5, first region
// wins); u, v, w are the barycentric weights. The plain version sums the
// selected weight with zeros, hence the 0.0f + (which turns -0 into +0).
DF void closest_pt_triangle(V3 a, V3 b, V3 c, V3& q, float& u, float& v, float& w) {
  V3 z = mk(0.0f, 0.0f, 0.0f);
  V3 ab = sub(b, a), ac = sub(c, a);
  V3 ap = sub(z, a);
  float d1 = dot(ab, ap), d2 = dot(ac, ap);
  V3 bp = sub(z, b);
  float d3 = dot(ab, bp), d4 = dot(ac, bp);
  V3 cp = sub(z, c);
  float d5 = dot(ab, cp), d6 = dot(ac, cp);
  bool in_a = d1 <= 0.0f && d2 <= 0.0f;
  bool in_b = d3 >= 0.0f && d4 <= d3;
  float vc = d1 * d4 - d3 * d2;
  bool on_ab = vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f;
  bool in_c = d6 >= 0.0f && d5 <= d6;
  float vb = d5 * d2 - d1 * d6;
  bool on_ac = vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f;
  float va = d3 * d6 - d5 * d4;
  bool on_bc = va <= 0.0f && d4 - d3 >= 0.0f && d5 - d6 >= 0.0f;
  float su, sv, sw;
  if (in_a) { su = 1.0f; sv = 0.0f; sw = 0.0f; }
  else if (in_b) { su = 0.0f; sv = 1.0f; sw = 0.0f; }
  else if (on_ab) {
    float t = d1 / nz30(d1 - d3);
    su = 1.0f - t; sv = t; sw = 0.0f;
  } else if (in_c) { su = 0.0f; sv = 0.0f; sw = 1.0f; }
  else if (on_ac) {
    float t = d2 / nz30(d2 - d6);
    su = 1.0f - t; sv = 0.0f; sw = t;
  } else if (on_bc) {
    float t = (d4 - d3) / nz30((d4 - d3) + (d5 - d6));
    su = 0.0f; sv = 1.0f - t; sw = t;
  } else {
    float denom = 1.0f / nz30(va + vb + vc);
    float v_in = vb * denom, w_in = vc * denom;
    su = 1.0f - v_in - w_in; sv = v_in; sw = w_in;
  }
  u = 0.0f + su; v = 0.0f + sv; w = 0.0f + sw;
  q = add(add(muls(a, u), muls(b, v)), muls(c, w));
}

DF bool same_side(V3 p1, V3 p2, V3 p3, V3 p4) {
  V3 n = cross(sub(p2, p1), sub(p3, p1));
  float s4 = dot(n, sub(p4, p1));
  float s0 = -dot(n, p1);
  return s4 * s0 >= 0.0f;
}

// closest point to the origin on the simplex of the 4 slots; lam its weights
DF void simplex_closest(const V3* ws, V3& q, float* lam) {
  const int tri[4][3] = {{0, 1, 2}, {0, 1, 3}, {0, 2, 3}, {1, 2, 3}};
  float best_d = BIG;
  q = mk(0.0f, 0.0f, 0.0f);
  for (int k = 0; k < 4; ++k) lam[k] = 0.0f;
  for (int t = 0; t < 4; ++t) {
    int i = tri[t][0], j = tri[t][1], k = tri[t][2];
    V3 qq; float u, v, w;
    closest_pt_triangle(ws[i], ws[j], ws[k], qq, u, v, w);
    float d = sqlen(qq);
    if (d < best_d) {
      best_d = d; q = qq;
      for (int m = 0; m < 4; ++m) lam[m] = 0.0f;
      lam[i] = u; lam[j] = v; lam[k] = w;
    }
  }
  float ext2 = fmaxf(fmaxf(sqlen(ws[0]), sqlen(ws[1])), fmaxf(sqlen(ws[2]), sqlen(ws[3])));
  V3 a = ws[0], b = ws[1], c = ws[2], d = ws[3];
  float vol = dot(cross(sub(b, a), sub(c, a)), sub(d, a));
  bool nondeg = vol * vol > 1e-10f * ext2 * ext2 * ext2;
  bool inside = nondeg && same_side(a, b, c, d) && same_side(a, b, d, c)
                && same_side(a, c, d, b) && same_side(b, c, d, a);
  if (inside) q = mk(0.0f, 0.0f, 0.0f);
}

// support functions of the distance GJK's two sides: a point, a segment, a
// hull's local vertices from its block, a polytope side's world vertices, a
// cylinder (cm_polytope.cylinder_hull_cm)
struct SupPoint {
  V3 p;
  DF V3 operator()(V3) const { return p; }
};
struct SupSegment {
  V3 a, b;
  DF V3 operator()(V3 d) const { return dot(d, a) > dot(d, b) ? a : b; }
};
struct SupHullLocal {
  const float* hv;
  int V;
  DF V3 operator()(V3 d) const { return sup_verts(hv, V, d); }
};

// distance GJK between side A and side B (gjk_distance.py), ITERS iterations
// at most: distance, witnesses and the overlap flag. Once a lane is done, the
// plain version's later iterations change no slot and recompute the same
// closest point; only ext2 keeps growing, and it feeds nothing but `done` and
// `overlap`, both frozen by then. So the loop stops there with the same bits.
template <int ITERS, class SA, class SB>
DF void gjk_distance(const SA& sup_a, const SB& sup_b, float& dist, V3& qa, V3& qb,
                     bool& overlap) {
  V3 dir0 = mk(1.0f, 0.1f, -0.2f);
  V3 pa0 = sup_a(dir0);
  V3 pb0 = sup_b(neg(dir0));
  V3 w0 = sub(pa0, pb0);
  V3 was[4] = {pa0, pa0, pa0, pa0}, wbs[4] = {pb0, pb0, pb0, pb0}, ws[4] = {w0, w0, w0, w0};
  bool valid[4] = {true, false, false, false};
  V3 q = w0;
  float lams[4] = {1.0f, 0.0f, 0.0f, 0.0f};
  overlap = false;
  bool done = false;
  float ext2 = sqlen(w0);
  for (int it = 0; it < ITERS; ++it) {
    float d2q = sqlen(q);
    bool deg = d2q <= 1e-12f * (ext2 + 1e-12f);
    overlap = overlap || (!done && deg);
    done = done || deg;
    V3 nd = muls(q, -1.0f / sqrtf(fmaxf(d2q, 1e-30f)));
    V3 pa = sup_a(nd);
    V3 pb = sup_b(neg(nd));
    V3 w = sub(pa, pb);
    ext2 = fmaxf(ext2, sqlen(w));
    float prog = d2q - dot(q, w);
    bool no_prog = prog <= 1e-6f * d2q + 1e-12f * ext2;
    done = done || no_prog;
    if (!done) {
      float sc[4];
      for (int i = 0; i < 4; ++i) sc[i] = valid[i] ? lams[i] : -1.0f;
      bool m01 = sc[0] <= sc[1], m23 = sc[2] <= sc[3];
      int i01 = m01 ? 0 : 1, i23 = m23 ? 2 : 3;
      float s01 = m01 ? sc[0] : sc[1], s23 = m23 ? sc[2] : sc[3];
      int repl = s01 <= s23 ? i01 : i23;
      was[repl] = pa; wbs[repl] = pb; ws[repl] = w; valid[repl] = true;
    }
    simplex_closest(ws, q, lams);
    if (done) break;
  }
  dist = sqrtf(fmaxf(sqlen(q), 0.0f));
  overlap = overlap || dist <= 1e-9f;
  qa = mk(0.0f, 0.0f, 0.0f);
  qb = mk(0.0f, 0.0f, 0.0f);
  for (int i = 0; i < 4; ++i) {
    qa = add(qa, muls(was[i], lams[i]));
    qb = add(qb, muls(wbs[i], lams[i]));
  }
}

// face with the largest signed distance n.p + off (valid faces only)
DF void face_mtv(V3 p, const float* planes, int F, float& best_sd, V3& best_n) {
  best_sd = -BIG;
  best_n = mk(0.0f, 1.0f, 0.0f);
  for (int f = 0; f < F; ++f) {
    const float* pl = planes + 5 * f;
    V3 n = ld3(pl);
    float sd = dot(n, p) + pl[3];
    sd = pl[4] > 0.5f ? sd : -BIG;
    if (sd > best_sd) { best_sd = sd; best_n = n; }
  }
}

// capsule (segment aa-ab, radius r) vs hull at (hp, hq): one contact
// (cm_hull.capsule_hull_core in the hull's frame, _narrow_native around it)
DN void capsule_hull(V3 aa, V3 ab, float r, V3 hp, Q4 hq, const float* hb,
                     const HullDims& hd, Manifold& o) {
  V3 ca = qirot(hq, sub(aa, hp)), cb = qirot(hq, sub(ab, hp));
  float dist; V3 qa, qb; bool overlap;
  SupSegment sa = {ca, cb};
  SupHullLocal sb = {hb, hd.V};
  gjk_distance<24>(sa, sb, dist, qa, qb, overlap);
  float inv_d = 1.0f / fmaxf(dist, 1e-30f);
  V3 n_s = muls(sub(qb, qa), inv_d);
  float depth_s = r - dist;
  V3 normal, point;
  float depth;
  if (overlap) {
    // the segment reaches into the hull: face-plane minimum translation of the
    // deepest of 5 segment samples
    float sd = 0.0f; V3 n_f = mk(0.0f, 0.0f, 0.0f), p_deep = n_f;
    for (int s = 0; s < 5; ++s) {
      float t = 0.25f * (float)s;
      V3 p = add(muls(ca, 1.0f - t), muls(cb, t));
      float sd_t; V3 n_t;
      face_mtv(p, hb + hb_planes(hd), hd.F, sd_t, n_t);
      if (s == 0 || sd_t < sd) { sd = sd_t; n_f = n_t; p_deep = p; }
    }
    normal = muls(n_f, -1.0f);
    depth = r - sd;
    point = add(p_deep, muls(n_f, -0.5f * sd));
  } else {
    normal = n_s;
    depth = depth_s;
    point = muls(add(add(qa, muls(n_s, r)), qb), 0.5f);
  }
  bool hit = overlap || depth_s >= 0.0f;
  o.pt[0] = add(qrot(hq, point), hp);
  o.dp[0] = depth;
  o.n = qrot(hq, normal);
  o.mask = hit ? 1 : 0;
}

// one side of a polytope pair: a box (8 corners, 6 faces, 3 edge directions)
// or a hull from its block; world vertices are kept, face normals, loop
// points and edge directions are rotated to world when used (the same
// operations as the plain version's world lists, so the same bits)
struct PolyBase {
  bool box;
  int nv, nf, ne, lm;      // vertices, faces, edge directions, points per stored loop
  V3 c, h;                 // box: center, half extents; hull: position (h unused)
  Q4 q;
  const float* hb;         // hull block
  const int* llen;         // hull loop lengths
  HullDims hd;
};
// the world vertices held per thread (hulls within the caps), or in the
// lane's slice of the hull scratch (`Wide`, bound by poly_bind)
template <bool Wide> struct PolyT : PolyBase {
  static constexpr bool kWide = false;
  static constexpr int kSlots = SCAP;   // clip slots held per thread
  V3 v[VCAP];
};
template <> struct PolyT<true> : PolyBase {
  static constexpr bool kWide = true;
  static constexpr int kSlots = 1;
  V3* v;
};
using Poly = PolyT<false>;
using PolyWide = PolyT<true>;

// a wide pair's vertex buffers in the lane's slice of the hull scratch,
// side A's then side B's (nothing to do for the per-thread form); the clip
// buffers follow them (polytope)
template <class P> DF void poly_bind(P& A, P& B, const HullDims& hd, float* hs) {
  if constexpr (P::kWide) {
    A.v = reinterpret_cast<V3*>(hs);
    B.v = A.v + hull_side_verts(hd);
  }
}

DF V3 box_axis(Q4 q, int i) {
  return qrot(q, mk(i == 0 ? 1.0f : 0.0f, i == 1 ? 1.0f : 0.0f, i == 2 ? 1.0f : 0.0f));
}

template <class P_>
DF void poly_box(P_& P, V3 c, V3 h, Q4 q) {
  P.box = true; P.nv = 8; P.nf = 6; P.ne = 3; P.lm = 4;
  P.c = c; P.h = h; P.q = q;
  int i = 0;
  for (int sx = -1; sx <= 1; sx += 2)
    for (int sy = -1; sy <= 1; sy += 2)
      for (int sz = -1; sz <= 1; sz += 2)
        P.v[i++] = add(qrot(q, mk((float)sx * h.x, (float)sy * h.y, (float)sz * h.z)), c);
}

template <class P_>
DF void poly_hull(P_& P, V3 p, Q4 q, const float* hb, const int* llen, const HullDims& hd) {
  P.box = false; P.nv = hd.V; P.nf = hd.FU; P.ne = hd.EU; P.lm = hd.LM;
  P.c = p; P.h = mk(0.0f, 0.0f, 0.0f); P.q = q; P.hb = hb; P.llen = llen; P.hd = hd;
  for (int i = 0; i < hd.V; ++i) P.v[i] = add(qrot(q, ld3(hb + 3 * i)), p);
}

// faces 2i, 2i+1 of a box: +axis i, -axis i (cm_polytope.box_topology_world)
template <class P_>
DF V3 poly_face_n(const P_& P, int f) {
  if (f < 0) return mk(0.0f, 0.0f, 0.0f);
  if (P.box) {
    V3 ax = box_axis(P.q, f >> 1);
    return (f & 1) ? neg(ax) : ax;
  }
  return qrot(P.q, ld3(P.hb + hb_pn(P.hd) + 3 * f));
}
template <class P_>
DF bool poly_face_ok(const P_& P, int f) {
  return P.box || P.hb[hb_pm(P.hd) + f] > 0.5f;
}
template <class P_>
DF int poly_loop_len(const P_& P, int f) {
  if (f < 0) return 0;
  return P.box ? 4 : P.llen[f];
}
// point l of face f's loop, padded past the stored points with the last one
template <class P_>
DF V3 poly_loop_pt(const P_& P, int f, int l) {
  if (f < 0) return mk(0.0f, 0.0f, 0.0f);
  int ll = l < P.lm ? l : P.lm - 1;
  if (P.box) {
    int i = f >> 1, j = (i + 1) % 3, k = (i + 2) % 3;
    bool pos = !(f & 1);
    const float sj_p[4] = {1.0f, 1.0f, -1.0f, -1.0f}, sk_p[4] = {-1.0f, 1.0f, 1.0f, -1.0f};
    const float sj_n[4] = {-1.0f, -1.0f, 1.0f, 1.0f}, sk_n[4] = {-1.0f, 1.0f, 1.0f, -1.0f};
    float s[3];
    s[i] = pos ? 1.0f : -1.0f;
    s[j] = pos ? sj_p[ll] : sj_n[ll];
    s[k] = pos ? sk_p[ll] : sk_n[ll];
    return add(qrot(P.q, mk(s[0] * P.h.x, s[1] * P.h.y, s[2] * P.h.z)), P.c);
  }
  return add(qrot(P.q, ld3(P.hb + hb_loops(P.hd) + 3 * (f * P.lm + ll))), P.c);
}
template <class P_>
DF V3 poly_edge(const P_& P, int e) {
  if (P.box) return box_axis(P.q, e);
  return qrot(P.q, ld3(P.hb + hb_ed(P.hd) + 3 * e));
}
template <class P_>
DF bool poly_edge_ok(const P_& P, int e) {
  return P.box || P.hb[hb_em(P.hd) + e] > 0.5f;
}

// first-min-wins step within the relative SAT_TIE_TOL margin
DF bool sat_better(float ov, float best) {
  float margin = SAT_TIE_TOL * (fabsf(best) + fabsf(ov)) + 1e-9f;
  return ov < best - margin;
}

// best face axis of side S against side O: overlap max_S(n) - min_O(n)
template <class P_>
DF void face_scan(const P_& S, const P_& O, float& best, int& bf, bool& sep) {
  best = BIG; bf = -1; sep = false;
  for (int f = 0; f < S.nf; ++f) {
    V3 n = poly_face_n(S, f);
    bool ok = poly_face_ok(S, f);
    float mx = dot(S.v[0], n);
    for (int i = 1; i < S.nv; ++i) mx = fmaxf(mx, dot(S.v[i], n));
    float mn = dot(O.v[0], n);
    for (int i = 1; i < O.nv; ++i) mn = fminf(mn, dot(O.v[i], n));
    float ov = mx - mn;
    sep = sep || (ok && ov < 0.0f);
    ov = ok ? ov : BIG;
    if (sat_better(ov, best)) { best = ov; bf = f; }
  }
}

template <class P_>
DF V3 centroid(const P_& P) {
  float inv = 1.0f / (float)P.nv;
  V3 c = P.v[0];
  for (int i = 1; i < P.nv; ++i) c = add(c, P.v[i]);
  return muls(c, inv);
}

template <class P_>
DF V3 support(const P_& P, V3 n) {
  V3 best = P.v[0];
  float bs = dot(best, n);
  for (int i = 1; i < P.nv; ++i) {
    float s = dot(P.v[i], n);
    if (s > bs) { bs = s; best = P.v[i]; }
  }
  return best;
}

// exact SAT + reference-face clip (cm_polytope.polytope_polytope_core); loops
// of both sides padded to LM, clip on S = 2 LM slots (per thread, or for
// wide hulls in the lane's hull scratch after both sides' vertices: 2 S
// vertices, then 2 S depths; side B is always a hull)
template <class P_>
DN void polytope(const P_& A, const P_& B, int LM, Manifold& o) {
  V3 ca = centroid(A), cb = centroid(B);
  float ov_a, ov_b; int fa, fb; bool sep_a, sep_b;
  face_scan(A, B, ov_a, fa, sep_a);
  face_scan(B, A, ov_b, fb, sep_b);
  // edge pairs, oriented A -> B by the centroids
  float ov_e = BIG; bool sep_e = false;
  V3 ax_e = mk(0.0f, 0.0f, 0.0f), da_e = ax_e, db_e = ax_e;
  V3 cab = sub(cb, ca);
  for (int ea = 0; ea < A.ne; ++ea) {
    V3 da = poly_edge(A, ea);
    bool va = poly_edge_ok(A, ea);
    for (int eb = 0; eb < B.ne; ++eb) {
      V3 db = poly_edge(B, eb);
      bool vb = poly_edge_ok(B, eb);
      V3 ax = cross(da, db);
      float l2 = sqlen(ax);
      bool ok = va && vb && l2 > 1e-10f;
      V3 axn = muls(ax, 1.0f / sqrtf(fmaxf(l2, 1e-30f)));
      axn = muls(axn, dot(axn, cab) < 0.0f ? -1.0f : 1.0f);
      float mxa = dot(A.v[0], axn);
      for (int i = 1; i < A.nv; ++i) mxa = fmaxf(mxa, dot(A.v[i], axn));
      float mnb = dot(B.v[0], axn);
      for (int i = 1; i < B.nv; ++i) mnb = fminf(mnb, dot(B.v[i], axn));
      float ov = mxa - mnb;
      sep_e = sep_e || (ok && ov < 0.0f);
      ov = ok ? ov : BIG;
      if (sat_better(ov, ov_e)) { ov_e = ov; ax_e = axn; da_e = da; db_e = db; }
    }
  }
  bool hit = !(sep_a || sep_b || sep_e);

  // winner: faces of A, then faces of B, then edges; earlier wins ties
  float best_ov = ov_a;
  int which = 0;
  if (sat_better(ov_b, best_ov)) { best_ov = ov_b; which = 1; }
  if (sat_better(ov_e, best_ov)) { best_ov = ov_e; which = 2; }
  V3 n_a = poly_face_n(A, fa), n_b = poly_face_n(B, fb);
  V3 normal = which == 0 ? n_a : (which == 1 ? neg(n_b) : ax_e);
  o.n = normal;

  if (which == 2) {
    // closest point between the lines through the supports along the axis
    V3 a_sup = support(A, ax_e), b_sup = support(B, neg(ax_e));
    V3 r = sub(b_sup, a_sup);
    float a11 = sqlen(da_e), a22 = sqlen(db_e), a12 = -dot(da_e, db_e);
    float b1 = dot(da_e, r), b2 = -dot(db_e, r);
    float det = a11 * a22 - a12 * a12;
    bool ok = det > 1e-12f;
    float inv = 1.0f / (ok ? det : 1.0f);
    float s = ok ? (b1 * a22 - b2 * a12) * inv : 0.0f;
    float t = ok ? (a11 * b2 - a12 * b1) * inv : 0.0f;
    V3 pa = add(a_sup, muls(da_e, s)), pb = add(b_sup, muls(db_e, t));
    o.pt[0] = muls(add(pa, pb), 0.5f);
    o.dp[0] = best_ov;
    o.mask = hit ? 1 : 0;
    return;
  }

  // face case: clip the incident face's loop against the reference loop
  bool face_b = which == 1;
  const P_& R = face_b ? B : A;
  const P_& I = face_b ? A : B;
  int rf = face_b ? fb : fa;
  V3 ref_n = face_b ? n_b : n_a;
  int ref_len = poly_loop_len(R, rf);
  float bs = -BIG;
  int bi = -1;
  for (int f = 0; f < I.nf; ++f) {
    float sc = poly_face_ok(I, f) ? -dot(poly_face_n(I, f), ref_n) : -BIG;
    if (sc > bs) { bs = sc; bi = f; }
  }
  V3 ref0 = poly_loop_pt(R, rf, 0);
  float rp_d = -dot(ref_n, ref0);
  const int S = 2 * LM;
  V3 va_t[P_::kSlots], vb_t[P_::kSlots];
  float da_t[P_::kSlots], db_t[P_::kSlots];
  V3 *va = va_t, *vb = vb_t;
  float *da = da_t, *db = db_t;
  if constexpr (P_::kWide) {
    float* clip = reinterpret_cast<float*>(B.v + hull_side_verts(B.hd));
    va = reinterpret_cast<V3*>(clip);
    vb = va + S;
    da = clip + 6 * S;
    db = da + S;
  }
  for (int l = 0; l < LM; ++l) {
    va[l] = poly_loop_pt(I, bi, l);
    da[l] = -(dot(va[l], ref_n) + rp_d);
  }
  int nn = poly_loop_len(I, bi);
  V3 *vin = va, *vout = vb;
  float *din = da, *dout = db;
  for (int i = 0; i < LM && i < ref_len; ++i) {
    V3 start = poly_loop_pt(R, rf, i);
    V3 end = i == ref_len - 1 ? ref0 : poly_loop_pt(R, rf, (i + 1) % LM);
    V3 side_n = cross(ref_n, sub(end, start));
    int no = clip_one_plane(vin, din, nn, side_n, -dot(side_n, start), vout, dout, S);
    nn = no < S ? no : S;
    V3* tv = vin; vin = vout; vout = tv;
    float* td = din; din = dout; dout = td;
  }
  // drop depth < 0, project onto the reference plane, compact
  int nf = 0;
  for (int k = 0; k < nn; ++k) {
    if (din[k] >= 0.0f) {
      vout[nf] = add(vin[k], muls(ref_n, din[k]));
      dout[nf] = din[k];
      ++nf;
    }
  }
  int count = reduce_manifold(vout, dout, nf, normal, o);
  hit = hit && nf > 0;
  if (!hit) count = 0;
  o.mask = (1 << count) - 1;
}

// box (side a) vs hull (side b); loops padded to max(4, LM of the hulls)
template <class P_>
DF void box_hull_t(V3 bc, V3 bh, Q4 bq, V3 hp, Q4 hq, const float* hb, const int* llen,
                   const HullDims& hd, float* hs, Manifold& o) {
  P_ A, B;
  poly_bind(A, B, hd, hs);
  poly_box(A, bc, bh, bq);
  poly_hull(B, hp, hq, hb, llen, hd);
  polytope(A, B, hd.LM > 4 ? hd.LM : 4, o);
}

template <class P_>
DF void hull_hull_t(V3 pa, Q4 qa, const float* hba, const int* lla, V3 pb, Q4 qb,
                    const float* hbb, const int* llb, const HullDims& hd, float* hs,
                    Manifold& o) {
  P_ A, B;
  poly_bind(A, B, hd, hs);
  poly_hull(A, pa, qa, hba, lla, hd);
  poly_hull(B, pb, qb, hbb, llb, hd);
  polytope(A, B, hd.LM, o);
}

// the recipes' entry points: the per-thread form inline, as it was before
// the hull scratch, and the wide form (`hs` the lane's slice of the hull
// scratch, non-null exactly for hulls past the caps) a call of its own, so
// that a scene within the caps runs the same code and register budget
DN void box_hull_wide(V3 bc, V3 bh, Q4 bq, V3 hp, Q4 hq, const float* hb,
                      const int* llen, const HullDims& hd, float* hs, Manifold& o) {
  box_hull_t<PolyWide>(bc, bh, bq, hp, hq, hb, llen, hd, hs, o);
}

DN void box_hull(V3 bc, V3 bh, Q4 bq, V3 hp, Q4 hq, const float* hb, const int* llen,
                 const HullDims& hd, float* hs, Manifold& o) {
  if (hs) {
    box_hull_wide(bc, bh, bq, hp, hq, hb, llen, hd, hs, o);
    return;
  }
  box_hull_t<Poly>(bc, bh, bq, hp, hq, hb, llen, hd, nullptr, o);
}

DN void hull_hull_wide(V3 pa, Q4 qa, const float* hba, const int* lla, V3 pb, Q4 qb,
                       const float* hbb, const int* llb, const HullDims& hd, float* hs,
                       Manifold& o) {
  hull_hull_t<PolyWide>(pa, qa, hba, lla, pb, qb, hbb, llb, hd, hs, o);
}

DN void hull_hull(V3 pa, Q4 qa, const float* hba, const int* lla, V3 pb, Q4 qb,
                  const float* hbb, const int* llb, const HullDims& hd, float* hs,
                  Manifold& o) {
  if (hs) {
    hull_hull_wide(pa, qa, hba, lla, pb, qb, hbb, llb, hd, hs, o);
    return;
  }
  hull_hull_t<Poly>(pa, qa, hba, lla, pb, qb, hbb, llb, hd, nullptr, o);
}

#if DXK_SHAPE_RECIPES
// ---- sphere and cylinder recipes (ops/kernels/cm_narrowphase.py, cm_hull.py,
// cm_polytope.py) -------------------------------------------------------------
// Compiled only into the library built with DXK_SHAPE_RECIPES=1, which the
// wrapper launches for scenes with such rows (fused_step.py, load_library):
// in the same module as the other recipes they made the ragdoll settle's
// kernel 4 % slower on an H100 though it never calls them
// (tools/time_fused_kernel_trees.py).
// One thread per pair row, out of line like the hull recipes. Where the plain
// version computes two branches and selects one, only the selected one is
// computed; where it selects nothing for a dead row, the row's mask is 0 and
// nothing else of it is read.

// sign() with components under 1e-6 snapped to +0 (jnp.sign of 0 is 0)
DF float snap_sign(float x) {
  float y = fabsf(x) < 1e-6f ? 0.0f : x;
  return y > 0.0f ? 1.0f : (y < 0.0f ? -1.0f : y);
}

// bit-for-bit equal: an iterate of a fixed-point loop that equals the one
// before gives the same point in every later round
DF bool same_bits(V3 a, V3 b) {
  return __float_as_uint(a.x) == __float_as_uint(b.x) &&
         __float_as_uint(a.y) == __float_as_uint(b.y) &&
         __float_as_uint(a.z) == __float_as_uint(b.z);
}

// cylinder (centre c, unit axis u, half length hl, radius r) support along d:
// cap by the snapped axial sign, then the radial rim (_cyl_support_cm)
DF V3 cyl_support_cm(V3 c, V3 u, float hl, float r, V3 d) {
  V3 cap = add(c, muls(u, hl * snap_sign(dot(u, d))));
  V3 radial = sub(d, muls(u, dot(d, u)));
  float rl = sqrtf(fmaxf(sqlen(radial), 0.0f));
  V3 rad = rl > EPSILON ? muls(radial, r / fmaxf(rl, 1e-30f)) : mk(0.0f, 0.0f, 0.0f);
  return add(cap, rad);
}

DN void sphere_sphere_row(V3 c1, float r1, V3 c2, float r2, Manifold& o) {
  bool hit;
  sphere_sphere(c1, r1, c2, r2, o.pt[0], o.dp[0], o.n, hit);
  o.mask = hit ? 1 : 0;
}

DN void sphere_capsule(V3 sc, float sr, V3 ca, V3 cb, float cr, Manifold& o) {
  bool hit;
  sphere_sphere(sc, sr, closest_pt_seg(sc, ca, cb), cr, o.pt[0], o.dp[0], o.n, hit);
  o.mask = hit ? 1 : 0;
}

DN void sphere_box(V3 sc, float sr, V3 bc, V3 bh, Q4 bq, Manifold& o) {
  V3 sl = qirot(bq, sub(sc, bc));
  V3 p = clip_box(sl, bh);
  V3 n = sub(p, sl);
  float sq = sqlen(n);
  bool hit = sq <= sr * sr;
  float dist = sqrtf(fmaxf(sq, 0.0f));
  bool pos = sq > 0.0f;
  float inv = 1.0f / fmaxf(dist, 1e-30f);
  n = pos ? muls(n, inv) : mk(0.0f, 1.0f, 0.0f);
  float depth = sr - (pos ? dist : 0.0f);
  V3 point_l = muls(add(add(p, sl), muls(n, sr)), 0.5f);
  o.n = qrot(bq, n);
  o.pt[0] = add(qrot(bq, point_l), bc);
  o.dp[0] = depth;
  o.mask = hit ? 1 : 0;
}

// sphere vs cylinder ca-cb: beside the body the sphere-on-axis contact, beyond
// a cap the closest point of the cap disk (sphere_cylinder_cm)
DF void sphere_cylinder_core(V3 sc, float sr, V3 ca, V3 cb, float cr, V3& pt, float& dp,
                             V3& nm, bool& hit) {
  V3 ab = sub(cb, ca);
  float t = dot(sub(sc, ca), ab) / fmaxf(sqlen(ab), 1e-12f);
  if (t >= 0.0f && t <= 1.0f) {
    sphere_sphere(sc, sr, add(ca, muls(ab, t)), cr, pt, dp, nm, hit);
    return;
  }
  bool t_lo = t <= 0.0f;
  V3 p = sel(t_lo, ca, cb);
  V3 up = sel(t_lo, sub(ca, cb), ab);
  V3 proj = cross(cross(up, sub(sc, p)), up);
  proj = muls(proj, 1.0f / fmaxf(sqrtf(fmaxf(sqlen(proj), 0.0f)), 1e-30f));
  V3 end_a = add(p, muls(proj, cr));
  V3 end_b = sub(p, muls(proj, cr));
  V3 closest = closest_pt_seg(sc, end_a, end_b);
  V3 nvec = sub(closest, sc);
  float sq = sqlen(nvec);
  hit = sq <= sr * sr;
  bool degenerate = sq == 0.0f;
  float dist = sqrtf(fmaxf(sq, 0.0f));
  V3 up_n = muls(up, 1.0f / fmaxf(sqrtf(fmaxf(sqlen(up), 0.0f)), 1e-30f));
  nm = degenerate ? mk(-up_n.x, -up_n.y, -up_n.z) : muls(nvec, 1.0f / fmaxf(dist, 1e-30f));
  dp = sr - (degenerate ? 0.0f : dist);
  pt = add(closest, muls(nvec, 0.5f * dp));
}

DN void sphere_cylinder(V3 sc, float sr, V3 ca, V3 cb, float cr, Manifold& o) {
  bool hit;
  sphere_cylinder_core(sc, sr, ca, cb, cr, o.pt[0], o.dp[0], o.n, hit);
  o.mask = hit ? 1 : 0;
}

// sphere (centre sc, radius r) vs hull at (hp, hq): one contact
// (cm_hull.sphere_hull_core in the hull's frame)
DN void sphere_hull(V3 sc_w, float r, V3 hp, Q4 hq, const float* hb, const HullDims& hd,
                    Manifold& o) {
  V3 sc = qirot(hq, sub(sc_w, hp));
  float dist; V3 qa, qb; bool overlap;
  SupPoint sa = {sc};
  SupHullLocal sb = {hb, hd.V};
  gjk_distance<24>(sa, sb, dist, qa, qb, overlap);
  float inv_d = 1.0f / fmaxf(dist, 1e-30f);
  V3 n_s = muls(sub(qb, qa), inv_d);
  float depth_s = r - dist;
  V3 normal, point;
  float depth;
  if (overlap) {
    // the centre is inside the hull: face-plane minimum translation
    float sd; V3 n_f;
    face_mtv(sc, hb + hb_planes(hd), hd.F, sd, n_f);
    normal = muls(n_f, -1.0f);
    depth = r - sd;
    point = add(sc, muls(n_f, -0.5f * sd));
  } else {
    normal = n_s;
    depth = depth_s;
    point = muls(add(add(sc, muls(n_s, r)), qb), 0.5f);
  }
  o.pt[0] = add(qrot(hq, point), hp);
  o.dp[0] = depth;
  o.n = qrot(hq, normal);
  o.mask = (overlap || depth_s >= 0.0f) ? 1 : 0;
}

// capsule aa-ab vs cylinder ba-bb: parallel and overlapping along the axis, two
// points; otherwise the capsule's closest axis point as a sphere against the
// cylinder (capsule_cylinder_cm)
DN void capsule_cylinder(V3 aa, V3 ab, float ar, V3 ba, V3 bb, float br, Manifold& o) {
  V3 a_dirv = sub(ab, aa);
  float a_len = sqrtf(fmaxf(sqlen(a_dirv), 0.0f));
  V3 a_dir = muls(a_dirv, 1.0f / fmaxf(a_len, 1e-30f));
  V3 b_dirv = sub(bb, ba);
  V3 b_dir = muls(b_dirv, 1.0f / fmaxf(sqrtf(fmaxf(sqlen(b_dirv), 0.0f)), 1e-30f));
  float par = dot(a_dir, b_dir);
  bool is_parallel = fabsf(par) > 0.99f;

  bool swap = par < 0.0f;
  V3 p_ba = sel(swap, bb, ba), p_bb = sel(swap, ba, bb);
  float b0 = dot(a_dir, sub(p_ba, aa));
  float b1 = dot(a_dir, sub(p_bb, aa));
  float left = fmaxf(0.0f, b0), right = fminf(a_len, b1);
  bool overlaps = right >= left;
  if (is_parallel && overlaps) {
    V3 ca0 = add(aa, muls(a_dir, left));
    V3 ca1 = add(aa, muls(a_dir, right));
    V3 cb0 = closest_pt_seg(ca0, p_ba, p_bb);
    V3 cb1 = add(cb0, muls(a_dir, right - left));
    V3 normal2; float d; bool deg;
    normalize_or_up(sub(cb0, ca0), normal2, d, deg);
    deg = d < EPSILON;
    normal2 = deg ? mk(0.0f, 1.0f, 0.0f) : normal2;
    float pen = (ar + br) - (deg ? 0.0f : d);
    bool two_hit = pen >= 0.0f;
    o.pt[0] = muls(add(ca0, cb0), 0.5f);
    o.pt[1] = muls(add(ca1, cb1), 0.5f);
    o.dp[0] = pen;
    o.dp[1] = pen;
    o.n = normal2;
    o.mask = two_hit ? 3 : 0;
    return;
  }
  V3 s;
  if (is_parallel) {
    // parallel but no axial overlap: the capsule's end sphere
    s = sel(0.0f > b1, aa, ab);
  } else {
    V3 c2;
    closest_seg_seg(aa, ab, ba, bb, s, c2);
  }
  bool hit;
  sphere_cylinder_core(s, ar, ba, bb, br, o.pt[0], o.dp[0], o.n, hit);
  o.mask = hit ? 1 : 0;
}

DF void cap_ring(V3 c, V3 t1, V3 t2, float rr, Manifold& o) {
  o.pt[0] = add(c, muls(t1, rr));
  o.pt[1] = sub(c, muls(t1, rr));
  o.pt[2] = add(c, muls(t2, rr));
  o.pt[3] = sub(c, muls(t2, rr));
}

// one candidate axis of the cylinder-box SAT: first minimum wins within the
// relative SAT_TIE_TOL (no absolute margin here, as in cylinder_box_cm)
DF void cb_consider(float ov, V3 n, int id, float& bo, V3& bn, int& bi) {
  if (ov < bo - SAT_TIE_TOL * (fabsf(ov) + fabsf(bo))) { bo = ov; bn = n; bi = id; }
}

// cylinder aa-ab (radius ar) vs box (bc, bh, bq): K=4 (cylinder_box_cm). Exact
// boolean from the axis distance and a solid-cylinder / box alternating
// projection, exact tube contact, SAT over candidate axes for cap and deep
// contacts, then the face-clip pair (lying tube) or the 4-point cap ring
DN void cylinder_box(V3 aa, V3 ab, float ar, V3 bc, V3 bh, Q4 bq, Manifold& o) {
  V3 la = qirot(bq, sub(aa, bc));
  V3 lb = qirot(bq, sub(ab, bc));
  V3 axis_v = sub(lb, la);
  float alen = sqrtf(fmaxf(sqlen(axis_v), 0.0f));
  V3 u = muls(axis_v, 1.0f / fmaxf(alen, 1e-30f));
  float hl = 0.5f * alen;
  V3 cc = muls(add(la, lb), 0.5f);
  const V3 up = mk(0.0f, 1.0f, 0.0f);

  V3 s, q;
  segment_box_closest(la, lb, bh, s, q);
  V3 delta = sub(q, s);
  float d2 = sqlen(delta);
  float dist_axis = sqrtf(fmaxf(d2, 1e-30f));
  float dir_thr = fmaxf(1e-3f * ar, 1e-6f);
  bool have_dir = d2 > dir_thr * dir_thr;
  bool tube_case = have_dir && fabsf(dot(delta, u)) <= 1e-4f * dist_axis;

  // solid-cylinder / box alternating projection, 32 rounds at most
  V3 p = cc;
  for (int it = 0; it < 32; ++it) {
    V3 w = sub(clip_box(p, bh), cc);
    float t = clipf(dot(w, u), -hl, hl);
    V3 rad = sub(w, muls(u, dot(w, u)));
    float rl = sqrtf(fmaxf(sqlen(rad), 0.0f));
    float scale = fminf(1.0f, ar / fmaxf(rl, 1e-30f));
    V3 pn = add(add(cc, muls(u, t)), muls(rad, scale));
    bool fixed = same_bits(pn, p);
    p = pn;
    if (fixed) break;
  }
  float d_cb2 = sqlen(sub(clip_box(p, bh), p));
  float touch = fmaxf(1e-3f * ar, 1e-5f);
  bool cap_hit = d_cb2 <= touch * touch;

  V3 n_tube = have_dir ? muls(delta, 1.0f / dist_axis) : up;
  float depth_tube = ar - dist_axis;

  // SAT over box faces, the cylinder axis, axis x box edges, the lateral
  // closest direction; overlap along unit n of box and cylinder
  float best_ov = BIG;
  V3 best_n = up;
  int best_id = -1;
  V3 cand[8];
  bool ok[8];
  int nc = 0;
  cand[nc] = mk(1.0f, 0.0f, 0.0f); ok[nc++] = true;
  cand[nc] = mk(0.0f, 1.0f, 0.0f); ok[nc++] = true;
  cand[nc] = mk(0.0f, 0.0f, 1.0f); ok[nc++] = true;
  cand[nc] = u; ok[nc++] = alen > EPSILON;
  for (int i = 0; i < 3; ++i) {
    V3 wax = cross(u, cand[i]);
    float wl = sqrtf(fmaxf(sqlen(wax), 0.0f));
    cand[nc] = muls(wax, 1.0f / fmaxf(wl, 1e-30f));
    ok[nc++] = wl > 1e-6f;
  }
  cand[nc] = n_tube; ok[nc++] = have_dir;
  for (int c = 0; c < 8; ++c) {
    if (!ok[c]) continue;        // an invalid axis scores BIG and never wins
    V3 n = cand[c];
    float rb = bh.x * fabsf(n.x) + bh.y * fabsf(n.y) + bh.z * fabsf(n.z);
    float un = dot(u, n);
    float rc = hl * fabsf(un) + ar * sqrtf(fmaxf(1.0f - un * un, 0.0f));
    cb_consider(rb + rc - fabsf(dot(cc, n)), n, c, best_ov, best_n, best_id);
  }
  float sgn = dot(cc, best_n) >= 0.0f ? 1.0f : -1.0f;
  V3 n_sat = muls(best_n, -sgn);                    // points cylinder -> box
  float depth_sat = best_ov;

  bool use_tube = tube_case && depth_tube <= depth_sat;
  V3 normal = use_tube ? n_tube : n_sat;
  float depth = use_tube ? depth_tube : depth_sat;
  bool hit = dist_axis <= ar && depth_sat >= 0.0f && (tube_case || cap_hit);
  if (!hit) { o.mask = 0; return; }

  float an0 = fabsf(normal.x), an1 = fabsf(normal.y), an2 = fabsf(normal.z);
  bool is_face = an0 > 0.99f || an1 > 0.99f || an2 > 0.99f;
  float cos_angle = fabsf(dot(normal, u));
  o.n = qrot(bq, normal);
  if (is_face && cos_angle > 0.99f) {
    // cap flat on a box face: 4-point rim ring
    V3 cap_c = sel(dot(la, normal) > dot(lb, normal), la, lb);
    V3 t1c = get_tangent(normal);
    V3 t2c = cross(normal, t1c);
    cap_ring(cap_c, t1c, t2c, ar * 0.95f, o);
    for (int k = 0; k < 4; ++k) {
      o.pt[k] = add(qrot(bq, o.pt[k]), bc);
      o.dp[k] = depth;
    }
    o.mask = 15;
    return;
  }
  V3 point;
  if (use_tube) {
    point = muls(add(add(s, muls(n_tube, ar)), q), 0.5f);
  } else {
    // witness point by the winning feature
    V3 pa_face = cyl_support_cm(cc, u, hl, ar, n_sat);
    if (best_id < 3) {
      point = sub(pa_face, muls(n_sat, 0.5f * depth_sat));
    } else {
      V3 pb_u = mk(snap_sign(-n_sat.x) * bh.x, snap_sign(-n_sat.y) * bh.y,
                   snap_sign(-n_sat.z) * bh.z);
      if (best_id == 3)
        point = add(pb_u, muls(n_sat, 0.5f * depth_sat));
      else if (have_dir)
        point = muls(add(add(s, muls(n_sat, ar)), q), 0.5f);
      else
        point = muls(add(pa_face, pb_u), 0.5f);
    }
  }
  bool use = false;
  FaceClip fc;
  if (is_face && cos_angle < 0.01f) {
    // lying tube on a box face: the clipped pair
    face_clip_segment(la, lb, ar, bh, normal, fc);
    use = fc.clip_ok && (fc.m_e0 || fc.m_e1);
  }
  if (use) {
    o.pt[0] = add(qrot(bq, fc.m_e0 ? fc.e0p : fc.e1p), bc);
    o.dp[0] = fc.m_e0 ? fc.dp_e0 : fc.dp_e1;
    o.pt[1] = add(qrot(bq, fc.e1p), bc);
    o.dp[1] = fc.dp_e1;
    o.mask = (fc.m_e0 && fc.m_e1) ? 3 : 1;
  } else {
    o.pt[0] = add(qrot(bq, point), bc);
    o.dp[0] = depth;
    o.mask = 1;
  }
}

// point x projected onto the solid cylinder (centre c, unit axis uax, half
// length hl, radius r)
DF V3 proj_cyl(V3 x, V3 c, V3 uax, float hl, float r) {
  V3 w = sub(x, c);
  float wu = dot(w, uax);
  float t = clipf(wu, -hl, hl);
  V3 rad = sub(w, muls(uax, wu));
  float rl = sqrtf(fmaxf(sqlen(rad), 0.0f));
  float scale = fminf(1.0f, r / fmaxf(rl, 1e-30f));
  return add(add(c, muls(uax, t)), muls(rad, scale));
}

DF float cyl_radius_on(V3 n, V3 uax, float hl, float r) {
  float un = dot(uax, n);
  return hl * fabsf(un) + r * sqrtf(fmaxf(1.0f - un * un, 0.0f));
}

// cylinder aa-ab vs cylinder ba-bb: K=4 (cylinder_cylinder_cm). Parallel: the
// cap-to-cap ring (or one cap point) or the tube-to-tube pair; otherwise an
// exact boolean and one SAT point
DN void cylinder_cylinder(V3 aa, V3 ab, float ar, V3 ba, V3 bb, float br, Manifold& o) {
  const V3 up = mk(0.0f, 1.0f, 0.0f);
  V3 a_dirv = sub(ab, aa);
  float a_len = sqrtf(fmaxf(sqlen(a_dirv), 0.0f));
  V3 a_dir = muls(a_dirv, 1.0f / fmaxf(a_len, 1e-30f));
  V3 b_dirv = sub(bb, ba);
  float b_len = sqrtf(fmaxf(sqlen(b_dirv), 0.0f));
  V3 b_dir = muls(b_dirv, 1.0f / fmaxf(b_len, 1e-30f));
  float par = dot(a_dir, b_dir);
  if (fabsf(par) > 0.99f) {
    bool swap = par < 0.0f;
    V3 p_ba = sel(swap, bb, ba), p_bb = sel(swap, ba, bb);
    float b0 = dot(a_dir, sub(p_ba, aa));
    float b1 = dot(a_dir, sub(p_bb, aa));
    float left = fmaxf(0.0f, b0), right = fminf(a_len, b1);
    V3 ca0 = add(aa, muls(a_dir, left));
    V3 ca1 = add(aa, muls(a_dir, right));
    V3 cb0 = closest_pt_seg(ca0, p_ba, p_bb);
    V3 cb1 = add(cb0, muls(a_dir, right - left));
    V3 nvec = sub(cb0, ca0);
    float d = sqrtf(fmaxf(sqlen(nvec), 0.0f));
    float pen = (ar + br) - d;
    if (!(right >= left && pen >= 0.0f)) { o.mask = 0; return; }
    float cap_pen = right - left;
    if (cap_pen < pen) {
      bool b_right = b0 > 0.0f;
      V3 cap_normal = b_right ? a_dir : neg(a_dir);
      V3 cap_point = b_right ? sub(ab, muls(a_dir, 0.5f * cap_pen))
                             : add(aa, muls(a_dir, 0.5f * cap_pen));
      // ring on the lens where the two cap disks overlap
      V3 lat = sub(nvec, muls(a_dir, dot(nvec, a_dir)));
      float dl = sqrtf(fmaxf(sqlen(lat), 0.0f));
      V3 lat_dir = dl > EPSILON ? muls(lat, 1.0f / fmaxf(dl, 1e-30f)) : get_tangent(a_dir);
      float lo = fmaxf(-ar, dl - br), hi = fminf(ar, dl + br);
      float re = fmaxf(0.5f * (hi - lo), 0.0f);
      float c_off = 0.5f * (lo + hi);
      o.n = cap_normal;
      if (re > EPSILON) {
        cap_ring(add(cap_point, muls(lat_dir, c_off)), lat_dir, cross(cap_normal, lat_dir),
                 re, o);
        for (int k = 0; k < 4; ++k) o.dp[k] = cap_pen;
        o.mask = 15;
      } else {
        o.pt[0] = cap_point;
        o.dp[0] = cap_pen;
        o.mask = 1;
      }
    } else {
      o.pt[0] = muls(add(ca0, cb0), 0.5f);
      o.pt[1] = muls(add(ca1, cb1), 0.5f);
      o.dp[0] = pen;
      o.dp[1] = pen;
      o.n = d < EPSILON ? up : muls(nvec, 1.0f / fmaxf(d, 1e-30f));
      o.mask = 3;
    }
    return;
  }

  V3 ca_c = muls(add(aa, ab), 0.5f), cb_c = muls(add(ba, bb), 0.5f);
  float a_hl = 0.5f * a_len, b_hl = 0.5f * b_len;
  float rsum = ar + br;
  V3 c1, c2;
  closest_seg_seg(aa, ab, ba, bb, c1, c2);
  V3 gdelta = sub(c2, c1);
  float dsq = sqlen(gdelta);
  float gdist = sqrtf(fmaxf(dsq, 1e-30f));
  float g_thr = fmaxf(1e-3f * fmaxf(ar, br), 1e-6f);
  bool g_have = dsq > g_thr * g_thr;
  bool perp = g_have && fabsf(dot(gdelta, a_dir)) <= 1e-4f * gdist
              && fabsf(dot(gdelta, b_dir)) <= 1e-4f * gdist;
  V3 n_tt = g_have ? muls(gdelta, 1.0f / gdist) : up;
  float depth_tt = rsum - gdist;

  // alternating projection between the two solid cylinders, 32 rounds at most
  V3 p = ca_c;
  for (int it = 0; it < 32; ++it) {
    V3 pn = proj_cyl(proj_cyl(p, cb_c, b_dir, b_hl, br), ca_c, a_dir, a_hl, ar);
    bool fixed = same_bits(pn, p);
    p = pn;
    if (fixed) break;
  }
  float d_cc2 = sqlen(sub(proj_cyl(p, cb_c, b_dir, b_hl, br), p));
  float g_touch = fmaxf(1e-3f * fmaxf(ar, br), 1e-5f);
  bool g_caphit = d_cc2 <= g_touch * g_touch;

  // SAT over both axes, their cross product and the closest-points direction
  V3 dc = sub(cb_c, ca_c);
  float g_bo = BIG;
  V3 g_bn = up;
  int g_bi = -1;
  V3 xax = cross(a_dir, b_dir);
  float xl = sqrtf(fmaxf(sqlen(xax), 0.0f));
  V3 cand[4] = {a_dir, b_dir, muls(xax, 1.0f / fmaxf(xl, 1e-30f)), n_tt};
  bool ok[4] = {a_len > EPSILON, b_len > EPSILON, xl > 1e-6f, g_have};
  for (int c = 0; c < 4; ++c) {
    if (!ok[c]) continue;        // an invalid axis scores BIG and never wins
    V3 n = cand[c];
    float ov = cyl_radius_on(n, a_dir, a_hl, ar) + cyl_radius_on(n, b_dir, b_hl, br)
               - fabsf(dot(dc, n));
    cb_consider(ov, n, c, g_bo, g_bn, g_bi);
  }
  float depth_gsat = g_bo;
  bool g_hit = gdist <= rsum && depth_gsat >= 0.0f && (perp || g_caphit);
  if (!g_hit) { o.mask = 0; return; }
  o.mask = 1;
  if (perp && depth_tt <= depth_gsat) {
    o.pt[0] = muls(add(add(c1, muls(n_tt, ar)), sub(c2, muls(n_tt, br))), 0.5f);
    o.dp[0] = depth_tt;
    o.n = n_tt;
    return;
  }
  float g_sgn = dot(dc, g_bn) >= 0.0f ? 1.0f : -1.0f;
  V3 n_gsat = muls(g_bn, g_sgn);                    // points A -> B
  V3 pb_sup = cyl_support_cm(cb_c, b_dir, b_hl, br, neg(n_gsat));
  V3 pa_sup = cyl_support_cm(ca_c, a_dir, a_hl, ar, n_gsat);
  V3 point;
  if (g_bi < 1)
    point = add(pb_sup, muls(n_gsat, 0.5f * depth_gsat));
  else if (g_bi == 1)
    point = sub(pa_sup, muls(n_gsat, 0.5f * depth_gsat));
  else if (g_have)
    point = muls(add(add(c1, muls(n_gsat, ar)), sub(c2, muls(n_gsat, br))), 0.5f);
  else
    point = muls(add(pa_sup, pb_sup), 0.5f);
  o.pt[0] = point;
  o.dp[0] = depth_gsat;
  o.n = n_gsat;
}

// the cylinder of cylinder_hull: centre m, unit axis adir, half length hlen,
// radius cr; its support point along n (cm_polytope.cylinder_hull_cm)
struct SupCyl {
  V3 m, adir;
  float hlen, cr;
  DF V3 operator()(V3 n) const {
    float na = dot(n, adir);
    V3 perp = sub(n, muls(adir, na));
    float pl = sqrtf(fmaxf(sqlen(perp), 0.0f));
    V3 pdir = muls(perp, 1.0f / fmaxf(pl, 1e-30f));
    float sgn = na >= 0.0f ? 1.0f : -1.0f;
    return add(m, add(muls(adir, hlen * sgn), muls(pdir, pl > 1e-6f ? cr : 0.0f)));
  }
};
template <class P_>
struct SupPolyVerts {
  const P_* P;
  DF V3 operator()(V3 d) const { return support(*P, d); }
};

// cylinder ca-cb2 (radius cr) vs hull at (hp, hq): one contact
// (cm_polytope.cylinder_hull_cm on the world-space polytope side)
template <class P_>
DF void cylinder_hull_t(V3 ca, V3 cb2, float cr, V3 hp, Q4 hq, const float* hb,
                        const int* llen, const HullDims& hd, float* hs, Manifold& o) {
  P_ B;
  if constexpr (P_::kWide) B.v = reinterpret_cast<V3*>(hs);
  poly_hull(B, hp, hq, hb, llen, hd);
  SupCyl cyl;
  cyl.m = muls(add(ca, cb2), 0.5f);
  V3 axv = sub(cb2, ca);
  cyl.hlen = 0.5f * sqrtf(fmaxf(sqlen(axv), 0.0f));
  cyl.adir = muls(axv, 1.0f / fmaxf(2.0f * cyl.hlen, 1e-30f));
  cyl.cr = cr;
  const V3 m = cyl.m, adir = cyl.adir;
  const float hlen = cyl.hlen;

  // candidate-axis SAT, two-sided overlap, normal oriented cylinder -> hull
  float best_ov = BIG;
  V3 best_n = mk(0.0f, 0.0f, 1.0f);
  bool separated = false;
  auto consider = [&](V3 n) {
    float na = dot(n, adir);
    float half = hlen * fabsf(na) + cr * sqrtf(fmaxf(1.0f - na * na, 0.0f));
    float c = dot(m, n);
    float mna = c - half, mxa = c + half;
    float mnb = dot(B.v[0], n), mxb = mnb;
    for (int i = 1; i < B.nv; ++i) {
      float sv = dot(B.v[i], n);
      mnb = fminf(mnb, sv);
      mxb = fmaxf(mxb, sv);
    }
    float d1 = mxa - mnb, d2 = mxb - mna;
    float ov = fminf(d1, d2);
    separated = separated || ov < 0.0f;
    if (sat_better(ov, best_ov)) { best_ov = ov; best_n = d1 <= d2 ? n : neg(n); }
  };
  // an invalid axis scores BIG and never wins: skipped
  for (int f = 0; f < B.nf; ++f)
    if (poly_face_ok(B, f)) consider(poly_face_n(B, f));
  consider(adir);
  for (int e = 0; e < B.ne; ++e) {
    V3 cx = cross(poly_edge(B, e), adir);
    float l2 = sqlen(cx);
    if (poly_edge_ok(B, e) && l2 > 1e-10f) consider(muls(cx, 1.0f / sqrtf(fmaxf(l2, 1e-30f))));
  }
  for (int i = 0; i < B.nv; ++i) {
    V3 w = sub(B.v[i], m);
    float t = clipf(dot(w, adir), -hlen, hlen);
    V3 perp = sub(w, muls(adir, t));
    float l2 = sqlen(perp);
    if (l2 > 1e-10f) consider(muls(perp, 1.0f / sqrtf(fmaxf(l2, 1e-30f))));
  }

  // support-witness descent from the best axis, keeping the minimum
  V3 probe_n = best_n;
  float probe_ov = best_ov;
  for (int it = 0; it < 8; ++it) {
    V3 d = sub(cyl(probe_n), support(B, neg(probe_n)));
    d = muls(d, probe_ov >= 0.0f ? 1.0f : -1.0f);
    float dl = sqrtf(fmaxf(sqlen(d), 0.0f));
    if (dl > 1e-9f) probe_n = muls(d, 1.0f / fmaxf(dl, 1e-30f));
    float na = dot(probe_n, adir);
    float half = hlen * fabsf(na) + cr * sqrtf(fmaxf(1.0f - na * na, 0.0f));
    float mn_h = dot(B.v[0], probe_n);
    for (int i = 1; i < B.nv; ++i) mn_h = fminf(mn_h, dot(B.v[i], probe_n));
    probe_ov = dot(m, probe_n) + half - mn_h;
    if (probe_ov < best_ov) { best_ov = probe_ov; best_n = probe_n; }
  }

  // boolean gate: the distance GJK, 16 iterations
  float dist; V3 qa, qb; bool overlap;
  SupPolyVerts<P_> sb = {&B};
  gjk_distance<16>(cyl, sb, dist, qa, qb, overlap);
  bool hit = best_ov >= 0.0f && !separated && (overlap || dist < 1e-5f);
  o.pt[0] = sub(cyl(best_n), muls(best_n, 0.5f * best_ov));
  o.dp[0] = best_ov;
  o.n = best_n;
  o.mask = hit ? 1 : 0;
}

DN void cylinder_hull_wide(V3 ca, V3 cb2, float cr, V3 hp, Q4 hq, const float* hb,
                           const int* llen, const HullDims& hd, float* hs, Manifold& o) {
  cylinder_hull_t<PolyWide>(ca, cb2, cr, hp, hq, hb, llen, hd, hs, o);
}

// as box_hull: the per-thread form inline, the wide one a call of its own
DN void cylinder_hull(V3 ca, V3 cb2, float cr, V3 hp, Q4 hq, const float* hb,
                      const int* llen, const HullDims& hd, float* hs, Manifold& o) {
  if (hs) {
    cylinder_hull_wide(ca, cb2, cr, hp, hq, hb, llen, hd, hs, o);
    return;
  }
  cylinder_hull_t<Poly>(ca, cb2, cr, hp, hq, hb, llen, hd, nullptr, o);
}

// the recipe of a sphere or cylinder row (recipe ids 6-14, fused_step.CM_RECIPES)
DN void shapes_row(int type, int ca, int cb, ColSide A, ColSide Bc,
                   const float* col_r, const int* hull_id, const int* hull_llen,
                   const float* hull_base, const HullDims& hd, float* hs, Manifold& mf) {
  switch (type) {
    case 6:
      sphere_sphere_row(ld3(A.a3), col_r[ca], ld3(Bc.a3), col_r[cb], mf);
      break;
    case 7:
      sphere_capsule(ld3(A.a3), col_r[ca], ld3(Bc.a3), ld3(Bc.b3), col_r[cb], mf);
      break;
    case 8:
      sphere_cylinder(ld3(A.a3), col_r[ca], ld3(Bc.a3), ld3(Bc.b3), col_r[cb], mf);
      break;
    case 9:
      sphere_box(ld3(A.a3), col_r[ca], ld3(Bc.a3), ld3(Bc.b3), ld4(Bc.q4), mf);
      break;
    case 10:
      sphere_hull(ld3(A.a3), col_r[ca], ld3(Bc.a3), ld4(Bc.q4),
                  hull_base + hb_size(hd) * hull_id[cb], hd, mf);
      break;
    case 11:
      capsule_cylinder(ld3(A.a3), ld3(A.b3), col_r[ca], ld3(Bc.a3), ld3(Bc.b3), col_r[cb],
                       mf);
      break;
    case 12:
      cylinder_cylinder(ld3(A.a3), ld3(A.b3), col_r[ca], ld3(Bc.a3), ld3(Bc.b3), col_r[cb],
                        mf);
      break;
    case 13:
      cylinder_box(ld3(A.a3), ld3(A.b3), col_r[ca], ld3(Bc.a3), ld3(Bc.b3), ld4(Bc.q4), mf);
      break;
    case 14:
      cylinder_hull(ld3(A.a3), ld3(A.b3), col_r[ca], ld3(Bc.a3), ld4(Bc.q4),
                    hull_base + hb_size(hd) * hull_id[cb],
                    hull_llen + hd.FU * hull_id[cb], hd, hs, mf);
      break;
  }
}

#endif  // DXK_SHAPE_RECIPES

// ---- contact prep (fused_step.py::_prep_points) -----------------------------
// Point fields in device memory (the wrapper's scratch), a point's 30 floats
// side by side ([slot][field]; the functions take a field stride):
//   0 rel_a, 3 rel_b, 6 normal, 9 tangent, 12 n_to_wa, 15 n_to_wb, 18 t_to_wa,
//   21 t_to_wb, 24 eff_n, 25 eff_t, 26 bias, 27 friction, 28 imp_n, 29 imp_t

DF void st3(float* base, int stride, int f, V3 v) {
  base[f * stride] = v.x; base[(f + 1) * stride] = v.y; base[(f + 2) * stride] = v.z;
}
DF V3 ldf3(const float* base, int stride, int f) {
  return mk(base[f * stride], base[(f + 1) * stride], base[(f + 2) * stride]);
}

DF void prep_point(V3 point, float depth, V3 normal, V3 pa, V3 pb, V3 va, V3 wa, V3 vb,
                   V3 wb, const float* ia, const float* ib, float inv_ma, float inv_mb,
                   float fric_c, float rest_c, float inv_dt, float* pf, int np) {
  V3 rel_a = sub(point, pa), rel_b = sub(point, pb);
  V3 av = add(va, cross(wa, rel_a));
  V3 bv = add(vb, cross(wb, rel_b));
  V3 rel_v = sub(bv, av);
  float vn0 = dot(normal, rel_v);
  V3 t_raw = sub(rel_v, muls(normal, vn0));
  float tl = sqrtf(fmaxf(sqlen(t_raw), 0.0f));
  bool ok = tl > 1e-6f;
  float tden = fmaxf(tl, 1e-30f);
  V3 tangent = ok ? mk(t_raw.x / tden, t_raw.y / tden, t_raw.z / tden) : mk(0.0f, 0.0f, 0.0f);

  V3 cr_at = cross(rel_a, tangent), cr_bt = cross(rel_b, tangent);
  V3 ia_at = matvec(ia, cr_at), ib_bt = matvec(ib, cr_bt);
  float im_t = inv_ma + inv_mb + dot(cr_at, ia_at) + dot(cr_bt, ib_bt);
  float eff_t = inv_nz(im_t);

  V3 cr_an = cross(rel_a, normal), cr_bn = cross(rel_b, normal);
  V3 ia_an = matvec(ia, cr_an), ib_bn = matvec(ib, cr_bn);
  float im_n = inv_ma + inv_mb + dot(cr_an, ia_an) + dot(cr_bn, ib_bn);
  float eff_n = inv_nz(im_n);

  const float slop = -0.001f;
  bool active = (-depth < slop) && (vn0 < 0.0f) && (inv_dt < 1e5f);
  float bias = active ? -rest_c * vn0 - 0.1f * (-depth - slop) * inv_dt : 0.0f;

  st3(pf, np, 0, rel_a); st3(pf, np, 3, rel_b); st3(pf, np, 6, normal);
  st3(pf, np, 9, tangent); st3(pf, np, 12, ia_an); st3(pf, np, 15, ib_bn);
  st3(pf, np, 18, ia_at); st3(pf, np, 21, ib_bt);
  pf[24 * np] = eff_n; pf[25 * np] = eff_t; pf[26 * np] = bias; pf[27 * np] = fric_c;
  pf[28 * np] = 0.0f; pf[29 * np] = 0.0f;
}

// ---- joint prep (ops/kernels/cm_joint_prep.py) ------------------------------
// static table per joint: 0 anchor_a, 3 anchor_b, 6 local_axis_a, 9 local_axis_b,
// 12 local_tangent_a, 15 local_bitangent_a, 18 local_tangent_b, 21 limit_min,
// 22 limit_max, 23 local_axis_a_unit, 26 length, 27 init_inv_rot (x, y, z, w);
// a field a type lacks is zero

struct JointBodies {
  Q4 qa, qb;
  V3 pa, pb;
  const float *ia, *ib;
  float inv_ma, inv_mb;
};

DF Q4 quat_mul(Q4 a, Q4 b) {
  V3 av = mk(a.x, a.y, a.z), bv = mk(b.x, b.y, b.z);
  float w = a.w * b.w - dot(av, bv);
  V3 c = cross(av, bv);
  V3 v = add(add(muls(av, b.w), muls(bv, a.w)), c);
  Q4 r; r.x = v.x; r.y = v.y; r.z = v.z; r.w = w; return r;
}
DF Q4 quat_normalize(Q4 q) {
  float n = sqrtf(fmaxf(q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w, 1e-30f));
  float inv = 1.0f / n;
  Q4 r; r.x = q.x * inv; r.y = q.y * inv; r.z = q.z * inv; r.w = q.w * inv; return r;
}
DF V3 normalize(V3 v) { return muls(v, 1.0f / sqrtf(fmaxf(sqlen(v), 1e-30f))); }
DF V3 noz(V3 v) {
  float sq = sqlen(v);
  bool ok = sq > 1e-12f;
  float inv = sqrtf(1.0f / (ok ? sq : 1.0f));
  return ok ? muls(v, inv) : mk(0.0f, 0.0f, 0.0f);
}

DF Q4 rotate_from_to(V3 f, V3 t) {
  t = normalize(t);
  float d = dot(f, t);
  float s = sqrtf(fmaxf((1.0f + d) * 2.0f, 1e-30f));
  float invs = 1.0f / s;
  V3 c = cross(f, t);
  Q4 qg; qg.x = c.x * invs; qg.y = c.y * invs; qg.z = c.z * invs; qg.w = s * 0.5f;
  qg = quat_normalize(qg);
  V3 ax1 = cross(mk(1.0f, 0.0f, 0.0f), f);
  V3 ax2 = cross(mk(0.0f, 1.0f, 0.0f), f);
  V3 axr = sqlen(ax1) < 1e-12f ? ax2 : ax1;
  V3 axis = normalize(add(axr, mk(1e-30f, 1e-30f, 1e-30f)));
  Q4 q = qg;
  if (d < (1e-6f - 1.0f)) { q.x = axis.x; q.y = axis.y; q.z = axis.z; q.w = 0.0f; }
  if (d >= 1.0f) { q.x = 0.0f; q.y = 0.0f; q.z = 0.0f; q.w = 1.0f; }
  return q;
}

DF void get_axis_rotation(Q4 q, V3& axis, float& angle) {
  V3 v = mk(q.x, q.y, q.z);
  float sq = sqlen(v);
  bool ok = sq > 0.0f;
  angle = ok ? 2.0f * fm_acos(clipf(q.w, -1.0f, 1.0f)) : 0.0f;
  float inv_len = ok ? 1.0f / sqrtf(sq) : 0.0f;
  axis = ok ? muls(v, inv_len) : mk(1.0f, 0.0f, 0.0f);
}

DF void matmul3(const float* a, const float* b, float* o) {
  #pragma unroll
  for (int i = 0; i < 3; ++i)
    #pragma unroll
    for (int j = 0; j < 3; ++j)
      o[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}
DF void skew(V3 r, float* s) {
  s[0] = 0.0f; s[1] = -r.z; s[2] = r.y;
  s[3] = r.z; s[4] = 0.0f; s[5] = -r.x;
  s[6] = -r.y; s[7] = r.x; s[8] = 0.0f;
}
DF void mat_t(const float* a, float* o) {
  o[0] = a[0]; o[1] = a[3]; o[2] = a[6];
  o[3] = a[1]; o[4] = a[4]; o[5] = a[7];
  o[6] = a[2]; o[7] = a[5]; o[8] = a[8];
}
// sa Ia sa^T + sb Ib sb^T + I (ma + mb)
DF void point_inv_eff_mass(const JointBodies& bd, V3 ra, V3 rb, float* m) {
  float s[9], st[9], t1[9], t2[9], ma[9];
  skew(ra, s); mat_t(s, st);
  for (int i = 0; i < 9; ++i) ma[i] = bd.ia[i];
  matmul3(s, ma, t1); matmul3(t1, st, t2);
  for (int i = 0; i < 9; ++i) m[i] = t2[i];
  skew(rb, s); mat_t(s, st);
  for (int i = 0; i < 9; ++i) ma[i] = bd.ib[i];
  matmul3(s, ma, t1); matmul3(t1, st, t2);
  for (int i = 0; i < 9; ++i) m[i] = m[i] + t2[i];
  float sm = bd.inv_ma + bd.inv_mb;
  m[0] += sm; m[4] += sm; m[8] += sm;
}

DF void st9(float* out, int nj, int f, const float* m) {
  for (int i = 0; i < 9; ++i) out[(f + i) * nj] = m[i];
}
DF void anchors(const float* js, const JointBodies& bd, V3& rel_a, V3& rel_b, V3& ga,
                V3& gb) {
  rel_a = qrot(bd.qa, ld3(js + 0));
  rel_b = qrot(bd.qb, ld3(js + 3));
  ga = add(bd.pa, rel_a);
  gb = add(bd.pb, rel_b);
}
// fixed / slider rotation error q_b * init_inv_rot * conj(q_a), vector part,
// as a Baumgarte bias
DF V3 rotation_bias(const float* js, const JointBodies& bd, bool dt_ok, float inv_dt) {
  Q4 err = quat_mul(quat_mul(bd.qb, ld4(js + 27)), conj(bd.qa));
  float k = SLIDER_BETA * inv_dt * 2.0f;
  return dt_ok ? mk(err.x * k, err.y * k, err.z * k) : mk(0.0f, 0.0f, 0.0f);
}

// distance row layout: 0 rel_a, 3 rel_b, 6 u, 9 to_wa, 12 to_wb, 15 bias,
// 16 eff_mass
DN void distance_prep(const float* js, const JointBodies& bd, float dt, float inv_dt,
                      float* out, int nj) {
  V3 rel_a, rel_b, ga, gb;
  anchors(js, bd, rel_a, rel_b, ga, gb);
  V3 u = sub(gb, ga);
  float l = sqrtf(fmaxf(sqlen(u), 0.0f));
  bool ok = l > 0.001f;
  float ld = fmaxf(l, 1e-12f);
  u = ok ? mk(u.x / ld, u.y / ld, u.z / ld) : mk(0.0f, 0.0f, 0.0f);
  V3 cr_a = cross(rel_a, u), cr_b = cross(rel_b, u);
  V3 to_wa = matvec(bd.ia, cr_a), to_wb = matvec(bd.ib, cr_b);
  float im = bd.inv_ma + dot(cr_a, to_wa) + bd.inv_mb + dot(cr_b, to_wb);
  bool dt_ok = dt > DT_THRESHOLD;
  float bias = dt_ok ? (l - js[26]) * (DISTANCE_BETA * inv_dt) : 0.0f;
  st3(out, nj, 0, rel_a); st3(out, nj, 3, rel_b); st3(out, nj, 6, u);
  st3(out, nj, 9, to_wa); st3(out, nj, 12, to_wb);
  out[15 * nj] = bias;
  out[16 * nj] = inv_nz(im);
}

// ball row layout: 0 rel_a, 3 rel_b, 6 bias, 9 m(9)
DN void ball_prep(const float* js, const JointBodies& bd, float dt, float inv_dt,
                  float* out, int nj) {
  V3 rel_a, rel_b, ga, gb;
  anchors(js, bd, rel_a, rel_b, ga, gb);
  float m[9];
  point_inv_eff_mass(bd, rel_a, rel_b, m);
  float kb = BALL_BETA * inv_dt;
  V3 bias = dt > DT_THRESHOLD ? muls(sub(gb, ga), kb) : mk(0.0f, 0.0f, 0.0f);
  st3(out, nj, 0, rel_a); st3(out, nj, 3, rel_b); st3(out, nj, 6, bias);
  st9(out, nj, 9, m);
}

// fixed row layout: 0 rel_a, 3 rel_b, 6 translation_bias, 9 rotation_bias,
// 12 mt(9), 21 mr(9)
DN void fixed_prep(const float* js, const JointBodies& bd, float dt, float inv_dt,
                   float* out, int nj) {
  V3 rel_a, rel_b, ga, gb;
  anchors(js, bd, rel_a, rel_b, ga, gb);
  float mt[9], mr[9];
  point_inv_eff_mass(bd, rel_a, rel_b, mt);
  for (int i = 0; i < 9; ++i) mr[i] = bd.ia[i] + bd.ib[i];
  bool dt_ok = dt > DT_THRESHOLD;
  float kb = BALL_BETA * inv_dt;
  V3 t_bias = dt_ok ? muls(sub(gb, ga), kb) : mk(0.0f, 0.0f, 0.0f);
  V3 r_bias = rotation_bias(js, bd, dt_ok, inv_dt);
  st3(out, nj, 0, rel_a); st3(out, nj, 3, rel_b); st3(out, nj, 6, t_bias);
  st3(out, nj, 9, r_bias);
  st9(out, nj, 12, mt); st9(out, nj, 21, mr);
}

// hinge row layout ([field][joint]): 0 rel_a, 3 rel_b, 6 translation_bias,
// 9 bxa, 12 cxa, 15 axis, 18 ml_to_wa, 21 ml_to_wb, 24 mt(9), 33 mr(4),
// 37 rot_bias(2), 39 eff_axial_mass, 40 solve_limit, 41 solve_motor,
// 42 limit_sign, 43 limit_bias, 44 motor_velocity, 45 max_motor_impulse
DN void hinge_prep(const float* js, const float* ctl, const JointBodies& bd, float dt,
                   float inv_dt, float* out, int nj) {
  V3 rel_a = qrot(bd.qa, ld3(js + 0)), rel_b = qrot(bd.qb, ld3(js + 3));
  V3 ga = add(bd.pa, rel_a), gb = add(bd.pb, rel_b);
  float mt[9];
  point_inv_eff_mass(bd, rel_a, rel_b, mt);
  bool dt_ok = dt > DT_THRESHOLD;
  V3 gd = sub(gb, ga);
  float kb = BALL_BETA * inv_dt;
  V3 t_bias = dt_ok ? muls(gd, kb) : mk(0.0f, 0.0f, 0.0f);

  V3 axis_a = qrot(bd.qa, ld3(js + 6));
  V3 axis_b = qrot(bd.qb, ld3(js + 9));
  V3 tan_b = get_tangent(axis_b);
  V3 bitan_b = cross(axis_b, tan_b);
  V3 bxa = cross(tan_b, axis_a), cxa = cross(bitan_b, axis_a);
  V3 ia_bxa = matvec(bd.ia, bxa), ib_bxa = matvec(bd.ib, bxa);
  V3 ia_cxa = matvec(bd.ia, cxa), ib_cxa = matvec(bd.ib, cxa);
  float m00 = dot(bxa, ia_bxa) + dot(bxa, ib_bxa);
  float m01 = dot(bxa, ia_cxa) + dot(bxa, ib_cxa);
  float m10 = dot(cxa, ia_bxa) + dot(cxa, ib_bxa);
  float m11 = dot(cxa, ia_cxa) + dot(cxa, ib_cxa);
  float kr = HINGE_ROTATION_BETA * inv_dt;
  float rb0 = dt_ok ? dot(axis_a, tan_b) * kr : 0.0f;
  float rb1 = dt_ok ? dot(axis_a, bitan_b) * kr : 0.0f;

  V3 compare_a = qrot(conj(bd.qa), qrot(bd.qb, ld3(js + 18)));
  float angle = fm_atan2(dot(compare_a, ld3(js + 15)), dot(compare_a, ld3(js + 12)));
  float lmin = js[21], lmax = js[22];
  bool min_violated = lmin <= 0.0f && angle <= lmin;
  bool max_violated = lmax >= 0.0f && angle >= lmax;
  float motor_type = ctl[0], target_c = ctl[1], max_torque = ctl[2];
  bool solve_limit = min_violated || max_violated;
  bool solve_motor = max_torque > 0.0f;

  V3 ia_ax = matvec(bd.ia, axis_a), ib_ax = matvec(bd.ib, axis_a);
  float im_ax = dot(axis_a, ia_ax) + dot(axis_a, ib_ax);
  float eff_ax = inv_nz(im_ax);
  float limit_sign = min_violated ? 1.0f : -1.0f;

  float min_l = lmin <= 0.0f ? lmin : -PI_F;
  float max_l = lmax >= 0.0f ? lmax : PI_F;
  float target = clipf(target_c, min_l, max_l);
  float pos_motor_vel = dt_ok ? (target - angle) * inv_dt : 0.0f;
  float motor_vel = motor_type == 1.0f ? pos_motor_vel : target_c;

  float d = min_violated ? angle - lmin : lmax - angle;
  float limit_bias = dt_ok ? d * HINGE_LIMIT_BETA * inv_dt : 0.0f;

  st3(out, nj, 0, rel_a); st3(out, nj, 3, rel_b); st3(out, nj, 6, t_bias);
  st3(out, nj, 9, bxa); st3(out, nj, 12, cxa); st3(out, nj, 15, axis_a);
  st3(out, nj, 18, ia_ax); st3(out, nj, 21, ib_ax);
  for (int i = 0; i < 9; ++i) out[(24 + i) * nj] = mt[i];
  out[33 * nj] = m00; out[34 * nj] = m01; out[35 * nj] = m10; out[36 * nj] = m11;
  out[37 * nj] = rb0; out[38 * nj] = rb1;
  out[39 * nj] = eff_ax;
  out[40 * nj] = solve_limit ? 1.0f : 0.0f;
  out[41 * nj] = solve_motor ? 1.0f : 0.0f;
  out[42 * nj] = limit_sign;
  out[43 * nj] = limit_bias;
  out[44 * nj] = motor_vel;
  out[45 * nj] = fmaxf(max_torque, 0.0f) * dt;
}

// cone-twist row layout: 0 rel_a, 3 rel_b, 6 bias, 9 swing_axis, 12 sl_to_wa,
// 15 sl_to_wb, 18 twist_axis, 21 tw_to_wa, 24 tw_to_wb, 27 swing_motor_axis,
// 30 sm_to_wa, 33 sm_to_wb, 36 m(9), 45 solve_swing_limit,
// 46 eff_swing_limit_mass, 47 swing_limit_bias, 48 solve_twist_limit,
// 49 eff_twist_mass, 50 twist_limit_sign, 51 twist_limit_bias,
// 52 solve_swing_motor, 53 eff_swing_motor_mass, 54 swing_motor_velocity,
// 55 max_swing_motor_impulse, 56 solve_twist_motor, 57 twist_motor_velocity,
// 58 max_twist_motor_impulse
DN void cone_twist_prep(const float* js, const float* ctl, const JointBodies& bd, float dt,
                        float inv_dt, float* out, int nj) {
  V3 rel_a = qrot(bd.qa, ld3(js + 0)), rel_b = qrot(bd.qb, ld3(js + 3));
  V3 ga = add(bd.pa, rel_a), gb = add(bd.pb, rel_b);
  float m[9];
  point_inv_eff_mass(bd, rel_a, rel_b, m);
  bool dt_ok = dt > DT_THRESHOLD;
  float kb = BALL_BETA * inv_dt;
  V3 bias = dt_ok ? muls(sub(gb, ga), kb) : mk(0.0f, 0.0f, 0.0f);

  V3 l_axis_a = ld3(js + 6), l_tan_a = ld3(js + 12), l_bitan_a = ld3(js + 15);
  Q4 btoa = quat_mul(conj(bd.qa), bd.qb);
  V3 axis_compare = qrot(btoa, ld3(js + 9));
  Q4 swing_rotation = rotate_from_to(ld3(js + 23), axis_compare);

  V3 twist_tan_a = qrot(swing_rotation, l_tan_a);
  V3 twist_bitan_a = qrot(swing_rotation, l_bitan_a);
  V3 tan_compare = qrot(btoa, ld3(js + 18));
  float twist_angle = fm_atan2(dot(tan_compare, twist_bitan_a), dot(tan_compare, twist_tan_a));

  V3 swing_axis_l; float swing_angle;
  get_axis_rotation(swing_rotation, swing_axis_l, swing_angle);
  if (swing_angle < 0.0f) { swing_angle = -swing_angle; swing_axis_l = neg(swing_axis_l); }

  float swing_limit = js[21], twist_limit = js[22];

  // swing limit
  bool solve_swing = swing_limit >= 0.0f && swing_angle >= swing_limit;
  V3 swing_axis = qrot(bd.qa, swing_axis_l);
  V3 ia_sl = matvec(bd.ia, swing_axis), ib_sl = matvec(bd.ib, swing_axis);
  float eff_sl = inv_nz(dot(swing_axis, ia_sl) + dot(swing_axis, ib_sl));
  float kl = HINGE_LIMIT_BETA * inv_dt;
  float swing_limit_bias = dt_ok ? (swing_limit - swing_angle) * kl : 0.0f;

  // swing motor
  float sw_type = ctl[0], sw_target = ctl[1], sw_axis_angle = ctl[2], sw_max = ctl[3];
  float tw_type = ctl[4], tw_target_c = ctl[5], tw_max = ctl[6];
  bool solve_swing_motor = sw_max > 0.0f;
  float ax_x = cosf(sw_axis_angle), ax_y = sinf(sw_axis_angle);
  V3 local_sm_axis = add(muls(l_tan_a, ax_x), muls(l_bitan_a, ax_y));
  V3 sm_axis_vel = qrot(bd.qa, local_sm_axis);
  float asl = fabsf(swing_limit);
  float target_angle = swing_limit >= 0.0f ? clipf(sw_target, -asl, asl) : sw_target;
  float half = target_angle * 0.5f;
  float sh = sinf(half);
  Q4 qt; qt.x = local_sm_axis.x * sh; qt.y = local_sm_axis.y * sh;
  qt.z = local_sm_axis.z * sh; qt.w = cosf(half);
  V3 local_target_dir = qrot(qt, l_axis_a);
  V3 local_sm_axis_pos = noz(cross(axis_compare, local_target_dir));
  V3 sm_axis_pos = qrot(bd.qa, local_sm_axis_pos);
  float cos_angle = dot(local_target_dir, axis_compare);
  float delta_angle = fm_acos(clipf(cos_angle, 0.0f, 1.0f));
  float sm_vel_p = dt_ok ? delta_angle * inv_dt * 0.2f : 0.0f;

  bool is_pos = sw_type == 1.0f;
  V3 sm_axis = sel(is_pos, sm_axis_pos, sm_axis_vel);
  float sm_vel = is_pos ? sm_vel_p : sw_target;
  V3 ia_sm = matvec(bd.ia, sm_axis), ib_sm = matvec(bd.ib, sm_axis);
  float eff_sm = inv_nz(dot(sm_axis, ia_sm) + dot(sm_axis, ib_sm));

  // twist limit & motor
  bool min_tw = twist_limit >= 0.0f && twist_angle <= -twist_limit;
  bool max_tw = twist_limit >= 0.0f && twist_angle >= twist_limit;
  bool solve_twist_limit = min_tw || max_tw;
  bool solve_twist_motor = tw_max > 0.0f;
  V3 twist_axis = qrot(bd.qa, l_axis_a);
  V3 ia_tw = matvec(bd.ia, twist_axis), ib_tw = matvec(bd.ib, twist_axis);
  float eff_tw = inv_nz(dot(twist_axis, ia_tw) + dot(twist_axis, ib_tw));
  float twist_limit_sign = min_tw ? 1.0f : -1.0f;

  float limit = twist_limit >= 0.0f ? twist_limit : PI_F;
  float tw_target = clipf(tw_target_c, -limit, limit);
  float tw_vel_p = dt_ok ? (tw_target - twist_angle) * inv_dt : 0.0f;
  float tw_vel = tw_type == 1.0f ? tw_vel_p : tw_target_c;

  float d = min_tw ? twist_limit + twist_angle : twist_limit - twist_angle;
  float twist_limit_bias = dt_ok ? d * TWIST_LIMIT_BETA * inv_dt : 0.0f;

  st3(out, nj, 0, rel_a); st3(out, nj, 3, rel_b); st3(out, nj, 6, bias);
  st3(out, nj, 9, swing_axis); st3(out, nj, 12, ia_sl); st3(out, nj, 15, ib_sl);
  st3(out, nj, 18, twist_axis); st3(out, nj, 21, ia_tw); st3(out, nj, 24, ib_tw);
  st3(out, nj, 27, sm_axis); st3(out, nj, 30, ia_sm); st3(out, nj, 33, ib_sm);
  for (int i = 0; i < 9; ++i) out[(36 + i) * nj] = m[i];
  out[45 * nj] = solve_swing ? 1.0f : 0.0f;
  out[46 * nj] = eff_sl;
  out[47 * nj] = swing_limit_bias;
  out[48 * nj] = solve_twist_limit ? 1.0f : 0.0f;
  out[49 * nj] = eff_tw;
  out[50 * nj] = twist_limit_sign;
  out[51 * nj] = twist_limit_bias;
  out[52 * nj] = solve_swing_motor ? 1.0f : 0.0f;
  out[53 * nj] = eff_sm;
  out[54 * nj] = sm_vel;
  out[55 * nj] = fmaxf(sw_max, 0.0f) * dt;
  out[56 * nj] = solve_twist_motor ? 1.0f : 0.0f;
  out[57 * nj] = tw_vel;
  out[58 * nj] = fmaxf(tw_max, 0.0f) * dt;
}

// slider row layout: 0 r_au_x_t, 3 r_au_x_b, 6 r_b_x_t, 9 r_b_x_b, 12 tangent,
// 15 bitangent, 18 axis, 21 r_au_x_s, 24 r_b_x_s, 27 l_to_wa, 30 l_to_wb,
// 33 rotation_bias, 36 mt(2x2), 40 tb(2), 42 mr(9), 51 solve_limit,
// 52 eff_axial_mass, 53 limit_bias, 54 limit_sign, 55 solve_motor,
// 56 motor_velocity, 57 max_motor_impulse
DN void slider_prep(const float* js, const float* ctl, const JointBodies& bd, float dt,
                    float inv_dt, float* out, int nj) {
  V3 rel_a, rel_b, ga, gb;
  anchors(js, bd, rel_a, rel_b, ga, gb);
  V3 axis = qrot(bd.qa, ld3(js + 6));
  V3 tangent = get_tangent(axis);
  V3 bitangent = cross(axis, tangent);
  V3 u = sub(gb, ga);
  V3 r_au = add(rel_a, u);
  V3 rbxt = cross(rel_b, tangent), rbxb = cross(rel_b, bitangent);
  V3 rauxt = cross(r_au, tangent), rauxb = cross(r_au, bitangent);
  V3 ia_rauxt = matvec(bd.ia, rauxt), ia_rauxb = matvec(bd.ia, rauxb);
  V3 ib_rbxt = matvec(bd.ib, rbxt), ib_rbxb = matvec(bd.ib, rbxb);
  float ims = bd.inv_ma + bd.inv_mb;
  float m00 = dot(rauxt, ia_rauxt) + dot(rbxt, ib_rbxt) + ims;
  float m01 = dot(rauxt, ia_rauxb) + dot(rbxt, ib_rbxb);
  float m10 = dot(rauxb, ia_rauxt) + dot(rbxb, ib_rbxt);
  float m11 = dot(rauxb, ia_rauxb) + dot(rbxb, ib_rbxb) + ims;
  float mr[9];
  for (int i = 0; i < 9; ++i) mr[i] = bd.ia[i] + bd.ib[i];
  bool dt_ok = dt > DT_THRESHOLD;
  float ks = SLIDER_BETA * inv_dt;
  float tb0 = dt_ok ? dot(u, tangent) * ks : 0.0f;
  float tb1 = dt_ok ? dot(u, bitangent) * ks : 0.0f;
  V3 r_bias = rotation_bias(js, bd, dt_ok, inv_dt);

  // limit
  float lmin = js[21], lmax = js[22];
  float dist = dot(u, axis);
  bool min_v = lmin <= 0.0f && dist < lmin;
  bool max_v = lmax >= 0.0f && dist > lmax;
  bool solve_limit = min_v || max_v;
  V3 rauxs = cross(r_au, axis), rbxs = cross(rel_b, axis);
  V3 ia_rauxs = matvec(bd.ia, rauxs), ib_rbxs = matvec(bd.ib, rbxs);
  float im_ax = ims + dot(rauxs, ia_rauxs) + dot(rbxs, ib_rbxs);
  float eff_ax = inv_nz(im_ax);
  float limit_sign = min_v ? 1.0f : -1.0f;
  float err = min_v ? dist - lmin : lmax - dist;
  float limit_bias = dt_ok ? err * (SLIDER_LIMIT_BETA * inv_dt) : 0.0f;

  // motor; a disabled limit leaves the target unclamped
  float motor_type = ctl[0], target_c = ctl[1], max_force = ctl[2];
  bool solve_motor = max_force > 0.0f;
  float min_l = lmin <= 0.0f ? lmin : -3.4e38f;
  float max_l = lmax >= 0.0f ? lmax : 3.4e38f;
  float target = clipf(target_c, min_l, max_l);
  float vel_p = dt_ok ? (target - dist) * inv_dt : 0.0f;
  float motor_vel = motor_type == 1.0f ? vel_p : target_c;

  st3(out, nj, 0, rauxt); st3(out, nj, 3, rauxb); st3(out, nj, 6, rbxt);
  st3(out, nj, 9, rbxb); st3(out, nj, 12, tangent); st3(out, nj, 15, bitangent);
  st3(out, nj, 18, axis); st3(out, nj, 21, rauxs); st3(out, nj, 24, rbxs);
  st3(out, nj, 27, ia_rauxs); st3(out, nj, 30, ib_rbxs); st3(out, nj, 33, r_bias);
  out[36 * nj] = m00; out[37 * nj] = m01; out[38 * nj] = m10; out[39 * nj] = m11;
  out[40 * nj] = tb0; out[41 * nj] = tb1;
  st9(out, nj, 42, mr);
  out[51 * nj] = solve_limit ? 1.0f : 0.0f;
  out[52 * nj] = eff_ax;
  out[53 * nj] = limit_bias;
  out[54 * nj] = limit_sign;
  out[55 * nj] = solve_motor ? 1.0f : 0.0f;
  out[56 * nj] = motor_vel;
  out[57 * nj] = fmaxf(max_force, 0.0f) * dt;
}

// ---- per-constraint solves (ops/kernels/batched_solver.py) ------------------

DF void solve_2x2(float a11, float a12, float a21, float a22, float b0, float b1,
                  float& x0, float& x1) {
  float det = a11 * a22 - a12 * a21;
  float inv = inv_nz(det);
  x0 = inv * (a22 * b0 - a12 * b1);
  x1 = inv * (a11 * b1 - a21 * b0);
}

// Cramer's rule on columns; m row-major, read with a stride
DF V3 solve_3x3(const float* m, int st, V3 b) {
  V3 ex = mk(m[0], m[3 * st], m[6 * st]);
  V3 ey = mk(m[1 * st], m[4 * st], m[7 * st]);
  V3 ez = mk(m[2 * st], m[5 * st], m[8 * st]);
  float det = dot(ex, cross(ey, ez));
  float inv = inv_nz(det);
  return mk(inv * dot(b, cross(ey, ez)), inv * dot(ex, cross(b, ez)),
            inv * dot(ex, cross(ey, b)));
}

struct Vel { V3 va, wa, vb, wb; };

// P = solve_3x3(m, -cdot3) applied at the anchors rel_a / rel_b (ball, fixed,
// hinge, cone-twist position parts)
DF void point_impulse(const float* m, int st, V3 rel_a, V3 rel_b, V3 bias, float inv_ma,
                      float inv_mb, const float* ia, const float* ib, Vel& u) {
  V3 av = add(u.va, cross(u.wa, rel_a));
  V3 bv = add(u.vb, cross(u.wb, rel_b));
  V3 cdot3 = add(sub(bv, av), bias);
  V3 P = solve_3x3(m, st, neg(cdot3));
  u.va = sub(u.va, muls(P, inv_ma));
  u.wa = sub(u.wa, matvec(ia, cross(rel_a, P)));
  u.vb = add(u.vb, muls(P, inv_mb));
  u.wb = add(u.wb, matvec(ib, cross(rel_b, P)));
}

// lam3 = solve_3x3(mr, -(wb - wa + rotation_bias)) (fixed, slider rotation parts)
DF void rotation_impulse(const float* mr, int st, V3 rbias, const float* ia,
                         const float* ib, Vel& u) {
  V3 cdot = sub(u.wb, u.wa);
  V3 rhs = mk(-(cdot.x + rbias.x), -(cdot.y + rbias.y), -(cdot.z + rbias.z));
  V3 lam = solve_3x3(mr, st, rhs);
  u.wa = sub(u.wa, matvec(ia, lam));
  u.wb = add(u.wb, matvec(ib, lam));
}

DF void distance_solve(const float* f, int nj, float inv_ma, float inv_mb, Vel& u) {
  V3 rel_a = ldf3(f, nj, 0), rel_b = ldf3(f, nj, 3), dir = ldf3(f, nj, 6);
  V3 av = add(u.va, cross(u.wa, rel_a));
  V3 bv = add(u.vb, cross(u.wb, rel_b));
  float cdot = dot(dir, sub(bv, av)) + f[15 * nj];
  float lam = -f[16 * nj] * cdot;
  u.va = sub(u.va, muls(dir, inv_ma * lam));
  u.wa = sub(u.wa, muls(ldf3(f, nj, 9), lam));
  u.vb = add(u.vb, muls(dir, inv_mb * lam));
  u.wb = add(u.wb, muls(ldf3(f, nj, 12), lam));
}

DF void ball_solve(const float* f, int nj, float inv_ma, float inv_mb, const float* ia,
                   const float* ib, Vel& u) {
  point_impulse(f + 9 * nj, nj, ldf3(f, nj, 0), ldf3(f, nj, 3), ldf3(f, nj, 6), inv_ma,
                inv_mb, ia, ib, u);
}

// rotation then position
DF void fixed_solve(const float* f, int nj, float inv_ma, float inv_mb, const float* ia,
                    const float* ib, Vel& u) {
  rotation_impulse(f + 21 * nj, nj, ldf3(f, nj, 9), ia, ib, u);
  point_impulse(f + 12 * nj, nj, ldf3(f, nj, 0), ldf3(f, nj, 3), ldf3(f, nj, 6), inv_ma,
                inv_mb, ia, ib, u);
}

// motor -> limit -> rotation -> position (2D, normal to the axis)
DF void slider_solve(const float* f, int nj, float inv_ma, float inv_mb, const float* ia,
                     const float* ib, Vel& u, float* imps) {
  float limit_imp = imps[0], motor_imp = imps[1];
  V3 axis = ldf3(f, nj, 18);
  // motor (pure linear along the axis)
  float cdot = dot(u.vb, axis) - dot(u.va, axis) - f[56 * nj];
  float mass = inv_nz(inv_ma + inv_mb);
  float lam = -mass * cdot;
  float mx = f[57 * nj];
  float nw = clipf(motor_imp + lam, -mx, mx);
  bool on = f[55 * nj] > 0.5f;
  lam = on ? nw - motor_imp : 0.0f;
  motor_imp = on ? nw : motor_imp;
  u.va = sub(u.va, muls(axis, inv_ma * lam));
  u.vb = add(u.vb, muls(axis, inv_mb * lam));
  // limit
  float lsign = f[54 * nj];
  cdot = dot(u.vb, axis) + dot(u.wb, ldf3(f, nj, 24)) - dot(u.va, axis)
         - dot(u.wa, ldf3(f, nj, 21));
  lam = -f[52 * nj] * (lsign * cdot + f[53 * nj]);
  float imp = fmaxf(limit_imp + lam, 0.0f);
  on = f[51 * nj] > 0.5f;
  lam = on ? imp - limit_imp : 0.0f;
  limit_imp = on ? imp : limit_imp;
  lam = lam * lsign;
  u.va = sub(u.va, muls(axis, inv_ma * lam));
  u.wa = sub(u.wa, muls(ldf3(f, nj, 27), lam));
  u.vb = add(u.vb, muls(axis, inv_mb * lam));
  u.wb = add(u.wb, muls(ldf3(f, nj, 30), lam));
  // rotation (3D)
  rotation_impulse(f + 42 * nj, nj, ldf3(f, nj, 33), ia, ib, u);
  // position (2D)
  V3 tan = ldf3(f, nj, 12), bitan = ldf3(f, nj, 15);
  V3 rauxt = ldf3(f, nj, 0), rauxb = ldf3(f, nj, 3);
  V3 rbxt = ldf3(f, nj, 6), rbxb = ldf3(f, nj, 9);
  float cx = dot(tan, u.vb) + dot(rbxt, u.wb) - dot(tan, u.va) - dot(rauxt, u.wa);
  float cy = dot(bitan, u.vb) + dot(rbxb, u.wb) - dot(bitan, u.va) - dot(rauxb, u.wa);
  float l0, l1;
  solve_2x2(f[36 * nj], f[37 * nj], f[38 * nj], f[39 * nj], -(cx + f[40 * nj]),
            -(cy + f[41 * nj]), l0, l1);
  V3 tbv = add(muls(tan, l0), muls(bitan, l1));
  u.va = sub(u.va, muls(tbv, inv_ma));
  u.wa = sub(u.wa, matvec(ia, add(muls(rauxt, l0), muls(rauxb, l1))));
  u.vb = add(u.vb, muls(tbv, inv_mb));
  u.wb = add(u.wb, matvec(ib, add(muls(rbxt, l0), muls(rbxb, l1))));
  imps[0] = limit_imp;
  imps[1] = motor_imp;
}

// friction then normal, against the running velocities of the row
DF void contact_point(float* pf, int np, float inv_ma, float inv_mb, Vel& u) {
  V3 rel_a = ldf3(pf, np, 0), rel_b = ldf3(pf, np, 3);
  V3 nrm = ldf3(pf, np, 6), tan = ldf3(pf, np, 9);
  float eff_n = pf[24 * np], eff_t = pf[25 * np], bias = pf[26 * np], fric = pf[27 * np];
  float imp_n = pf[28 * np], imp_t = pf[29 * np];

  V3 av = add(u.va, cross(u.wa, rel_a));
  V3 bv = add(u.vb, cross(u.wb, rel_b));
  float vt = dot(tan, sub(bv, av));
  float lam = -eff_t * vt;
  float max_f = fric * imp_n;
  float nw = clipf(imp_t + lam, -max_f, max_f);
  lam = nw - imp_t;
  imp_t = nw;
  u.va = sub(u.va, muls(tan, inv_ma * lam));
  u.wa = sub(u.wa, muls(ldf3(pf, np, 18), lam));
  u.vb = add(u.vb, muls(tan, inv_mb * lam));
  u.wb = add(u.wb, muls(ldf3(pf, np, 21), lam));

  av = add(u.va, cross(u.wa, rel_a));
  bv = add(u.vb, cross(u.wb, rel_b));
  float vn = dot(nrm, sub(bv, av));
  lam = -eff_n * (vn - bias);
  nw = fmaxf(imp_n + lam, 0.0f);
  lam = nw - imp_n;
  imp_n = nw;
  u.va = sub(u.va, muls(nrm, inv_ma * lam));
  u.wa = sub(u.wa, muls(ldf3(pf, np, 12), lam));
  u.vb = add(u.vb, muls(nrm, inv_mb * lam));
  u.wb = add(u.wb, muls(ldf3(pf, np, 15), lam));
  pf[28 * np] = imp_n;
  pf[29 * np] = imp_t;
}

// motor -> limit -> rotation -> position
DF void hinge_solve(const float* f, int nj, float inv_ma, float inv_mb, const float* ia,
                    const float* ib, Vel& u, float* imps) {
  V3 axis = ldf3(f, nj, 15), ml_a = ldf3(f, nj, 18), ml_b = ldf3(f, nj, 21);
  float eff_ax = f[39 * nj];
  float limit_imp = imps[0], motor_imp = imps[1];
  // motor
  float rel_w = dot(axis, u.wb) - dot(axis, u.wa);
  float cdot = rel_w - f[44 * nj];
  float lam = -eff_ax * cdot;
  float mx = f[45 * nj];
  float nw = clipf(motor_imp + lam, -mx, mx);
  bool on = f[41 * nj] > 0.5f;
  lam = on ? nw - motor_imp : 0.0f;
  motor_imp = on ? nw : motor_imp;
  u.wa = sub(u.wa, muls(ml_a, lam));
  u.wb = add(u.wb, muls(ml_b, lam));
  // limit
  float lsign = f[42 * nj];
  rel_w = lsign * (dot(axis, u.wb) - dot(axis, u.wa));
  cdot = rel_w + f[43 * nj];
  lam = -eff_ax * cdot;
  float imp = fmaxf(limit_imp + lam, 0.0f);
  on = f[40 * nj] > 0.5f;
  lam = on ? imp - limit_imp : 0.0f;
  limit_imp = on ? imp : limit_imp;
  lam = lam * lsign;
  u.wa = sub(u.wa, muls(ml_a, lam));
  u.wb = add(u.wb, muls(ml_b, lam));
  // rotation (2D)
  V3 bxa = ldf3(f, nj, 9), cxa = ldf3(f, nj, 12);
  V3 dw = sub(u.wb, u.wa);
  float c0 = dot(bxa, dw) + f[37 * nj];
  float c1 = dot(cxa, dw) + f[38 * nj];
  float l0, l1;
  solve_2x2(f[33 * nj], f[34 * nj], f[35 * nj], f[36 * nj], -c0, -c1, l0, l1);
  V3 rot_p = add(muls(bxa, l0), muls(cxa, l1));
  u.wa = sub(u.wa, matvec(ia, rot_p));
  u.wb = add(u.wb, matvec(ib, rot_p));
  // position (3D)
  point_impulse(f + 24 * nj, nj, ldf3(f, nj, 0), ldf3(f, nj, 3), ldf3(f, nj, 6), inv_ma,
                inv_mb, ia, ib, u);
  imps[0] = limit_imp;
  imps[1] = motor_imp;
}

// twist motor -> swing motor -> twist limit -> swing limit -> position
DF void cone_twist_solve(const float* f, int nj, float inv_ma, float inv_mb,
                         const float* ia, const float* ib, Vel& u, float* imps) {
  float swing_imp = imps[0], twist_imp = imps[1], sm_imp = imps[2], tm_imp = imps[3];
  V3 tw_axis = ldf3(f, nj, 18), tw_a = ldf3(f, nj, 21), tw_b = ldf3(f, nj, 24);
  float eff_tw = f[49 * nj];
  // twist motor
  float rel_w = dot(tw_axis, u.wb) - dot(tw_axis, u.wa);
  float cdot = rel_w - f[57 * nj];
  float lam = -eff_tw * cdot;
  float mx = f[58 * nj];
  float nw = clipf(tm_imp + lam, -mx, mx);
  bool on = f[56 * nj] > 0.5f;
  lam = on ? nw - tm_imp : 0.0f;
  tm_imp = on ? nw : tm_imp;
  u.wa = sub(u.wa, muls(tw_a, lam));
  u.wb = add(u.wb, muls(tw_b, lam));
  // swing motor
  V3 sm_axis = ldf3(f, nj, 27);
  rel_w = dot(sm_axis, u.wb) - dot(sm_axis, u.wa);
  cdot = rel_w - f[54 * nj];
  lam = -f[53 * nj] * cdot;
  mx = f[55 * nj];
  nw = clipf(sm_imp + lam, -mx, mx);
  on = f[52 * nj] > 0.5f;
  lam = on ? nw - sm_imp : 0.0f;
  sm_imp = on ? nw : sm_imp;
  u.wa = sub(u.wa, muls(ldf3(f, nj, 30), lam));
  u.wb = add(u.wb, muls(ldf3(f, nj, 33), lam));
  // twist limit
  float tsign = f[50 * nj];
  rel_w = tsign * (dot(tw_axis, u.wb) - dot(tw_axis, u.wa));
  cdot = rel_w + f[51 * nj];
  lam = -eff_tw * cdot;
  float imp = fmaxf(twist_imp + lam, 0.0f);
  on = f[48 * nj] > 0.5f;
  lam = on ? imp - twist_imp : 0.0f;
  twist_imp = on ? imp : twist_imp;
  lam = lam * tsign;
  u.wa = sub(u.wa, muls(tw_a, lam));
  u.wb = add(u.wb, muls(tw_b, lam));
  // swing limit (reversed signs)
  V3 sw_axis = ldf3(f, nj, 9);
  cdot = dot(sw_axis, u.wa) - dot(sw_axis, u.wb) + f[47 * nj];
  lam = -f[46 * nj] * cdot;
  imp = fmaxf(swing_imp + lam, 0.0f);
  on = f[45 * nj] > 0.5f;
  lam = on ? imp - swing_imp : 0.0f;
  swing_imp = on ? imp : swing_imp;
  u.wa = add(u.wa, muls(ldf3(f, nj, 12), lam));
  u.wb = sub(u.wb, muls(ldf3(f, nj, 15), lam));
  // position
  point_impulse(f + 36 * nj, nj, ldf3(f, nj, 0), ldf3(f, nj, 3), ldf3(f, nj, 6), inv_ma,
                inv_mb, ia, ib, u);
  imps[0] = swing_imp; imps[1] = twist_imp; imps[2] = sm_imp; imps[3] = tm_imp;
}

DF void ld_vel(const float* vw, int a, int b, Vel& u) {
  u.va = ld3(vw + 6 * a); u.wa = ld3(vw + 6 * a + 3);
  u.vb = ld3(vw + 6 * b); u.wb = ld3(vw + 6 * b + 3);
}
// 12 floats: (new - start) of va, wa, vb, wb
DF void st_delta(float* d, const Vel& u, const Vel& u0) {
  V3 x;
  x = sub(u.va, u0.va); d[0] = x.x; d[1] = x.y; d[2] = x.z;
  x = sub(u.wa, u0.wa); d[3] = x.x; d[4] = x.y; d[5] = x.z;
  x = sub(u.vb, u0.vb); d[6] = x.x; d[7] = x.y; d[8] = x.z;
  x = sub(u.wb, u0.wb); d[9] = x.x; d[10] = x.y; d[11] = x.z;
}

// The lanes that work on one env: `warps` whole warps of the block. Inside
// the iteration loop they meet only each other: __syncwarp for one warp, a
// named barrier (1 + team id; 0 is __syncthreads') for several.
struct Team {
  int id, warps, lane, size;
  DF void sync() const {
    if (warps == 1) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;" : : "r"(id + 1), "r"(32 * warps) : "memory");
    }
  }
};

// vw[6 n + c] += (sum over body n's entries, in list order, of
// delta[6 * ent[e] + c]) * (omega * scale[n]) for the `nbod` bodies listed in
// `bodies`, or for bodies 0..nbod-1 when `bodies` is null; a lane per body,
// its six components side by side
template <class Idx>
DF void apply_deltas(float* vw, const float* delta, const Idx* ptr, const Idx* ent,
                     const float* scale, float omega, const int* bodies, int nbod,
                     const Team& tm) {
  for (int i = tm.lane; i < nbod; i += tm.size) {
    int n = bodies ? bodies[i] : i;
    float s[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int e = ptr[n]; e < ptr[n + 1]; ++e) {
      const float* d = delta + 6 * (int)ent[e];
      #pragma unroll
      for (int c = 0; c < 6; ++c) s[c] = s[c] + d[c];
    }
    float f = omega * scale[n];
    #pragma unroll
    for (int c = 0; c < 6; ++c) vw[6 * n + c] = vw[6 * n + c] + s[c] * f;
  }
}

// one joint type: its joint count; offsets of its rows, accumulated impulses and
// controls (floats, in the env's shared rows / impulses and in its controls
// row); index of its first joint in the wiring and static tables; offsets of
// its incidence lists (itab) and inverse degrees (ftab); offset (itab) and
// count of the bodies its joints touch
struct JointDesc { int n, row, acc, ctl, base, ptr, idx, idg, tb, ntb; };

struct Dims {
  int B, nb, C, P, nphase, R1, npts, iters;
  int io[5];    // itab: rows, phase_rows, con_ptr, con_idx, jab
  int fo[3];    // ftab: col_r, row fric/rest, joint static
  JointDesc jd[NJT];   // in JOINT_ORDER
  int hull_col, hull_llen, hull_base;   // itab: collider -> hull id, loop lengths;
                                        // ftab: first hull block
  HullDims hd;                          // padded hull counts (0 without hulls)
  int envs, warps;                      // envs per block, warps per env
};

// One env's part of the block's shared memory, offsets in 4-byte words, each
// part 16-byte aligned (fused_step.py's FusedTables.shared_layout mirrors it).
// What the iteration loop reads and rewrites on every pass, and nothing whose
// size follows the point slots: body velocities, inverse inertias, joint rows, accumulated
// joint impulses, one joint pass's deltas, contact inverse degrees per phase
// slice, and the live lists built after the narrowphase: per phase the live
// pair rows in row order (lrow from lph[ph]) and per phase and body its live
// incidence entries in the static lists' order (lent from lptr), all u16,
// and the rows' live-point masks (u8).
struct EnvLayout { int vw, invI, jrow, jimp, jdelta, idg, lptr, lph, lrow, lent, rmask, words; };

__host__ __device__ inline int words16(int w) { return (w + 3) & ~3; }

__host__ __device__ inline EnvLayout env_layout(const Dims& D, int& nrow_f, int& nacc_f,
                                                int& nJmax) {
  nJmax = 1; nrow_f = 0; nacc_f = 0;
  for (int t = 0; t < NJT; ++t) {
    nJmax = D.jd[t].n > nJmax ? D.jd[t].n : nJmax;
    nrow_f += joint_rows(t) * D.jd[t].n;
    nacc_f += joint_accs(t) * D.jd[t].n;
  }
  EnvLayout L;
  int o = 0;
  L.vw = o;     o += words16(6 * D.nb);
  L.invI = o;   o += words16(9 * D.nb);
  L.jrow = o;   o += words16(nrow_f);
  L.jimp = o;   o += words16(nacc_f);
  L.jdelta = o; o += words16(12 * nJmax);
  L.idg = o;    o += words16(D.nphase * D.nb);
  L.lptr = o;   o += words16((D.nphase * (D.nb + 1) + 1) / 2);
  L.lph = o;    o += words16((D.nphase + 2) / 2);
  L.lrow = o;   o += words16((D.P + 1) / 2);
  L.lent = o;   o += words16(D.P);
  L.rmask = o;  o += words16((D.P + 3) / 4);
  L.words = o;
  return L;
}

// prep of joint j of type T
template <int T>
DF void joint_prep(const JointDesc& d, int j, const int* jab,
                   const float* jstat, const float* rot, const float* pos,
                   const float* invI, const float* invm, const float* ctl, float dt,
                   float inv_dt, float* jrow) {
  JointBodies bd;
  int a = jab[2 * (d.base + j)], b = jab[2 * (d.base + j) + 1];
  bd.qa = ld4(rot + 4 * a); bd.qb = ld4(rot + 4 * b);
  bd.pa = ld3(pos + 3 * a); bd.pb = ld3(pos + 3 * b);
  bd.ia = invI + 9 * a; bd.ib = invI + 9 * b;
  bd.inv_ma = invm[a]; bd.inv_mb = invm[b];
  const float* js = jstat + (d.base + j) * STATIC_WIDTH;
  const float* c = ctl + d.ctl + joint_ctls(T) * j;
  float* out = jrow + d.row + j;
  if (T == J_DISTANCE) distance_prep(js, bd, dt, inv_dt, out, d.n);
  if (T == J_BALL) ball_prep(js, bd, dt, inv_dt, out, d.n);
  if (T == J_FIXED) fixed_prep(js, bd, dt, inv_dt, out, d.n);
  if (T == J_HINGE) hinge_prep(js, c, bd, dt, inv_dt, out, d.n);
  if (T == J_CONE_TWIST) cone_twist_prep(js, c, bd, dt, inv_dt, out, d.n);
  if (T == J_SLIDER) slider_prep(js, c, bd, dt, inv_dt, out, d.n);
}

// one averaged pass over the joints of type T: the team's lanes solve its
// joints against the pass-start velocities and write their deltas; then the
// lanes apply the degree-averaged per-body sums to the bodies the type's
// joints touch. The plain version adds (+0) * scale to every other body,
// which turns a -0.0 into +0.0 and leaves any other value as it is; a value
// that is not -0.0 never becomes one through vw + s * f (s is a sum that
// starts at +0.0). So only the solve's first pass (`all`) needs every body.
template <int T>
DF void joint_pass(const JointDesc& d, const Team& tm, const int* jab, const int* itab,
                   const float* ftab, const float* jrow, float* jimp, float* jdelta,
                   float* vw, const float* invm, const float* invI, float omega,
                   bool& all, int nb) {
  if (d.n == 0) return;
  for (int j = tm.lane; j < d.n; j += tm.size) {
    int a = jab[2 * (d.base + j)], b = jab[2 * (d.base + j) + 1];
    Vel u0, u;
    ld_vel(vw, a, b, u0);
    u = u0;
    const float* f = jrow + d.row + j;
    float* imps = jimp + d.acc + joint_accs(T) * j;
    const float *ia = invI + 9 * a, *ib = invI + 9 * b;
    if (T == J_DISTANCE) distance_solve(f, d.n, invm[a], invm[b], u);
    if (T == J_BALL) ball_solve(f, d.n, invm[a], invm[b], ia, ib, u);
    if (T == J_FIXED) fixed_solve(f, d.n, invm[a], invm[b], ia, ib, u);
    if (T == J_HINGE) hinge_solve(f, d.n, invm[a], invm[b], ia, ib, u, imps);
    if (T == J_CONE_TWIST) cone_twist_solve(f, d.n, invm[a], invm[b], ia, ib, u, imps);
    if (T == J_SLIDER) slider_solve(f, d.n, invm[a], invm[b], ia, ib, u, imps);
    st_delta(jdelta + 12 * j, u, u0);
  }
  tm.sync();
  apply_deltas(vw, jdelta, itab + d.ptr, itab + d.idx, ftab + d.idg, omega,
               all ? nullptr : itab + d.tb, all ? nb : d.ntb, tm);
  all = false;
  tm.sync();
}

#if DXK_PREPPED_JOINTS
constexpr int PASSED_ROW = 15;     // fused_step.PASSED_ROW

DF void st_vel(float* vw, int a, int b, const Vel& u) {
  float* ra = vw + 6 * a;
  float* rb = vw + 6 * b;
  ra[0] = u.va.x; ra[1] = u.va.y; ra[2] = u.va.z;
  ra[3] = u.wa.x; ra[4] = u.wa.y; ra[5] = u.wa.z;
  rb[0] = u.vb.x; rb[1] = u.vb.y; rb[2] = u.vb.z;
  rb[3] = u.wb.x; rb[4] = u.wb.y; rb[5] = u.wb.z;
}

// one sequential pass over the joints of type T: each joint solves against the
// current velocities, and both bodies' rows are stored before the next joint
template <int T>
DF void joint_seq(const JointDesc& d, const int* jab, const float* jrow, float* jimp,
                  float* vw, const float* invm, const float* invI) {
  for (int j = 0; j < d.n; ++j) {
    int a = jab[2 * (d.base + j)], b = jab[2 * (d.base + j) + 1];
    Vel u;
    ld_vel(vw, a, b, u);
    const float* f = jrow + d.row + j;
    float* imps = jimp + d.acc + joint_accs(T) * j;
    const float *ia = invI + 9 * a, *ib = invI + 9 * b;
    if (T == J_DISTANCE) distance_solve(f, d.n, invm[a], invm[b], u);
    if (T == J_BALL) ball_solve(f, d.n, invm[a], invm[b], ia, ib, u);
    if (T == J_FIXED) fixed_solve(f, d.n, invm[a], invm[b], ia, ib, u);
    if (T == J_HINGE) hinge_solve(f, d.n, invm[a], invm[b], ia, ib, u, imps);
    if (T == J_CONE_TWIST) cone_twist_solve(f, d.n, invm[a], invm[b], ia, ib, u, imps);
    if (T == J_SLIDER) slider_solve(f, d.n, invm[a], invm[b], ia, ib, u, imps);
    st_vel(vw, a, b, u);
  }
}
#endif

}  // namespace

// At most 256 threads and at least two blocks per SM: caps the kernel at 128
// registers, 16 warps per SM. The register count is one number for the whole
// call graph, so without the cap the out-of-line hull recipes (163 registers)
// would set it for every scene.
__global__ void __launch_bounds__(256, 2) fused_step_kernel(
    Dims D, float omega, float inv_dt,
    const float* __restrict__ g_v, const float* __restrict__ g_w,
    const float* __restrict__ g_inv_mass, const float* __restrict__ g_inv_inertia,
    const float* __restrict__ g_pos, const float* __restrict__ g_rot,
    const float* __restrict__ g_ctl, const float* __restrict__ g_col_a,
    const float* __restrict__ g_col_b, const float* __restrict__ g_col_rot,
#if DXK_PREPPED_JOINTS
    const float* __restrict__ g_jrows, int sequential, int rows_passed,
    const float* __restrict__ g_crows, int crow_pts,
#endif
    const int* __restrict__ itab, const float* __restrict__ ftab,
    float* g_pts, float* g_rdelta, float* g_hull,
    float* __restrict__ o_v, float* __restrict__ o_w, float* __restrict__ o_imp,
    unsigned char* __restrict__ o_live) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  Team tm;
  tm.warps = D.warps;
  tm.size = 32 * D.warps;
  tm.id = tid / tm.size;
  tm.lane = tid - tm.id * tm.size;
  const int T = tm.size, tl = tm.lane;
  const int env = blockIdx.x * D.envs + tm.id;
  const int nb = D.nb, C = D.C, P = D.P, np = D.npts;

  const int* rows_i = itab + D.io[0];
  const int* phase_rows = itab + D.io[1];
  const int* con_ptr = itab + D.io[2];
  const int* con_idx = itab + D.io[3];
  const int* jab = itab + D.io[4];
  const int* hull_id = itab + D.hull_col;
  const int* hull_llen = itab + D.hull_llen;
  const float* col_r = ftab + D.fo[0];
  const float* rows_f = ftab + D.fo[1];
  const float* jstat = ftab + D.fo[2];
  int nrow_f, nacc_f, nJmax;
  const EnvLayout L = env_layout(D, nrow_f, nacc_f, nJmax);

  // ---- the block's one copy of the static inverse masses; the last block's
  // missing envs leave after it (no block-wide barrier follows) --------------
  float* invm = smem;
  for (int i = tid; i < nb; i += blockDim.x) invm[i] = g_inv_mass[i];
  __syncthreads();
  if (env >= D.B) return;

  // ---- the env's shared words, its device-memory scratch and inputs ---------
  float* es = smem + words16(nb) + tm.id * L.words;
  float* vw = es + L.vw;
  float* invI = es + L.invI;
  float* jrow = es + L.jrow;
  float* jimp = es + L.jimp;
  float* jdelta = es + L.jdelta;
  float* idg_con = es + L.idg;
  unsigned short* lptr = reinterpret_cast<unsigned short*>(es + L.lptr);
  unsigned short* lph = reinterpret_cast<unsigned short*>(es + L.lph);
  unsigned short* lrow = reinterpret_cast<unsigned short*>(es + L.lrow);
  unsigned short* lent = reinterpret_cast<unsigned short*>(es + L.lent);
  unsigned char* rmask = reinterpret_cast<unsigned char*>(es + L.rmask);
  float* pts = g_pts + (size_t)env * np * POINT_FIELDS;   // [slot][field]
  float* rdelta = g_rdelta + (size_t)env * P * 12;        // 12 per live row
  const float* pos = g_pos + (size_t)env * nb * 3;
  const float* rot = g_rot + (size_t)env * nb * 4;
  const float* cwa = g_col_a + (size_t)env * C * 3;
  const float* cwb = g_col_b + (size_t)env * C * 3;
  const float* cwq = g_col_rot + (size_t)env * C * 4;

  // ---- stage the env's velocities and inverse inertias ----------------------
  for (int i = tl; i < nb * 3; i += T) {
    int n = i / 3, c = i - 3 * n;
    vw[6 * n + c] = g_v[(size_t)env * nb * 3 + i];
    vw[6 * n + 3 + c] = g_w[(size_t)env * nb * 3 + i];
  }
  for (int i = tl; i < nb * 9; i += T) invI[i] = g_inv_inertia[(size_t)env * nb * 9 + i];
  for (int i = tl; i < nacc_f; i += T) jimp[i] = 0.0f;
#if DXK_PREPPED_JOINTS
  // joint rows prepared outside the kernel, already in the field-major layout
  // of jrow; the controls are then not read at all
  if (rows_passed)
    for (int i = tl; i < nrow_f; i += T) jrow[i] = g_jrows[(size_t)env * nrow_f + i];
#endif
  tm.sync();

  // ---- narrowphase + contact prep, then the joint prep, over the team's lanes;
  // only live points are written -----------------------------------------------
  for (int r = tl; r < P; r += T) {
    const int* ri = rows_i + r * ROW_INTS;
    int type = ri[0], K = ri[1], ca = ri[2], cb = ri[3], ba = ri[4], bb = ri[5];
    int slot0 = ri[6], stride = ri[7];
#if DXK_PREPPED_JOINTS
    // prep-passed contact points: the last crow_pts slots, fields 0-27 as
    // prepared, both accumulated impulses zero; point k is live where its
    // eff_n > 0
    if (type == PASSED_ROW) {
      const float* src = g_crows + (size_t)env * (POINT_FIELDS - 2) * crow_pts;
      int m = 0;
      for (int k = 0; k < K; ++k) {
        int s = slot0 + k * stride, i = s - (np - crow_pts);
        if (src[24 * crow_pts + i] > 0.0f) {
          m |= 1 << k;
          float* pf = pts + POINT_FIELDS * s;
          for (int f = 0; f < POINT_FIELDS - 2; ++f) pf[f] = src[f * crow_pts + i];
          pf[28] = 0.0f;
          pf[29] = 0.0f;
        }
      }
      rmask[r] = (unsigned char)m;
      o_live[(size_t)env * P + r] = (unsigned char)m;
      continue;
    }
#endif
    ColSide A = {cwa + 3 * ca, cwb + 3 * ca, cwq + 4 * ca};
    ColSide Bc = {cwa + 3 * cb, cwb + 3 * cb, cwq + 4 * cb};
    Manifold mf;
    mf.mask = 0;
    // the recipe of the row's shape pair (fused_step.CM_RECIPES)
    switch (type) {
      case 0:
        capsule_capsule(ld3(A.a3), ld3(A.b3), col_r[ca], ld3(Bc.a3), ld3(Bc.b3), col_r[cb],
                        mf);
        break;
      case 1:
        capsule_box(ld3(A.a3), ld3(A.b3), col_r[ca], ld3(Bc.a3), ld3(Bc.b3), ld4(Bc.q4), mf);
        break;
      case 2:
        box_box(ld3(A.a3), ld3(A.b3), ld4(A.q4), ld3(Bc.a3), ld3(Bc.b3), ld4(Bc.q4), mf);
        break;
      case 3:
        capsule_hull(ld3(A.a3), ld3(A.b3), col_r[ca], ld3(Bc.a3), ld4(Bc.q4),
                     ftab + D.hull_base + hb_size(D.hd) * hull_id[cb], D.hd, mf);
        break;
      case 4:
        box_hull(ld3(A.a3), ld3(A.b3), ld4(A.q4), ld3(Bc.a3), ld4(Bc.q4),
                 ftab + D.hull_base + hb_size(D.hd) * hull_id[cb],
                 hull_llen + D.hd.FU * hull_id[cb], D.hd,
                 hull_slice(g_hull, D.hd, env, P, T, tl), mf);
        break;
      // hull-hull stays the default case: with an explicit case 5 and an
      // empty default the settle kernel took 3 % longer on an H100
#if DXK_SHAPE_RECIPES
      case 6: case 7: case 8: case 9: case 10: case 11: case 12: case 13: case 14:
        shapes_row(type, ca, cb, A, Bc, col_r, hull_id, hull_llen, ftab + D.hull_base,
                   D.hd, hull_slice(g_hull, D.hd, env, P, T, tl), mf);
        break;
#endif
      default:
        hull_hull(ld3(A.a3), ld4(A.q4), ftab + D.hull_base + hb_size(D.hd) * hull_id[ca],
                  hull_llen + D.hd.FU * hull_id[ca], ld3(Bc.a3), ld4(Bc.q4),
                  ftab + D.hull_base + hb_size(D.hd) * hull_id[cb],
                  hull_llen + D.hd.FU * hull_id[cb], D.hd,
                  hull_slice(g_hull, D.hd, env, P, T, tl), mf);
    }
    rmask[r] = (unsigned char)mf.mask;
    o_live[(size_t)env * P + r] = (unsigned char)mf.mask;
    if (!mf.mask) continue;
    float fric = rows_f[2 * r], rest = rows_f[2 * r + 1];
    V3 pa = ld3(pos + 3 * ba), pb = ld3(pos + 3 * bb);
    Vel u0;
    ld_vel(vw, ba, bb, u0);
    for (int k = 0; k < K; ++k)
      if (mf.mask >> k & 1)
        prep_point(mf.pt[k], mf.dp[k], mf.n, pa, pb, u0.va, u0.wa, u0.vb, u0.wb,
                   invI + 9 * ba, invI + 9 * bb, invm[ba], invm[bb], fric, rest, inv_dt,
                   pts + POINT_FIELDS * (slot0 + k * stride), 1);
  }
#if DXK_PREPPED_JOINTS
  if (!rows_passed)
#endif
  {
    const float* ctl = g_ctl + (size_t)env * D.R1;
    float dt = ctl[D.R1 - 1];
#define DXK_PREP(JT)                                                                   \
  for (int j = tl; j < D.jd[JT].n; j += T)                                            \
    joint_prep<JT>(D.jd[JT], j, jab, jstat, rot, pos, invI, invm, ctl, dt, inv_dt, jrow);
    DXK_PREP(J_DISTANCE) DXK_PREP(J_BALL) DXK_PREP(J_FIXED)
    DXK_PREP(J_HINGE) DXK_PREP(J_CONE_TWIST) DXK_PREP(J_SLIDER)
#undef DXK_PREP
  }
  tm.sync();

  // ---- the live lists, by the team's first warp: per phase its live rows in
  // row order (ballot + popc), per phase and body its live incidence entries in
  // list order (a shuffle scan of the counts) and the contact inverse degree ---
  if (tl < 32) {
    const unsigned full = 0xffffffffu;
    const unsigned below = (1u << tl) - 1u;
    int cnt = 0;
    for (int ph = 0; ph < D.nphase; ++ph) {
      if (tl == 0) lph[ph] = (unsigned short)cnt;
      int r_end = phase_rows[ph + 1];
      for (int r0 = phase_rows[ph]; r0 < r_end; r0 += 32) {
        int r = r0 + tl;
        bool live = r < r_end && rmask[r] != 0;
        unsigned bits = __ballot_sync(full, live);
        if (live) lrow[cnt + __popc(bits & below)] = (unsigned short)r;
        cnt += __popc(bits);
      }
    }
    if (tl == 0) lph[D.nphase] = (unsigned short)cnt;
    int run = 0;
    for (int ph = 0; ph < D.nphase; ++ph) {
      unsigned short* lp = lptr + ph * (nb + 1);
      for (int n0 = 0; n0 < nb; n0 += 32) {
        int n = n0 + tl, c = 0, e0 = 0, e1 = 0;
        if (n < nb) {
          e0 = con_ptr[ph * nb + n];
          e1 = con_ptr[ph * nb + n + 1];
          for (int e = e0; e < e1; ++e) c += rmask[con_idx[e] >> 1] != 0;
        }
        int incl = c;
        for (int o = 1; o < 32; o <<= 1) {
          int x = __shfl_up_sync(full, incl, o);
          if (tl >= o) incl += x;
        }
        if (n < nb) {
          int p = run + incl - c;
          lp[n] = (unsigned short)p;
          idg_con[ph * nb + n] = 1.0f / fmaxf((float)c, 1.0f);
          for (int e = e0; e < e1; ++e)
            if (rmask[con_idx[e] >> 1]) lent[p++] = (unsigned short)con_idx[e];
        }
        run += __shfl_sync(full, incl, 31);
      }
      if (tl == 0) lp[nb] = (unsigned short)run;
    }
  }
  tm.sync();

  // ---- the solve ---------------------------------------------------------------
#if DXK_PREPPED_JOINTS
  // sequential: one lane of the team walks the chain; joints in JOINT_ORDER,
  // then the live rows in phase order with their live points in order (a dead
  // point's effective masses and friction are zero: solving it could change
  // no more than the sign of a zero)
  if (sequential) {
    if (tl == 0) {
      for (int it = 0; it < D.iters; ++it) {
        joint_seq<J_DISTANCE>(D.jd[J_DISTANCE], jab, jrow, jimp, vw, invm, invI);
        joint_seq<J_BALL>(D.jd[J_BALL], jab, jrow, jimp, vw, invm, invI);
        joint_seq<J_FIXED>(D.jd[J_FIXED], jab, jrow, jimp, vw, invm, invI);
        joint_seq<J_HINGE>(D.jd[J_HINGE], jab, jrow, jimp, vw, invm, invI);
        joint_seq<J_CONE_TWIST>(D.jd[J_CONE_TWIST], jab, jrow, jimp, vw, invm, invI);
        joint_seq<J_SLIDER>(D.jd[J_SLIDER], jab, jrow, jimp, vw, invm, invI);
        for (int i = 0; i < lph[D.nphase]; ++i) {
          int r = lrow[i], mask = rmask[r];
          const int* ri = rows_i + r * ROW_INTS;
          int K = ri[1], ba = ri[4], bb = ri[5], slot0 = ri[6], stride = ri[7];
          Vel u;
          ld_vel(vw, ba, bb, u);
          float inv_ma = invm[ba], inv_mb = invm[bb];
          for (int k = 0; k < K; ++k)
            if (mask >> k & 1)
            contact_point(pts + POINT_FIELDS * (slot0 + k * stride), 1, inv_ma, inv_mb, u);
          st_vel(vw, ba, bb, u);
        }
      }
    }
    tm.sync();
  }
  const int avg_iters = sequential ? 0 : D.iters;
#else
  const int avg_iters = D.iters;
#endif
  bool all = true;           // the first joint pass applies to every body
  for (int it = 0; it < avg_iters; ++it) {
    // joint passes in JOINT_ORDER; a type with no joints is skipped
#define DXK_PASS(JT)                                                                   \
  joint_pass<JT>(D.jd[JT], tm, jab, itab, ftab, jrow, jimp, jdelta, vw, invm, invI,    \
                 omega, all, nb);
    DXK_PASS(J_DISTANCE) DXK_PASS(J_BALL) DXK_PASS(J_FIXED)
    DXK_PASS(J_HINGE) DXK_PASS(J_CONE_TWIST) DXK_PASS(J_SLIDER)
#undef DXK_PASS
    // contact phase slices: every live row reads the slice-start velocities
    // and solves its live points in order; the summed deltas of the live rows
    // are degree-averaged (a dead row's delta is +0.0, and a sum that starts
    // at +0.0 is never -0.0, so leaving it out changes no bit)
    for (int ph = 0; ph < D.nphase; ++ph) {
      for (int i = lph[ph] + tl; i < lph[ph + 1]; i += T) {
        int r = lrow[i], mask = rmask[r];
        const int* ri = rows_i + r * ROW_INTS;
        int K = ri[1], ba = ri[4], bb = ri[5], slot0 = ri[6], stride = ri[7];
        Vel u0, u;
        ld_vel(vw, ba, bb, u0);
        u = u0;
        float inv_ma = invm[ba], inv_mb = invm[bb];
        for (int k = 0; k < K; ++k)
          if (mask >> k & 1)
            contact_point(pts + POINT_FIELDS * (slot0 + k * stride), 1, inv_ma, inv_mb, u);
        st_delta(rdelta + 12 * r, u, u0);
      }
      tm.sync();
      apply_deltas(vw, rdelta, lptr + ph * (nb + 1), lent, idg_con + ph * nb, omega,
                   nullptr, nb, tm);
      tm.sync();
    }
  }

  // ---- results: a dead point's impulse is 0 -----------------------------------
  for (int i = tl; i < nb * 3; i += T) {
    int n = i / 3, c = i - 3 * n;
    o_v[(size_t)env * nb * 3 + i] = vw[6 * n + c];
    o_w[(size_t)env * nb * 3 + i] = vw[6 * n + 3 + c];
  }
  for (int i = tl; i < P * 4; i += T) {
    int r = i >> 2, k = i & 3;
    const int* ri = rows_i + r * ROW_INTS;
    float v = 0.0f;
    if (k < ri[1] && (rmask[r] >> k & 1)) v = pts[POINT_FIELDS * (ri[6] + k * ri[7]) + 28];
    o_imp[(size_t)env * P * 4 + i] = v;
  }
}

// Launches ceil(B / envs) blocks of envs * warps warps on `stream`: `envs` envs
// a block, `warps` warps each (FusedTables.launch_plan). `pts` and `rdelta` are
// the wrapper's scratch, POINT_FIELDS x npts and P x 12 floats per env, read
// only where this launch wrote them; `hull` the hull scratch, min(P, 32 warps)
// x hull_lane_floats floats per env for hulls past the per-thread caps, null
// otherwise. Returns the CUDA error code of the launch
// (0 = success), cudaErrorInvalidValue when `smem_bytes` is not the layout's
// size (env_layout) or the plan does not fit a block; does not synchronise and
// allocates nothing. The prepped build's entry also takes the env's prepared
// joint rows (`jrows`, read when `rows_passed`; `ctl` is then not read), the
// `sequential` flag and the env's prep-passed contact points (`crows`,
// (POINT_FIELDS - 2) x `crow_pts` floats per env, field-major; none when
// `crow_pts` is 0).
#if DXK_PREPPED_JOINTS
extern "C" int dxk_fused_step_prepped_launch(
    const int* dims, float omega, float inv_dt,
    const void* v, const void* w, const void* inv_mass, const void* inv_inertia,
    const void* pos_cog, const void* rot, const void* ctl, const void* col_a,
    const void* col_b, const void* col_rot, const void* jrows, int sequential,
    int rows_passed, const void* crows, int crow_pts, const void* itab,
    const void* ftab, void* pts, void* rdelta, void* hull,
    void* v_out, void* w_out, void* imp_out, void* live_out,
    int envs, int warps, int smem_bytes, void* stream) {
#else
extern "C" int dxk_fused_step_launch(
    const int* dims, float omega, float inv_dt,
    const void* v, const void* w, const void* inv_mass, const void* inv_inertia,
    const void* pos_cog, const void* rot, const void* ctl, const void* col_a,
    const void* col_b, const void* col_rot, const void* itab, const void* ftab,
    void* pts, void* rdelta, void* hull, void* v_out, void* w_out, void* imp_out,
    void* live_out,
    int envs, int warps, int smem_bytes, void* stream) {
#endif
  Dims D;
  D.B = dims[0]; D.nb = dims[1]; D.C = dims[2]; D.P = dims[3]; D.nphase = dims[4];
  D.R1 = dims[5]; D.npts = dims[6]; D.iters = dims[7];
  for (int i = 0; i < 5; ++i) D.io[i] = dims[8 + i];
  for (int i = 0; i < 3; ++i) D.fo[i] = dims[13 + i];
  for (int t = 0; t < NJT; ++t) {
    const int* q = dims + 16 + 10 * t;
    JointDesc& d = D.jd[t];
    d.n = q[0]; d.row = q[1]; d.acc = q[2]; d.ctl = q[3];
    d.base = q[4]; d.ptr = q[5]; d.idx = q[6]; d.idg = q[7];
    d.tb = q[8]; d.ntb = q[9];
  }
  const int* h = dims + 16 + 10 * NJT;
  D.hull_col = h[0]; D.hull_llen = h[1]; D.hull_base = h[2];
  D.hd.V = h[3]; D.hd.F = h[4]; D.hd.FU = h[5]; D.hd.LM = h[6]; D.hd.EU = h[7];
  D.envs = envs; D.warps = warps;
  // hulls past the per-thread caps need the hull scratch, and only they
  const int hull_floats = hull_lane_floats(D.hd);
  if ((hull_floats > 0) != (hull != nullptr)) return (int)cudaErrorInvalidValue;
  // a scene with sphere or cylinder rows needs the library built with them
  if (h[8] != 0 && !DXK_SHAPE_RECIPES) return (int)cudaErrorInvalidValue;
  int nrow_f, nacc_f, nJmax;
  EnvLayout L = env_layout(D, nrow_f, nacc_f, nJmax);
  int threads = 32 * envs * warps;
  if (envs < 1 || warps < 1 || threads > 256 || (warps > 1 && envs > 15)
      || smem_bytes != 4 * (words16(D.nb) + envs * L.words) || 2 * D.P > 65535)
    return (int)cudaErrorInvalidValue;
  if (D.B <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      fused_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int grid = (D.B + envs - 1) / envs;
  fused_step_kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      D, omega, inv_dt,
      (const float*)v, (const float*)w, (const float*)inv_mass,
      (const float*)inv_inertia, (const float*)pos_cog, (const float*)rot,
      (const float*)ctl, (const float*)col_a, (const float*)col_b,
      (const float*)col_rot,
#if DXK_PREPPED_JOINTS
      (const float*)jrows, sequential, rows_passed, (const float*)crows, crow_pts,
#endif
      (const int*)itab, (const float*)ftab, (float*)pts, (float*)rdelta, (float*)hull,
      (float*)v_out, (float*)w_out, (float*)imp_out, (unsigned char*)live_out);
  return (int)cudaGetLastError();
}
