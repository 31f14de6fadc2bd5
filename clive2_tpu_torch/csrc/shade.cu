// One bounce of the subpath trace's shading, one thread a lane
// (clive2_tpu_torch/integrator/trace.py: shade_kernel; its plain version,
// shade_plain, is the tensor code this kernel mirrors):
//
//   shade_kernel  the hit's triangle row and material, the shading normal,
//                 the bounce's three uniforms (drawn here with threefry.cuh,
//                 as rng.cu's draws make them), the GGX half vector and the
//                 Fresnel lottery, the one bounce routine the material
//                 picks, the throughput, the pdfs and the store and continue
//                 rules; it writes vertex d of the subpath and the next ray.
//
// It replaces no TPU kernel: the JAX package's shading
// (clive2_tpu/integrator/trace.py) is jnp code that XLA fuses, with no
// Pallas kernel.  The port ran the same tensor code eagerly, 4,206 PyTorch
// launches and about 122 ms of device time a 1080p sample (PERF.md), each
// launch writing an [N, 3] or [N] temporary to device memory.
//
// What bounds it on the H100 is bytes.  A lane reads its ray's 11 fields
// (76 B), the hit (16 B), its active and camera flags and pending pdf
// (6 B) and the gathered triangle row (60 B), and writes vertex d's 11
// fields (76 B), the next ray's (76 B), the pending pdf and two flags
// (6 B): about 316 B, 1.31 GB a bounce of the merged 1080p wavefront
// (4,147,200 lanes), 0.39 ms at 3.35 TB/s, 2.35 ms a sample.  Its
// arithmetic, five threefry hashes (about 360 integer operations) and a
// few hundred FP32 operations a lane, is about 0.1 ms.  So the design
// keeps everything between those reads and writes in registers: one thread
// a lane, each field's loads and stores coalesced across a warp, the
// read-only tables (the triangle rows, the materials, the hits) through
// the read-only cache, and of the three bounce routines only the one the
// material picks computed (the plain version's torch.where returns the
// picked routine's values, so the bits are the same).  Divergence across
// material types costs little in a kernel bound by bytes.  Past depth 0
// the next ray is written over the current one, and a lane that does not
// continue writes nothing there.  Block size: kThreads.
//
// Arithmetic: every expression is the plain version's (integrator/trace.py,
// ops/bsdf.py, ops/sampling.py), in its order, as connect.cu's are (built
// with --fmad=false; v3.cuh).  A dot is v3.cuh's dot3 plus +0: PyTorch's
// reduce starts its sums at +0, so a dot of -0 products is +0 there.  A
// tensor divided by a Python float is a multiply by the float's reciprocal
// (x / PI is x * INV_PI); a Python float divided by a tensor is the
// tensor's reciprocal times the float (Tensor.__rtruediv__); x ** 2 is
// x * x.  torch.clamp keeps a NaN.  sqrtf, sinf, cosf, acosf and atanf are
// the functions PyTorch's elementwise kernels call.  torch.argmin takes a
// NaN as the least value and ties to the first axis.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "threefry.cuh"
#include "v3.cuh"

namespace {

// From ptxas's report (-Xptxas -v): 80 registers a thread in every
// instance, no spill; its 32-byte stack frame is sinf's and cosf's
// argument reduction for |x| past 105,615, which no angle here reaches.
// At 80 registers an SM's 64K hold 24 warps whatever the block size (3
// blocks of 256 threads or 6 of 128); 256 it is.
constexpr int kThreads = 256;

constexpr float kPi = 0x1.921fb6p+1f;           // ops/sampling.py:PI
constexpr float kTwoPi = 0x1.921fb6p+2f;        // 2.0 * PI
constexpr float kInvPi = 0x1.45f306p-2f;        // f32(1) / PI
constexpr float kFloor = 1e-30f;                // the clamps' and guards'

// A wavefront's 11 ray fields ([N, 3] vectors, [N] scalars), or vertex d's
// row of a subpath's [D, N, ...] fields.  Written past depth 0 over the
// fields they are read from, so never read through the read-only cache.
struct Rays {
  float* origin;
  float* direction;
  float* normal;
  float* color;
  float* c_imp;
  float* l_imp;
  float* tot;
  int* material;
  int* triangle;
  int* hit_light;
  int* hit_camera;
};

// The extension cast's answers, [N] each.
struct Hits {
  const int* i;
  const float* t;
  const float* u;
  const float* v;
};

// The scene's packed triangle rows (f32 [T, >= 15], rows `stride` floats
// apart; `vec`: 16-byte aligned rows, read as three float4 and three
// floats) and material table.
struct Tables {
  const float* packed;
  long long stride;
  long long rows;
  bool vec;
  const float* alpha;
  const float* ior;
  const int* type;
  const float* color;
  int mat_rows;
};

__device__ __forceinline__ V3 get3(const float* p, long long i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void put3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// ops/sampling.py:dot, as PyTorch's reduce returns it
__device__ __forceinline__ float dot(V3 a, V3 b) { return dot3(a, b) + 0.0f; }

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// torch.argmin's order: a NaN is the least value, the first NaN wins
__device__ __forceinline__ bool less_or_nan(float a, float b) {
  return (isnan(a) && !isnan(b)) || a < b;
}

// ops/sampling.py:orthonormal: the unit vector of the axis with the least
// |n| component (torch.argmin, ties to the first), projected orthogonal to
// n.
__device__ __forceinline__ void orthonormal(V3 n, V3& x, V3& y) {
  const float ax = fabsf(n.x), ay = fabsf(n.y), az = fabsf(n.z);
  int axis = 0;
  float least = ax;
  if (less_or_nan(ay, least)) {
    axis = 1;
    least = ay;
  }
  if (less_or_nan(az, least)) axis = 2;
  const V3 v = {axis == 0 ? 1.0f : 0.0f, axis == 1 ? 1.0f : 0.0f,
                axis == 2 ? 1.0f : 0.0f};
  x = normalize3(v - scale(n, dot(v, n)));
  y = normalize3(cross(n, x));
}

// ops/sampling.py:ggx_sample around n, whose frame is (x, y).
__device__ __forceinline__ V3 ggx_sample(V3 n, V3 x, V3 y, float r0,
                                         float r1, float alpha) {
  const float theta = kTwoPi * r0;
  const float phi =
      atanf(alpha * sqrtf(r1) / sqrtf(clamp_min(1.0f - r1, kFloor)));
  const float sp = sinf(phi), cp = cosf(phi);
  return normalize3(scale(x, sp * cosf(theta)) + scale(y, sp * sinf(theta)) +
                    scale(n, cp));
}

// ops/bsdf.py:fresnel
__device__ __forceinline__ float fresnel(V3 i, V3 m, float ni, float nt) {
  const float cos_i = fabsf(dot(i, m));
  const float eta = ni / nt;
  const float sin_t2 = eta * eta * (1.0f - cos_i * cos_i);
  const float cos_t = sqrtf(clamp_min(1.0f - sin_t2, 0.0f));
  const float r_par = (nt * cos_i - ni * cos_t) / (nt * cos_i + ni * cos_t);
  const float r_perp = (ni * cos_i - nt * cos_t) / (ni * cos_i + nt * cos_t);
  const float f = 0.5f * (r_par * r_par + r_perp * r_perp);
  return sin_t2 >= 1.0f ? 1.0f : f;
}

// ops/bsdf.py:ggx_d
__device__ __forceinline__ float ggx_d(V3 m, V3 n, float alpha) {
  const float a2 = alpha * alpha;
  const float c = dot(m, n);
  const float denom = c * c * (a2 - 1.0f) + 1.0f;
  const float d = a2 / (kPi * denom * denom);
  return alpha == 0.0f ? 1.0f : d;
}

// ops/bsdf.py:ggx_g1 and ggx_g
__device__ __forceinline__ float ggx_g1(V3 v, V3 m, float alpha) {
  const float mv = dot(m, v);
  const float sin2 = 1.0f - mv * mv;
  const float tan2 = sin2 / clamp_min(mv * mv, kFloor);
  return 1.0f / (1.0f + sqrtf(1.0f + alpha * alpha * tan2)) * 2.0f;
}
__device__ __forceinline__ float ggx_g(V3 i, V3 o, V3 m, V3 n, float alpha) {
  const float g = ggx_g1(i, m, alpha) * ggx_g1(o, m, alpha);
  const bool ok = dot(i, m) * dot(i, n) > 0.0f && dot(o, m) * dot(o, n) > 0.0f;
  return ok ? g : 0.0f;
}

// ops/bsdf.py:reflect_jacobian
__device__ __forceinline__ float reflect_jacobian(V3 m, V3 o) {
  return 1.0f / (4.0f * fabsf(dot(m, o)) + kFloor) * 1.0f;
}

// A bounce routine's (wo, f, c_p, l_p) in camera convention.
struct Bounce {
  V3 wo;
  float f, fwd, rev;
};

// ops/bsdf.py:diffuse_bounce (random_hemisphere_cosine in n's frame).
__device__ __forceinline__ Bounce diffuse_bounce(V3 wi, V3 n, V3 x, V3 y,
                                                 float r0, float r1) {
  const float theta = acosf(sqrtf(r0));
  const float phi = kTwoPi * r1;
  const float st = sinf(theta), ct = cosf(theta);
  const V3 wo = normalize3(scale(x, st * cosf(phi)) +
                           scale(y, st * sinf(phi)) + scale(n, ct));
  const float f = fabsf(dot(n, wo)) * kInvPi;
  return {wo, f, f, fabsf(dot(n, wi)) * kInvPi};
}

// ops/bsdf.py:reflect_bounce; fres = fresnel(wi, m, ni, no), d =
// ggx_d(m, n, alpha).
__device__ __forceinline__ Bounce reflect_bounce(V3 wi, V3 n, V3 m,
                                                 float alpha, float fres,
                                                 float d) {
  const V3 wo = normalize3(scale(m, dot(wi, m) * 2.0f) - wi);
  const float g = ggx_g(wi, wo, m, n, alpha);
  const float f = d * g * fres / (4.0f * fabsf(dot(wi, m)) + kFloor);
  const float k = fres * (fabsf(dot(m, n)) * d);
  return {wo, f, k * reflect_jacobian(m, wo), k * reflect_jacobian(m, wi)};
}

// ops/bsdf.py:transmit_bounce (ggx_transmit_direction, ggx_brdf_transmit,
// transmit_jacobian); fres and d as reflect_bounce's.  transmit_jacobian's
// half vector is the BTDF's h both ways round (its two terms add the other
// way round for (wo, wi), which is the same sum), so its cosines are im and
// om, swapped for the reverse pdf.
template <bool kReference>
__device__ __forceinline__ Bounce transmit_bounce(V3 wi, V3 n, V3 m,
                                                  float ni, float no,
                                                  float alpha, float fres,
                                                  float d) {
  const float cos_i = dot(wi, m);
  const float eta = ni / no;
  const float cos_t =
      sqrtf(clamp_min(1.0f + eta * eta * (cos_i * cos_i - 1.0f), 0.0f));
  const V3 wo = normalize3(scale(m, eta * cos_i - cos_t) - scale(wi, eta));
  const V3 h = normalize3(scale(wo, no) + scale(wi, ni));
  const float g = ggx_g(wi, wo, m, n, alpha);
  const float im = dot(wi, h), om = dot(wo, h);
  const float i_n = dot(wi, n), o_n = dot(wo, n);
  const float coeff =
      im * om / (fabsf(i_n * o_n) > kFloor ? i_n * o_n : kFloor);
  const float num = no * no * d * g * (1.0f - fres);
  const float s = ni * im + no * om;
  const float den = clamp_min(s * s, kFloor);
  float f = coeff * num / den;
  if (!kReference) f = f * fabsf(dot(wo, n));
  const float k = (1.0f - fres) * (fabsf(dot(m, n)) * d);
  return {wo, f, k * (no * no * fabsf(om) / den),
          k * (ni * ni * fabsf(im) / den)};
}

// A uniform of the draw under key (k0, k1) at a counter (rng.cu's).
__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            uint64_t c) {
  return clive2::bits_to_uniform(clive2::threefry_bits(k0, k1, c));
}

// kRows: lane i draws row rows[i] of the depth's draws (else row i).
// kEmitCos: depth 0 of the corrected estimator (the light lanes' first
// throughput carries the emitter's cosine).
// One launch's arguments (clive2_trace_shade's): the current rays, the
// next rays (the same pointers past depth 0), vertex d's row; the cast's
// hits; active and the pending pdfs (read and written), stored (written);
// from_camera, fc_stride 0 or 1 lanes apart; the depth's three keys
// (int64 [3, 2]); rows (int64 [n]) or null; n lanes; the scene's tables.
struct Launch {
  Rays cur, next, vert;
  Hits hit;
  bool* active;
  float* pending;
  bool* store;
  const bool* from_camera;
  long long fc_stride;
  const long long* keys;
  const long long* rows;
  long long n;
  Tables tab;
};

template <bool kRows, bool kReference, bool kEmitCos>
__global__ void __launch_bounds__(kThreads) shade_kernel(const Launch a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const Rays cur = a.cur, next = a.next, vert = a.vert;
  const Hits hit = a.hit;
  const Tables tab = a.tab;

  // the ray, written out unchanged as vertex d
  const V3 o = get3(cur.origin, i);
  const V3 d = get3(cur.direction, i);
  const V3 n_in = get3(cur.normal, i);
  const V3 col = get3(cur.color, i);
  const float c_in = cur.c_imp[i], l_in = cur.l_imp[i], tot = cur.tot[i];
  const int mat_in = cur.material[i], tri_in = cur.triangle[i];
  const int hl_in = cur.hit_light[i], hc_in = cur.hit_camera[i];
  const bool act = a.active[i];
  const float pend = a.pending[i];
  const bool fc = a.from_camera[i * a.fc_stride];
  const bool copy = next.origin != cur.origin;
  put3(vert.origin, i, o);
  put3(vert.direction, i, d);
  put3(vert.normal, i, n_in);
  put3(vert.color, i, col);
  vert.tot[i] = tot;
  vert.material[i] = mat_in;
  vert.triangle[i] = tri_in;
  vert.hit_light[i] = hl_in;
  vert.hit_camera[i] = hc_in;

  // the hit's triangle row (row clamp(i, min=0)) and material
  const int hi = __ldg(hit.i + i);
  const float ht = __ldg(hit.t + i), hu = __ldg(hit.u + i),
              hv = __ldg(hit.v + i);
  const int safe = hi < 0 ? 0 : hi;
  float row[15];
#pragma unroll
  for (int k = 0; k < 15; ++k) row[k] = 0.0f;
  if (safe < tab.rows) {
    const float* p = tab.packed + (long long)safe * tab.stride;
    if (tab.vec) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(p) + q);
        row[4 * q] = w.x;
        row[4 * q + 1] = w.y;
        row[4 * q + 2] = w.z;
        row[4 * q + 3] = w.w;
      }
#pragma unroll
      for (int k = 12; k < 15; ++k) row[k] = __ldg(p + k);
    } else {
#pragma unroll
      for (int k = 0; k < 15; ++k) row[k] = __ldg(p + k);
    }
  }
  const V3 face_n = {row[0], row[1], row[2]};
  const V3 n0 = {row[3], row[4], row[5]};
  const V3 n1 = {row[6], row[7], row[8]};
  const V3 n2 = {row[9], row[10], row[11]};
  const int tri_mat = (int)row[12];
  const int is_light = (int)row[13];
  const int is_camera = (int)row[14];
  const bool in_table = tri_mat >= 0 && tri_mat < tab.mat_rows;
  const float alpha = in_table ? __ldg(tab.alpha + tri_mat) : 0.0f;
  const float ior = in_table ? __ldg(tab.ior + tri_mat) : 0.0f;
  const int mat_type = in_table ? __ldg(tab.type + tri_mat) : 0;
  const V3 mat_color = table_row(tab.color, tri_mat, tab.mat_rows);

  // the shading frame
  const V3 wi = -d;
  const float cos_f = dot(wi, face_n);
  const bool front = cos_f > 0.0f;
  const bool degenerate = cos_f == 0.0f;
  const float w = 1.0f - hu - hv;
  const V3 sampled_n =
      normalize3(scale(n0, w) + scale(n1, hu) + scale(n2, hv));
  const V3 nrm = front ? sampled_n : -sampled_n;
  const float ni = front ? 1.0f : ior;
  const float no = front ? ior : 1.0f;
  const V3 new_origin = along(o, ht, d);
  const int new_hit_light =
      is_light != 0 && dot(d, face_n) < 0.0f ? hi : -1;
  const int new_hit_camera = is_camera != 0 ? hi : -1;

  // roll_a, roll_b (two values a lane) and roll_c (one) under the depth's
  // three keys: lane i's value j has the counter row * inner + j
  const uint64_t r = kRows ? (uint64_t)__ldg(a.rows + i) : (uint64_t)i;
  uint32_t k[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) k[q] = (uint32_t)__ldg(a.keys + q);
  const float a0 = uniform_at(k[0], k[1], 2 * r);
  const float a1 = uniform_at(k[0], k[1], 2 * r + 1);
  const float b0 = uniform_at(k[2], k[3], 2 * r);
  const float b1 = uniform_at(k[2], k[3], 2 * r + 1);
  const float roll_c = uniform_at(k[4], k[5], r);

  V3 x, y;
  orthonormal(nrm, x, y);
  const V3 m = ggx_sample(nrm, x, y, a0, a1, alpha);
  const bool ok_m = dot(wi, m) >= 0.0f && dot(m, nrm) >= 0.0f;
  const float fres = fresnel(wi, m, ni, no);

  // trace.py:_select_bounce's pick: type 0 diffuse; 1 reflect | transmit,
  // 2 reflect | diffuse by the Fresnel lottery; any other reflect
  const bool take_reflect = roll_c <= fres;
  const bool diffuse = mat_type == 0 || (mat_type == 2 && !take_reflect);
  const bool transmit = mat_type == 1 && !take_reflect;
  Bounce b;
  if (diffuse) {
    b = diffuse_bounce(wi, nrm, x, y, b0, b1);
  } else {
    const float dm = ggx_d(m, nrm, alpha);
    b = transmit ? transmit_bounce<kReference>(wi, nrm, m, ni, no, alpha,
                                               fres, dm)
                 : reflect_bounce(wi, nrm, m, alpha, fres, dm);
  }
  const float c_p = fc ? b.fwd : b.rev;
  const float l_p = fc ? b.rev : b.fwd;

  // throughput: the material's color only on external reflection / egress
  const float wo_fn = dot(b.wo, face_n);
  const bool apply_color =
      (cos_f > 0.0f && wo_fn > 0.0f) || (cos_f < 0.0f && wo_fn > 0.0f);
  V3 new_color = scale(col, b.f);
  if (apply_color) new_color = new_color * mat_color;
  if (kEmitCos && !fc) new_color = scale(new_color, fabsf(dot(d, n_in)));

  // the reference stores a vertex only when its bounce succeeded too; the
  // corrected estimator stores on the hit alone, continues on the bounce
  const bool bounce_ok = ok_m && b.f != 0.0f;
  const bool hit_ok = act && hi >= 0 && !degenerate;
  const bool valid = hit_ok && bounce_ok;
  const bool stored = kReference ? valid : hit_ok;
  vert.l_imp[i] = fc ? l_p : l_in;
  vert.c_imp[i] = fc ? c_in : c_p;
  a.store[i] = stored;
  a.active[i] = valid;
  if (valid) {
    put3(next.origin, i, new_origin);
    put3(next.direction, i, b.wo);
    put3(next.normal, i, nrm);
    put3(next.color, i, new_color);
    next.c_imp[i] = fc ? pend : 1.0f;
    next.l_imp[i] = fc ? 1.0f : pend;
    next.tot[i] = tot * pend;
    next.material[i] = tri_mat;
    next.triangle[i] = hi;
    next.hit_light[i] = new_hit_light;
    next.hit_camera[i] = new_hit_camera;
    a.pending[i] = fc ? c_p : l_p;
  } else if (copy) {
    put3(next.origin, i, o);
    put3(next.direction, i, d);
    put3(next.normal, i, n_in);
    put3(next.color, i, col);
    next.c_imp[i] = c_in;
    next.l_imp[i] = l_in;
    next.tot[i] = tot;
    next.material[i] = mat_in;
    next.triangle[i] = tri_in;
    next.hit_light[i] = hl_in;
    next.hit_camera[i] = hc_in;
  }
}

template <bool kRows, bool kReference, bool kEmitCos>
cudaError_t launch(const Launch& a, cudaStream_t s) {
  const unsigned blocks = (unsigned)((a.n + kThreads - 1) / kThreads);
  shade_kernel<kRows, kReference, kEmitCos><<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

// The instance of the estimator and the depth (the emitter's cosine is the
// corrected estimator's, at depth 0).
template <bool kRows>
cudaError_t launch_estimator(const Launch& a, int reference, int depth,
                             cudaStream_t s) {
  if (reference) return launch<kRows, true, false>(a, s);
  if (depth == 0) return launch<kRows, false, true>(a, s);
  return launch<kRows, false, false>(a, s);
}

}  // namespace

// One bounce at depth `depth` of n lanes: the fields of Launch in its
// order (the rays' 11 fields each: origin, direction, normal, color,
// c_importance, l_importance, tot_importance, material, triangle,
// hit_light, hit_camera), the packed triangle rows (row stride, row count),
// the material table (alpha, ior, type, color, row count), the estimator.
extern "C" int clive2_trace_shade(
    float* origin, float* direction, float* normal, float* color,
    float* c_imp, float* l_imp, float* tot, int* material, int* triangle,
    int* hit_light, int* hit_camera, float* next_origin,
    float* next_direction, float* next_normal, float* next_color,
    float* next_c_imp, float* next_l_imp, float* next_tot,
    int* next_material, int* next_triangle, int* next_hit_light,
    int* next_hit_camera, float* vert_origin, float* vert_direction,
    float* vert_normal, float* vert_color, float* vert_c_imp,
    float* vert_l_imp, float* vert_tot, int* vert_material,
    int* vert_triangle, int* vert_hit_light, int* vert_hit_camera,
    const int* hit_i, const float* hit_t, const float* hit_u,
    const float* hit_v, bool* active, float* pending, bool* store,
    const bool* from_camera, long long fc_stride, const long long* keys,
    const long long* rows, long long n, int depth, const float* packed,
    long long packed_stride, long long packed_rows, const float* alpha,
    const float* ior, const int* type, const float* mat_color, int mat_rows,
    int reference, void* stream) {
  if (n < 0 || depth < 0 || (fc_stride != 0 && fc_stride != 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const Rays cur{origin, direction, normal,   color,    c_imp,     l_imp,
                 tot,    material,  triangle, hit_light, hit_camera};
  const Rays next{next_origin,    next_direction, next_normal,
                  next_color,     next_c_imp,     next_l_imp,
                  next_tot,       next_material,  next_triangle,
                  next_hit_light, next_hit_camera};
  const Rays vert{vert_origin,    vert_direction, vert_normal,
                  vert_color,     vert_c_imp,     vert_l_imp,
                  vert_tot,       vert_material,  vert_triangle,
                  vert_hit_light, vert_hit_camera};
  const Tables tab{packed, packed_stride, packed_rows,
                   packed_stride % 4 == 0 && (uintptr_t)packed % 16 == 0,
                   alpha, ior, type, mat_color, mat_rows};
  const Launch a{cur,         next,      vert,  {hit_i, hit_t, hit_u, hit_v},
                 active,      pending,   store, from_camera,
                 fc_stride,   keys,      rows,  n,
                 tab};
  cudaStream_t s = (cudaStream_t)stream;
  if (rows == nullptr)
    return (int)launch_estimator<false>(a, reference, depth, s);
  return (int)launch_estimator<true>(a, reference, depth, s);
}
