// The BDPT connection's two kernels, one each side of its cast
// (clive2_tpu_torch/integrator/connect.py):
//
//   connect_rays_kernel   stage A: the [P, N] connection rays of the (t, s)
//                         strategies that need a cast (connection_rays);
//   connect_shade_kernel  stage B: every strategy's MIS weight and
//                         contribution from the cast's answers, the t = 1
//                         splats added into the light image (shade).
//
// They replace no TPU kernel: the JAX package's connection
// (clive2_tpu/integrator/connect.py) is jnp code that XLA fuses, with no
// Pallas kernel.  The port ran the same tensor code eagerly, some 8,400
// PyTorch launches a 1080p sample (about 100 at stage A, about 200 a
// strategy at stage B), each of them writing [P, N, 3] or [N] temporaries
// to device memory; the plain versions beside the wrappers
// (connection_rays_plain, shade_plain) are that code.
//
// What bounds them on the H100 is bytes.  A lane reads its 12 subpath
// vertices once (about 864 B over the fields each stage needs) and its
// 36 cast answers (288 B), and writes 16 B, plus its t = 1 splats as
// atomics into the [H*W] light image: about 2.5 GB a 1080p sample for
// stage B, 0.75 ms at 3.35 TB/s.  Stage A reads about 0.7 GB of vertices
// and writes its 2.2 GB of rays (origin, direction, t_max, active): 0.9 ms.
// The design keeps everything between those reads and writes out of device
// memory: one thread a lane; stage A loads its lane's vertices once into
// registers and unrolls every (t, s) at compile time, writing the row of
// each pair the caller lists, a pair's stores coalesced across the lanes
// of a warp; stage B computes the per-path MIS terms of
// connect.py:precompute_mis once a lane (cosines, squared edge lengths,
// specular flags, stored importances) and unrolls the 41 strategies and
// their MIS chains at compile time (templates over t and s), so that every
// vertex index is static and the chains stay in registers.
//
// Arithmetic: every expression is the plain version's, in its order, and
// the library is built with --fmad=false, so multiplies and adds round
// apart as PyTorch's elementwise kernels do; a 3-term dot (v3.cuh's
// dot3) is (x*x' + z*z') + y*y', the order in which PyTorch's reduce sums
// (a * b).sum(-1) over three floats on the card (measured on every row
// alignment, PyTorch 2.11 on the H100), so a dot here is the plain
// version's bit for bit.  A tensor divided by a Python float on the card is
// a multiply by the float's reciprocal (PyTorch's div by a CPU scalar), so
// x / PI here is x * INV_PI.  Table rows outside [0, M) read as zero, as
// ops/gather.py:gather_rows does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "common.cuh"
#include "v3.cuh"

namespace {

constexpr int kMaxDepth = 6;                    // constants.MAX_BOUNCES
constexpr int kMaxPairs = kMaxDepth * kMaxDepth;
// Block sizes from ptxas's report (-Xptxas -v): stage A takes 112
// registers a thread, stage B 104-110, neither spills nor keeps a stack
// frame.  At those counts an SM's 64K registers hold 16 warps either way
// (4 blocks of 128 threads or 2 of 256); stage B takes 128, so that its
// last wave of blocks leaves fewer SMs idle.
constexpr int kRaysThreads = 256;
constexpr int kShadeThreads = 128;

constexpr float kInvPi = 0x1.45f306p-2f;        // ops/sampling.py:INV_PI
constexpr float kInv2Pi = 0x1.45f306p-3f;       // INV_2PI
constexpr float kBelow = 0x1.ff7ceep-1f;        // f32(1.0 - 1e-3)
constexpr float kBeyond = 0x1.00418ap+0f;       // f32(1.001)
constexpr float kTiny = 1e-38f;                 // denominator floor

// torch.where(d.abs() > 1e-38, d, 1e-38)
__device__ __forceinline__ float guard(float d) {
  return fabsf(d) > kTiny ? d : kTiny;
}
// connect.py:specular: the material's type > 0, false outside the table
__device__ __forceinline__ bool specular(const int* __restrict__ type, int m,
                                         int rows) {
  return m >= 0 && m < rows && __ldg(type + m) > 0;
}

// Calls f(std::integral_constant<int, I>) for I = 0 .. N-1, so that every
// index the body derives from I is a constant.
template <class F, int... I>
__device__ __forceinline__ void static_for_impl(
    F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// The camera's device tensors (scene["camera"]).
struct Camera {
  const float* center;
  const float* focal;
  const float* dir;
  const float* dx;
  const float* dy;
  const float* phys_w;
  const float* phys_h;
};

__device__ __forceinline__ V3 cam3(const float* __restrict__ p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

// ---- stage A ---------------------------------------------------------------

// The fields of one subpath that stage A reads: [D, N, 3] and [D, N], each
// depth row contiguous, depth d of lane i at d * stride + i.
struct RayPath {
  const float* origin;
  const float* normal;
  const int* material;
  long long stride;
};

// Where each strategy's rays go: row[t-1][s-1] is the pair's index in
// cast order, -1 for a pair not cast.  Copied into the launch's parameters.
struct PairRows {
  signed char row[kMaxDepth][kMaxDepth];
};

template <bool kAnyHit>
__global__ void __launch_bounds__(kRaysThreads) connect_rays_kernel(
    RayPath C, RayPath L, const int* __restrict__ cam_len,
    const int* __restrict__ light_len, long long n, int depth,
    const int* __restrict__ mat_type, int n_mat, Camera cam, PairRows pairs,
    float* __restrict__ origin, float* __restrict__ direction,
    bool* __restrict__ active, float* __restrict__ t_max) {
  const long long i = (long long)blockIdx.x * kRaysThreads + threadIdx.x;
  if (i >= n) return;
  V3 co[kMaxDepth], cn[kMaxDepth], lo[kMaxDepth], ln[kMaxDepth];
  bool cs[kMaxDepth], ls[kMaxDepth];
#pragma unroll
  for (int d = 0; d < kMaxDepth; ++d) {
    co[d] = cn[d] = lo[d] = ln[d] = V3{0.0f, 0.0f, 0.0f};
    cs[d] = ls[d] = false;
    if (d < depth) {
      co[d] = load3(C.origin, d * C.stride + i);
      cn[d] = load3(C.normal, d * C.stride + i);
      cs[d] = specular(mat_type, __ldg(C.material + d * C.stride + i), n_mat);
      lo[d] = load3(L.origin, d * L.stride + i);
      ln[d] = load3(L.normal, d * L.stride + i);
      ls[d] = specular(mat_type, __ldg(L.material + d * L.stride + i), n_mat);
    }
  }
  const int clen = __ldg(cam_len + i);
  const int llen = __ldg(light_len + i);
  const V3 focal = cam3(cam.focal);
  const V3 cdir = cam3(cam.dir);
  const V3 center = cam3(cam.center);

  // every (t, s) at compile time, so that the vertices are registers
  static_for<kMaxDepth>([&](auto tt) {
    constexpr int t = decltype(tt)::value + 1;
    static_for<kMaxDepth>([&](auto ss) {
      constexpr int s = decltype(ss)::value + 1;
      const int p = pairs.row[t - 1][s - 1];
      if (p < 0) return;
      const V3 lvo = lo[s - 1];
      const bool lens_ok = t <= clen && s <= llen;
      bool ok;
      V3 dir;
      float cap;
      if constexpr (t == 1) {
        const V3 proj = normalize3(focal - lvo);
        const float den = dot3(proj, cdir);
        ok = !ls[s - 1] && den <= 0.0f;
        dir = proj;
        const float num = dot3(center - lvo, cdir);
        cap = den < -1e-12f ? num / den : INFINITY;
      } else {
        const V3 delta = co[t - 1] - lvo;
        dir = normalize3(delta);
        // dot(cv_n, -dir) is -dot(cv_n, dir) exactly
        ok = !ls[s - 1] && !cs[t - 1] && dot3(ln[s - 1], dir) >= kDelta &&
             -dot3(cn[t - 1], dir) >= kDelta;
        cap = sqrtf(clamp_min(dot3(delta, delta), 0.0f));
      }
      const long long q = (long long)p * n + i;
      origin[3 * q] = lvo.x;
      origin[3 * q + 1] = lvo.y;
      origin[3 * q + 2] = lvo.z;
      direction[3 * q] = dir.x;
      direction[3 * q + 1] = dir.y;
      direction[3 * q + 2] = dir.z;
      active[q] = lens_ok && ok;
      // any-hit: strictly below the target; closest-hit: just beyond it
      t_max[q] = kAnyHit ? cap * kBelow : cap * kBeyond + 1e-4f;
    });
  });
}

// ---- stage B ---------------------------------------------------------------

// The fields of one subpath that stage B reads (layout as RayPath).
struct ShadePath {
  const float* origin;
  const float* direction;
  const float* normal;
  const float* color;
  const float* c_imp;
  const float* l_imp;
  const float* tot;
  const int* material;
  const int* triangle;
  const int* hit_light;   // camera subpath only
  long long stride;
};

struct Materials {
  const int* type;
  const float* color;
  const float* emission;
  int rows;
};

// connect.py:precompute_mis of one lane's subpath: w (cosine against the
// stored direction), in_cos (against the incoming edge), D (squared edge
// lengths), l and c (stored importances), spec.
struct Terms {
  float w[kMaxDepth], in_cos[kMaxDepth], D[kMaxDepth], l[kMaxDepth],
      c[kMaxDepth];
  bool spec[kMaxDepth];
};

__device__ __forceinline__ void load_terms(Terms& T, const ShadePath& P,
                                           const Materials& mat, long long i,
                                           int depth) {
  V3 prev_dir{0.0f, 0.0f, 0.0f}, prev_o{0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int d = 0; d < kMaxDepth; ++d) {
    T.w[d] = T.in_cos[d] = T.D[d] = T.l[d] = T.c[d] = 0.0f;
    T.spec[d] = false;
    if (d < depth) {
      const long long r = d * P.stride + i;
      const V3 o = load3(P.origin, r);
      const V3 dir = load3(P.direction, r);
      const V3 nrm = load3(P.normal, r);
      T.w[d] = fabsf(dot3(dir, nrm));
      T.in_cos[d] = d == 0 ? T.w[0] : fabsf(dot3(prev_dir, nrm));
      if (d > 0) {
        const V3 e = o - prev_o;
        T.D[d - 1] = clamp_min(dot3(e, e), kTiny2);
      }
      T.l[d] = __ldg(P.l_imp + r);
      T.c[d] = __ldg(P.c_imp + r);
      T.spec[d] = specular(mat.type, __ldg(P.material + r), mat.rows);
      prev_dir = dir;
      prev_o = o;
    }
  }
}

// What a strategy knows of its junction (connect.py's keyword arguments of
// the weights).
struct Junction {
  float Dx;           // squared junction distance
  float jcos_l;       // |cos| of the junction edge at the light junction
  float jcos_c;       // ... at the camera junction (t = 1: the sensor)
  float l0_override;  // s = 0: the light-area pdf
  float t1_cam_c;     // t = 1: the sensor's c_importance
  float w_synth;      // t = 1, reference: the synthetic vertex's cosine
  bool spec_synth;    // t = 1: the sensor material is specular
};

// connect.py:_balance.
template <int K, int S>
__device__ __forceinline__ float balance(float p_s, const float (&r)[K],
                                         const bool (&spec)[K], bool& ok) {
  float p[K + 1];
  p[S] = p_s;
  static_for<K - S>([&](auto j) {
    constexpr int i = S + decltype(j)::value;
    p[i + 1] = p[i] * r[i];
  });
  static_for<S>([&](auto j) {
    constexpr int i = S - 1 - decltype(j)::value;
    p[i] = p[i + 1] / guard(r[i]);
  });
  static_for<K>([&](auto j) {
    constexpr int i = decltype(j)::value;
    if (spec[i]) {
      p[i] = 0.0f;
      p[i + 1] = 0.0f;
    }
  });
  p[K] = 0.0f;
  float total = p[0];
  static_for<K>([&](auto j) {
    constexpr int i = decltype(j)::value + 1;
    total = total + p[i];
  });
  ok = p[S] > 0.0f && total > 0.0f;
  return ok ? p[S] / (total > 0.0f ? total : 1.0f) : 0.0f;
}

// connect.py:_mis_weight_correct for strategy (T, S), term for term:
// vertex i counts from the light end, x_i = light[i] for i < S, else
// camera[T + S - 1 - i].
template <int T, int S>
__device__ __forceinline__ float mis_correct(const Terms& L, const Terms& C,
                                             float p_s, const Junction& j,
                                             bool& ok) {
  constexpr int K = T + S;
  auto vert_l = [&](auto ii) -> float {
    constexpr int i = decltype(ii)::value;
    if constexpr (i == 0 && S == 0) return j.l0_override;
    else if constexpr (i == 1) return kInv2Pi;
    else if constexpr (i == S && S >= 1) return j.jcos_l * kInvPi;
    else if constexpr (i < S) return L.l[i];
    else return C.l[T + S - 1 - i];
  };
  auto vert_c = [&](auto ii) -> float {
    constexpr int i = decltype(ii)::value;
    if constexpr (S >= 1 && i == S - 1) {
      if constexpr (T == 1) return j.t1_cam_c;
      else return j.jcos_c * kInvPi;
    } else if constexpr (i < S) {
      return L.c[i];
    } else {
      return C.c[T + S - 1 - i];
    }
  };
  auto cos_light_side = [&](auto ii) -> float {
    constexpr int i = decltype(ii)::value;
    if constexpr (S >= 1 && i - 1 == S - 1) return j.jcos_c;
    else if constexpr (i - 1 <= S - 2) return L.in_cos[i];
    else return C.w[T + S - 1 - i];
  };
  auto cos_cam_side = [&](auto ii) -> float {
    constexpr int i = decltype(ii)::value;
    if constexpr (S >= 1 && i == S - 1) return j.jcos_l;
    else if constexpr (i <= S - 2) return L.w[i];
    else return C.in_cos[T + S - 1 - i];
  };
  auto edge_D = [&](auto ee) -> float {
    constexpr int e = decltype(ee)::value;
    if constexpr (S >= 1 && e == S - 1) return j.Dx;
    else if constexpr (e <= S - 2) return L.D[e];
    else return C.D[T + S - 2 - e];
  };
  float r[K];
  bool spec[K];
  static_for<K>([&](auto ii) {
    constexpr int i = decltype(ii)::value;
    using I = std::integral_constant<int, i>;
    float num, den;
    if constexpr (i == 0) {
      num = vert_l(I{});
      den = vert_c(I{}) * cos_cam_side(I{}) /
            edge_D(std::integral_constant<int, 0>{});
    } else if constexpr (i == K - 1) {
      num = vert_l(I{}) * cos_light_side(I{}) /
            edge_D(std::integral_constant<int, K - 2>{});
      den = vert_c(I{});
    } else {
      num = vert_l(I{}) * cos_light_side(I{}) /
            edge_D(std::integral_constant<int, i - 1>{});
      den = vert_c(I{}) * cos_cam_side(I{}) / edge_D(I{});
    }
    r[i] = num / guard(den);
    if constexpr (i < S) spec[i] = L.spec[i];
    else if constexpr (T == 1 && T + S - 1 - i == 0) spec[i] = j.spec_synth;
    else spec[i] = C.spec[T + S - 1 - i];
  });
  return balance<K, S>(p_s, r, spec, ok);
}

// connect.py:_mis_weight_fast (the reference estimator) for (T, S).
template <int T, int S>
__device__ __forceinline__ float mis_fast(const Terms& L, const Terms& C,
                                          float p_s, const Junction& j,
                                          bool& ok) {
  constexpr int K = T + S;
  float w[K], l[K], c[K];
  bool spec[K];
  static_for<K>([&](auto ii) {
    constexpr int i = decltype(ii)::value;
    if constexpr (i < S) {
      w[i] = L.w[i], l[i] = L.l[i], c[i] = L.c[i], spec[i] = L.spec[i];
    } else if constexpr (T == 1 && T + S - 1 - i == 0) {
      w[i] = j.w_synth, l[i] = C.l[0], c[i] = C.c[0];
      spec[i] = j.spec_synth;
    } else {
      constexpr int jj = T + S - 1 - i;
      w[i] = C.w[jj], l[i] = C.l[jj], c[i] = C.c[jj], spec[i] = C.spec[jj];
    }
  });
  auto edge = [&](auto ee) -> float {
    constexpr int e = decltype(ee)::value;
    if constexpr (e <= S - 2) return L.D[e];
    else if constexpr (S >= 1 && e == S - 1) return j.Dx;
    else return C.D[T + S - 2 - e];
  };
  float r[K];
  static_for<K>([&](auto ii) {
    constexpr int i = decltype(ii)::value;
    float num, den;
    if constexpr (i == 0) {
      num = l[0];
      den = c[0] * (w[0] * w[1] / edge(std::integral_constant<int, 0>{}));
    } else if constexpr (i == K - 1) {
      num = l[i] * (w[i] * w[K - 2] /
                    edge(std::integral_constant<int, K - 2>{}));
      den = c[i];
    } else {
      num = l[i] * (w[i - 1] * w[i] /
                    edge(std::integral_constant<int, i - 1>{}));
      den = c[i] * (w[i] * w[i + 1] /
                    edge(std::integral_constant<int, i>{}));
    }
    r[i] = num / guard(den);
  });
  return balance<K, S>(p_s, r, spec, ok);
}

template <bool kRef, int T, int S>
__device__ __forceinline__ float mis_weight(const Terms& L, const Terms& C,
                                            float p_s, const Junction& j,
                                            bool& ok) {
  if constexpr (kRef) return mis_fast<T, S>(L, C, p_s, j, ok);
  else return mis_correct<T, S>(L, C, p_s, j, ok);
}

struct ShadeArgs {
  ShadePath C, L;
  const int* cam_len;
  long long n;
  int mb;                       // max_bounces: P = mb * mb cast pairs
  const int* cast_tri;          // [P, N]
  const float* cast_t;
  const bool* cast_active;
  Materials mat;
  const float* packed;          // scene["tri"]["packed"], [T, cols]
  int packed_cols;
  long long n_tris;
  Camera cam;
  int width, height;
  float* contribution;          // [N, 3]
  float* weight_sum;            // [N]
  float* light_image;           // [H * W, 3], added into
  float* light_weight;          // [H * W], added into
};

// connect.py:_strategy_t1 for (1, S): lane i's light vertex S-1 projected
// onto the sensor, added into the light image when it lands on a pixel.
template <bool kRef, int S>
__device__ __forceinline__ void splat(const ShadeArgs& a, const Terms& L,
                                      const Terms& C, long long i) {
  const long long q = (long long)(S - 1) * a.n + i;
  const int hit = __ldg(a.cast_tri + q);
  const float hit_t = __ldg(a.cast_t + q);
  const bool act = a.cast_active[q];
  const long long lr = (S - 1) * a.L.stride + i;
  const V3 lvo = load3(a.L.origin, lr);
  const V3 lvn = load3(a.L.normal, lr);
  const V3 focal = cam3(a.cam.focal);
  const V3 cdir = cam3(a.cam.dir);
  const V3 center = cam3(a.cam.center);
  const V3 proj = normalize3(focal - lvo);
  const int safe = hit > 0 ? hit : 0;
  bool reached = hit >= 0 && safe < a.n_tris &&
                 __ldg(a.packed + (long long)safe * a.packed_cols + 14) != 0.0f;
  V3 point;
  if constexpr (kRef) {
    point = along(lvo, hit_t, proj);
  } else {
    // the sensor plane, analytically; reached when no scene hit lies
    // strictly inside the segment
    const float den = dot3(proj, cdir);
    const float num = dot3(center - lvo, cdir);
    const float t_plane = den < -1e-12f ? num / den : INFINITY;
    reached = (reached || hit < 0 || hit_t >= t_plane * kBelow) &&
              isfinite(t_plane) && t_plane > 0.0f;
    point = along(lvo, t_plane, proj);
  }
  const V3 rel = point - center;
  const float x = (dot3(rel, cam3(a.cam.dx)) / __ldg(a.cam.phys_w) + 0.5f) *
                  (float)a.width;
  const float y = (dot3(rel, cam3(a.cam.dy)) / __ldg(a.cam.phys_h) + 0.5f) *
                  (float)a.height;
  // the reference's round() is half to even
  const int px = (int)(kRef ? rintf(x) : floorf(x));
  const int py = (int)(kRef ? rintf(y) : floorf(y));
  const bool pix_ok = px >= 0 && px < a.width && py >= 0 && py < a.height;
  bool valid = act && reached && pix_ok;

  const float p_s = __ldg(a.L.tot + lr);
  const V3 delta = point - lvo;
  const float d_x = clamp_min(dot3(delta, delta), kTiny2);
  const V3 dir = normalize3(point - lvo);
  constexpr int prior = S - 2 > 0 ? S - 2 : 0;
  const V3 lcolor =
      load3(a.L.color, prior * a.L.stride + i) *
      table_row(a.mat.color, __ldg(a.L.material + lr), a.mat.rows);
  Junction j{};
  j.Dx = d_x;
  j.spec_synth = __ldg(a.mat.type + 7) > 0;
  bool ok;
  float w, shade;
  if constexpr (kRef) {
    const V3 synth_dir = normalize3(focal - point);
    j.w_synth = fabsf(dot3(synth_dir, cdir));
    w = mis_weight<true, 1, S>(L, C, p_s, j, ok);
    const float light_f = S > 1 ? fabsf(dot3(dir, lvn)) * kInvPi : 1.0f;
    // _geom(lv, synth)
    shade = light_f * (L.w[S - 1] * j.w_synth / d_x);
  } else {
    j.jcos_l = fabsf(dot3(dir, lvn));
    j.jcos_c = fabsf(dot3(dir, cdir));
    j.t1_cam_c = C.c[0];
    w = mis_weight<false, 1, S>(L, C, p_s, j, ok);
    // radiance toward the sensor times the light->pixel area Jacobian
    // through the pinhole
    float brdf = 1.0f;
    if constexpr (S == 2) brdf = kInvPi * L.w[0];
    else if constexpr (S > 2) brdf = kInvPi;
    const float cos_c = clamp_min(j.jcos_c, 1e-6f);
    const V3 f0 = focal - lvo;
    const V3 f1 = focal - point;
    const float r0 = sqrtf(clamp_min(dot3(f0, f0), kTiny2));
    const float r1 = sqrtf(clamp_min(dot3(f1, f1), kTiny2));
    const float k_sensor = __ldg(a.cam.phys_w) * __ldg(a.cam.phys_h);
    const float ratio = r1 / r0;
    shade = brdf * k_sensor * (j.jcos_l / cos_c) * (ratio * ratio);
  }
  valid = valid && ok;
  if (valid) {
    const float k = w * shade / clamp_min(p_s, kTiny);
    const long long pix = (long long)py * a.width + px;
    atomicAdd(a.light_image + 3 * pix, k * lcolor.x);
    atomicAdd(a.light_image + 3 * pix + 1, k * lcolor.y);
    atomicAdd(a.light_image + 3 * pix + 2, k * lcolor.z);
    atomicAdd(a.light_weight + pix, w);
  }
}

// s = 0: camera vertex T-1 lies on an emitter.
template <bool kRef, int T>
__device__ __forceinline__ void emitter(const ShadeArgs& a, const Terms& L,
                                        const Terms& C, long long i, int clen,
                                        V3& acc, float& wsum) {
  const long long cr = (T - 1) * a.C.stride + i;
  bool valid = T <= clen && __ldg(a.C.hit_light + cr) >= 0;
  const V3 color =
      load3(a.C.color, (T - 2) * a.C.stride + i) *
      table_row(a.mat.emission, __ldg(a.C.material + cr), a.mat.rows);
  const float p_s = __ldg(a.C.tot + cr);
  Junction j{};
  j.l0_override = L.l[0];
  bool ok;
  const float w = mis_weight<kRef, T, 0>(L, C, p_s, j, ok);
  valid = valid && ok;
  const float k = w * 1.0f / clamp_min(p_s, kTiny);
  acc.x = acc.x + (valid ? k * color.x : 0.0f);
  acc.y = acc.y + (valid ? k * color.y : 0.0f);
  acc.z = acc.z + (valid ? k * color.z : 0.0f);
  wsum = wsum + (valid ? w : 0.0f);
}

// t >= 2, s >= 1: light vertex S-1 joined to camera vertex T-1 through the
// cast's visibility answer.
template <bool kRef, int T, int S>
__device__ __forceinline__ void join(const ShadeArgs& a, const Terms& L,
                                     const Terms& C, long long i, V3& acc,
                                     float& wsum) {
  const long long q = (long long)((T - 1) * a.mb + S - 1) * a.n + i;
  const int hit = __ldg(a.cast_tri + q);
  const long long cr = (T - 1) * a.C.stride + i;
  const long long lr = (S - 1) * a.L.stride + i;
  const V3 cvo = load3(a.C.origin, cr);
  const V3 lvo = load3(a.L.origin, lr);
  const int cv_tri = __ldg(a.C.triangle + cr);
  const V3 seg = cvo - lvo;
  const float d2 = clamp_min(dot3(seg, seg), kTiny2);
  bool visible;
  if constexpr (kRef) {
    visible = hit >= 0 && hit != __ldg(a.L.triangle + lr) && hit == cv_tri;
  } else {
    // with the cast capped below the segment, no hit strictly inside the
    // segment means unoccluded
    visible = hit == cv_tri || hit < 0 ||
              __ldg(a.cast_t + q) >= sqrtf(d2) * kBelow;
  }
  bool valid = a.cast_active[q] && visible;
  const V3 dir = normalize3(seg);
  const V3 cvn = load3(a.C.normal, cr);
  const V3 lvn = load3(a.L.normal, lr);
  const float cos_l = fabsf(dot3(dir, lvn));
  const float cos_c = fabsf(dot3(dir, cvn));
  float camera_f, g;
  if constexpr (kRef) {
    // cos/pi junction "BRDFs" and _geom(cv, lv) from the stored directions
    camera_f = cos_c * kInvPi;
    g = C.w[T - 1] * L.w[S - 1] / d2;
  } else {
    camera_f = kInvPi;
    g = cos_l * cos_c / d2;
  }
  const V3 camera_color =
      scale(load3(a.C.color, (T - 2) * a.C.stride + i), camera_f) *
      table_row(a.mat.color, __ldg(a.C.material + cr), a.mat.rows);
  V3 light_color;
  const int lmat = __ldg(a.L.material + lr);
  if constexpr (S == 1) {
    light_color = table_row(a.mat.emission, lmat, a.mat.rows);
  } else {
    float light_f;
    if constexpr (kRef) light_f = cos_l * kInvPi;
    // the emission cosine lives in color(y_1) onward; s == 2 uses
    // color(y_0) and needs it explicitly
    else if constexpr (S == 2) light_f = kInvPi * L.w[0];
    else light_f = kInvPi;
    light_color = scale(load3(a.L.color, (S - 2) * a.L.stride + i),
                        light_f) *
                  table_row(a.mat.color, lmat, a.mat.rows);
  }
  const V3 color = camera_color * light_color;
  const float p_s = __ldg(a.C.tot + cr) * __ldg(a.L.tot + lr);
  Junction j{};
  j.Dx = d2;
  j.jcos_l = cos_l;
  j.jcos_c = cos_c;
  bool ok;
  const float w = mis_weight<kRef, T, S>(L, C, p_s, j, ok);
  valid = valid && ok;
  const float k = w * g / clamp_min(p_s, kTiny);
  acc.x = acc.x + (valid ? k * color.x : 0.0f);
  acc.y = acc.y + (valid ? k * color.y : 0.0f);
  acc.z = acc.z + (valid ? k * color.z : 0.0f);
  wsum = wsum + (valid ? w : 0.0f);
}

template <bool kRef>
__global__ void __launch_bounds__(kShadeThreads)
    connect_shade_kernel(const ShadeArgs a) {
  const long long i = (long long)blockIdx.x * kShadeThreads + threadIdx.x;
  if (i >= a.n) return;
  Terms L, C;
  load_terms(L, a.L, a.mat, i, a.mb);
  load_terms(C, a.C, a.mat, i, a.mb);
  const int clen = __ldg(a.cam_len + i);
  V3 acc{0.0f, 0.0f, 0.0f};
  float wsum = 0.0f;
  // connect_paths' order: t outer, s inner
  static_for<kMaxDepth>([&](auto tt) {
    constexpr int T = decltype(tt)::value + 1;
    if (T > a.mb) return;
    static_for<kMaxDepth + 1>([&](auto ss) {
      constexpr int S = decltype(ss)::value;
      if (S > a.mb) return;
      if constexpr (T == 1) {
        if constexpr (S >= 1) splat<kRef, S>(a, L, C, i);
      } else if constexpr (S == 0) {
        emitter<kRef, T>(a, L, C, i, clen, acc, wsum);
      } else {
        join<kRef, T, S>(a, L, C, i, acc, wsum);
      }
    });
  });
  a.contribution[3 * i] = acc.x;
  a.contribution[3 * i + 1] = acc.y;
  a.contribution[3 * i + 2] = acc.z;
  a.weight_sum[i] = wsum;
}

}  // namespace

// Stage A: origin, direction [P, N, 3] and active, t_max [P, N] of the
// pairs (pairs: host array of P distinct (t, s)); vertex depths below
// ``depth`` are read.
extern "C" int clive2_connect_rays(
    const float* c_origin, const float* c_normal, const int* c_material,
    long long c_stride, const float* l_origin, const float* l_normal,
    const int* l_material, long long l_stride, const int* cam_len,
    const int* light_len, long long n, int depth, const int* mat_type,
    int n_mat, const float* cam_center, const float* cam_focal,
    const float* cam_dir, const int* pairs, int n_pairs, int any_hit,
    float* origin, float* direction, bool* active, float* t_max,
    void* stream) {
  if (n_pairs < 0 || n_pairs > kMaxPairs || depth < 1 || depth > kMaxDepth)
    return (int)cudaErrorInvalidValue;
  PairRows rows;
  for (int t = 0; t < kMaxDepth; ++t)
    for (int s = 0; s < kMaxDepth; ++s) rows.row[t][s] = -1;
  for (int k = 0; k < n_pairs; ++k) {
    const int t = pairs[2 * k], s = pairs[2 * k + 1];
    if (t < 1 || t > depth || s < 1 || s > depth ||
        rows.row[t - 1][s - 1] >= 0)
      return (int)cudaErrorInvalidValue;
    rows.row[t - 1][s - 1] = (signed char)k;
  }
  if (n <= 0 || n_pairs == 0) return (int)cudaSuccess;
  const RayPath C{c_origin, c_normal, c_material, c_stride};
  const RayPath L{l_origin, l_normal, l_material, l_stride};
  const Camera cam{cam_center, cam_focal, cam_dir, nullptr,
                   nullptr,    nullptr,   nullptr};
  const unsigned blocks = (unsigned)((n + kRaysThreads - 1) / kRaysThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit)
    connect_rays_kernel<true><<<blocks, kRaysThreads, 0, s>>>(
        C, L, cam_len, light_len, n, depth, mat_type, n_mat, cam, rows,
        origin, direction, active, t_max);
  else
    connect_rays_kernel<false><<<blocks, kRaysThreads, 0, s>>>(
        C, L, cam_len, light_len, n, depth, mat_type, n_mat, cam, rows,
        origin, direction, active, t_max);
  return (int)cudaGetLastError();
}

// Stage B: contribution [N, 3] and weight_sum [N] written, the t = 1
// splats added into light_image [H*W, 3] and light_weight [H*W].  The
// camera subpath's fields first (origin, direction, normal, color,
// c_importance, l_importance, tot_importance, material, triangle,
// hit_light, depth stride), then the light subpath's (the same but
// hit_light).
extern "C" int clive2_connect_shade(
    const float* c_origin, const float* c_direction, const float* c_normal,
    const float* c_color, const float* c_cimp, const float* c_limp,
    const float* c_tot, const int* c_material, const int* c_triangle,
    const int* c_hit_light, long long c_stride, const float* l_origin,
    const float* l_direction, const float* l_normal, const float* l_color,
    const float* l_cimp, const float* l_limp, const float* l_tot,
    const int* l_material, const int* l_triangle, long long l_stride,
    const int* cam_len, long long n, int max_bounces, const int* cast_tri,
    const float* cast_t, const bool* cast_active, const int* mat_type,
    const float* mat_color, const float* mat_emission, int n_mat,
    const float* packed, int packed_cols, long long n_tris,
    const float* cam_center, const float* cam_focal, const float* cam_dir,
    const float* cam_dx, const float* cam_dy, const float* cam_phys_w,
    const float* cam_phys_h, int width, int height, int reference,
    float* contribution, float* weight_sum, float* light_image,
    float* light_weight, void* stream) {
  if (max_bounces < 1 || max_bounces > kMaxDepth || n_mat < 8 ||
      packed_cols < 15)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  ShadeArgs a;
  a.C = ShadePath{c_origin, c_direction, c_normal, c_color,   c_cimp,   c_limp,
                  c_tot,    c_material,  c_triangle, c_hit_light, c_stride};
  a.L = ShadePath{l_origin, l_direction, l_normal,   l_color, l_cimp, l_limp,
                  l_tot,    l_material,  l_triangle, nullptr, l_stride};
  a.cam_len = cam_len;
  a.n = n;
  a.mb = max_bounces;
  a.cast_tri = cast_tri;
  a.cast_t = cast_t;
  a.cast_active = cast_active;
  a.mat = Materials{mat_type, mat_color, mat_emission, n_mat};
  a.packed = packed;
  a.packed_cols = packed_cols;
  a.n_tris = n_tris;
  a.cam = Camera{cam_center, cam_focal, cam_dir,   cam_dx,
                 cam_dy,     cam_phys_w, cam_phys_h};
  a.width = width;
  a.height = height;
  a.contribution = contribution;
  a.weight_sum = weight_sum;
  a.light_image = light_image;
  a.light_weight = light_weight;
  const unsigned blocks = (unsigned)((n + kShadeThreads - 1) / kShadeThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (reference)
    connect_shade_kernel<true><<<blocks, kShadeThreads, 0, s>>>(a);
  else
    connect_shade_kernel<false><<<blocks, kShadeThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
