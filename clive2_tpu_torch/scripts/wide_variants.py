"""Development A/B of the BVH8 traversal kernel's design on one NVIDIA GPU.

    python3 clive2_tpu_torch/scripts/wide_variants.py

Builds clive2_tpu_torch/csrc/traverse_wide.cu as it is and variants of it
(text patches of the source, PATCHES, combined in VARIANTS) into separate
libraries, records the casts of one 512x512 sample of the ``dragon`` preset
under ``CLIVE2_TRAVERSAL=wide`` (the 524,288-ray extension cast and the
9,437,184-ray any-hit connection cast), and times each variant and the BVH2
kernel (tables packed from the same gather-walk rows) on both casts, in
turns, with CUDA events: 5 launches after a warm-up, twice round.  Every
variant's ids equal the kernel's (closest-hit: t too; a variant that moves
the any-hit stop: its verdicts).  Then it counts the
work per active ray on every k-th ray of each cast (k the least stride
leaving at most 2^20 rays): wide node visits, box tests and triangle tests
of ``wide_plain``, and node visits, box tests and triangle tests of the
BVH2 kernel's walk order (nearer child first, any-hit stopping after the
first leaf with a hit) run as a plain lockstep walk.  Prints one JSON line
per build (ptxas's registers, frame and spills), per timing round and per
count, then a summary line and the card's name and power limit.  Imports
no JAX.  The patches are written against the kernel as it is; one that no
longer applies raises.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

# the kernel's leaf phase: one loop of one row per step over a lane's leaf
# children and sets (head and tail of the loop)
_FLAT_LEAVES = """    // ---- test the postponed leaf children, one row per step ----
    {
      unsigned mask = post & 0xffu;
      int row = 0, end = 0;
      while (post != 0u) {
        if (row == end) {                // on to the next leaf child
          const float4* nd = nodes + 2 * kWide * (long long)(post >> 8);
          while (mask && row == end) {
            const int c = __ffs(mask) - 1;
            mask &= mask - 1u;
            const float4 a = __ldg(nd + 2 * c);
            const float4 b = __ldg(nd + 2 * c + 1);
            if (box_entry(a.x, a.y, a.z, b.x, b.y, b.z, ox, oy, oz, ix, iy,
                          iz, bt) < INFINITY) {
              const int code = ~__float_as_int(a.w);
              row = code >> kLeafBits;
              end = row + (code & ((1 << kLeafBits) - 1));
            }
          }
          if (row == end) {              // the set is done
            if (kAnyHit && bs >= 0) {
              ref = kNone;
              pend = 0u;
            }
            post = pend;
            pend = 0u;
            mask = post & 0xffu;
            continue;
          }
        }
"""
_FLAT_TAIL = """          bu = u;
          bv = v;
        }
        ++row;
      }
    }
"""
# the same phase as nested loops: set, leaf child, row
_NESTED_LEAVES = """    // ---- test the postponed leaf children ----
    while (post != 0u) {
      const float4* nd = nodes + 2 * kWide * (long long)(post >> 8);
      unsigned mask = post & 0xffu;
      while (mask) {
        const int c = __ffs(mask) - 1;
        mask &= mask - 1u;
        const float4 a = __ldg(nd + 2 * c);
        const float4 b = __ldg(nd + 2 * c + 1);
        if (!(box_entry(a.x, a.y, a.z, b.x, b.y, b.z, ox, oy, oz, ix, iy, iz,
                        bt) < INFINITY))
          continue;
        const int code = ~__float_as_int(a.w);
        const int first = code >> kLeafBits;
        const int count = code & ((1 << kLeafBits) - 1);
        for (int row = first; row < first + count; ++row) {
"""
_NESTED_TAIL = """          bu = u;
          bv = v;
        }
        }
      }
      if (kAnyHit && bs >= 0) {
        ref = kNone;
        pend = 0u;
      }
      post = pend;
      pend = 0u;
    }
"""
# the kernel's visit: every child of the node in one unrolled loop
_VISIT = """        const float4* nd = nodes + 2 * kWide * (long long)ref;
        float tc[kWide];
        unsigned inner = 0u, leaves = 0u;
        int best = -1;
        float best_t = INFINITY;
#pragma unroll
        for (int c = 0; c < kWide; ++c) {
          const float4 a = __ldg(nd + 2 * c);
          const int cr = __float_as_int(a.w);
          if (cr == kNone) break;          // empty children come last
          const float4 b = __ldg(nd + 2 * c + 1);
          tc[c] = box_entry(a.x, a.y, a.z, b.x, b.y, b.z, ox, oy, oz, ix, iy,
                            iz, bt);
          if (tc[c] < INFINITY) {
            if (cr >= 0) {
              inner |= 1u << c;
              if (tc[c] < best_t) {
                best = c;
                best_t = tc[c];
              }
            } else {
              leaves |= 1u << c;
            }
          }
        }
        // the other hit inner children in child order, under the nearest
        const unsigned rest = best >= 0 ? inner & ~(1u << best) : 0u;
#pragma unroll
        for (int c = 0; c < kWide; ++c)
          if (rest >> c & 1u) st.push(__float_as_int(__ldg(nd + 2 * c).w),
                                      tc[c]);
        if (leaves) {
          const unsigned set = (unsigned)ref << 8 | leaves;
          if (post == 0u) post = set; else pend = set;
        }
        ref = best >= 0 ? __float_as_int(__ldg(nd + 2 * best).w)
                        : st.pop(bt);
"""
# one child per walk step: every hit inner child pushed in child order and
# the nearest taken back out of the stack at the node's end, the entries
# above it moved down one; the child count is read from child 0's hi.w
# (child_counts)
_STEPS = """        const float4* ch = nodes + 2 * (kWide * (long long)ref + kid);
        const float4 a = __ldg(ch);
        const float4 b = __ldg(ch + 1);
        if (kid == 0) n_kids = __float_as_int(b.w);
        const float t = box_entry(a.x, a.y, a.z, b.x, b.y, b.z, ox, oy, oz,
                                  ix, iy, iz, bt);
        if (t < INFINITY) {
          const int cr = __float_as_int(a.w);
          if (cr >= 0) {
            if (t < near_t) {
              near_t = t;
              near_at = st.sp;
            }
            st.push(cr, t);
          } else {
            leaves |= 1u << kid;
          }
        }
        if (++kid == n_kids) {             // the node is done
          if (leaves) {
            const unsigned set = (unsigned)ref << 8 | leaves;
            if (post == 0u) post = set; else pend = set;
          }
          if (near_t < INFINITY) {
            const int j = near_at;
            ref = j < kSharedStack
                      ? walk_stack_ref[j * kWalkThreads + threadIdx.x]
                      : st.deep_ref[j - kSharedStack];
            for (int k = j + 1; k < st.sp; ++k) {
              int rk;
              float tk;
              if (k < kSharedStack) {
                rk = walk_stack_ref[k * kWalkThreads + threadIdx.x];
                tk = walk_stack_t[k * kWalkThreads + threadIdx.x];
              } else {
                rk = st.deep_ref[k - kSharedStack];
                tk = st.deep_t[k - kSharedStack];
              }
              if (k - 1 < kSharedStack) {
                walk_stack_ref[(k - 1) * kWalkThreads + threadIdx.x] = rk;
                walk_stack_t[(k - 1) * kWalkThreads + threadIdx.x] = tk;
              } else {
                st.deep_ref[k - 1 - kSharedStack] = rk;
                st.deep_t[k - 1 - kSharedStack] = tk;
              }
            }
            --st.sp;
          } else {
            ref = st.pop(bt);
          }
          kid = 0;
          leaves = 0u;
          near_t = INFINITY;
        }
"""
_DECL = ("  unsigned pend = 0u;       // a second set, found while one is "
         "postponed\n")
_FETCH = "      pend = 0u;\n      st.sp = 0;\n"

# name: [(old text, new text), ...] applied to traverse_wide.cu in order
PATCHES = {
    "nested": [(_FLAT_LEAVES, _NESTED_LEAVES), (_FLAT_TAIL, _NESTED_TAIL)],
    "pair": [("""          const float4 a = __ldg(nd + 2 * c);
          const int cr = __float_as_int(a.w);
          if (cr == kNone) break;          // empty children come last
          const float4 b = __ldg(nd + 2 * c + 1);
""", """          const float4 a = __ldg(nd + 2 * c);
          const float4 b = __ldg(nd + 2 * c + 1);
          const int cr = __float_as_int(a.w);
          if (cr == kNone) break;          // empty children come last
""")],
    "anyfirst": [("""        if (row == end) {                // on to the next leaf child
""", """        if (row == end) {                // on to the next leaf child
          if (kAnyHit && bs >= 0) mask = 0u;
""")],
    "steps": [(_VISIT, _STEPS),
              (_DECL, _DECL + "  int kid = 0, n_kids = 0, near_at = 0;\n"
               "  unsigned leaves = 0u;\n  float near_t = INFINITY;\n"),
              (_FETCH, "      pend = 0u;\n      kid = 0;\n      leaves = 0u;\n"
               "      near_t = INFINITY;\n      st.sp = 0;\n")],
}
VARIANTS = {
    # the kernel as it is
    "kernel": [],
    # the leaf phase as nested loops: a warp runs each set's leaf children,
    # and each child's rows, at its slowest lane's pace
    "nested": ["nested"],
    # a child's two loads issued together, before its reference is checked
    "pair": ["pair"],
    # the walk one child per step
    "steps": ["steps"],
    # any-hit stops at the first leaf child with a hit, not after its set
    # (its any-hit ids may differ from the kernel's, its verdicts may not)
    "anyfirst": ["anyfirst"],
}
CHANGES_ANY_HIT_IDS = {"anyfirst"}


def child_counts(tables):
    """The tables with each node's child count in child 0's hi.w (read by
    the ``steps`` variant; the kernel reads no hi.w)."""
    import torch

    from clive2_tpu_torch.ops import traverse_wide as tw

    nodes = tables["nodes"].clone()
    bits = nodes.view(torch.int32).view(-1, tw.WIDE, tw.CHILD)
    bits[:, 0, 7] = (bits[..., 3] != tw.EMPTY).sum(1).int()
    return dict(tables, nodes=nodes)


TABLES = {"steps": child_counts}


def build_variants(names):
    """{name: library path, ptxas report} for the variants, one nvcc each,
    all started together."""
    from clive2_tpu_torch import kernels

    src = open(os.path.join(kernels.CSRC, "traverse_wide.cu")).read()
    out = os.path.join(kernels.BUILD_DIR, "wide_variants")
    os.makedirs(out, exist_ok=True)
    cmds, libs = [], {}
    for name in names:
        text = src
        for patch in VARIANTS[name]:
            for old, new in PATCHES[patch]:
                if text.count(old) != 1:
                    raise ValueError(f"patch {patch} does not apply")
                text = text.replace(old, new)
        cu = os.path.join(out, f"traverse_wide_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        libs[name] = os.path.join(out, f"libwide_{name}.so")
        cmds.append([kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC,
                     "-Xptxas", "-v", "-shared", "-o", libs[name], cu])
    reports = kernels._run_all(cmds)
    return {name: (libs[name], rep) for name, rep in zip(names, reports)}


def ptxas_figures(report):
    """Registers, frame bytes and spill-store bytes of each kernel instance
    in a ptxas report."""
    return dict(
        registers=[int(x) for x in re.findall(r"Used (\d+) registers",
                                              report)],
        frame_bytes=[int(x) for x in re.findall(r"(\d+) bytes stack frame",
                                                report)],
        spill_store_bytes=[int(x) for x in re.findall(
            r"(\d+) bytes spill stores", report)])


def launcher(library):
    """A cast through the clive2_wide entry of ``library``."""
    import torch

    from clive2_tpu_torch import kernels
    from clive2_tpu_torch.ops import traverse_wide as tw

    fn = ctypes.CDLL(library).clive2_wide
    fn.argtypes = kernels._SIGNATURES["clive2_wide"]
    fn.restype = ctypes.c_int

    def cast(c, tables):
        rays = kernels.ray_args(c["origin"], c["direction"], c["active"],
                                c["t_max"])
        args = kernels.aligned_tables(tables, tw._TABLES,
                                      c["origin"].device, "wide")
        out = kernels.hit_outputs(c["origin"])
        counter = torch.empty(1, dtype=torch.int64,
                              device=c["origin"].device)
        rc = fn(*rays.pointers(), *map(kernels.ptr, args),
                kernels.ptr(counter), ctypes.c_int(int(c["any_hit"])),
                *map(kernels.ptr, out),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f"{library}: CUDA error {rc}")
        return out

    return cast


def wide_counts(c, tables):
    """Node visits, box tests and triangle tests of ``wide_plain`` on cast
    ``c`` (a visit is one ray's row of slab tests)."""
    from clive2_tpu_torch.ops import traverse_wide as tw
    from clive2_tpu_torch.ops.intersect import WORK

    visits = []
    slab = tw.box_entry

    def counted(o, inv, box, bt):
        visits.append(box.shape[0])
        return slab(o, inv, box, bt)

    WORK.clear()
    tw.box_entry = counted
    try:
        tw.wide_plain(c["origin"], c["direction"], tables,
                      active=c["active"], t_max=c["t_max"],
                      any_hit=c["any_hit"])
    finally:
        tw.box_entry = slab
    return dict(visits=sum(visits), boxes=WORK["boxes"],
                triangles=WORK["triangles"])


def bvh2_counts(c, tables):
    """Node visits, box tests and triangle tests of the BVH2 kernel's walk
    order on cast ``c``: a lockstep walk of its node records (the streaming
    kernels' top-tree walk, ops/traverse_stream.py:walk_top_tree: nearer
    child first, the farther pushed) whose leaves test their rows with the
    (t, row) rule; any-hit stops after the first leaf with a hit."""
    import torch

    from clive2_tpu_torch.ops.intersect import INF, WORK, _mt
    from clive2_tpu_torch.ops.traverse_bvh2 import LEAF_BITS
    from clive2_tpu_torch.ops.traverse_stream import walk_top_tree

    nodes, tris = tables["nodes"], tables["tris"]
    nodebox = torch.cat([nodes[:, [0, 2, 8, 1, 3, 9]],
                         nodes[:, [4, 6, 10, 5, 7, 11]]], dim=1)
    childs = nodes.view(torch.int32)[:, 12:14]
    o, d = c["origin"], c["direction"]
    n = o.shape[0]
    act = (torch.ones(n, dtype=torch.bool, device=o.device)
           if c["active"] is None else c["active"].bool())
    bt = (torch.full((n,), INF, device=o.device) if c["t_max"] is None
          else c["t_max"].clone())
    best = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    kk = torch.arange(8, device=o.device)

    def visit(ci, code):
        first = code >> LEAF_BITS
        real = kk < (code & ((1 << LEAF_BITS) - 1))[:, None]
        row = torch.where(real, first[:, None] + kk, 0)
        tr = tris[row]
        WORK["triangles"] += int(real.sum())
        hit, t, _, _ = _mt(tuple(x[:, None] for x in o[ci].unbind(-1)),
                           tuple(x[:, None] for x in d[ci].unbind(-1)),
                           tr[..., 0:3].unbind(-1), tr[..., 4:7].unbind(-1),
                           tr[..., 8:11].unbind(-1))
        t = torch.where(hit & real, t, INF)
        t_best = t.amin(1)
        r_best = torch.where(t == t_best[:, None], row,
                             tris.shape[0]).amin(1)
        cur_t, cur_r = bt[ci], best[ci]
        better = (t_best < INF) & ((t_best < cur_t) | (
            (t_best == cur_t) & (r_best < cur_r)))
        bt[ci] = torch.where(better, t_best, cur_t)
        best[ci] = torch.where(better, r_best, cur_r)

    WORK.clear()
    walk_top_tree(o, d, nodebox, childs, bt, best, act, c["any_hit"], visit)
    return dict(visits=WORK["boxes"] // 2, boxes=WORK["boxes"],
                triangles=WORK["triangles"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wide_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import clive2_tpu_torch as ct
    from clive2_tpu_torch.ops import traverse_bvh2, traverse_wide
    from clive2_tpu_torch.scene import RESOURCE_DIR

    dev = torch.device("cuda")
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    cs.emit(phase="device", kind=torch.cuda.get_device_name(0), smi=smi)
    t0 = time.perf_counter()
    libs = build_variants(list(VARIANTS))
    for name, (_, rep) in libs.items():
        cs.emit(phase="build", variant=name, patches=VARIANTS[name],
                **ptxas_figures(rep))
    cs.emit(phase="built", seconds=time.perf_counter() - t0)
    casts_of = {name: launcher(lib) for name, (lib, _) in libs.items()}

    cs.write_assets(RESOURCE_DIR)
    with cs.environment(CLIVE2_TRAVERSAL="wide"):
        scene = ct.create_scene_from_preset("dragon", 512, 512, device=dev)
    ab = cs.with_traversal(scene, "bvh2")
    casts = cs.record_casts(traverse_wide, "intersect_wide",
                            ct.Renderer(scene, seed=1, device=dev))
    names = {524288: "extension", 9437184: "connection"}
    if sorted(casts) != sorted(names):
        raise AssertionError(f"casts of {sorted(casts)} rays")
    tables = {name: TABLES.get(name, lambda x: x)(scene.data["wide"])
              for name in VARIANTS}
    times = {}
    for rnd in range(2):
        for rays, c in sorted(casts.items()):
            ref = None
            row = {}
            for name, cast in casts_of.items():
                ms, got = cs.cuda_time(lambda: cast(c, tables[name]), 5)
                if ref is None:
                    ref = got
                elif c["any_hit"] and name in CHANGES_ANY_HIT_IDS:
                    if not torch.equal(got[0] >= 0, ref[0] >= 0):
                        raise AssertionError(f"{name}: verdicts differ")
                elif not (torch.equal(got[0], ref[0]) and (
                        c["any_hit"] or torch.equal(got[1], ref[1]))):
                    raise AssertionError(f"{name}: ids or t differ")
                row[name] = ms
            row["bvh2"] = cs.cuda_time(
                lambda: traverse_bvh2.intersect_bvh2(
                    c["origin"], c["direction"], ab.data,
                    active=c["active"], t_max=c["t_max"],
                    any_hit=c["any_hit"]), 5)[0]
            cs.emit(phase="round", round=rnd, cast=names[rays], rays=rays,
                    ms=row)
            for k, v in row.items():
                times.setdefault((names[rays], k), []).append(v)
    for rays, c in sorted(casts.items()):
        stride = -(-rays // (1 << 20))
        part = cs.strided(c, stride)
        active = (part["origin"].shape[0] if part["active"] is None
                  else int(part["active"].sum()))
        for kernel, counts in (
                ("wide", wide_counts(part, scene.data["wide"])),
                ("bvh2", bvh2_counts(part, ab.data["bvh2"]))):
            cs.emit(phase="work", cast=names[rays], kernel=kernel,
                    stride=stride, active_rays=active, **counts,
                    per_active_ray={k: v / active for k, v in counts.items()},
                    boxes_per_visit=counts["boxes"] / counts["visits"])
    print(json.dumps({"summary": {f"{cast} {k}": v for (cast, k), v
                                  in sorted(times.items())}}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
