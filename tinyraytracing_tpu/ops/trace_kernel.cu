// Closest-hit BVH trace for NVIDIA Hopper (sm_90a), called from JAX through
// the XLA foreign function interface (ops/trace_cuda.py builds and registers
// it; ops/trace.py dispatches to it).
//
// One thread per ray. Each thread walks the binary preorder BVH of ops/bvh.py
// (left child of internal node i is i+1, right child skip[i+1]) with a
// fixed-depth stack in local memory, testing both children's boxes at the
// parent and descending into the nearer one first. Node records and
// triangles are read through the read-only data cache; a 100K-triangle tree
// stays resident in L2.
//
// The arithmetic is the plain path's (ops/traverse.py, ops/intersect.py):
// the reference slab test (interactAABB, bvh.cpp:231-245), Möller–Trumbore
// with t_min and the grazing cull (bvh.cpp:185-189), and the relative
// emissive tie band (bvh.cpp:219, config.tie_eps). Semantics of the bound:
//   - the walk starts at the ray's bound tb: the first hit is admitted iff
//     t <= tb * (1 + tie_eps); after that the usual closest/tie-band rule;
//   - target-material early kill (tg > -1.5): an admitted hit of another
//     material strictly inside the band of the current best (t * (1 + eps)
//     < bt) ends the walk and reports the ray as occluded (tri == -2).
// Outputs: t (the best distance, or tb on a miss), tri (triangle index, -1
// miss, -2 killed) and the barycentrics (u, v) of the best hit. Shading
// attributes are gathered by the caller for the final hit only.

#include <cuda_runtime.h>

#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

// Entries of the per-thread traversal stack. The wrapper refuses trees whose
// depth exceeds it (at most depth - 1 far children are pending at once).
constexpr int kStackSize = 64;
constexpr int kThreads = 128;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Reference slab test; returns the hit flag and the entry distance max(t0, 0)
// used both for the bound test and for ordering the children.
__device__ __forceinline__ bool slab(const float4* __restrict__ nodes, int i,
                                     const Ray& r, float limit, float* entry) {
  const float4 a = __ldg(nodes + 2 * i);      // minx miny minz maxx
  const float4 b = __ldg(nodes + 2 * i + 1);  // maxy maxz info info
  const float tax = (a.x - r.ox) * r.ix, tbx = (a.w - r.ox) * r.ix;
  const float tay = (a.y - r.oy) * r.iy, tby = (b.x - r.oy) * r.iy;
  const float taz = (a.z - r.oz) * r.iz, tbz = (b.y - r.oz) * r.iz;
  const float t0 = fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)), fminf(taz, tbz));
  const float t1 = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)), fmaxf(taz, tbz));
  const float dist = t0 > 0.f ? t0 : t1;
  *entry = fmaxf(t0, 0.f);
  return (t1 >= t0) && (dist > 0.f) && (*entry <= limit);
}

__global__ void __launch_bounds__(kThreads)
trace_kernel(int64_t n_rays, const float* __restrict__ rays,
             const float4* __restrict__ nodes, const float4* __restrict__ tris,
             const int* __restrict__ info, float t_min, float graze,
             float tie_eps, float* __restrict__ out_t, int* __restrict__ out_tri,
             float* __restrict__ out_u, float* __restrict__ out_v) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n_rays) return;

  Ray r;
  r.ox = rays[0 * n_rays + i];
  r.oy = rays[1 * n_rays + i];
  r.oz = rays[2 * n_rays + i];
  r.dx = rays[3 * n_rays + i];
  r.dy = rays[4 * n_rays + i];
  r.dz = rays[5 * n_rays + i];
  const float tb = rays[6 * n_rays + i];
  const float tg = rays[7 * n_rays + i];
  r.ix = 1.f / (r.dx == 0.f ? 1e-30f : r.dx);
  r.iy = 1.f / (r.dy == 0.f ? 1e-30f : r.dy);
  r.iz = 1.f / (r.dz == 0.f ? 1e-30f : r.dz);

  const float band = 1.f + tie_eps;
  const bool has_target = tg > -1.5f;
  float bt = tb;
  int bi = -1;
  float bu = 0.f, bv = 0.f;
  bool be = false;

  int stack[kStackSize];
  float stack_entry[kStackSize];
  int sp = 0;
  int node = 0;
  float entry;

  if (slab(nodes, 0, r, bt * band, &entry)) {
    while (true) {
      const float4 rec = __ldg(nodes + 2 * node + 1);
      const int first = __float_as_int(rec.z);  // leaf: start; inner: right
      const int count = __float_as_int(rec.w);
      bool descend = false;
      if (count > 0) {
        for (int k = first; k < first + count; ++k) {
          const float4 p0 = __ldg(tris + 3 * k);      // v0.xyz, e1.x
          const float4 p1 = __ldg(tris + 3 * k + 1);  // e1.yz, e2.xy
          const float4 p2 = __ldg(tris + 3 * k + 2);  // e2.z, gn.xyz
          const float e1x = p0.w, e1y = p1.x, e1z = p1.y;
          const float e2x = p1.z, e2y = p1.w, e2z = p2.x;
          const float px = r.dy * e2z - r.dz * e2y;
          const float py = r.dz * e2x - r.dx * e2z;
          const float pz = r.dx * e2y - r.dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const float inv_det = 1.f / (det == 0.f ? 1.f : det);
          const float sx = r.ox - p0.x, sy = r.oy - p0.y, sz = r.oz - p0.z;
          const float u = (sx * px + sy * py + sz * pz) * inv_det;
          const float qx = sy * e1z - sz * e1y;
          const float qy = sz * e1x - sx * e1z;
          const float qz = sx * e1y - sy * e1x;
          const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
          const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          const float ndd = r.dx * p2.y + r.dy * p2.z + r.dz * p2.w;
          const bool ok = fabsf(ndd) >= graze && det != 0.f && t >= t_min &&
                          u >= 0.f && v >= 0.f && u + v <= 1.f;
          if (!ok) continue;
          const int code = __ldg(info + k);  // material * 2 + emissive
          const bool em = code & 1;
          if (has_target && fabsf(static_cast<float>(code >> 1) - tg) > 0.5f &&
              t * band < bt) {
            bi = -2;  // occluded by another material
            goto done;
          }
          bool repl;
          if (bi < 0) {
            repl = t <= tb * band;
          } else {
            const bool near = t <= bt * band && bt <= t * band;
            repl = (!near && t < bt) || (near && em && !be);
          }
          if (repl) {
            bt = t;
            bi = k;
            bu = u;
            bv = v;
            be = em;
          }
        }
      } else {
        const int left = node + 1, right = first;
        float el, er;
        const float limit = bt * band;
        const bool hl = slab(nodes, left, r, limit, &el);
        const bool hr = slab(nodes, right, r, limit, &er);
        if (hl && hr) {
          const bool left_first = el <= er;
          stack[sp] = left_first ? right : left;
          stack_entry[sp] = left_first ? er : el;
          ++sp;
          node = left_first ? left : right;
          descend = true;
        } else if (hl || hr) {
          node = hl ? left : right;
          descend = true;
        }
      }
      if (descend) continue;
      // pop, skipping subtrees the shrunken bound has since excluded
      bool found = false;
      while (sp > 0) {
        --sp;
        if (stack_entry[sp] <= bt * band) {
          node = stack[sp];
          found = true;
          break;
        }
      }
      if (!found) break;
    }
  }
done:
  out_t[i] = bi == -2 ? -1.f : bt;
  out_tri[i] = bi;
  out_u[i] = bu;
  out_v[i] = bv;
}

ffi::Error TraceImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> rays,
                     ffi::Buffer<ffi::F32> nodes, ffi::Buffer<ffi::F32> tris,
                     ffi::Buffer<ffi::S32> info, float t_min, float graze,
                     float tie_eps, ffi::ResultBuffer<ffi::F32> t,
                     ffi::ResultBuffer<ffi::S32> tri,
                     ffi::ResultBuffer<ffi::F32> u,
                     ffi::ResultBuffer<ffi::F32> v) {
  const int64_t n_rays = t->element_count();
  if (rays.element_count() != 8 * n_rays) {
    return ffi::Error::InvalidArgument("rays must be an (8, R) array");
  }
  if (n_rays == 0) return ffi::Error::Success();
  const int64_t blocks = (n_rays + kThreads - 1) / kThreads;
  trace_kernel<<<blocks, kThreads, 0, stream>>>(
      n_rays, rays.typed_data(),
      reinterpret_cast<const float4*>(nodes.typed_data()),
      reinterpret_cast<const float4*>(tris.typed_data()), info.typed_data(),
      t_min, graze, tie_eps, t->typed_data(), tri->typed_data(),
      u->typed_data(), v->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(TinyptTrace, TraceImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // rays (8, R)
                                  .Arg<ffi::Buffer<ffi::F32>>()  // nodes (N, 8)
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tris (T, 12)
                                  .Arg<ffi::Buffer<ffi::S32>>()  // info (T,)
                                  .Attr<float>("t_min")
                                  .Attr<float>("graze")
                                  .Attr<float>("tie_eps")
                                  .Ret<ffi::Buffer<ffi::F32>>()   // t
                                  .Ret<ffi::Buffer<ffi::S32>>()   // tri
                                  .Ret<ffi::Buffer<ffi::F32>>()   // u
                                  .Ret<ffi::Buffer<ffi::F32>>());  // v
