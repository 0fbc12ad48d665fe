"""Render configuration.

The reference renderer has no config system: it prompts on stdin for scene
paths + SPP (reference: RayTracingOnCPU/main.cpp:46-55) and hard-codes every
other constant. All of those constants become explicit, documented flags here,
with defaults equal to the reference's values:

- ``p_rr = 0.8``            Russian-roulette survival prob (pathtracing.h:12)
- ``t_min = 5e-4``          min hit distance (bvh.cpp:189)
- ``n_dot_d_min = 1e-5``    grazing-ray rejection (bvh.cpp:185)
- ``leaf_size = 8``         BVH leaf capacity (main.cpp:76)
- ``aabb_pad = 1e-3``       AABB padding (bvh.cpp:31-40)
- ``spp = 256``             default sample count (main.cpp:13)

Reference-quirk switches (SURVEY.md §7 "hard part 4"): several estimator
details of the reference are physically questionable; each is kept behind a
flag so we can demonstrate both bit-level fidelity ("ref") and the corrected
estimator:

- ``light_sampler``  "ref": light-point barycentrics from 3 normalized
  uniforms (non-uniform over area, pathTracing.cpp:44-47) and the light-pick
  uniform drawn from the FIRST light's total area for every light (the
  ``static`` distribution quirk at pathTracing.cpp:37-38). "uniform":
  sqrt-based uniform-area barycentrics and per-light pick range.
- ``specular_weight``  "ref": SPECULAR indirect bounces multiply Kd
  (pathTracing.cpp:91-93). "ks": multiply Ks (the physically intended weight).
- ``shadow_test``  "mtl": visibility == (closest-hit material id == light
  material id), the reference's name comparison (pathTracing.cpp:55-58).
  "tmin": classic distance-based occlusion test.
"""

from __future__ import annotations

import dataclasses

# Ray types, mirroring the reference constants (reference: RayTracingOnCPU/ray.h:5-8)
DIFFUSE = 0
SPECULAR = 1
TRANSMISSION = 2
INVALID = 3
# Extra type for freshly generated camera rays (the reference encodes this
# implicitly by calling shade() at recursion depth 0, main.cpp:101).
CAMERA = 4


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (hashable) render configuration — safe to close over in jit."""

    # sampling
    spp: int = 256
    max_depth: int = 16          # reference recursion is unbounded, RR-terminated
    p_rr: float = 0.8
    # intersection
    t_min: float = 5e-4
    n_dot_d_min: float = 1e-5
    intersector: str = "auto"    # auto | mxu | brute | bvh
    # how the renderers' trace finds hits (ops/trace.py): "cuda" = the
    # CUDA kernel (GPU only; elsewhere an error), "xla" = the plain JAX
    # path through ``intersector``, "auto" = the kernel on a GPU, the
    # plain path elsewhere
    trace: str = "auto"          # auto | cuda | xla
    tri_chunk: int = 256         # triangle tile for the chunked brute-force scan
    tie_eps: float = 4e-6        # RELATIVE t band treated as "equal distance"
    # for the emissive tie-break (bvh.cpp:219). The reference's plane test
    # yields bitwise-equal t for coplanar axis-aligned quads (the classic
    # light-on-ceiling case); our per-triangle arithmetic (MT / Woop)
    # differs in the last ulps, so exact equality would silently lose NEE
    # visibility. ~4e-6 relative = a few ulps of float32.
    ray_chunk: int = 65536       # rays processed per device step
    bvh_early_out: bool = True   # front-to-back-ish pruning by current best t
    #   (strict improvement over the reference's explore-both, bvh.cpp:156-166)
    # BVH build
    leaf_size: int = 8
    aabb_pad: float = 1e-3
    # estimator fidelity switches (see module docstring)
    light_sampler: str = "ref"     # ref | uniform
    specular_weight: str = "ref"   # ref | ks
    shadow_test: str = "mtl"       # mtl | tmin
    # queue-renderer refill granularity. "lane": a dead lane immediately
    # takes the next queue entry (~100% occupancy; neighbouring lanes drift
    # into incoherent path mixtures as lanes die at different times).
    # "row": a 128-lane row refills only when wholly dead, so each row
    # always holds 128 CONSECUTIVE tile-order paths (spatially tight) at
    # the cost of occupancy (survivors park rows).
    queue_refill: str = "lane"     # lane | row
    # re-sort the queue renderer's lane state every N iterations (0 =
    # never, -1 = auto): refills insert new paths at dead-lane positions,
    # so neighbouring lanes drift into incoherent mixtures; a periodic
    # stable sort restores locality at the cost of one multi-plane sort.
    # "auto" resorts scenes >= 10K triangles by the MORTON key (every
    # iteration on trees of more than 4096 nodes, every second one below).
    # These choices were tuned on the previous accelerator; on the GPU
    # they are not measured yet.
    queue_resort_every: int = -1
    # resort key: "path" = pure path id (tile-order origins);
    # "path_octant" = path id blocks sub-sorted by direction octant;
    # "morton" = 15-bit morton code of the ray origin (spatial
    # re-formation for flat many-leaf scenes)
    queue_resort_key: str = "path"
    # morton-resort cells per axis. A config field — not an env var — so
    # sweeps invalidate the jit cache like any other config change.
    morton_cells: int = 32
    # compact live shadow lanes to the front of each light's segment
    # before the occlusion dispatch (ops/trace.occlusion_trace_segmented).
    # Per-lane trace results do not depend on a lane's neighbours, so
    # renders are bitwise-identical either way; the compaction itself is
    # one batched stable (L, R) lax.sort each way. "auto" enables it on
    # trees of more than 4096 nodes (not yet measured on the GPU).
    shadow_compact: str = "auto"   # auto | on | off
    # differentiation: detach sampled directions / discrete decisions so
    # the backward pass is the path-replay interior-term estimator
    detach_sampling: bool = True
    # precision of the accumulation image
    accum_dtype: str = "float32"

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RenderConfig()
