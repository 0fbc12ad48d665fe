// CPU baseline renderer: a from-scratch single-file reimplementation of the
// reference ALGORITHM (Chairy-neko/TinyRayTracing, RayTracingOnCPU/) used to
// MEASURE the CPU baseline this framework is compared against
// (BASELINE.md: "run the reference algorithm ... and record rays/s") — the
// reference ships only a Windows .exe and publishes no numbers.
//
// Estimator semantics follow SURVEY.md §2's inventory including the quirks
// (so fidelity comparisons against the JAX renderer in "ref" mode are
// apples-to-apples):
//   - NEE per light with prefix-area CDF pick; pick range = FIRST light's
//     total area (the reference's static-distribution quirk)
//   - light point via three normalized uniforms (non-uniform over area)
//   - shadow visibility = closest-hit material equals the light material
//   - Phong BRDF Kd/pi + Ks (Ns+2)/(2pi) cos^Ns(alpha) with half-vector
//   - Russian roulette P=0.8; indirect weight Kd for DIFFUSE and SPECULAR,
//     Tr for TRANSMISSION; emissive hits excluded for D/S
//   - Schlick Fresnel + refraction when Ni > 1, TIR -> mirror
//   - intersection epsilons: t >= 5e-4, |N.d| >= 1e-5; emissive preferred
//     on equal-distance ties
//   - BVH: SAH over centroid-sorted ranges, leaf <= 8, AABB pad 1e-3
//
// Differences from the reference implementation (deliberate, documented):
//   SoA scene layout, iterative stackless traversal, per-thread
//   counter-free RNG (one engine per thread — the reference SHARES one
//   engine across threads, a data race), per-pixel OpenMP with per-thread
//   accumulators instead of the racy shared image sum.
//
// Build:  g++ -O3 -march=native -fopenmp -std=c++17 cpu_reference.cc -o cpu_ref
// Usage:  ./cpu_ref WIDTH HEIGHT SPP [out.ppm]   (cornell box built in)

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <random>
#include <sstream>
#include <string>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct V3 {
  float x = 0, y = 0, z = 0;
};
inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
inline V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float len(V3 a) { return std::sqrt(dot(a, a)); }
inline V3 norm(V3 a) {
  float l = len(a);
  return l > 0 ? a * (1.0f / l) : a;
}

constexpr float kTMin = 5e-4f;
constexpr float kGraze = 1e-5f;
constexpr float kPRR = 0.8f;
constexpr int kDiffuse = 0, kSpecular = 1, kTransmission = 2, kInvalid = 3;

struct Mat {
  V3 kd, ks, tr, radiance;
  float ns = 1, ni = 1;
  bool emissive = false;
};

struct Tri {
  V3 a, b, c;     // vertices
  V3 na, nb, nc;  // shading normals
  V3 gn;          // geometric normal
  int mtl = 0;
  bool emissive = false;
};

struct SceneCPU {
  std::vector<Tri> tris;
  std::vector<Mat> mats;
  // lights: id -> (mtl, triangle ids, prefix areas)
  struct LightT {
    int mtl;
    std::vector<int> ids;
    std::vector<double> prefix;
    double area = 0;
  };
  std::vector<LightT> lights;
  double first_light_area = 0;
};

// ------------------------------------------------------------ BVH
struct Node {
  V3 lo, hi;
  int32_t start = 0, count = 0, skip = 0;
};

struct BVH {
  std::vector<Node> nodes;
  std::vector<int> order;  // triangle permutation, leaf-contiguous
};

void build_bvh(const SceneCPU& sc, BVH* out, int leaf = 8, float pad = 1e-3f) {
  const int n = (int)sc.tris.size();
  std::vector<V3> lo(n), hi(n);
  std::vector<double> cx(n), cy(n), cz(n);
  for (int i = 0; i < n; ++i) {
    const Tri& t = sc.tris[i];
    lo[i] = {std::min({t.a.x, t.b.x, t.c.x}), std::min({t.a.y, t.b.y, t.c.y}),
             std::min({t.a.z, t.b.z, t.c.z})};
    hi[i] = {std::max({t.a.x, t.b.x, t.c.x}), std::max({t.a.y, t.b.y, t.c.y}),
             std::max({t.a.z, t.b.z, t.c.z})};
    cx[i] = (double(t.a.x) + t.b.x + t.c.x) / 3;
    cy[i] = (double(t.a.y) + t.b.y + t.c.y) / 3;
    cz[i] = (double(t.a.z) + t.b.z + t.c.z) / 3;
  }
  std::vector<int> ord[3];
  for (int a = 0; a < 3; ++a) {
    ord[a].resize(n);
    for (int i = 0; i < n; ++i) ord[a][i] = i;
    const double* k = a == 0 ? cx.data() : a == 1 ? cy.data() : cz.data();
    std::stable_sort(ord[a].begin(), ord[a].end(),
                     [k](int x, int y) { return k[x] < k[y]; });
  }
  std::vector<char> inl(n);
  std::vector<int> scratch(n);
  std::vector<V3> plo(n), phi(n), slo(n), shi(n);

  struct F {
    int l, r, node;
    bool post;
  };
  std::vector<F> st{{0, n - 1, -1, false}};
  while (!st.empty()) {
    F f = st.back();
    st.pop_back();
    if (f.post) {
      out->nodes[f.node].skip = (int32_t)out->nodes.size();
      continue;
    }
    int id = (int)out->nodes.size();
    out->nodes.push_back({});
    Node& nd = out->nodes.back();
    nd.lo = lo[ord[0][f.l]];
    nd.hi = hi[ord[0][f.l]];
    for (int i = f.l + 1; i <= f.r; ++i) {
      const V3 &a = lo[ord[0][i]], &b = hi[ord[0][i]];
      nd.lo = {std::min(nd.lo.x, a.x), std::min(nd.lo.y, a.y), std::min(nd.lo.z, a.z)};
      nd.hi = {std::max(nd.hi.x, b.x), std::max(nd.hi.y, b.y), std::max(nd.hi.z, b.z)};
    }
    nd.lo = nd.lo - V3{pad, pad, pad};
    nd.hi = nd.hi + V3{pad, pad, pad};
    st.push_back({0, 0, id, true});

    int m = f.r - f.l + 1;
    if (m <= leaf) {
      nd.start = (int32_t)out->order.size();
      nd.count = m;
      for (int i = f.l; i <= f.r; ++i) out->order.push_back(ord[0][i]);
      continue;
    }
    double best = 1e300;
    int bax = 0, bnl = m / 2;
    for (int a = 0; a < 3; ++a) {
      plo[0] = lo[ord[a][f.l]];
      phi[0] = hi[ord[a][f.l]];
      for (int i = 1; i < m; ++i) {
        const V3 &x = lo[ord[a][f.l + i]], &y = hi[ord[a][f.l + i]];
        plo[i] = {std::min(plo[i - 1].x, x.x), std::min(plo[i - 1].y, x.y), std::min(plo[i - 1].z, x.z)};
        phi[i] = {std::max(phi[i - 1].x, y.x), std::max(phi[i - 1].y, y.y), std::max(phi[i - 1].z, y.z)};
      }
      slo[m - 1] = lo[ord[a][f.r]];
      shi[m - 1] = hi[ord[a][f.r]];
      for (int i = m - 2; i >= 0; --i) {
        const V3 &x = lo[ord[a][f.l + i]], &y = hi[ord[a][f.l + i]];
        slo[i] = {std::min(slo[i + 1].x, x.x), std::min(slo[i + 1].y, x.y), std::min(slo[i + 1].z, x.z)};
        shi[i] = {std::max(shi[i + 1].x, y.x), std::max(shi[i + 1].y, y.y), std::max(shi[i + 1].z, y.z)};
      }
      auto sa = [](V3 a, V3 b) {
        double dx = b.x - a.x, dy = b.y - a.y, dz = b.z - a.z;
        return 2.0 * (dx * dy + dx * dz + dy * dz);
      };
      for (int i = 0; i < m - 1; ++i) {
        double c = sa(plo[i], phi[i]) * (i + 1) + sa(slo[i + 1], shi[i + 1]) * (m - 1 - i);
        if (c < best) {
          best = c;
          bax = a;
          bnl = i + 1;
        }
      }
    }
    for (int i = f.l; i <= f.r; ++i) inl[ord[bax][i]] = (i < f.l + bnl);
    for (int o = 0; o < 3; ++o) {
      if (o == bax) continue;
      int ia = 0, ib = 0;
      for (int i = f.l; i <= f.r; ++i) {
        if (inl[ord[o][i]])
          scratch[ia++] = ord[o][i];
        else
          scratch[bnl + ib++] = ord[o][i];
      }
      std::memcpy(&ord[o][f.l], scratch.data(), sizeof(int) * m);
    }
    st.push_back({f.l + bnl, f.r, -1, false});
    st.push_back({f.l, f.l + bnl - 1, -1, false});
  }
}

// ------------------------------------------------------------ intersection
struct HitR {
  float t = 3e38f;
  int tri = -1;
  float u = 0, v = 0;
  bool emissive = false;
};

// Relative band treated as "equal distance" for the emissive tie
// preference. The original reference's plane-equation test produces
// bitwise-identical t for coplanar axis-aligned quads (so its exact
// equality check works); Moller-Trumbore arithmetic differs per triangle,
// so the band makes the tie-break robust (mirrors config.tie_eps in the
// JAX renderer).
constexpr float kTieEps = 4e-6f;

inline bool hit_tri(const Tri& tr, V3 o, V3 d, float* t, float* u, float* v) {
  if (std::fabs(dot(tr.gn, d)) < kGraze) return false;
  V3 e1 = tr.b - tr.a, e2 = tr.c - tr.a;
  V3 p = cross(d, e2);
  float det = dot(e1, p);
  if (det == 0) return false;
  float inv = 1.0f / det;
  V3 tv = o - tr.a;
  float uu = dot(tv, p) * inv;
  if (uu < 0 || uu > 1) return false;
  V3 q = cross(tv, e1);
  float vv = dot(d, q) * inv;
  if (vv < 0 || uu + vv > 1) return false;
  float tt = dot(e2, q) * inv;
  if (tt < kTMin) return false;
  *t = tt;
  *u = uu;
  *v = vv;
  return true;
}

HitR closest_hit(const SceneCPU& sc, const BVH& bvh, V3 o, V3 d) {
  HitR best;
  V3 inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  int i = 0;
  const int n = (int)bvh.nodes.size();
  while (i < n) {
    const Node& nd = bvh.nodes[i];
    float tx0 = (nd.lo.x - o.x) * inv.x, tx1 = (nd.hi.x - o.x) * inv.x;
    float ty0 = (nd.lo.y - o.y) * inv.y, ty1 = (nd.hi.y - o.y) * inv.y;
    float tz0 = (nd.lo.z - o.z) * inv.z, tz1 = (nd.hi.z - o.z) * inv.z;
    float t0 = std::max({std::min(tx0, tx1), std::min(ty0, ty1), std::min(tz0, tz1)});
    float t1 = std::min({std::max(tx0, tx1), std::max(ty0, ty1), std::max(tz0, tz1)});
    bool hit = t1 >= t0 && (t0 > 0 ? t0 : t1) > 0 &&
               std::max(t0, 0.0f) <= best.t * (1 + kTieEps);
    if (!hit) {
      i = nd.skip;
      continue;
    }
    if (nd.count > 0) {
      for (int k = 0; k < nd.count; ++k) {
        int ti = bvh.order[nd.start + k];
        float t, u, v;
        if (hit_tri(sc.tris[ti], o, d, &t, &u, &v)) {
          bool em = sc.tris[ti].emissive;
          bool near = t <= best.t * (1 + kTieEps) && best.t <= t * (1 + kTieEps);
          if ((!near && t < best.t) || (near && em && !best.emissive)) {
            best = {t, ti, u, v, em};
          }
        }
      }
      i = nd.skip;
    } else {
      i = i + 1;
    }
  }
  return best;
}

// ------------------------------------------------------------ shading
struct Rng {
  std::mt19937 eng;
  std::uniform_real_distribution<float> uni{0.0f, 1.0f};
  explicit Rng(uint64_t seed) : eng(seed) {}
  float operator()() { return uni(eng); }
};

V3 sample_lobe(V3 axis, int type, float ns, Rng& rng) {
  float phi = rng() * 2.0f * float(M_PI);
  float theta = type == kDiffuse
                    ? std::asin(std::sqrt(rng()))
                    : std::acos(std::pow(rng(), 1.0f / (ns + 1.0f)));
  V3 s{std::sin(theta) * std::cos(phi), std::cos(theta), std::sin(theta) * std::sin(phi)};
  V3 front = std::fabs(axis.x) > std::fabs(axis.y)
                 ? norm(V3{axis.z, 0, -axis.x})
                 : norm(V3{0, -axis.z, axis.y});
  V3 right = cross(axis, front);
  return norm(right * s.x + axis * s.y + front * s.z);
}

V3 reflectv(V3 d, V3 n) { return d - n * (2.0f * dot(d, n)); }

struct PathStats {
  uint64_t rays = 0;
};

V3 shade(const SceneCPU& sc, const BVH& bvh, const HitR& h, V3 wi, Rng& rng,
         PathStats* ps, int depth) {
  const Tri& tr = sc.tris[h.tri];
  const Mat& m = sc.mats[tr.mtl];
  if (tr.emissive) return m.radiance;
  if (depth > 256) return {};  // hard safety net (RR terminates in practice)

  float w = 1.0f - h.u - h.v;
  V3 pn = norm(tr.na * w + tr.nb * h.u + tr.nc * h.v);
  V3 p;  // hitpoint reconstructed from barycentrics
  p = tr.a * w + tr.b * h.u + tr.c * h.v;
  V3 kd = m.kd;

  V3 L{};
  // ---- next-event estimation per light
  for (const auto& light : sc.lights) {
    double rnd = rng() * sc.first_light_area;  // reference's static-range quirk
    if (rnd >= light.area) continue;
    size_t pick = std::lower_bound(light.prefix.begin(), light.prefix.end(), rnd,
                                   [](double a, double b) { return a <= b; }) -
                  light.prefix.begin();
    if (pick >= light.ids.size()) continue;
    const Tri& lt = sc.tris[light.ids[pick]];
    float u1 = rng(), u2 = rng(), u3 = rng();
    float s = u1 + u2 + u3;
    float p1 = u1 / s, p2 = u2 / s, p3 = u3 / s;
    V3 lp = lt.a * p1 + lt.b * p2 + lt.c * p3;
    V3 ln = norm(lt.na * p1 + lt.nb * p2 + lt.nc * p3);
    V3 wo = norm(lp - p);
    ps->rays++;
    HitR sh = closest_hit(sc, bvh, p, wo);
    bool visible = sh.tri >= 0 && sc.tris[sh.tri].mtl == light.mtl;
    if (visible && dot(wo, pn) > 0) {
      V3 dl = lp - p;
      float r2 = dot(dl, dl);
      float cos_p = std::fabs(dot(wo, ln));
      float cos_t = std::fabs(dot(wo, pn));
      V3 inten = sc.mats[light.mtl].radiance * (cos_p * cos_t / r2 * float(light.area));
      V3 hvec = norm(wi + wo);
      float ca = std::max(dot(pn, hvec), 0.0f);
      V3 brdf = kd * (1.0f / float(M_PI)) +
                m.ks * ((m.ns + 2.0f) * std::pow(ca, m.ns) / (2.0f * float(M_PI)));
      L = L + inten * brdf;
    }
  }

  // ---- Russian roulette + next bounce
  if (rng() < kPRR) {
    V3 d = -wi;
    V3 nd{};
    int type = kInvalid;
    if (m.ni > 1.0f) {
      float ci = dot(d, pn);
      V3 nn = ci > 0 ? -pn : pn;
      float n1 = ci > 0 ? m.ni : 1.0f, n2 = ci > 0 ? 1.0f : m.ni;
      float rf0 = (n1 - n2) / (n1 + n2);
      rf0 *= rf0;
      float fres = rf0 + (1 - rf0) * std::pow(1 - std::fabs(ci), 5.0f);
      if (fres < rng()) {
        float eta = n1 / n2;
        float cosi = dot(nn, d);
        float k = 1 - eta * eta * (1 - cosi * cosi);
        if (k >= 0) {
          nd = d * eta - nn * (eta * cosi + std::sqrt(k));
          type = kTransmission;
        } else {
          nd = reflectv(d, nn);
          type = kSpecular;
        }
      }
    }
    if (type == kInvalid) {
      float kl = len(m.kd), sl = len(m.ks);
      float tot = kl + sl;
      float pu = rng();
      if (tot > 0 && pu < kl / tot) {
        nd = sample_lobe(pn, kDiffuse, m.ns, rng);
        type = kDiffuse;
      } else if (tot > 0 && m.ns > 1 && pu < 1.0f) {
        nd = sample_lobe(reflectv(d, pn), kSpecular, m.ns, rng);
        type = kSpecular;
      }
    }
    if (type != kInvalid) {
      ps->rays++;
      HitR nh = closest_hit(sc, bvh, p, nd);
      if (nh.tri >= 0) {
        bool emis = sc.tris[nh.tri].emissive;
        if (type == kTransmission || !emis) {
          V3 inten = shade(sc, bvh, nh, -nd, rng, ps, depth + 1) * (1.0f / kPRR);
          V3 wgt = type == kTransmission ? m.tr : kd;  // SPECULAR uses Kd (quirk)
          L = L + wgt * inten;
        }
      }
    }
  }
  return L;
}

// ------------------------------------------------------------ scene: cornell
void make_cornell(SceneCPU* sc) {
  auto quad = [&](V3 a, V3 b, V3 c, V3 d, int mtl) {
    V3 gn = norm(cross(b - a, c - a));
    bool e = sc->mats[mtl].emissive;
    sc->tris.push_back({a, b, c, gn, gn, gn, gn, mtl, e});
    gn = norm(cross(c - a, d - a));
    sc->tris.push_back({a, c, d, gn, gn, gn, gn, mtl, e});
  };
  Mat white;
  white.kd = {0.79f, 0.76f, 0.73f};
  white.tr = {1, 1, 1};
  Mat blue = white;
  blue.kd = {0.0f, 0.24f, 0.9f};
  Mat green = white;
  green.kd = {0.2f, 0.76f, 0.0f};
  Mat light;
  light.emissive = true;
  light.radiance = {34, 24, 8};
  light.tr = {1, 1, 1};
  sc->mats = {white, blue, green, light};  // 0 white, 1 left/blue, 2 right/green, 3 light

  quad({552.8f, 0, 0}, {0, 0, 0}, {0, 0, 559.2f}, {549.6f, 0, 559.2f}, 0);
  quad({343, 548.8f, 227}, {343, 548.8f, 332}, {213, 548.8f, 332}, {213, 548.8f, 227}, 3);
  quad({556, 548.8f, 0}, {556, 548.8f, 559.2f}, {0, 548.8f, 559.2f}, {0, 548.8f, 0}, 0);
  quad({549.6f, 0, 559.2f}, {0, 0, 559.2f}, {0, 548.8f, 559.2f}, {556, 548.8f, 559.2f}, 0);
  quad({0, 0, 559.2f}, {0, 0, 0}, {0, 548.8f, 0}, {0, 548.8f, 559.2f}, 2);
  quad({552.8f, 0, 0}, {549.6f, 0, 559.2f}, {556, 548.8f, 559.2f}, {556, 548.8f, 0}, 1);
  // short block
  quad({130, 165, 65}, {82, 165, 225}, {240, 165, 272}, {290, 165, 114}, 0);
  quad({290, 0, 114}, {290, 165, 114}, {240, 165, 272}, {240, 0, 272}, 0);
  quad({130, 0, 65}, {130, 165, 65}, {290, 165, 114}, {290, 0, 114}, 0);
  quad({82, 0, 225}, {82, 165, 225}, {130, 165, 65}, {130, 0, 65}, 0);
  quad({240, 0, 272}, {240, 165, 272}, {82, 165, 225}, {82, 0, 225}, 0);
  // tall block
  quad({423, 330, 247}, {265, 330, 296}, {314, 330, 456}, {472, 330, 406}, 0);
  quad({423, 0, 247}, {423, 330, 247}, {472, 330, 406}, {472, 0, 406}, 0);
  quad({472, 0, 406}, {472, 330, 406}, {314, 330, 456}, {314, 0, 456}, 0);
  quad({314, 0, 456}, {314, 330, 456}, {265, 330, 296}, {265, 0, 296}, 0);
  quad({265, 0, 296}, {265, 330, 296}, {423, 330, 247}, {423, 0, 247}, 0);

  SceneCPU::LightT lt;
  lt.mtl = 3;
  double acc = 0;
  for (int i = 0; i < (int)sc->tris.size(); ++i) {
    if (sc->tris[i].mtl == 3) {
      const Tri& t = sc->tris[i];
      acc += 0.5 * len(cross(t.b - t.a, t.c - t.a));
      lt.ids.push_back(i);
      lt.prefix.push_back(acc);
    }
  }
  lt.area = acc;
  sc->lights.push_back(lt);
  sc->first_light_area = acc;
}

// ------------------------------------------------ scene files (xml/obj/mtl)
// Minimal hand-rolled loaders for the course scene formats (see
// example-scenes-cg22/README.md in the reference repo). Semantics follow the
// reference loaders (RayTracingOnCPU/scene.cpp): xml marks light materials
// emissive BEFORE the obj parse; the obj 'f a/b/c' second/third slot layout
// uses the isvnvt heuristic (any 'vt' before the first 'vn' means v/vt);
// mtl handles Kd/Ks/Tr/Ns/Ni and IGNORES Kt (test/back.mtl quirk) and
// map_Kd (textures out of scope for the estimator cross-check — none of the
// cross-checked scenes use them).

struct CamCfg {
  V3 eye{278, 273, -800}, lookat{278, 273, -799}, up{0, 1, 0};
  float fovy = 39.3077f;
  int w = 256, h = 256;
};

struct SceneBuild {
  std::map<std::string, int> mat_id;
  std::vector<std::string> light_mtls;  // XML order
  int id(SceneCPU* sc, const std::string& name) {
    auto it = mat_id.find(name);
    if (it != mat_id.end()) return it->second;
    int i = (int)sc->mats.size();
    sc->mats.push_back(Mat{});
    mat_id.emplace(name, i);
    return i;
  }
};

static std::string attr(const std::string& tag, const char* key) {
  std::string pat = std::string(key) + "=\"";
  size_t p = tag.find(pat);
  if (p == std::string::npos) return "";
  p += pat.size();
  size_t q = tag.find('"', p);
  return tag.substr(p, q - p);
}

bool load_xml(const char* path, SceneCPU* sc, SceneBuild* b, CamCfg* cam) {
  std::ifstream f(path);
  if (!f) return false;
  std::stringstream ss;
  ss << f.rdbuf();
  std::string s = ss.str();
  // camera element + its children
  size_t cpos = s.find("<camera");
  if (cpos != std::string::npos) {
    std::string ctag = s.substr(cpos, s.find('>', cpos) - cpos);
    if (!attr(ctag, "width").empty()) cam->w = std::atoi(attr(ctag, "width").c_str());
    if (!attr(ctag, "height").empty()) cam->h = std::atoi(attr(ctag, "height").c_str());
    if (!attr(ctag, "fovy").empty()) cam->fovy = std::atof(attr(ctag, "fovy").c_str());
    for (const char* key : {"eye", "lookat", "up"}) {
      size_t p = s.find(std::string("<") + key, cpos);
      if (p == std::string::npos) continue;
      std::string tag = s.substr(p, s.find('>', p) - p);
      V3 v{(float)std::atof(attr(tag, "x").c_str()),
           (float)std::atof(attr(tag, "y").c_str()),
           (float)std::atof(attr(tag, "z").c_str())};
      if (!std::strcmp(key, "eye")) cam->eye = v;
      else if (!std::strcmp(key, "lookat")) cam->lookat = v;
      else cam->up = v;
    }
  }
  // lights: mark materials emissive with their radiance (reference order:
  // xml BEFORE obj so readobj sees the emissive flags)
  for (size_t p = s.find("<light"); p != std::string::npos;
       p = s.find("<light", p + 1)) {
    std::string tag = s.substr(p, s.find('>', p) - p);
    std::string name = attr(tag, "mtlname");
    std::string rad = attr(tag, "radiance");
    if (name.empty()) continue;
    V3 r{};
    std::sscanf(rad.c_str(), "%f , %f , %f", &r.x, &r.y, &r.z);
    int m = b->id(sc, name);
    sc->mats[m].emissive = true;
    sc->mats[m].radiance = r;
    b->light_mtls.push_back(name);
  }
  return true;
}

bool load_obj(const char* path, SceneCPU* sc, SceneBuild* b) {
  std::ifstream f(path);
  if (!f) return false;
  std::vector<V3> vs, vns, vts;
  bool seen_vn = false, isvnvt = true;
  int cur = -1;
  std::string line;
  while (std::getline(f, line)) {
    std::istringstream is(line);
    std::string k;
    is >> k;
    if (k == "v") {
      V3 v;
      is >> v.x >> v.y >> v.z;
      vs.push_back(v);
    } else if (k == "vn") {
      V3 v;
      is >> v.x >> v.y >> v.z;
      vns.push_back(v);
      seen_vn = true;
    } else if (k == "vt") {
      V3 v;
      is >> v.x >> v.y;
      vts.push_back(v);
      if (!seen_vn) isvnvt = false;  // vt before first vn -> 'f v/vt' layout
    } else if (k == "usemtl") {
      std::string name;
      is >> name;
      cur = b->id(sc, name);
    } else if (k == "f") {
      int vi[3] = {0, 0, 0}, ni[3] = {0, 0, 0};
      for (int t = 0; t < 3; ++t) {
        std::string w;
        if (!(is >> w)) return false;
        // a/b/c -> slot meanings depend on isvnvt (reference heuristic):
        // isvnvt: a=v, b=vn, c=vt;  !isvnvt: a=v, b=vt, c=vn
        int a = 0, bb = 0, c = 0;
        std::sscanf(w.c_str(), "%d/%d/%d", &a, &bb, &c);
        vi[t] = a;
        ni[t] = isvnvt ? bb : c;
      }
      Tri tr;
      tr.a = vs[vi[0] - 1];
      tr.b = vs[vi[1] - 1];
      tr.c = vs[vi[2] - 1];
      tr.gn = norm(cross(tr.b - tr.a, tr.c - tr.a));
      tr.na = ni[0] > 0 ? vns[ni[0] - 1] : tr.gn;
      tr.nb = ni[1] > 0 ? vns[ni[1] - 1] : tr.gn;
      tr.nc = ni[2] > 0 ? vns[ni[2] - 1] : tr.gn;
      tr.mtl = cur < 0 ? b->id(sc, "default") : cur;
      tr.emissive = sc->mats[tr.mtl].emissive;
      sc->tris.push_back(tr);
    }
  }
  // light tables in XML order; NEE draw range = FIRST light's total area
  // (the reference's static-distribution quirk)
  for (const std::string& name : b->light_mtls) {
    SceneCPU::LightT lt;
    lt.mtl = b->mat_id[name];
    double acc = 0;
    for (int i = 0; i < (int)sc->tris.size(); ++i) {
      if (sc->tris[i].mtl == lt.mtl) {
        const Tri& t = sc->tris[i];
        acc += 0.5 * len(cross(t.b - t.a, t.c - t.a));
        lt.ids.push_back(i);
        lt.prefix.push_back(acc);
      }
    }
    lt.area = acc;
    if (sc->lights.empty()) sc->first_light_area = acc;
    sc->lights.push_back(lt);
  }
  return true;
}

bool load_mtl(const char* path, SceneCPU* sc, SceneBuild* b) {
  std::ifstream f(path);
  if (!f) return false;
  int cur = -1;
  std::string line;
  while (std::getline(f, line)) {
    std::istringstream is(line);
    std::string k;
    is >> k;
    if (k == "newmtl") {
      std::string name;
      is >> name;
      cur = b->id(sc, name);
    } else if (cur >= 0 && (k == "Kd" || k == "Ks" || k == "Tr")) {
      V3 v;
      is >> v.x >> v.y >> v.z;
      if (k == "Kd") sc->mats[cur].kd = v;
      else if (k == "Ks") sc->mats[cur].ks = v;
      else sc->mats[cur].tr = v;
    } else if (cur >= 0 && k == "Ns") {
      is >> sc->mats[cur].ns;
    } else if (cur >= 0 && k == "Ni") {
      is >> sc->mats[cur].ni;
    }
    // Kt / map_Kd intentionally ignored (reference parser quirk / no
    // textures in the cross-checked scenes)
  }
  return true;
}

}  // namespace

int main(int argc, char** argv) {
  // usage:
  //   ./cpu_ref [W H SPP [out.ppm]]                      built-in cornell
  //   ./cpu_ref --scene XML OBJ MTL SPP [out.ppm [W H]]  scene files
  SceneCPU sc;
  CamCfg cc;
  int W, H, spp;
  const char* out = nullptr;
  if (argc > 1 && !std::strcmp(argv[1], "--scene")) {
    if (argc < 6) {
      std::fprintf(stderr, "--scene needs XML OBJ MTL SPP\n");
      return 2;
    }
    SceneBuild b;
    // reference load order xml -> obj -> mtl (scene.cpp comment in main.cpp:66)
    if (!load_xml(argv[2], &sc, &b, &cc) || !load_obj(argv[3], &sc, &b) ||
        !load_mtl(argv[4], &sc, &b)) {
      std::fprintf(stderr, "failed to load scene files\n");
      return 2;
    }
    spp = std::atoi(argv[5]);
    out = argc > 6 ? argv[6] : nullptr;
    W = argc > 7 ? std::atoi(argv[7]) : cc.w;
    H = argc > 8 ? std::atoi(argv[8]) : cc.h;
  } else {
    W = argc > 1 ? std::atoi(argv[1]) : 256;
    H = argc > 2 ? std::atoi(argv[2]) : 256;
    spp = argc > 3 ? std::atoi(argv[3]) : 64;
    out = argc > 4 ? argv[4] : nullptr;
    make_cornell(&sc);
  }
  BVH bvh;
  build_bvh(sc, &bvh);

  V3 eye = cc.eye, lookat = cc.lookat, up = cc.up;
  float fovy = cc.fovy;
  float hh = std::tan(fovy * float(M_PI) / 180 / 2);
  float vh = 2 * hh, vw = vh * float(W) / float(H);
  V3 cw = norm(eye - lookat);
  V3 cu = norm(cross(up, cw));
  V3 cv = cross(cw, cu);
  V3 horiz = cu * vw, vert = cv * vh;
  V3 llc = eye - horiz * 0.5f - vert * 0.5f - cw;

  std::vector<double> img(size_t(W) * H * 3, 0.0);
  uint64_t total_rays = 0;
  auto t0 = std::chrono::steady_clock::now();

#ifdef _OPENMP
#pragma omp parallel reduction(+ : total_rays)
#endif
  {
#ifdef _OPENMP
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    Rng rng(0x9e3779b97f4a7c15ull + tid);
    PathStats ps;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 4)
#endif
    for (int i = 0; i < H; ++i) {
      for (int j = 0; j < W; ++j) {
        V3 acc{};
        for (int s = 0; s < spp; ++s) {
          float x = float(j) / (W - 1.0f) + (rng() - 0.5f) / W;
          float y = float(H - i) / (H - 1.0f) + (rng() - 0.5f) / H;
          V3 d = norm(llc + horiz * x + vert * y - eye);
          ps.rays++;
          HitR h = closest_hit(sc, bvh, eye, d);
          if (h.tri >= 0) acc = acc + shade(sc, bvh, h, -d, rng, &ps, 0);
        }
        size_t px = (size_t(i) * W + j) * 3;
        img[px + 0] += acc.x / spp;
        img[px + 1] += acc.y / spp;
        img[px + 2] += acc.z / spp;
      }
    }
    total_rays += ps.rays;
  }

  auto t1 = std::chrono::steady_clock::now();
  double dt = std::chrono::duration<double>(t1 - t0).count();
  // machine-readable result line consumed by run_cpu_baseline.py
  std::printf("{\"width\": %d, \"height\": %d, \"spp\": %d, \"seconds\": %.4f, "
              "\"rays\": %llu, \"rays_per_s\": %.1f}\n",
              W, H, spp, dt, (unsigned long long)total_rays, total_rays / dt);

  if (out) {
    FILE* f = std::fopen(out, "wb");
    std::fprintf(f, "P6\n%d %d\n255\n", W, H);
    for (size_t k = 0; k < img.size(); ++k) {
      double g = std::pow(std::max(img[k], 0.0), 1.0 / 2.2) * 255.0;
      unsigned char c = (unsigned char)std::min(std::max(g, 0.0), 255.0);
      std::fwrite(&c, 1, 1, f);
    }
    std::fclose(f);
  }
  return 0;
}
