// Software raycasting renderer for primitive-geom scenes.
//
// Evaluation videos and debug views are rendered on the host by this
// dependency-free C++ rasterizer over the engine's geom states: no GL
// context is needed (the reference renders through dm_control's EGL/GL
// path, vnl_ray environment.yml:22-27). The JAX package carries the same
// source (flybody_tpu/native/rasterizer.cpp); the port keeps its own copy.
//
// C ABI, driven via ctypes (flybody_tpu_torch/utils/rendering.py), which
// builds it with g++ on first use into flybody_tpu_torch/_build/.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 v3(float x, float y, float z) { return {x, y, z}; }
inline Vec3 operator+(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 operator*(float s, Vec3 a) { return {s * a.x, s * a.y, s * a.z}; }
inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline float norm(Vec3 a) { return std::sqrt(dot(a, a)); }
inline Vec3 normalize(Vec3 a) {
  float n = norm(a);
  return n > 1e-12f ? (1.0f / n) * a : v3(0, 0, 1);
}

// geom types (MuJoCo codes)
constexpr int kPlane = 0, kSphere = 2, kCapsule = 3, kEllipsoid = 4,
              kCylinder = 5, kBox = 6;

struct Hit {
  float t;
  Vec3 normal;
  int geom;
};

// Rotate world vector into geom frame (mat is row-major 3x3, local->world).
inline Vec3 to_local(const float* mat, Vec3 v) {
  return {mat[0] * v.x + mat[3] * v.y + mat[6] * v.z,
          mat[1] * v.x + mat[4] * v.y + mat[7] * v.z,
          mat[2] * v.x + mat[5] * v.y + mat[8] * v.z};
}
inline Vec3 to_world(const float* mat, Vec3 v) {
  return {mat[0] * v.x + mat[1] * v.y + mat[2] * v.z,
          mat[3] * v.x + mat[4] * v.y + mat[5] * v.z,
          mat[6] * v.x + mat[7] * v.y + mat[8] * v.z};
}

bool intersect_sphere_local(Vec3 o, Vec3 d, float r, float* t, Vec3* n) {
  float b = dot(o, d);
  float c = dot(o, o) - r * r;
  float disc = b * b - c;
  if (disc < 0) return false;
  float tt = -b - std::sqrt(disc);
  if (tt < 1e-5f) return false;
  *t = tt;
  *n = normalize(o + tt * d);
  return true;
}

bool intersect_geom(int type, const float* pos, const float* mat,
                    const float* size, Vec3 ro, Vec3 rd, Hit* hit) {
  Vec3 p = v3(pos[0], pos[1], pos[2]);
  Vec3 o = to_local(mat, ro - p);
  Vec3 d = to_local(mat, rd);
  float t;
  Vec3 n_local;
  switch (type) {
    case kPlane: {
      if (std::fabs(d.z) < 1e-9f) return false;
      t = -o.z / d.z;
      if (t < 1e-5f) return false;
      n_local = v3(0, 0, 1);
      break;
    }
    case kSphere: {
      if (!intersect_sphere_local(o, d, size[0], &t, &n_local)) return false;
      break;
    }
    case kCapsule: {
      // segment along z, half-length size[1], radius size[0]
      float r = size[0], h = size[1];
      // infinite cylinder first
      float a = d.x * d.x + d.y * d.y;
      bool found = false;
      t = 1e30f;
      if (a > 1e-12f) {
        float b = o.x * d.x + o.y * d.y;
        float c = o.x * o.x + o.y * o.y - r * r;
        float disc = b * b - a * c;
        if (disc >= 0) {
          float tt = (-b - std::sqrt(disc)) / a;
          float z = o.z + tt * d.z;
          if (tt > 1e-5f && std::fabs(z) <= h) {
            t = tt;
            n_local = normalize(v3(o.x + tt * d.x, o.y + tt * d.y, 0));
            found = true;
          }
        }
      }
      for (float zc : {-h, h}) {
        float tc;
        Vec3 nc;
        Vec3 oc = o - v3(0, 0, zc);
        if (intersect_sphere_local(oc, d, r, &tc, &nc) && tc < t) {
          float z = o.z + tc * d.z;
          if ((zc < 0 && z <= -h) || (zc > 0 && z >= h)) {
            t = tc;
            n_local = nc;
            found = true;
          }
        }
      }
      if (!found) return false;
      break;
    }
    case kEllipsoid: {
      Vec3 inv = v3(1.0f / size[0], 1.0f / size[1], 1.0f / size[2]);
      Vec3 os = v3(o.x * inv.x, o.y * inv.y, o.z * inv.z);
      Vec3 ds = v3(d.x * inv.x, d.y * inv.y, d.z * inv.z);
      float a = dot(ds, ds), b = dot(os, ds), c = dot(os, os) - 1.0f;
      float disc = b * b - a * c;
      if (disc < 0) return false;
      t = (-b - std::sqrt(disc)) / a;
      if (t < 1e-5f) return false;
      Vec3 q = o + t * d;
      n_local = normalize(v3(q.x * inv.x * inv.x, q.y * inv.y * inv.y,
                             q.z * inv.z * inv.z));
      break;
    }
    case kCylinder: {
      float r = size[0], h = size[1];
      float a = d.x * d.x + d.y * d.y;
      bool found = false;
      t = 1e30f;
      if (a > 1e-12f) {
        float b = o.x * d.x + o.y * d.y;
        float c = o.x * o.x + o.y * o.y - r * r;
        float disc = b * b - a * c;
        if (disc >= 0) {
          float tt = (-b - std::sqrt(disc)) / a;
          float z = o.z + tt * d.z;
          if (tt > 1e-5f && std::fabs(z) <= h) {
            t = tt;
            n_local = normalize(v3(o.x + tt * d.x, o.y + tt * d.y, 0));
            found = true;
          }
        }
      }
      // caps
      for (float zc : {-h, h}) {
        if (std::fabs(d.z) < 1e-9f) continue;
        float tt = (zc - o.z) / d.z;
        if (tt < 1e-5f || tt >= t) continue;
        float x = o.x + tt * d.x, y = o.y + tt * d.y;
        if (x * x + y * y <= r * r) {
          t = tt;
          n_local = v3(0, 0, zc > 0 ? 1.0f : -1.0f);
          found = true;
        }
      }
      if (!found) return false;
      break;
    }
    case kBox: {
      Vec3 tmin_v, tmax_v;
      float tmin = -1e30f, tmax = 1e30f;
      int axis = 0;
      const float* sz = size;
      float oo[3] = {o.x, o.y, o.z};
      float dd[3] = {d.x, d.y, d.z};
      for (int i = 0; i < 3; ++i) {
        if (std::fabs(dd[i]) < 1e-9f) {
          if (std::fabs(oo[i]) > sz[i]) return false;
          continue;
        }
        float t1 = (-sz[i] - oo[i]) / dd[i];
        float t2 = (sz[i] - oo[i]) / dd[i];
        if (t1 > t2) std::swap(t1, t2);
        if (t1 > tmin) {
          tmin = t1;
          axis = i;
        }
        tmax = std::min(tmax, t2);
      }
      if (tmin > tmax || tmin < 1e-5f) return false;
      t = tmin;
      float sgn = (axis == 0 ? (d.x > 0 ? -1 : 1)
                             : axis == 1 ? (d.y > 0 ? -1 : 1)
                                         : (d.z > 0 ? -1 : 1));
      n_local = v3(axis == 0 ? sgn : 0, axis == 1 ? sgn : 0,
                   axis == 2 ? sgn : 0);
      (void)tmin_v;
      (void)tmax_v;
      break;
    }
    default:
      return false;
  }
  hit->t = t;
  hit->normal = to_world(mat, n_local);
  return true;
}

}  // namespace

extern "C" {

// Renders an RGB frame. All arrays row-major float32.
//   cam_pos[3], cam_mat[9] (camera frame: x right, y up, -z forward),
//   fovy degrees; geoms: types[n], pos[n*3], mat[n*9], size[n*3],
//   rgba[n*4]; out: rgb[h*w*3] uint8.
void render_rgb(const float* cam_pos, const float* cam_mat, float fovy,
                int width, int height, int ngeom, const int* types,
                const float* pos, const float* mat, const float* size,
                const float* rgba, uint8_t* out) {
  Vec3 eye = v3(cam_pos[0], cam_pos[1], cam_pos[2]);
  Vec3 right = v3(cam_mat[0], cam_mat[3], cam_mat[6]);
  Vec3 up = v3(cam_mat[1], cam_mat[4], cam_mat[7]);
  Vec3 fwd = v3(-cam_mat[2], -cam_mat[5], -cam_mat[8]);
  float tanv = std::tan(fovy * 3.14159265f / 360.0f);
  float aspect = float(width) / float(height);
  Vec3 light = normalize(v3(-0.3f, 0.4f, 1.0f));

  for (int py = 0; py < height; ++py) {
    for (int px = 0; px < width; ++px) {
      float u = (2.0f * (px + 0.5f) / width - 1.0f) * tanv * aspect;
      float v = (1.0f - 2.0f * (py + 0.5f) / height) * tanv;
      Vec3 rd = normalize(fwd + u * right + v * up);
      Hit best{1e30f, v3(0, 0, 1), -1};
      for (int g = 0; g < ngeom; ++g) {
        Hit h;
        if (intersect_geom(types[g], pos + 3 * g, mat + 9 * g, size + 3 * g,
                           eye, rd, &h) &&
            h.t < best.t) {
          best = h;
          best.geom = g;
        }
      }
      uint8_t* px_out = out + 3 * (py * width + px);
      if (best.geom < 0) {
        px_out[0] = 135;  // sky
        px_out[1] = 170;
        px_out[2] = 210;
        continue;
      }
      float diffuse = std::max(0.0f, dot(best.normal, light));
      float shade = 0.35f + 0.65f * diffuse;
      const float* col = rgba + 4 * best.geom;
      px_out[0] = uint8_t(std::min(255.0f, col[0] * shade * 255.0f));
      px_out[1] = uint8_t(std::min(255.0f, col[1] * shade * 255.0f));
      px_out[2] = uint8_t(std::min(255.0f, col[2] * shade * 255.0f));
    }
  }
}

// Depth-only render (for eye-camera validation).
void render_depth(const float* cam_pos, const float* cam_mat, float fovy,
                  int width, int height, int ngeom, const int* types,
                  const float* pos, const float* mat, const float* size,
                  float* out) {
  Vec3 eye = v3(cam_pos[0], cam_pos[1], cam_pos[2]);
  Vec3 right = v3(cam_mat[0], cam_mat[3], cam_mat[6]);
  Vec3 up = v3(cam_mat[1], cam_mat[4], cam_mat[7]);
  Vec3 fwd = v3(-cam_mat[2], -cam_mat[5], -cam_mat[8]);
  float tanv = std::tan(fovy * 3.14159265f / 360.0f);
  float aspect = float(width) / float(height);
  for (int py = 0; py < height; ++py) {
    for (int px = 0; px < width; ++px) {
      float u = (2.0f * (px + 0.5f) / width - 1.0f) * tanv * aspect;
      float v = (1.0f - 2.0f * (py + 0.5f) / height) * tanv;
      Vec3 rd = normalize(fwd + u * right + v * up);
      float t = 1e30f;
      for (int g = 0; g < ngeom; ++g) {
        Hit h;
        if (intersect_geom(types[g], pos + 3 * g, mat + 9 * g, size + 3 * g,
                           eye, rd, &h) &&
            h.t < t)
          t = h.t;
      }
      out[py * width + px] = t;
    }
  }
}

}  // extern "C"
