// Native host runtime for raytracing_tests_tpu_torch.
//
// The reference keeps its accelerator-structure builder and texture bakers
// in native code on the host (CPU LBVH: In-Next-Week/LBVH/lbvh.h; simplex
// noise + projection remap on 4 std::async threads: Utilities/utility.cpp).
// This library is the same architectural slot for the PyTorch package: a
// C-ABI .so loaded via ctypes, used for host-side scene preparation when the
// device is busy rendering.  The on-device torch builders remain the default
// compute path; these are the "runtime around it".
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread
//
// Exports:
//   rt_build_lbvh    — Morton-sorted Karras LBVH over object AABBs.
//   rt_noise_texture — simplex/FBM/turbulence texture baking, multithreaded.
//   rt_version       — ABI version tag.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

int rt_version() { return 1; }

// ---------------------------------------------------------------------------
// LBVH
// ---------------------------------------------------------------------------

// Expand the low 10 bits of v so there are two zero bits between each.
static inline uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

static inline uint32_t morton3d(float x, float y, float z) {
  auto q = [](float f) {
    f = f * 1024.0f;
    if (f < 0.0f) f = 0.0f;
    if (f > 1023.0f) f = 1023.0f;
    return (uint32_t)f;
  };
  return (expand_bits(q(x)) << 2) | (expand_bits(q(y)) << 1) | expand_bits(q(z));
}

struct Key {
  uint32_t code;
  float size;
  int32_t idx;
};

// Common-prefix metric with index tie-break (Karras 2012 §4).
static inline int delta(const std::vector<uint32_t>& codes, int i, int j, int n) {
  if (j < 0 || j >= n) return -1;
  uint32_t x = codes[i] ^ codes[j];
  if (x == 0) return 32 + __builtin_clz((uint32_t)(i ^ j));
  return __builtin_clz(x);
}

// Build a Karras LBVH. Inputs: per-object AABBs (n x 3 each). Outputs are
// preallocated by the caller: left/right/parent/obj_id are (2n-1,), node
// AABBs are (2n-1, 3). Layout matches bvh/build.py: internal nodes [0, n-2]
// with node 0 the root, leaf k at node (n-1)+k.
void rt_build_lbvh(const float* bb_min, const float* bb_max, int n,
                   int32_t* left, int32_t* right, int32_t* parent,
                   int32_t* obj_id, float* node_lo, float* node_hi) {
  // Scene bounds + centroids.
  float slo[3] = {1e30f, 1e30f, 1e30f}, shi[3] = {-1e30f, -1e30f, -1e30f};
  for (int i = 0; i < n; i++)
    for (int k = 0; k < 3; k++) {
      slo[k] = std::min(slo[k], bb_min[i * 3 + k]);
      shi[k] = std::max(shi[k], bb_max[i * 3 + k]);
    }
  float ext[3];
  for (int k = 0; k < 3; k++) ext[k] = std::max(shi[k] - slo[k], 1e-12f);

  std::vector<Key> keys(n);
  for (int i = 0; i < n; i++) {
    float c[3], size = 0.0f;
    for (int k = 0; k < 3; k++) {
      c[k] = ((bb_min[i * 3 + k] + bb_max[i * 3 + k]) * 0.5f - slo[k]) / ext[k];
      size += bb_max[i * 3 + k] - bb_min[i * 3 + k];
    }
    keys[i] = {morton3d(c[0], c[1], c[2]), size, i};
  }
  // morton asc, ties by AABB size (reference lbvh.h:112-120), then index.
  std::sort(keys.begin(), keys.end(), [](const Key& a, const Key& b) {
    if (a.code != b.code) return a.code < b.code;
    if (a.size != b.size) return a.size < b.size;
    return a.idx < b.idx;
  });

  std::vector<uint32_t> codes(n);
  for (int i = 0; i < n; i++) codes[i] = keys[i].code;

  const int n_int = n - 1;
  const int total = 2 * n - 1;
  for (int i = 0; i < total; i++) {
    left[i] = right[i] = parent[i] = obj_id[i] = -1;
  }
  // Leaves.
  for (int k = 0; k < n; k++) {
    int node = n_int + k;
    obj_id[node] = keys[k].idx;
    for (int c = 0; c < 3; c++) {
      node_lo[node * 3 + c] = bb_min[keys[k].idx * 3 + c];
      node_hi[node * 3 + c] = bb_max[keys[k].idx * 3 + c];
    }
  }

  // Internal nodes (parallel over i; each is independent).
  std::vector<int> range_l(n_int), range_r(n_int);
  int n_threads = std::min(8u, std::max(1u, std::thread::hardware_concurrency()));
  if (n_int < 1024) n_threads = 1;
  std::vector<std::thread> workers;
  auto work = [&](int t0, int t1) {
    for (int i = t0; i < t1; i++) {
      int d = (delta(codes, i, i + 1, n) > delta(codes, i, i - 1, n)) ? 1 : -1;
      int dmin = delta(codes, i, i - d, n);
      int lmax = 2;
      while (delta(codes, i, i + lmax * d, n) > dmin) lmax *= 2;
      int l = 0;
      for (int t = lmax / 2; t >= 1; t /= 2)
        if (delta(codes, i, i + (l + t) * d, n) > dmin) l += t;
      int j = i + l * d;
      int dnode = delta(codes, i, j, n);
      int s = 0;
      for (int t = (l + 1) / 2;; t = (t + 1) / 2) {
        if (delta(codes, i, i + (s + t) * d, n) > dnode) s += t;
        if (t <= 1) break;
      }
      int gamma = i + s * d + std::min(d, 0);
      int first = std::min(i, j), last = std::max(i, j);
      left[i] = (first == gamma) ? n_int + gamma : gamma;
      right[i] = (last == gamma + 1) ? n_int + gamma + 1 : gamma + 1;
      range_l[i] = first;
      range_r[i] = last;
    }
  };
  if (n_threads == 1) {
    work(0, n_int);
  } else {
    int chunk = (n_int + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++)
      workers.emplace_back(work, t * chunk, std::min(n_int, (t + 1) * chunk));
    for (auto& w : workers) w.join();
  }
  for (int i = 0; i < n_int; i++) {
    parent[left[i]] = i;
    parent[right[i]] = i;
  }

  // Internal AABBs: prefix sweep over sorted leaves gives O(n log n) worst
  // case via per-node range reduction; n here is host-side small, keep it
  // simple with a bottom-up pass instead (children before parents is not
  // index-ordered in Karras layout, so do a post-order stack walk).
  std::vector<int> order;
  order.reserve(total);
  {
    std::vector<int> stack = {0};
    while (!stack.empty()) {
      int k = stack.back();
      stack.pop_back();
      order.push_back(k);
      if (left[k] >= 0) {
        stack.push_back(left[k]);
        stack.push_back(right[k]);
      }
    }
  }
  for (auto it = order.rbegin(); it != order.rend(); ++it) {
    int k = *it;
    if (left[k] < 0) continue;  // leaf AABB already set
    for (int c = 0; c < 3; c++) {
      node_lo[k * 3 + c] =
          std::min(node_lo[left[k] * 3 + c], node_lo[right[k] * 3 + c]);
      node_hi[k * 3 + c] =
          std::max(node_hi[left[k] * 3 + c], node_hi[right[k] * 3 + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Simplex noise / FBM / turbulence texture baking (Helper::Noise equivalent,
// utility.cpp:657-768 + MakeTexture utility.h:70-192: strip-threaded).
// ---------------------------------------------------------------------------

static const uint8_t kPerm[256] = {
    151, 160, 137, 91,  90,  15,  131, 13,  201, 95,  96,  53,  194, 233, 7,
    225, 140, 36,  103, 30,  69,  142, 8,   99,  37,  240, 21,  10,  23,  190,
    6,   148, 247, 120, 234, 75,  0,   26,  197, 62,  94,  252, 219, 203, 117,
    35,  11,  32,  57,  177, 33,  88,  237, 149, 56,  87,  174, 20,  125, 136,
    171, 168, 68,  175, 74,  165, 71,  134, 139, 48,  27,  166, 77,  146, 158,
    231, 83,  111, 229, 122, 60,  211, 133, 230, 220, 105, 92,  41,  55,  46,
    245, 40,  244, 102, 143, 54,  65,  25,  63,  161, 1,   216, 80,  73,  209,
    76,  132, 187, 208, 89,  18,  169, 200, 196, 135, 130, 116, 188, 159, 86,
    164, 100, 109, 198, 173, 186, 3,   64,  52,  217, 226, 250, 124, 123, 5,
    202, 38,  147, 118, 126, 255, 82,  85,  212, 207, 206, 59,  227, 47,  16,
    58,  17,  182, 189, 28,  42,  223, 183, 170, 213, 119, 248, 152, 2,   44,
    154, 163, 70,  221, 153, 101, 155, 167, 43,  172, 9,   129, 22,  39,  253,
    19,  98,  108, 110, 79,  113, 224, 232, 178, 185, 112, 104, 218, 246, 97,
    228, 251, 34,  242, 193, 238, 210, 144, 12,  191, 179, 162, 241, 81,  51,
    145, 235, 249, 14,  239, 107, 49,  192, 214, 31,  181, 199, 106, 157, 184,
    84,  204, 176, 115, 121, 50,  45,  127, 4,   150, 254, 138, 236, 205, 93,
    222, 114, 67,  29,  24,  72,  243, 141, 128, 195, 78,  66,  215, 61,  156,
    180};

static inline float grad2(int hash, float x, float y) {
  int h = hash & 7;
  float u = h < 4 ? x : y;
  float v = h < 4 ? 2.0f * y : 2.0f * x;
  return ((h & 1) ? -u : u) + ((h & 2) ? -v : v);
}

static float snoise2(float x, float y) {
  const float F2 = 0.366025403f, G2 = 0.211324865f;
  float s = (x + y) * F2;
  int i = (int)std::floor(x + s), j = (int)std::floor(y + s);
  float t = (i + j) * G2;
  float x0 = x - (i - t), y0 = y - (j - t);
  int i1 = x0 > y0 ? 1 : 0, j1 = 1 - i1;
  float x1 = x0 - i1 + G2, y1 = y0 - j1 + G2;
  float x2 = x0 - 1.0f + 2.0f * G2, y2 = y0 - 1.0f + 2.0f * G2;
  int ii = i & 255, jj = j & 255;
  float n = 0.0f;
  float t0 = 0.5f - x0 * x0 - y0 * y0;
  if (t0 > 0) {
    t0 *= t0;
    n += t0 * t0 * grad2(kPerm[(ii + kPerm[jj & 255]) & 255], x0, y0);
  }
  float t1 = 0.5f - x1 * x1 - y1 * y1;
  if (t1 > 0) {
    t1 *= t1;
    n += t1 * t1 *
         grad2(kPerm[(ii + i1 + kPerm[(jj + j1) & 255]) & 255], x1, y1);
  }
  float t2 = 0.5f - x2 * x2 - y2 * y2;
  if (t2 > 0) {
    t2 *= t2;
    n += t2 * t2 *
         grad2(kPerm[(ii + 1 + kPerm[(jj + 1) & 255]) & 255], x2, y2);
  }
  return 40.0f * n;
}

static float fbm2(float x, float y, int octaves, float lacunarity, float gain) {
  float amp = 1.0f, freq = 1.0f, sum = 0.0f;
  for (int o = 0; o < octaves; o++) {
    sum += amp * snoise2(x * freq, y * freq);
    freq *= lacunarity;
    amp *= gain;
  }
  return sum;
}

static float turbulence2(float x, float y, int octaves, float lacunarity,
                         float gain) {
  float amp = 1.0f, freq = 1.0f, sum = 0.0f;
  for (int o = 0; o < octaves; o++) {
    sum += amp * std::fabs(snoise2(x * freq, y * freq));
    freq *= lacunarity;
    amp *= gain;
  }
  return sum;
}

// kind: 0 = simplex, 1 = fbm, 2 = turbulence. Output (h, w) floats,
// min-max normalized to [0,1] (two-pass, like MakeTexture utility.h:90-147).
void rt_noise_texture(int h, int w, float scale, int octaves, int kind,
                      float* out) {
  int n_threads = std::min(8u, std::max(1u, std::thread::hardware_concurrency()));
  if ((int64_t)h * w < 16384) n_threads = 1;
  std::vector<std::thread> workers;
  auto work = [&](int y0, int y1) {
    for (int y = y0; y < y1; y++)
      for (int x = 0; x < w; x++) {
        float fx = x * scale / w, fy = y * scale / h;
        float v;
        if (kind == 1)
          v = fbm2(fx, fy, octaves, 2.0f, 0.5f);
        else if (kind == 2)
          v = turbulence2(fx, fy, octaves, 2.0f, 0.5f);
        else
          v = snoise2(fx, fy);
        out[y * w + x] = v;
      }
  };
  if (n_threads == 1) {
    work(0, h);
  } else {
    int chunk = (h + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++)
      workers.emplace_back(work, t * chunk, std::min(h, (t + 1) * chunk));
    for (auto& th : workers) th.join();
  }
  float lo = 1e30f, hi = -1e30f;
  for (int64_t i = 0; i < (int64_t)h * w; i++) {
    lo = std::min(lo, out[i]);
    hi = std::max(hi, out[i]);
  }
  float inv = (hi > lo) ? 1.0f / (hi - lo) : 1.0f;
  for (int64_t i = 0; i < (int64_t)h * w; i++) out[i] = (out[i] - lo) * inv;
}

}  // extern "C"
