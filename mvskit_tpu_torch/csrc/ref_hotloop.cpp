// Copy of native/ref_hotloop.cpp; tools/bench.py builds it into build/ at first use.
// Single-threaded CPU microbenchmark of the PM-MVS hot loop.
//
// Models the reference's per-evaluation cost (reference
// pmmvps/optim.cpp:790-948: getTex -> normalize -> dot -> robustincc):
// for every cost evaluation, warp a wsize x wsize lattice window into
// each of tau views with bilinear RGB fetches from an 8-bit image,
// zero-mean/unit-RMS normalize, and accumulate robust INCC against the
// reference view. This is a fresh implementation (no reference code),
// written only to MEASURE the per-sample throughput shape of the C++
// design for BASELINE comparison (BASELINE.md: "measure on C++
// reference (CPU)"). Build: g++ -O3 -march=native -o ref_hotloop ref_hotloop.cpp
//
// Output: one line "<Msamples/s>"

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>

struct V3 {
  float x, y, z;
};

static inline V3 bilinear(const uint8_t* img, int w, int h, float fx,
                          float fy) {
  int lx = (int)fx;
  int ly = (int)fy;
  if (lx < 0) lx = 0;
  if (ly < 0) ly = 0;
  if (lx > w - 2) lx = w - 2;
  if (ly > h - 2) ly = h - 2;
  float dx1 = fx - lx, dy1 = fy - ly;
  float dx0 = 1.f - dx1, dy0 = 1.f - dy1;
  const uint8_t* p0 = img + 3 * (ly * w + lx);
  const uint8_t* p1 = p0 + 3 * w;
  float f00 = dx0 * dy0, f10 = dx1 * dy0, f01 = dx0 * dy1, f11 = dx1 * dy1;
  V3 c;
  c.x = p0[0] * f00 + p0[3] * f10 + p1[0] * f01 + p1[3] * f11;
  c.y = p0[1] * f00 + p0[4] * f10 + p1[1] * f01 + p1[4] * f11;
  c.z = p0[2] * f00 + p0[5] * f10 + p1[2] * f01 + p1[5] * f11;
  return c;
}

int main(int argc, char** argv) {
  const int W = 640, H = 480, WSIZE = 7, TAU = 6;
  const int S = WSIZE * WSIZE;
  long evals = argc > 1 ? atol(argv[1]) : 200000;

  // synthetic smooth image (per view a phase-shifted pattern)
  std::vector<std::vector<uint8_t>> imgs(TAU);
  for (int v = 0; v < TAU; ++v) {
    imgs[v].resize(W * H * 3);
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x)
        for (int c = 0; c < 3; ++c)
          imgs[v][3 * (y * W + x) + c] = (uint8_t)(127.5 +
              120.0 * sin(0.05 * x + 0.07 * y + 0.5 * v + 0.9 * c));
  }

  std::vector<V3> tex(TAU * S);
  double sink = 0.0;
  unsigned rng = 12345;
  auto frand = [&rng]() {
    rng = rng * 1664525u + 1013904223u;
    return (rng >> 8) * (1.0f / 16777216.0f);
  };

  auto t0 = std::chrono::steady_clock::now();
  for (long e = 0; e < evals; ++e) {
    // per-eval lattice parameters (vary per view like reprojection)
    float score = 0.0f;
    int denom = 0;
    for (int v = 0; v < TAU; ++v) {
      float cx = 40.0f + frand() * (W - 80);
      float cy = 40.0f + frand() * (H - 80);
      float dxx = 0.8f + 0.4f * frand(), dxy = 0.2f * frand();
      float dyx = 0.2f * frand(), dyy = 0.8f + 0.4f * frand();
      float tlx = cx - (WSIZE / 2) * (dxx + dyx);
      float tly = cy - (WSIZE / 2) * (dxy + dyy);
      V3* t = &tex[v * S];
      for (int yy = 0; yy < WSIZE; ++yy)
        for (int xx = 0; xx < WSIZE; ++xx)
          t[yy * WSIZE + xx] = bilinear(
              imgs[v].data(), W, H, tlx + xx * dxx + yy * dyx,
              tly + xx * dxy + yy * dyy);
      // zero-mean, unit-RMS normalize
      float ax = 0, ay = 0, az = 0;
      for (int i = 0; i < S; ++i) {
        ax += t[i].x; ay += t[i].y; az += t[i].z;
      }
      ax /= S; ay /= S; az /= S;
      float ssd = 0;
      for (int i = 0; i < S; ++i) {
        float dx = t[i].x - ax, dy = t[i].y - ay, dz = t[i].z - az;
        ssd += dx * dx + dy * dy + dz * dz;
        t[i].x = dx; t[i].y = dy; t[i].z = dz;
      }
      float msd = sqrtf(ssd / (3 * S));
      if (msd == 0) msd = 1;
      float inv = 1.0f / msd;
      for (int i = 0; i < S; ++i) {
        t[i].x *= inv; t[i].y *= inv; t[i].z *= inv;
      }
      if (v > 0) {
        float dot = 0;
        const V3* r = &tex[0];
        for (int i = 0; i < S; ++i)
          dot += t[i].x * r[i].x + t[i].y * r[i].y + t[i].z * r[i].z;
        dot /= 3 * S;
        float incc = 1.0f - dot;
        score += incc / (1 + 3 * incc);
        ++denom;
      }
    }
    sink += score / denom;
  }
  auto t1 = std::chrono::steady_clock::now();
  double secs = std::chrono::duration<double>(t1 - t0).count();
  double samples = (double)evals * TAU * S;
  fprintf(stderr, "sink=%f evals=%ld secs=%.3f\n", sink, evals, secs);
  printf("%.3f\n", samples / secs / 1e6);
  return 0;
}
