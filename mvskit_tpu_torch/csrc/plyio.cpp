// Copy of native/plyio.cpp, built by mvskit_tpu_torch/io/native.py.
// Native PLY vertex reader/writer for mvskit_tpu.
//
// The reference keeps its point-cloud I/O in native code (io/io_file.c
// over the vendored RPly; SURVEY.md C14/C15). This is the equivalent
// native component for the TPU engine, written from scratch: a small
// C ABI shared library (built with g++, bound via ctypes) that parses
// ascii / binary_little_endian PLY vertex elements — x/y/z plus
// optional nx/ny/nz and rgb (red/diffuse_red/r naming) — an order of
// magnitude faster than the pure-Python path on multi-million-point
// clouds. List properties (faces) after the vertex element are ignored.
//
// Build: g++ -O2 -shared -fPIC -o libplyio.so plyio.cpp

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Prop {
  std::string name;
  int size;      // bytes for binary
  char kind;     // 'f' float, 'd' double, 'u' uint8, 'i' int32-ish
};

struct Header {
  bool binary = false;
  long n_vertex = -1;
  std::vector<Prop> props;  // vertex properties, in file order
  long data_offset = 0;
  bool vertex_first = true;  // vertex element precedes any other
};

int prop_info(const std::string& t, Prop* p) {
  if (t == "float" || t == "float32") { p->size = 4; p->kind = 'f'; }
  else if (t == "double" || t == "float64") { p->size = 8; p->kind = 'd'; }
  else if (t == "uchar" || t == "uint8" || t == "char" || t == "int8") {
    p->size = 1; p->kind = 'u';
  }
  else if (t == "short" || t == "ushort" || t == "int16" || t == "uint16") {
    p->size = 2; p->kind = 'i';
  }
  else if (t == "int" || t == "uint" || t == "int32" || t == "uint32") {
    p->size = 4; p->kind = 'i';
  }
  else return -1;
  return 0;
}

int parse_header(FILE* f, Header* h) {
  char line[4096];
  if (!fgets(line, sizeof line, f)) return -1;
  if (strncmp(line, "ply", 3) != 0) return -1;
  std::string cur_elem;
  bool seen_vertex = false;
  while (fgets(line, sizeof line, f)) {
    char w0[64] = {0}, w1[64] = {0}, w2[64] = {0}, w3[64] = {0};
    long num = 0;
    if (sscanf(line, "%63s", w0) != 1) continue;
    if (strcmp(w0, "end_header") == 0) {
      h->data_offset = ftell(f);
      return h->n_vertex >= 0 ? 0 : -1;
    }
    if (strcmp(w0, "format") == 0) {
      sscanf(line, "%*s %63s", w1);
      if (strcmp(w1, "ascii") == 0) h->binary = false;
      else if (strcmp(w1, "binary_little_endian") == 0) h->binary = true;
      else return -1;
    } else if (strcmp(w0, "element") == 0) {
      sscanf(line, "%*s %63s %ld", w1, &num);
      cur_elem = w1;
      if (cur_elem == "vertex") {
        h->n_vertex = num;
        seen_vertex = true;
        h->vertex_first = true;
      } else if (!seen_vertex) {
        // a non-vertex element before vertex: unsupported skip case
        h->vertex_first = false;
      }
    } else if (strcmp(w0, "property") == 0 && cur_elem == "vertex") {
      sscanf(line, "%*s %63s %63s %63s", w1, w2, w3);
      if (strcmp(w1, "list") == 0) return -2;  // list in vertex: no
      Prop p;
      p.name = w2;
      if (prop_info(w1, &p) != 0) return -1;
      h->props.push_back(p);
    }
  }
  return -1;
}

int find_prop(const Header& h, const char* name) {
  for (size_t i = 0; i < h.props.size(); ++i)
    if (h.props[i].name == name) return (int)i;
  return -1;
}

int rgb_base(const Header& h) {
  const char* sets[3][3] = {
      {"red", "green", "blue"},
      {"diffuse_red", "diffuse_green", "diffuse_blue"},
      {"r", "g", "b"}};
  for (auto& s : sets) {
    int a = find_prop(h, s[0]);
    if (a >= 0 && find_prop(h, s[1]) >= 0 && find_prop(h, s[2]) >= 0)
      return a;
  }
  return -1;
}

}  // namespace

extern "C" {

// Returns vertex count, or negative on error. has_normals/has_rgb are
// optional out-flags.
long ply_count(const char* path, int* has_normals, int* has_rgb) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  int rc = parse_header(f, &h);
  fclose(f);
  if (rc != 0 || !h.vertex_first) return -1;
  if (has_normals)
    *has_normals = find_prop(h, "nx") >= 0 && find_prop(h, "ny") >= 0 &&
                   find_prop(h, "nz") >= 0;
  if (has_rgb) *has_rgb = rgb_base(h) >= 0;
  return h.n_vertex;
}

// Fill pre-allocated arrays: xyz[n*3] double (required), normals[n*3]
// double (nullable), rgb[n*3] uint8 (nullable). Returns 0 on success.
int ply_read(const char* path, double* xyz, double* normals,
             uint8_t* rgb) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  if (parse_header(f, &h) != 0 || !h.vertex_first) {
    fclose(f);
    return -1;
  }
  const int np = (int)h.props.size();
  int ix = find_prop(h, "x"), iy = find_prop(h, "y"), iz = find_prop(h, "z");
  if (ix < 0 || iy < 0 || iz < 0) {
    fclose(f);
    return -1;
  }
  int inx = find_prop(h, "nx"), iny = find_prop(h, "ny"),
      inz = find_prop(h, "nz");
  int irgb = rgb_base(h);

  std::vector<double> row(np);
  if (h.binary) {
    long rec = 0;
    for (auto& p : h.props) rec += p.size;
    std::vector<unsigned char> buf((size_t)rec * 4096);
    long remaining = h.n_vertex;
    long v = 0;
    while (remaining > 0) {
      long chunk = remaining < 4096 ? remaining : 4096;
      if (fread(buf.data(), rec, chunk, f) != (size_t)chunk) {
        fclose(f);
        return -1;
      }
      for (long c = 0; c < chunk; ++c, ++v) {
        const unsigned char* q = buf.data() + (size_t)c * rec;
        for (int i = 0; i < np; ++i) {
          const Prop& p = h.props[i];
          double val = 0;
          switch (p.kind) {
            case 'f': { float t; memcpy(&t, q, 4); val = t; break; }
            case 'd': { double t; memcpy(&t, q, 8); val = t; break; }
            case 'u': val = *q; break;
            default: {
              if (p.size == 2) { int16_t t; memcpy(&t, q, 2); val = t; }
              else { int32_t t; memcpy(&t, q, 4); val = t; }
            }
          }
          row[i] = val;
          q += p.size;
        }
        xyz[v * 3 + 0] = row[ix];
        xyz[v * 3 + 1] = row[iy];
        xyz[v * 3 + 2] = row[iz];
        if (normals && inx >= 0) {
          normals[v * 3 + 0] = row[inx];
          normals[v * 3 + 1] = row[iny];
          normals[v * 3 + 2] = row[inz];
        }
        if (rgb && irgb >= 0) {
          rgb[v * 3 + 0] = (uint8_t)row[irgb];
          rgb[v * 3 + 1] = (uint8_t)row[irgb + 1];
          rgb[v * 3 + 2] = (uint8_t)row[irgb + 2];
        }
      }
      remaining -= chunk;
    }
  } else {
    for (long v = 0; v < h.n_vertex; ++v) {
      for (int i = 0; i < np; ++i) {
        if (fscanf(f, "%lf", &row[i]) != 1) {
          fclose(f);
          return -1;
        }
      }
      xyz[v * 3 + 0] = row[ix];
      xyz[v * 3 + 1] = row[iy];
      xyz[v * 3 + 2] = row[iz];
      if (normals && inx >= 0) {
        normals[v * 3 + 0] = row[inx];
        normals[v * 3 + 1] = row[iny];
        normals[v * 3 + 2] = row[inz];
      }
      if (rgb && irgb >= 0) {
        rgb[v * 3 + 0] = (uint8_t)row[irgb];
        rgb[v * 3 + 1] = (uint8_t)row[irgb + 1];
        rgb[v * 3 + 2] = (uint8_t)row[irgb + 2];
      }
    }
  }
  fclose(f);
  return 0;
}

// Write a vertex-only PLY. normals / rgb nullable; binary != 0 writes
// binary_little_endian. Property names match the reference layout
// (diffuse_* color names, patch_manager.cpp:545-557).
int ply_write(const char* path, long n, const float* xyz,
              const float* normals, const uint8_t* rgb, int binary) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "ply\nformat %s 1.0\nelement vertex %ld\n",
          binary ? "binary_little_endian" : "ascii", n);
  fprintf(f, "property float x\nproperty float y\nproperty float z\n");
  if (normals)
    fprintf(f, "property float nx\nproperty float ny\nproperty float nz\n");
  if (rgb)
    fprintf(f,
            "property uchar diffuse_red\nproperty uchar diffuse_green\n"
            "property uchar diffuse_blue\n");
  fprintf(f, "end_header\n");
  for (long v = 0; v < n; ++v) {
    if (binary) {
      fwrite(xyz + v * 3, 4, 3, f);
      if (normals) fwrite(normals + v * 3, 4, 3, f);
      if (rgb) fwrite(rgb + v * 3, 1, 3, f);
    } else {
      fprintf(f, "%.9g %.9g %.9g", xyz[v * 3], xyz[v * 3 + 1],
              xyz[v * 3 + 2]);
      if (normals)
        fprintf(f, " %.9g %.9g %.9g", normals[v * 3], normals[v * 3 + 1],
                normals[v * 3 + 2]);
      if (rgb)
        fprintf(f, " %d %d %d", rgb[v * 3], rgb[v * 3 + 1], rgb[v * 3 + 2]);
      fputc('\n', f);
    }
  }
  fclose(f);
  return 0;
}

}  // extern "C"
