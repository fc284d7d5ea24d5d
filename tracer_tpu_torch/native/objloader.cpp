// Native host-side asset loader / writer for tracer_tpu_torch (its own
// copy of the JAX package's tracer_tpu/native/objloader.cpp, same C ABI).
//
// C++ replacement for the reference's Rust host crates (ljus OBJ/MTL
// loader, ljus/src/lib.rs; demo-save PCD output, demo-save/src/main.rs).
// Exposes a plain C ABI consumed from Python via ctypes
// (tracer_tpu_torch/utils/native.py). Output layout matches the engine
// init ABI:
//   tri_data f32[T*9]   vertex positions per triangle
//   tri_mats u32[T]     material index per triangle
//   mat_data f32[M*28]  12 color knots | Pr Pm Ni Tf | 12 emission knots
//
// Custom MTL extensions (ljus/src/lib.rs:57-89): Sp/Em spectral knot
// lists, Pr roughness, Pm metalness, Tf opacity, Ni refractive index;
// RGB Kd/Ke fall back to knots at 610/550/460 nm.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr float kRedWavelen = 610.0f;
constexpr float kGreenWavelen = 550.0f;
constexpr float kBlueWavelen = 460.0f;

struct Mtl {
  float kd[3] = {0.f, 0.f, 0.f};
  float ke[3] = {0.f, 0.f, 0.f};
  float ni = 1.0f;
  std::unordered_map<std::string, std::string> extras;  // Sp/Em/Pr/Pm/Tf
};

std::string strip(const std::string& s) {
  size_t a = s.find_first_not_of(" \t\r\n");
  if (a == std::string::npos) return "";
  size_t b = s.find_last_not_of(" \t\r\n");
  return s.substr(a, b - a + 1);
}

std::vector<float> parse_floats(const std::string& s) {
  std::vector<float> out;
  std::istringstream is(s);
  float v;
  while (is >> v) out.push_back(v);
  return out;
}

// First token and the rest of a line with the comment stripped.
bool split_line(const std::string& raw, std::string* tag, std::string* rest) {
  std::string line = raw.substr(0, raw.find('#'));
  line = strip(line);
  if (line.empty()) return false;
  size_t sp = line.find_first_of(" \t");
  if (sp == std::string::npos) {
    *tag = line;
    rest->clear();
  } else {
    *tag = line.substr(0, sp);
    *rest = strip(line.substr(sp + 1));
  }
  return true;
}

struct MtlFile {
  std::vector<std::string> order;
  std::vector<Mtl> mats;
  std::unordered_map<std::string, uint32_t> index;
};

bool parse_mtl(const std::string& path, MtlFile* out, std::string* err) {
  std::ifstream f(path);
  if (!f) {
    *err = "cannot open mtl file: " + path;
    return false;
  }
  Mtl* cur = nullptr;
  std::string raw, tag, rest;
  while (std::getline(f, raw)) {
    if (!split_line(raw, &tag, &rest)) continue;
    if (tag == "newmtl") {
      out->index[rest] = static_cast<uint32_t>(out->mats.size());
      out->order.push_back(rest);
      out->mats.emplace_back();
      cur = &out->mats.back();
    } else if (!cur) {
      continue;
    } else if (tag == "Kd" || tag == "Ke") {
      auto v = parse_floats(rest);
      float* dst = (tag == "Kd") ? cur->kd : cur->ke;
      for (size_t i = 0; i < 3 && i < v.size(); ++i) dst[i] = v[i];
    } else if (tag == "Ni") {
      auto v = parse_floats(rest);
      if (!v.empty()) cur->ni = v[0];
    } else if (tag == "Sp" || tag == "Em" || tag == "Pr" || tag == "Pm" ||
               tag == "Tf") {
      cur->extras[tag] = rest;
    }
  }
  return true;
}

void spectrum12(const Mtl& m, const char* key, const float rgb[3],
                float out[12]) {
  auto it = m.extras.find(key);
  if (it != m.extras.end()) {
    auto vals = parse_floats(it->second);
    for (int i = 0; i < 12; ++i)
      out[i] = (i < static_cast<int>(vals.size()))
                   ? vals[i]
                   : ((i % 2 == 0) ? -1.0f : 0.0f);
    return;
  }
  const float knots[12] = {kRedWavelen, rgb[0], kGreenWavelen, rgb[1],
                           kBlueWavelen, rgb[2], -1.f, 0.f,
                           -1.f, 0.f, -1.f, 0.f};
  std::memcpy(out, knots, sizeof(knots));
}

float scalar_extra(const Mtl& m, const char* key, float dflt) {
  auto it = m.extras.find(key);
  if (it == m.extras.end()) return dflt;
  auto v = parse_floats(it->second);
  return v.empty() ? dflt : v[0];
}

void mat_row(const Mtl& m, float out[28]) {
  spectrum12(m, "Sp", m.kd, out);
  out[12] = scalar_extra(m, "Pr", 1.0f);
  out[13] = scalar_extra(m, "Pm", 0.0f);
  out[14] = m.ni;
  out[15] = scalar_extra(m, "Tf", 1.0f);
  spectrum12(m, "Em", m.ke, out + 16);
}

std::string dirname_of(const std::string& path) {
  size_t sl = path.find_last_of("/\\");
  return (sl == std::string::npos) ? std::string(".") : path.substr(0, sl);
}

}  // namespace

extern "C" {

// Returns 0 on success. Buffers are malloc'd; free with tracer_free.
int tracer_load_obj(const char* obj_path, size_t* num_tris, size_t* num_mats,
                    float** tri_data, uint32_t** tri_mats, float** mat_data,
                    char* errbuf, size_t errlen) {
  std::string err;
  std::ifstream f(obj_path);
  if (!f) {
    err = std::string("cannot open obj file: ") + obj_path;
    std::snprintf(errbuf, errlen, "%s", err.c_str());
    return 1;
  }
  std::vector<float> verts;   // flat xyz
  std::vector<float> tris;    // flat 9 per tri
  std::vector<uint32_t> tmats;
  MtlFile mtl;
  int cur_mat = -1;
  std::string raw, tag, rest;
  const std::string base = dirname_of(obj_path);

  while (std::getline(f, raw)) {
    if (!split_line(raw, &tag, &rest)) continue;
    if (tag == "v") {
      auto v = parse_floats(rest);
      for (size_t i = 0; i < 3; ++i)
        verts.push_back(i < v.size() ? v[i] : 0.0f);
    } else if (tag == "mtllib") {
      if (!parse_mtl(base + "/" + rest, &mtl, &err)) {
        std::snprintf(errbuf, errlen, "%s", err.c_str());
        return 1;
      }
    } else if (tag == "usemtl") {
      auto it = mtl.index.find(rest);
      if (it == mtl.index.end()) {
        std::snprintf(errbuf, errlen, "unknown material '%s'", rest.c_str());
        return 1;
      }
      cur_mat = static_cast<int>(it->second);
    } else if (tag == "f") {
      if (cur_mat < 0) {
        std::snprintf(errbuf, errlen, "face without material");
        return 1;
      }
      std::vector<long> idx;
      std::istringstream is(rest);
      std::string tok;
      const long nverts = static_cast<long>(verts.size() / 3);
      while (is >> tok) {
        long vi = std::strtol(tok.c_str(), nullptr, 10);
        idx.push_back(vi > 0 ? vi - 1 : nverts + vi);
      }
      // fan triangulation, matching tobj / the python loader
      for (size_t k = 1; k + 1 < idx.size(); ++k) {
        const long is3[3] = {idx[0], idx[k], idx[k + 1]};
        for (long vi : is3) {
          if (vi < 0 || vi >= nverts) {
            std::snprintf(errbuf, errlen, "vertex index out of range");
            return 1;
          }
          tris.push_back(verts[3 * vi]);
          tris.push_back(verts[3 * vi + 1]);
          tris.push_back(verts[3 * vi + 2]);
        }
        tmats.push_back(static_cast<uint32_t>(cur_mat));
      }
    }
  }

  *num_tris = tmats.size();
  *num_mats = mtl.mats.size();
  *tri_data = static_cast<float*>(std::malloc(tris.size() * sizeof(float)));
  *tri_mats =
      static_cast<uint32_t*>(std::malloc(tmats.size() * sizeof(uint32_t)));
  *mat_data =
      static_cast<float*>(std::malloc(mtl.mats.size() * 28 * sizeof(float)));
  if (!*tri_data || !*tri_mats || !*mat_data) {
    std::snprintf(errbuf, errlen, "allocation failed");
    return 1;
  }
  std::memcpy(*tri_data, tris.data(), tris.size() * sizeof(float));
  std::memcpy(*tri_mats, tmats.data(), tmats.size() * sizeof(uint32_t));
  for (size_t i = 0; i < mtl.mats.size(); ++i)
    mat_row(mtl.mats[i], *mat_data + 28 * i);
  return 0;
}

void tracer_free(void* p) { std::free(p); }

// ASCII PCD writer (fields x y z intensity), matching the reference's
// demo-save output (demo-save/src/main.rs:24-32). points: n*4 floats.
int tracer_write_pcd(const char* path, const float* points, size_t n,
                     char* errbuf, size_t errlen) {
  std::FILE* f = std::fopen(path, "w");
  if (!f) {
    std::snprintf(errbuf, errlen, "cannot open %s for writing", path);
    return 1;
  }
  std::fprintf(f,
               "# .PCD v0.7 - Point Cloud Data file format\n"
               "VERSION 0.7\n"
               "FIELDS x y z intensity\n"
               "SIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n"
               "WIDTH %zu\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
               "POINTS %zu\nDATA ascii\n",
               n, n);
  for (size_t i = 0; i < n; ++i) {
    const float* p = points + 4 * i;
    std::fprintf(f, "%.6g %.6g %.6g %.6g\n", p[0], p[1], p[2], p[3]);
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
