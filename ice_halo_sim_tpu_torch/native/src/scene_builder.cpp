// scene_builder.cpp — C-side scene value building (see include/iht.h).
//
// TPU-native counterpart of the reference's LUMICE_Scene value builder
// (reference/src/server/c_api.cpp scene-building surface): a C
// front-end assembles a scene without touching JSON by hand (typed
// conveniences) or with raw JSON fragments for full schema coverage. The
// builder is pure C++ — no Python until IHT_SceneCommit, where the
// assembled document goes through the same validated path as file commits.

#include "iht.h"

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" IHT_Status IHT_CommitSceneJson(IHT_Server*, const char*, int*);

namespace {

std::string Num(double v) {
  char buf[64];
  std::snprintf(buf, sizeof(buf), "%.10g", v);
  return buf;
}

std::string Join(const std::vector<std::string>& parts, const char* sep) {
  std::string out;
  for (size_t i = 0; i < parts.size(); ++i) {
    if (i != 0) out += sep;
    out += parts[i];
  }
  return out;
}

// Minimal structural check for a user-supplied fragment: non-empty and
// brace-balanced. Full validation happens in the config loader at commit.
bool LooksLikeJsonObject(const char* s) {
  if (s == nullptr) return false;
  while (*s == ' ' || *s == '\n' || *s == '\t' || *s == '\r') ++s;
  if (*s != '{') return false;
  int depth = 0;
  bool in_str = false;
  for (const char* p = s; *p != '\0'; ++p) {
    char c = *p;
    if (in_str) {
      if (c == '\\' && p[1] != '\0') {
        ++p;
      } else if (c == '"') {
        in_str = false;
      }
      continue;
    }
    if (c == '"') in_str = true;
    if (c == '{') ++depth;
    if (c == '}') --depth;
    if (depth == 0) {
      for (const char* q = p + 1; *q != '\0'; ++q) {
        if (*q != ' ' && *q != '\n' && *q != '\t' && *q != '\r') return false;
      }
      return true;
    }
  }
  return false;
}

}  // namespace

struct IHT_Scene {
  std::vector<std::string> crystals;
  std::vector<std::string> filters;
  std::vector<std::string> scatter_layers;
  std::vector<std::string> renders;
  std::string light = R"({"type": "sun", "altitude": 20.0})";
  std::string raypath_color;  // empty = absent
  long long ray_num = 1000000;
  int max_hits = 8;

  std::string ToJson() const {
    std::string out = "{\n  \"crystal\": [";
    out += Join(crystals, ", ");
    out += "],\n  \"filter\": [";
    out += Join(filters, ", ");
    out += "],\n  \"scene\": {\n    \"light_source\": ";
    out += light;
    out += ",\n    \"ray_num\": " + std::to_string(ray_num);
    out += ",\n    \"max_hits\": " + std::to_string(max_hits);
    out += ",\n    \"scattering\": [";
    out += Join(scatter_layers, ", ");
    out += "]\n  },\n  \"render\": [";
    out += Join(renders, ", ");
    out += "]";
    if (!raypath_color.empty()) {
      out += ",\n  \"raypath_color\": " + raypath_color;
    }
    out += "\n}\n";
    return out;
  }
};

extern "C" {

IHT_Status IHT_SceneCreate(IHT_Scene** out) {
  if (out == nullptr) return IHT_ERR_INVALID_ARG;
  *out = new IHT_Scene();
  return IHT_OK;
}

IHT_Status IHT_SceneClone(const IHT_Scene* scene, IHT_Scene** out) {
  if (scene == nullptr || out == nullptr) return IHT_ERR_INVALID_ARG;
  *out = new IHT_Scene(*scene);
  return IHT_OK;
}

IHT_Status IHT_SceneDestroy(IHT_Scene* scene) {
  if (scene == nullptr) return IHT_ERR_INVALID_ARG;
  delete scene;
  return IHT_OK;
}

IHT_Status IHT_SceneAddPrismCrystal(IHT_Scene* scene, int id, double height,
                                    double zenith_mean_deg,
                                    double zenith_std_deg) {
  if (scene == nullptr) return IHT_ERR_INVALID_ARG;
  std::string zenith =
      zenith_std_deg > 0
          ? R"({"type": "uniform", "mean": )" + Num(zenith_mean_deg) +
                R"(, "std": )" + Num(zenith_std_deg) + "}"
          : Num(zenith_mean_deg);
  scene->crystals.push_back(
      R"({"id": )" + std::to_string(id) +
      R"(, "type": "prism", "shape": {"height": )" + Num(height) +
      R"(}, "axis": {"zenith": )" + zenith + "}}");
  return IHT_OK;
}

IHT_Status IHT_SceneSetSun(IHT_Scene* scene, double altitude_deg,
                           double azimuth_deg, double diameter_deg) {
  if (scene == nullptr) return IHT_ERR_INVALID_ARG;
  // Preserve any spectrum already set.
  std::string spectrum;
  size_t pos = scene->light.find("\"spectrum\"");
  if (pos != std::string::npos) {
    size_t end = scene->light.rfind('}');
    spectrum = ", " + scene->light.substr(pos, end - pos);
  }
  scene->light = R"({"type": "sun", "altitude": )" + Num(altitude_deg) +
                 R"(, "azimuth": )" + Num(azimuth_deg) +
                 R"(, "diameter": )" + Num(diameter_deg) + spectrum + "}";
  return IHT_OK;
}

IHT_Status IHT_SceneSetWavelength(IHT_Scene* scene, double wl_nm) {
  if (scene == nullptr) return IHT_ERR_INVALID_ARG;
  size_t end = scene->light.rfind('}');
  size_t pos = scene->light.find(", \"spectrum\"");
  std::string base = scene->light.substr(
      0, pos != std::string::npos ? pos : end);
  scene->light = base + R"(, "spectrum": [{"wavelength": )" + Num(wl_nm) +
                 R"(, "weight": 1.0}]})";
  return IHT_OK;
}

IHT_Status IHT_SceneSetIlluminant(IHT_Scene* scene, const char* name) {
  if (scene == nullptr || name == nullptr) return IHT_ERR_INVALID_ARG;
  size_t end = scene->light.rfind('}');
  size_t pos = scene->light.find(", \"spectrum\"");
  std::string base = scene->light.substr(
      0, pos != std::string::npos ? pos : end);
  scene->light = base + R"(, "spectrum": ")" + name + R"("})";
  return IHT_OK;
}

IHT_Status IHT_SceneSetSimParams(IHT_Scene* scene, long long ray_num,
                                 int max_hits) {
  if (scene == nullptr || max_hits <= 0 || max_hits > 64) {
    return IHT_ERR_INVALID_ARG;
  }
  scene->ray_num = ray_num;
  scene->max_hits = max_hits;
  return IHT_OK;
}

IHT_Status IHT_SceneAddScatterLayer(IHT_Scene* scene, double prob,
                                    const int* crystal_ids,
                                    const double* proportions,
                                    const int* filter_ids, int n_entries) {
  if (scene == nullptr || crystal_ids == nullptr || proportions == nullptr ||
      n_entries <= 0) {
    return IHT_ERR_INVALID_ARG;
  }
  std::vector<std::string> entries;
  for (int i = 0; i < n_entries; ++i) {
    std::string e = R"({"crystal": )" + std::to_string(crystal_ids[i]) +
                    R"(, "proportion": )" + Num(proportions[i]);
    if (filter_ids != nullptr && filter_ids[i] != 0) {
      e += R"(, "filter": )" + std::to_string(filter_ids[i]);
    }
    entries.push_back(e + "}");
  }
  scene->scatter_layers.push_back(
      R"({"prob": )" + Num(prob) + R"(, "entries": [)" + Join(entries, ", ") +
      "]}");
  return IHT_OK;
}

IHT_Status IHT_SceneAddRender(IHT_Scene* scene, int id, const char* lens_type,
                              double fov_deg, int width, int height,
                              double view_az_deg, double view_el_deg,
                              double view_ro_deg) {
  if (scene == nullptr || lens_type == nullptr || width <= 0 || height <= 0) {
    return IHT_ERR_INVALID_ARG;
  }
  scene->renders.push_back(
      R"({"id": )" + std::to_string(id) + R"(, "lens": {"type": ")" +
      lens_type + R"(", "fov": )" + Num(fov_deg) +
      R"(}, "resolution": [)" + std::to_string(width) + ", " +
      std::to_string(height) + R"(], "view": {"azimuth": )" +
      Num(view_az_deg) + R"(, "elevation": )" + Num(view_el_deg) +
      R"(, "roll": )" + Num(view_ro_deg) + "}}");
  return IHT_OK;
}

static IHT_Status AddFragment(std::vector<std::string>* dst,
                              const char* json) {
  if (dst == nullptr || !LooksLikeJsonObject(json)) {
    return IHT_ERR_INVALID_ARG;
  }
  dst->push_back(json);
  return IHT_OK;
}

IHT_Status IHT_SceneAddCrystalJson(IHT_Scene* scene, const char* json) {
  return scene ? AddFragment(&scene->crystals, json) : IHT_ERR_INVALID_ARG;
}

IHT_Status IHT_SceneAddFilterJson(IHT_Scene* scene, const char* json) {
  return scene ? AddFragment(&scene->filters, json) : IHT_ERR_INVALID_ARG;
}

IHT_Status IHT_SceneAddRenderJson(IHT_Scene* scene, const char* json) {
  return scene ? AddFragment(&scene->renders, json) : IHT_ERR_INVALID_ARG;
}

IHT_Status IHT_SceneSetRaypathColorJson(IHT_Scene* scene, const char* json) {
  if (scene == nullptr || !LooksLikeJsonObject(json)) {
    return IHT_ERR_INVALID_ARG;
  }
  scene->raypath_color = json;
  return IHT_OK;
}

size_t IHT_SceneToJson(const IHT_Scene* scene, char* dst, size_t cap) {
  if (scene == nullptr) return 0;
  std::string json = scene->ToJson();
  size_t need = json.size() + 1;
  if (dst != nullptr && cap > 0) {
    size_t n = need < cap ? need : cap;
    std::memcpy(dst, json.c_str(), n - 1);
    dst[n - 1] = '\0';
  }
  return need;
}

IHT_Status IHT_SceneCommit(IHT_Server* server, const IHT_Scene* scene,
                           int* out_reused) {
  if (server == nullptr || scene == nullptr) return IHT_ERR_INVALID_ARG;
  std::string json = scene->ToJson();
  return IHT_CommitSceneJson(server, json.c_str(), out_reused);
}

double IHT_MaxFov(const char* lens_type) {
  // Mirrors config/schema.py max_fov (reference render_config.cpp:127-141).
  if (lens_type == nullptr) return -1.0;
  std::string t = lens_type;
  if (t == "linear") return 179.0;
  if (t == "fisheye_stereographic") return 359.0;
  if (t == "fisheye_orthographic" || t == "dual_fisheye_orthographic") {
    return 180.0;
  }
  if (t == "globe") return 90.0;
  if (t == "fisheye_equal_area" || t == "fisheye_equidistant" ||
      t == "dual_fisheye_equal_area" || t == "dual_fisheye_equidistant" ||
      t == "dual_fisheye_stereographic" || t == "rectangular") {
    return 360.0;
  }
  return -1.0;
}

}  // extern "C"
