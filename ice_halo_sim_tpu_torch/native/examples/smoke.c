/* smoke.c — standalone C front-end over libiht.
 *
 * Exercises the full C API surface without a Python host process (libiht
 * initializes the embedded interpreter itself): create server, commit a
 * tiny scene, wait idle, read back the frame, print a summary line.
 * Exit code 0 = every check passed. Mirrors the role of the reference CLI
 * as a C-API consumer (reference/src/main.cpp uses only lumice.h).
 *
 * Usage: iht_smoke <scene.json> [ray_num]
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "iht.h"

#define CHECK(cond, msg)                              \
  do {                                                \
    if (!(cond)) {                                    \
      fprintf(stderr, "FAIL: %s (%s)\n", msg,         \
              IHT_LastError());                       \
      return 1;                                       \
    }                                                 \
  } while (0)

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s <scene.json>\n", argv[0]);
    return 2;
  }

  CHECK(IHT_ApiVersion() == IHT_API_VERSION, "api version");
  CHECK(IHT_IsLegalFace(IHT_CRYSTAL_PRISM, 3) == 1, "legal face 3");
  CHECK(IHT_IsLegalFace(IHT_CRYSTAL_PRISM, 13) == 0, "prism face 13 illegal");
  CHECK(IHT_ValidateRaypathText("3-5-1", -1) == IHT_RAYPATH_VALID, "raypath ok");
  CHECK(IHT_ValidateRaypathText("3--5", -1) == IHT_RAYPATH_INVALID, "raypath bad");

  IHT_Server* server = NULL;
  CHECK(IHT_CreateServer(&server, 7u, 16384) == IHT_OK, "create server");

  int reused = -1;
  CHECK(IHT_CommitSceneFile(server, argv[1], &reused) == IHT_OK, "commit");
  CHECK(reused == 0, "first commit must not reuse");

  CHECK(IHT_WaitIdle(server, 600.0) == IHT_OK, "wait idle");
  CHECK(IHT_QueryServerState(server) == IHT_STATE_IDLE, "state idle");
  long long rays = IHT_GetSimRayCount(server);
  CHECK(rays > 0, "ray count > 0");

  IHT_ResultFrame* frame = NULL;
  CHECK(IHT_AcquireResultFrame(server, &frame) == IHT_OK, "acquire frame");
  CHECK(IHT_FrameIsIdle(frame) == 1, "frame idle");
  int n = IHT_FrameGetRenderCount(frame);
  CHECK(n >= 1, "render count");

  int w = 0, h = 0;
  CHECK(IHT_FrameGetRenderSize(frame, 0, &w, &h) == IHT_OK, "render size");
  CHECK(w > 0 && h > 0, "positive size");

  unsigned char* rgb = (unsigned char*)malloc((size_t)w * h * 3);
  float* xyz = (float*)malloc((size_t)w * h * 3 * sizeof(float));
  CHECK(rgb != NULL && xyz != NULL, "alloc");
  CHECK(IHT_FrameGetRender(frame, 0, rgb, (size_t)w * h * 3) == IHT_OK,
        "get render");
  CHECK(IHT_FrameGetRawXyz(frame, 0, xyz, (size_t)w * h * 3) == IHT_OK,
        "get raw xyz");
  CHECK(IHT_FrameGetRender(frame, 0, rgb, 16) == IHT_ERR_BUFFER_TOO_SMALL,
        "short buffer detected");

  long long lit = 0;
  double xyz_sum = 0.0;
  for (long long i = 0; i < (long long)w * h * 3; ++i) {
    if (rgb[i] > 10) lit++;
    xyz_sum += xyz[i];
  }
  CHECK(lit > 0, "image has content");
  CHECK(xyz_sum > 0.0, "xyz accumulated");

  IHT_Stats stats;
  CHECK(IHT_FrameGetStats(frame, &stats) == IHT_OK, "stats");
  CHECK(stats.rays_traced >= rays, "stats ray count");

  printf("iht_smoke OK: rays=%lld render=%dx%d lit_channels=%lld gen=%lld\n",
         stats.rays_traced, w, h, lit, IHT_FrameGetGeneration(frame));

  CHECK(IHT_ReleaseResultFrame(frame) == IHT_OK, "release frame");

  /* Phase 2: scene built in C (no JSON authored by the caller). */
  CHECK(IHT_MaxFov("fisheye_equal_area") == 360.0, "max fov");
  IHT_Scene* scene = NULL;
  CHECK(IHT_SceneCreate(&scene) == IHT_OK, "scene create");
  CHECK(IHT_SceneAddPrismCrystal(scene, 1, 1.1, 90.0, 360.0) == IHT_OK,
        "add crystal");
  CHECK(IHT_SceneSetSun(scene, 30.0, 0.0, 0.5) == IHT_OK, "set sun");
  CHECK(IHT_SceneSetWavelength(scene, 550.0) == IHT_OK, "set wavelength");
  CHECK(IHT_SceneSetSimParams(scene, 16384, 6) == IHT_OK, "sim params");
  {
    int ids[1] = {1};
    double props[1] = {100.0};
    CHECK(IHT_SceneAddScatterLayer(scene, 0.0, ids, props, NULL, 1) == IHT_OK,
          "scatter layer");
  }
  CHECK(IHT_SceneAddRender(scene, 1, "fisheye_equal_area", 120.0, 48, 48,
                           0.0, 30.0, 0.0) == IHT_OK,
        "add render");
  size_t need = IHT_SceneToJson(scene, NULL, 0);
  CHECK(need > 100, "scene json size");

  CHECK(IHT_SceneCommit(server, scene, &reused) == IHT_OK, "scene commit");
  CHECK(reused == 0, "new layout must not reuse");
  CHECK(IHT_WaitIdle(server, 600.0) == IHT_OK, "builder scene idle");
  IHT_ResultFrame* frame2 = NULL;
  CHECK(IHT_AcquireResultFrame(server, &frame2) == IHT_OK, "frame 2");
  CHECK(IHT_FrameGetRenderSize(frame2, 0, &w, &h) == IHT_OK, "size 2");
  CHECK(w == 48 && h == 48, "builder render size");
  IHT_Stats stats2;
  CHECK(IHT_FrameGetStats(frame2, &stats2) == IHT_OK, "stats 2");
  CHECK(stats2.ray_segments > 0, "segments counted");
  CHECK(stats2.landed_weight > 0.0, "landed weight");
  printf("scene_builder OK: %dx%d segs=%lld landed=%.1f\n", w, h,
         stats2.ray_segments, stats2.landed_weight);
  CHECK(IHT_ReleaseResultFrame(frame2) == IHT_OK, "release frame 2");
  CHECK(IHT_SceneDestroy(scene) == IHT_OK, "scene destroy");

  CHECK(IHT_DestroyServer(server) == IHT_OK, "destroy server");
  free(rgb);
  free(xyz);
  return 0;
}
