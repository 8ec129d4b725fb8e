/* iht.h — public C API of the TPU-native ice-halo renderer.
 *
 * Mirrors the capability surface of the reference C API
 * (reference/src/include/lumice.h: server lifecycle, scene commit,
 * result-frame acquisition, stats, validation helpers) in the TPU-native
 * formulation: the compute path is the JAX engine, and this library embeds
 * the CPython runtime to drive it, exposing a plain C ABI so C/C++
 * front-ends (CLI, GUI, FFI bindings) need no Python linkage of their own.
 *
 * Threading: all functions are thread-safe; calls may be made from any
 * thread. Result frames are immutable snapshots (reference ResultFrame,
 * server.hpp:229-242): acquire, read, release.
 */

#ifndef IHT_H_
#define IHT_H_

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

#define IHT_API_VERSION 1

typedef struct IHT_Server IHT_Server;
typedef struct IHT_ResultFrame IHT_ResultFrame;

typedef enum {
  IHT_OK = 0,
  IHT_ERR_INVALID_ARG = -1,
  IHT_ERR_RUNTIME = -2,     /* Python-side exception; see IHT_LastError */
  IHT_ERR_NO_FRAME = -3,    /* no commit yet */
  IHT_ERR_BUFFER_TOO_SMALL = -4,
  IHT_ERR_TIMEOUT = -5,
} IHT_Status;

typedef enum {
  IHT_STATE_IDLE = 0,
  IHT_STATE_RUNNING = 1,
  IHT_STATE_STOPPED = 2,
} IHT_ServerState;

typedef enum { IHT_CRYSTAL_PRISM = 0, IHT_CRYSTAL_PYRAMID = 1 } IHT_CrystalKind;

typedef enum {
  IHT_RAYPATH_VALID = 0,
  IHT_RAYPATH_INCOMPLETE = 1,
  IHT_RAYPATH_INVALID = 2,
} IHT_RaypathValidation;

/* Aggregate statistics snapshot (two-rule aggregation: stochastic counts
 * accumulate, deterministic counts are config constants —
 * reference trace_backend.hpp:525-625). */
typedef struct {
  long long rays_traced;
  long long ray_segments;
  double landed_weight;
  double dropped_cont_weight;
  long long stochastic_crystal_samples;
  long long stochastic_orientation_samples;
  long long deterministic_crystal_count;
  long long deterministic_orientation_count;
} IHT_Stats;

int IHT_ApiVersion(void);

/* Last error message for the calling thread ("" if none). The returned
 * pointer is valid until the next IHT_* call on the same thread. */
const char* IHT_LastError(void);

/* ---- server lifecycle ------------------------------------------------- */

/* seed: RNG seed. batch_size: rays per device step, 0 = auto. */
IHT_Status IHT_CreateServer(IHT_Server** out, unsigned int seed,
                            int batch_size);
IHT_Status IHT_DestroyServer(IHT_Server* server);

/* Commit a scene (project JSON text / file path). out_reused (may be NULL)
 * receives 1 if the previous accumulation was kept (value-equal layout,
 * reference Server::CommitConfig reuse), else 0. */
IHT_Status IHT_CommitSceneJson(IHT_Server* server, const char* json,
                               int* out_reused);
IHT_Status IHT_CommitSceneFile(IHT_Server* server, const char* path,
                               int* out_reused);

/* O(1), render-free progress counter (reference stats.hpp:18-25). */
long long IHT_GetSimRayCount(IHT_Server* server);

/* IHT_ServerState, or a negative IHT_Status. */
int IHT_QueryServerState(IHT_Server* server);

/* Block until the committed ray budget is drained. timeout_s < 0 = forever. */
IHT_Status IHT_WaitIdle(IHT_Server* server, double timeout_s);

/* Halt pumping; results stay readable (reference LUMICE_StopServer). */
IHT_Status IHT_StopServer(IHT_Server* server);

/* ---- result frames ---------------------------------------------------- */

IHT_Status IHT_AcquireResultFrame(IHT_Server* server, IHT_ResultFrame** out);
IHT_Status IHT_ReleaseResultFrame(IHT_ResultFrame* frame);

long long IHT_FrameGetGeneration(const IHT_ResultFrame* frame);
long long IHT_FrameGetRayCount(const IHT_ResultFrame* frame);
int IHT_FrameIsIdle(const IHT_ResultFrame* frame);
int IHT_FrameGetRenderCount(const IHT_ResultFrame* frame);
IHT_Status IHT_FrameGetRenderSize(const IHT_ResultFrame* frame, int idx,
                                  int* width, int* height);
/* Tone-mapped sRGB image, tightly packed RGB8, row-major. cap in bytes
 * (needs width*height*3). */
IHT_Status IHT_FrameGetRender(const IHT_ResultFrame* frame, int idx,
                              unsigned char* dst, size_t cap);
/* Raw accumulated CIE-XYZ floats, row-major [H][W][3]. cap in floats. */
IHT_Status IHT_FrameGetRawXyz(const IHT_ResultFrame* frame, int idx,
                              float* dst, size_t cap);
IHT_Status IHT_FrameGetStats(const IHT_ResultFrame* frame, IHT_Stats* out);
/* 1 if renderer idx has a raypath-color composite in this frame. */
int IHT_FrameHasComposite(const IHT_ResultFrame* frame, int idx);
/* Composited raypath-color image, row-major [H][W][3] floats in [0,1].
 * cap in floats. IHT_ERR_NO_FRAME if the renderer has no composite. */
IHT_Status IHT_FrameGetComposite(const IHT_ResultFrame* frame, int idx,
                                 float* dst, size_t cap);
/* Total landed weight for renderer idx (the snapshot_intensity anchor). */
IHT_Status IHT_FrameGetLanded(const IHT_ResultFrame* frame, int idx,
                              double* out);
/* Adaptive-brightness EV suggestion for renderer idx (P99-anchored;
 * reference doc/adaptive-brightness.md). */
IHT_Status IHT_FrameGetEvAuto(const IHT_ResultFrame* frame, int idx,
                              double* out);

/* ---- display-time color control (no re-simulation; lumice.h:950-984) -- */

/* json: {"classes": [{"color": [r,g,b], "visible": true, "solo": false},
 * ...], "z_order": [...], "mode": "dominant"|"additive"|"painter"}.
 * classes count must match the committed scene; z_order/mode optional. */
IHT_Status IHT_SetRaypathColors(IHT_Server* server, const char* json);
/* Display-time EV applied inside the composite bake only. */
IHT_Status IHT_SetCompositeExposure(IHT_Server* server, double ev);
/* Per-class has-signal flags (1 = the class's Y lane has any nonzero
 * pixel). Writes up to cap ints; returns the class count, or a negative
 * IHT_Status. */
int IHT_GetColorClassSignal(IHT_Server* server, int* out, int cap);
/* Color predicates beyond the component-mask bit budget stop producing
 * bits (coloring degrades, never fails — reference def.hpp:43-51). */
IHT_Status IHT_GetColorOverflowInfo(IHT_Server* server, int* overflow_count,
                                    int* capacity);

/* ---- lifecycle / drain ------------------------------------------------ */

/* Totals are final once *drained_epoch == *current_epoch
 * (LUMICE_GetDrainStatus contract). */
IHT_Status IHT_GetDrainStatus(IHT_Server* server, long long* current_epoch,
                              long long* drained_epoch);
/* state: IHT_ServerState; epoch: commit generation. */
IHT_Status IHT_GetSimLifecycle(IHT_Server* server, int* state,
                               long long* epoch);

/* ---- logging ----------------------------------------------------------- */

/* level/logger/message strings are valid only for the call's duration. */
typedef void (*IHT_LogCallback)(const char* level, const char* logger,
                                const char* message, void* user);
/* "debug" | "info" | "warning" | "error" | "off". */
IHT_Status IHT_SetLogLevel(const char* level);
/* Replaces any previous callback; cb = NULL uninstalls. The callback may
 * be invoked from any thread; it must not call back into IHT_*. */
IHT_Status IHT_SetLogCallback(IHT_LogCallback cb, void* user);

/* ---- geometry introspection ------------------------------------------- */

/* Triangulated preview mesh of a crystal-section JSON fragment at its
 * distribution centers (LUMICE_GetCrystalMesh). Two-call protocol: counts
 * are always written; arrays are filled only when their caps suffice
 * (vertices: 3 floats each; triangles: 3 ints each). */
IHT_Status IHT_GetCrystalMesh(const char* crystal_json, float* vertices,
                              size_t vertex_cap_floats, int* out_n_vertices,
                              int* triangles, size_t triangle_cap_ints,
                              int* out_n_triangles);

/* ---- validation helpers (no server needed) ---------------------------- */

/* 1 if the face number is legal on the crystal kind (crystal.cpp:43-56). */
int IHT_IsLegalFace(IHT_CrystalKind kind, int face);

/* IHT_RaypathValidation for dash/comma-separated face text. kind < 0 =
 * syntax-only. */
int IHT_ValidateRaypathText(const char* text, int kind);

/* Shape-scalar slots use the reference's unified 10-slot map
 * (crystal_config.hpp:32-41): 0 height (prism), 1-3 upper_h/prism_h/
 * lower_h (pyramid), 4-9 face distances (both). */
int IHT_IsShapeScalarApplicable(IHT_CrystalKind kind, int slot);
/* Sync-group JSON key for an applicable slot ("height", "upper_h",
 * "prism_h", "lower_h", "face_distance"); NULL if not applicable. */
const char* IHT_ShapeScalarSyncKeyName(IHT_CrystalKind kind, int slot);


/* ---- scene value building (pure C++, no Python until commit) ---------- */

/* A scene document under construction (the reference's LUMICE_Scene value
 * builder, lumice.h:734-818). Sections accumulate as JSON fragments; the
 * assembled document is validated by the config loader at commit. */
typedef struct IHT_Scene IHT_Scene;

IHT_Status IHT_SceneCreate(IHT_Scene** out);
IHT_Status IHT_SceneClone(const IHT_Scene* scene, IHT_Scene** out);
IHT_Status IHT_SceneDestroy(IHT_Scene* scene);

/* Typed conveniences. */
IHT_Status IHT_SceneAddPrismCrystal(IHT_Scene* scene, int id, double height,
                                    double zenith_mean_deg,
                                    double zenith_std_deg);
IHT_Status IHT_SceneSetSun(IHT_Scene* scene, double altitude_deg,
                           double azimuth_deg, double diameter_deg);
IHT_Status IHT_SceneSetWavelength(IHT_Scene* scene, double wl_nm);
IHT_Status IHT_SceneSetIlluminant(IHT_Scene* scene, const char* name);
IHT_Status IHT_SceneSetSimParams(IHT_Scene* scene, long long ray_num,
                                 int max_hits);
IHT_Status IHT_SceneAddScatterLayer(IHT_Scene* scene, double prob,
                                    const int* crystal_ids,
                                    const double* proportions,
                                    const int* filter_ids /* may be NULL */,
                                    int n_entries);
IHT_Status IHT_SceneAddRender(IHT_Scene* scene, int id, const char* lens_type,
                              double fov_deg, int width, int height,
                              double view_az_deg, double view_el_deg,
                              double view_ro_deg);

/* Raw JSON fragments for every section (full schema coverage: pyramid
 * crystals, filters, raypath_color, render extras...). The fragment is an
 * object in the on-disk schema for that section. */
IHT_Status IHT_SceneAddCrystalJson(IHT_Scene* scene, const char* json);
IHT_Status IHT_SceneAddFilterJson(IHT_Scene* scene, const char* json);
IHT_Status IHT_SceneAddRenderJson(IHT_Scene* scene, const char* json);
IHT_Status IHT_SceneSetRaypathColorJson(IHT_Scene* scene, const char* json);

/* Assemble the project JSON. Returns the required byte count (including
 * NUL); writes up to cap bytes into dst if dst != NULL. */
size_t IHT_SceneToJson(const IHT_Scene* scene, char* dst, size_t cap);

/* Commit the assembled scene to a server (validates the document). */
IHT_Status IHT_SceneCommit(IHT_Server* server, const IHT_Scene* scene,
                           int* out_reused);

/* Maximum field of view in degrees for a lens type name
 * (reference LUMICE_MaxFov; render_config.cpp:127-141). <= 0 on unknown. */
double IHT_MaxFov(const char* lens_type);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* IHT_H_ */
