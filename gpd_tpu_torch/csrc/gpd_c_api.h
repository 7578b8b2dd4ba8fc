/* gpd_tpu_torch C ABI: a native binding for the PyTorch/CUDA grasp
 * detector.
 *
 * The same extern "C" functions and the same GpdGrasp struct as gpd_tpu's
 * binding (native/gpd_tpu.h), so a C caller switches between the two by
 * linking the other library. Parity surface for the reference's extern "C"
 * Python binding (reference: src/detect_grasps_python.cpp:
 * detectGraspsInCloud :431, detectGraspsInFile :468, calcGraspDescriptors
 * :579), the other way around: the pipeline is a PyTorch program, so the C
 * ABI embeds CPython and drives gpd_tpu_torch.capi, letting C/C++ robot
 * stacks link grasp detection as a plain shared library.
 *
 * Build: gpd_tpu_torch.ops._build.load("gpd_c_api") compiles
 * gpd_c_api.cpp with the host C++ compiler against the building Python's
 * headers into gpd_tpu_torch/_build/libgpd_c_api-<hash>.so, linked to
 * libpython when that interpreter runs from it. A C program that embeds
 * a library built by an interpreter with libpython linked into its
 * executable (Debian's python3) links libpython itself.
 * Thread-safety: calls are serialized on the embedded interpreter's GIL.
 */
#ifndef GPD_TPU_TORCH_C_API_H
#define GPD_TPU_TORCH_C_API_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* One 6-DOF grasp (reference struct Grasp, detect_grasps_python.cpp:49-57,
 * with the rotation given in full instead of a quaternion). */
typedef struct GpdGrasp {
  double position[3];     /* hand bottom-center, world frame */
  double orientation[9];  /* row-major 3x3; columns approach/binormal/axis */
  double sample[3];       /* cloud sample the grasp came from */
  double width;           /* aperture */
  double score;           /* classifier score */
  int full_antipodal;     /* force-closure label */
  int half_antipodal;
} GpdGrasp;

/* Returns a description of the last error on this thread ("" if none). */
const char *gpd_last_error(void);

/* Optional explicit runtime init before the first detector is created.
 * platform: the device of detectors created afterwards, "cuda" (also
 * NULL/"", the default) or "cpu" (tests and machines without a card).
 * Returns 0 on success. Safe to skip: gpd_detector_create initializes
 * lazily, on CUDA. */
int gpd_init(const char *platform);

/* Create a detector from a .cfg file (the reference's config grammar).
 * Returns a handle > 0, or 0 on error. */
int64_t gpd_detector_create(const char *cfg_path);
void gpd_detector_destroy(int64_t detector);

/* Detect grasps in a PCD/PLY file. On success fills *out_grasps (malloc'd
 * array, free with gpd_free) and *out_count; returns 0. */
int gpd_detect_grasps_in_file(int64_t detector, const char *cloud_path,
                              GpdGrasp **out_grasps, int *out_count);

/* Detect grasps in an in-memory cloud.
 * points: n_points * 3 floats (xyz rows).
 * view_points: n_view_points * 3 floats, or NULL for the config's
 *   camera_position.
 * cam_source: per-point uint32 camera bitmask (bit k = seen by camera k),
 *   or NULL for single-camera. */
int gpd_detect_grasps_in_cloud(int64_t detector, const float *points,
                               int n_points, const float *view_points,
                               int n_view_points, const uint32_t *cam_source,
                               GpdGrasp **out_grasps, int *out_count);

/* Compute grasp candidates plus their multi-channel descriptor images
 * (no final selection). images: malloc'd count*size*size*channels uint8
 * buffer (HWC per grasp), free with gpd_free. */
int gpd_calc_grasp_descriptors(int64_t detector, const float *points,
                               int n_points, const float *view_points,
                               int n_view_points, GpdGrasp **out_grasps,
                               uint8_t **out_images, int *out_count,
                               int *out_image_size, int *out_channels);

/* Free any buffer returned by this library. */
void gpd_free(void *ptr);

#ifdef __cplusplus
}
#endif

#endif /* GPD_TPU_TORCH_C_API_H */
