/* mh_tpu native C ABI — wire format v1.
 *
 * The equivalent of the reference's exported DLL surface
 * (KernelWrapper, Kernel.cu:873: relationshipStruct / relationshipAngleStruct
 * / positionAndRotation / rectangle / Surface / gpuConfig in, result out).
 * Every field is 8 bytes (double or int64) so the layout is identical on
 * every ABI without packing pragmas, and trivially blittable from C# /
 * Python ctypes / C.
 *
 * Cost breakdown order (mh_result_costs): total, pair_wise, visual_balance,
 * focal_point, symmetry, clearance, off_limits, surface_area — matching
 * resultCosts (Kernel.cu:134-144), except the values are real (the
 * reference returns uninitialized memory here, Kernel.cu:852-861).
 */
#ifndef MH_TPU_WIRE_H_
#define MH_TPU_WIRE_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* positionAndRotation (Kernel.cu:59-72) */
typedef struct {
  double x, y, z;
  double rot_x, rot_y, rot_z;
  double length, width;
  int64_t frozen; /* 0 / 1 */
} mh_pose;

/* relationshipStruct (Kernel.cu:79-85); degrees_of_attraction kept for wire
 * parity but unused, as in the reference. */
typedef struct {
  double range_start, range_end;
  double degrees_of_attraction;
  int64_t source_index, target_index;
} mh_relationship;

/* relationshipAngleStruct (Kernel.cu:87-92) */
typedef struct {
  double angle_min, angle_max;
  int64_t source_index, target_index;
} mh_angle_relationship;

/* rectangle (Kernel.cu:50-57) with its 4 vertices inlined (x0,y0,...,x3,y3)
 * instead of indices into a shared vertex pool. */
typedef struct {
  double quad[8];
  int64_t source_index;
} mh_rect;

/* Surface (Kernel.cu:94-117) + the surface rectangle vertices. */
typedef struct {
  int64_t n_objs, n_relationships, n_angle_relationships, n_clearances;
  double w_focal_point, w_pair_wise, w_visual_balance, w_symmetry;
  double w_off_limits, w_clearance, w_surface_area;
  double centroid_x, centroid_y;
  double focal_x, focal_y, focal_rot;
  double surface_quad[8];
} mh_surface;

/* gpuConfig (Kernel.cu:119-127): grid dim -> n_chains (suggestions),
 * block dim -> moves per step, plus sampler knobs.
 * accept_draws: number of independent accept decisions per compound
 * proposal (accept iff min of K uniforms < ratio) — the deterministic
 * emulation of the reference's blockxDim per-thread divergent Accept
 * (Kernel.cu:819). 0 or 1 = one draw (clean semantics); set equal to
 * moves_per_step for reference-default behavior. */
typedef struct {
  int64_t n_chains, iterations, moves_per_step;
  int64_t accept_draws;
  int64_t parity_mode; /* 1 = reference parity, 0 = fixed semantics */
  int64_t seed;
  double beta; /* <= 0 selects the reference BETA = 2.0 */
} mh_config;

typedef struct {
  double total, pair_wise, visual_balance, focal_point;
  double symmetry, clearance, off_limits, surface_area;
} mh_result_costs;

/* Out buffers are caller-allocated:
 *   out_points: n_chains * n_objs * 6 doubles (x,y,z,rotX,rotY,rotZ)
 *   out_costs:  n_chains mh_result_costs
 *   out_accept_rate: n_chains doubles
 * Returns 0 on success, negative error code otherwise. */
int64_t MHKernelWrapper(const mh_surface* surface,
                        const mh_relationship* relationships,
                        const mh_angle_relationship* angle_relationships,
                        const mh_pose* poses,
                        const mh_rect* clearances,
                        const mh_rect* offlimits,
                        const mh_config* config,
                        double* out_points,
                        mh_result_costs* out_costs,
                        double* out_accept_rate);

/* Device discovery (reference basicCudaDeviceInformation, Kernel.cu:986):
 * writes a NUL-terminated device report into buf. Returns 0 on success. */
int64_t MHDeviceReport(char* buf, int64_t buf_len);

#ifdef __cplusplus
}
#endif

#endif /* MH_TPU_WIRE_H_ */
