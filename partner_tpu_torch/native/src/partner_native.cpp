// Native host-pipeline kernels for partner_tpu_torch: the port's own copy
// of partner_tpu/native/src/partner_native.cpp. It keeps that code but for
// the hard voxelizer's cell arithmetic, which here divides by the voxel
// size and rounds the grid in float, as the numpy body and
// dynamic_voxelize do; the original multiplies by the reciprocal, which
// puts a point within a rounding of a cell edge into the next cell (7 of
// 5,850,000 outputs on one 180,000-point sweep).
//
// The reference implements these CPU hot loops as numba JIT kernels
// (det3d/ops/point_cloud/point_cloud_ops.py:8-74 hard voxelizer,
// det3d/core/sampler/preprocess.py:855-938 GT-AUG box collision); they
// bound the training data path's throughput. Here they are C++ with an
// extern "C" ABI consumed via ctypes, whose calls release the interpreter
// lock, so the data loader's threads run them side by side; the
// vectorized-numpy bodies in ops/voxelize.py, data/augment.py and
// core/box_np_ops.py remain the fallback and the parity oracle.
//
// Semantics match the numpy versions (same FCFS voxel ordering, same
// per-voxel point capping, same SAT epsilon). points_in_rbbox rotates in
// double where numpy rotates in float32, so a point within a rounding of
// a box face can land on the other side of it.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// First-come-first-served hard voxelizer.
//
// points:      (n_points, n_feat) float32, dims 0..2 are the grid axes
// voxel_size:  (3,) float32
// pc_range:    (6,) float32 (min xyz, max xyz)
// voxels:      out (max_voxels, max_points, n_feat) float32, zero-filled here
// coords:      out (max_voxels, 3) int32, reversed dims (z, y, x)
// num_points:  out (max_voxels,) int32
// returns the number of voxels emitted (<= max_voxels).
//
// Matches ops/voxelize.py:points_to_voxel: voxels ordered by first point
// occurrence; each voxel keeps its first max_points points in stream order;
// num_points counts members before capping, clamped to max_points; points
// belonging to voxels past max_voxels are dropped.
int ptn_points_to_voxel(const float* points, int64_t n_points, int n_feat,
                        const float* voxel_size, const float* pc_range,
                        int max_points, int max_voxels,
                        float* voxels, int32_t* coords, int32_t* num_points) {
    int64_t grid[3];
    for (int d = 0; d < 3; ++d) {
        // float32 division rounded half to even, as np.round of the
        // float32 quotient
        grid[d] = (int64_t)std::nearbyint(
            (pc_range[d + 3] - pc_range[d]) / voxel_size[d]);
    }
    const int64_t n_cells = grid[0] * grid[1] * grid[2];

    // open-addressing hash: linear cell id -> voxel index. Sized by the
    // point count (unique voxels + overflow tombstones <= n_points) so the
    // table can never fill up.
    size_t cap = 1;
    int64_t want = n_points * 2;
    if (want < (int64_t)max_voxels * 4) want = (int64_t)max_voxels * 4;
    while ((int64_t)cap < want) cap <<= 1;
    if (cap < 1024) cap = 1024;
    std::vector<int64_t> keys(cap, -1);
    std::vector<int32_t> vals(cap);
    const size_t mask = cap - 1;

    int n_vox = 0;
    for (int64_t i = 0; i < n_points; ++i) {
        const float* p = points + i * n_feat;
        int64_t c[3];
        bool ok = true;
        for (int d = 0; d < 3; ++d) {
            float f = std::floor((p[d] - pc_range[d]) / voxel_size[d]);
            c[d] = (int64_t)f;
            if (f < 0.0f || c[d] >= grid[d]) { ok = false; break; }
        }
        if (!ok) continue;
        // z-major linear id, same as the numpy path
        int64_t lin = (c[2] * grid[1] + c[1]) * grid[0] + c[0];
        (void)n_cells;

        size_t h = (size_t)(((uint64_t)lin) * 0x9E3779B97F4A7C15ull) & mask;
        int32_t vid = -1;
        for (;;) {
            int64_t k = keys[h];
            if (k == lin) { vid = vals[h]; break; }
            if (k == -1) {
                if (n_vox >= max_voxels) {
                    // voxel past capacity: drop the point but do NOT insert,
                    // matching the numpy FCFS ranking (later points of an
                    // overflow voxel are also dropped). Insert a tombstone
                    // value so repeat lookups stay O(1).
                    keys[h] = lin;
                    vals[h] = -2;
                    vid = -2;
                    break;
                }
                keys[h] = lin;
                vals[h] = n_vox;
                vid = n_vox;
                coords[(int64_t)n_vox * 3 + 0] = (int32_t)c[2];
                coords[(int64_t)n_vox * 3 + 1] = (int32_t)c[1];
                coords[(int64_t)n_vox * 3 + 2] = (int32_t)c[0];
                num_points[n_vox] = 0;
                ++n_vox;
                break;
            }
            h = (h + 1) & mask;
        }
        if (vid < 0) continue;
        int32_t cnt = num_points[vid];
        if (cnt < max_points) {
            std::memcpy(voxels + ((int64_t)vid * max_points + cnt) * n_feat,
                        p, sizeof(float) * n_feat);
        }
        // count all members (clamped by the caller contract below)
        num_points[vid] = cnt + 1;
    }
    for (int v = 0; v < n_vox; ++v)
        if (num_points[v] > max_points) num_points[v] = max_points;
    return n_vox;
}

// Exact rotated-rectangle overlap via separating axes.
// corners_a: (n, 4, 2) float32, corners_b: (k, 4, 2) float32
// out: (n, k) uint8, 1 = overlap. Epsilon matches augment.py (1e-9).
void ptn_box_collision(const float* corners_a, int64_t n,
                       const float* corners_b, int64_t k, uint8_t* out) {
    const double eps = 1e-9;
    // Precompute per-box edge normals and projection extents onto own axes.
    auto project = [](const float* c, const double ax, const double ay,
                      double& lo, double& hi) {
        lo = 1e300; hi = -1e300;
        for (int p = 0; p < 4; ++p) {
            double v = c[p * 2] * ax + c[p * 2 + 1] * ay;
            if (v < lo) lo = v;
            if (v > hi) hi = v;
        }
    };
    for (int64_t i = 0; i < n; ++i) {
        const float* ca = corners_a + i * 8;
        double axes_a[4][2];
        for (int e = 0; e < 4; ++e) {
            int e2 = (e + 1) & 3;
            double ex = ca[e2 * 2] - ca[e * 2];
            double ey = ca[e2 * 2 + 1] - ca[e * 2 + 1];
            axes_a[e][0] = -ey; axes_a[e][1] = ex;
        }
        for (int64_t j = 0; j < k; ++j) {
            const float* cb = corners_b + j * 8;
            bool sep = false;
            for (int e = 0; e < 4 && !sep; ++e) {
                double la, ha, lb, hb;
                project(ca, axes_a[e][0], axes_a[e][1], la, ha);
                project(cb, axes_a[e][0], axes_a[e][1], lb, hb);
                sep = (ha < lb - eps) || (hb < la - eps);
            }
            for (int e = 0; e < 4 && !sep; ++e) {
                int e2 = (e + 1) & 3;
                double ex = cb[e2 * 2] - cb[e * 2];
                double ey = cb[e2 * 2 + 1] - cb[e * 2 + 1];
                double ax = -ey, ay = ex;
                double la, ha, lb, hb;
                project(ca, ax, ay, la, ha);
                project(cb, ax, ay, lb, hb);
                sep = (ha < lb - eps) || (hb < la - eps);
            }
            out[i * k + j] = sep ? 0 : 1;
        }
    }
}

// Per-point rotated-3D-box membership.
// points: (n, >=3) float32 (stride elems per row), boxes: (k, box_stride)
// float32 [cx cy cz l w h ... yaw] — dims at 3:6, yaw in the LAST column
// (box_stride-1), matching core/box_np_ops.py:points_in_rbbox which reads
// boxes[:, -1] so (k, 7) and velocity-carrying (k, 9) both work.
// out: (n, k) uint8.
void ptn_points_in_rbbox(const float* points, int64_t n, int stride,
                         const float* boxes, int64_t k, int box_stride,
                         uint8_t* out) {
    std::vector<double> cs(k), sn(k);
    for (int64_t j = 0; j < k; ++j) {
        double yaw = (double)boxes[j * box_stride + (box_stride - 1)];
        cs[j] = std::cos(yaw);
        sn[j] = std::sin(yaw);
    }
    for (int64_t i = 0; i < n; ++i) {
        const float* p = points + i * stride;
        for (int64_t j = 0; j < k; ++j) {
            const float* b = boxes + j * box_stride;
            double dx = p[0] - b[0], dy = p[1] - b[1], dz = p[2] - b[2];
            // rotate into the box frame (inverse yaw)
            double lx =  dx * cs[j] + dy * sn[j];
            double ly = -dx * sn[j] + dy * cs[j];
            out[i * k + j] =
                (std::fabs(lx) <= b[3] * 0.5 && std::fabs(ly) <= b[4] * 0.5 &&
                 std::fabs(dz) <= b[5] * 0.5) ? 1 : 0;
        }
    }
}

}  // extern "C"
