"""3D scene export for detections over a point cloud.

A copy of ``partner_tpu/utils/viz3d.py``: the port imports nothing of the
JAX package, not even its numpy-only modules. The reference's 3D viewer
draws the cloud and box wireframes in an interactive open3d window; here
the same scene is written as an ASCII PLY (vertex colors for points, an
``edge`` element for the 12 wireframe lines of each box) that MeshLab,
CloudCompare or open3d render. :func:`to_open3d` returns live open3d
geometries where open3d is installed and raises an ImportError naming it
elsewhere. ``tools/demo.py --export_ply`` writes one per frame.
"""

import numpy as np

# wireframe edges of a box given corners ordered as
# center_to_corner_box3d's output (bottom 0-3, top 4-7)
BOX_EDGES = np.array(
    [(0, 1), (1, 2), (2, 3), (3, 0),
     (4, 5), (5, 6), (6, 7), (7, 4),
     (0, 4), (1, 5), (2, 6), (3, 7)], np.int64)

DET_COLOR = (214, 39, 40)    # red
GT_COLOR = (44, 160, 44)     # green


def box_corners_3d(boxes):
    """(N, 7+) [x y z dx dy dz (...) yaw] -> (N, 8, 3) corners."""
    from ..core.box_np_ops import center_to_corner_box3d

    boxes = np.asarray(boxes, np.float64)
    if boxes.size == 0:
        return np.zeros((0, 8, 3))
    return np.asarray(center_to_corner_box3d(
        boxes[:, :3], boxes[:, 3:6], boxes[:, -1]))


def _point_colors(points, intensity_dim=3):
    """Grayscale-by-intensity colors (uint8), mid-gray without one."""
    n = len(points)
    if points.shape[1] > intensity_dim:
        inten = np.asarray(points[:, intensity_dim], np.float64)
        lo, hi = np.percentile(inten, [2, 98]) if n else (0.0, 1.0)
        t = np.clip((inten - lo) / max(hi - lo, 1e-9), 0, 1)
        g = (64 + 160 * t).astype(np.uint8)
    else:
        g = np.full((n,), 140, np.uint8)
    return np.stack([g, g, g], 1)


def write_ply_scene(path, points, det_boxes=None, gt_boxes=None):
    """One ASCII PLY holding the cloud + box wireframes.

    points: (N, >=3); det_boxes / gt_boxes: (M, 7+) with yaw last.
    Box corners ride as extra colored vertices; the wireframes as the
    PLY ``edge`` element. Returns the path.
    """
    points = np.asarray(points)
    verts = [np.asarray(points[:, :3], np.float64)]
    colors = [_point_colors(points)]
    edges = []
    base = len(points)
    for boxes, col in ((gt_boxes, GT_COLOR), (det_boxes, DET_COLOR)):
        if boxes is None or len(boxes) == 0:
            continue
        corners = box_corners_3d(boxes)          # (M, 8, 3)
        m = len(corners)
        verts.append(corners.reshape(-1, 3))
        colors.append(np.tile(np.array(col, np.uint8), (m * 8, 1)))
        offs = base + 8 * np.arange(m)[:, None, None]
        edges.append((BOX_EDGES[None] + offs).reshape(-1, 2))
        base += m * 8
    v = np.concatenate(verts, 0)
    c = np.concatenate(colors, 0)
    e = (np.concatenate(edges, 0) if edges
         else np.zeros((0, 2), np.int64))

    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(v)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\n"
                f"element edge {len(e)}\n"
                "property int vertex1\nproperty int vertex2\n"
                "end_header\n")
        for (x, y, z), (r, g, b) in zip(v, c):
            f.write(f"{x:.4f} {y:.4f} {z:.4f} {r} {g} {b}\n")
        for a, b2 in e:
            f.write(f"{a} {b2}\n")
    return path


def to_open3d(points, det_boxes=None, gt_boxes=None):
    """Live open3d geometries (PointCloud + LineSets) when open3d is
    importable — the reference viewer's contract; raises ImportError
    otherwise (:func:`write_ply_scene` needs nothing beyond numpy)."""
    try:
        import open3d as o3d
    except ImportError as e:
        raise ImportError("to_open3d needs the open3d package, which is not "
                          "installed; write_ply_scene writes the same scene "
                          "as a PLY file") from e

    points = np.asarray(points)
    pc = o3d.geometry.PointCloud()
    pc.points = o3d.utility.Vector3dVector(points[:, :3])
    pc.colors = o3d.utility.Vector3dVector(
        _point_colors(points).astype(np.float64) / 255.0)
    geoms = [pc]
    for boxes, col in ((gt_boxes, GT_COLOR), (det_boxes, DET_COLOR)):
        if boxes is None or len(boxes) == 0:
            continue
        for corners in box_corners_3d(boxes):
            ls = o3d.geometry.LineSet()
            ls.points = o3d.utility.Vector3dVector(corners)
            ls.lines = o3d.utility.Vector2iVector(BOX_EDGES)
            ls.colors = o3d.utility.Vector3dVector(
                np.tile(np.array(col, np.float64) / 255.0, (12, 1)))
            geoms.append(ls)
    return geoms
