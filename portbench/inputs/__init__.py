"""Seeded inputs, made with numpy alone: frozen copies of the smoke
script's synthetic scenes, so that a change to the program never changes
what the benchmark feeds it. The program and the reference get the same
arrays."""

import numpy as np


def rng_for(seed, stream):
    """A ``np.random.RandomState`` for ``seed`` (any whole number below
    2**64) and a named ``stream`` of draws: the same pair gives the same
    draws."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF,
             sum(ord(c) << (8 * (i % 4)) for i, c in enumerate(stream))
             & 0xFFFFFFFF]
    return np.random.RandomState(words)


def synthetic_scene(rng, pc_range, n_points, max_boxes):
    """One synthetic sweep: ``max_boxes // 2`` to ``max_boxes`` vehicle
    boxes [x, y, z, dx, dy, dz, yaw], half the points on them and half in
    the background -> (boxes (nb, 7), cartesian xyz (n_points, 3))."""
    nb = rng.randint(max_boxes // 2, max_boxes + 1)
    rho = rng.uniform(pc_range[0] + 5, pc_range[3] * 0.8, nb)
    phi = rng.uniform(pc_range[1] * 0.9, pc_range[4] * 0.9, nb)
    boxes = np.stack([rho * np.cos(phi), rho * np.sin(phi),
                      rng.uniform(-0.5, 0.5, nb), rng.uniform(3.5, 5.5, nb),
                      rng.uniform(1.6, 2.2, nb), rng.uniform(1.4, 2.0, nb),
                      rng.uniform(-np.pi, np.pi, nb)], 1)
    per_box = n_points // (2 * nb)
    on = [rng.uniform(-0.5, 0.5, (per_box, 3)) * bx[3:6] + bx[:3]
          for bx in boxes]
    n_bg = n_points - per_box * nb
    bg_r = rng.uniform(pc_range[0] + 0.5, pc_range[3] - 0.5, n_bg)
    bg_t = rng.uniform(pc_range[1], pc_range[4], n_bg)
    bg = np.stack([bg_r * np.cos(bg_t), bg_r * np.sin(bg_t),
                   rng.uniform(pc_range[2], pc_range[5], n_bg)], 1)
    return boxes, np.concatenate(on + [bg])


def log_uniform_background(rng, pc_range, n_points):
    """The smoke script's "realistic" sweep (``synthetic_sweep``) as
    cartesian xyz: log-uniform range (p(rho) ~ 1/rho), ground-hugging z,
    uniform azimuth."""
    rho = np.exp(rng.uniform(np.log(pc_range[0] + 0.2),
                             np.log(pc_range[3] - 0.2), n_points))
    z = pc_range[2] + np.abs(rng.randn(n_points)) * 0.18 * (
        pc_range[5] - pc_range[2])
    z = np.clip(z, pc_range[2], pc_range[5])
    phi = rng.uniform(pc_range[1], pc_range[4], n_points)
    return np.stack([rho * np.cos(phi), rho * np.sin(phi), z], 1)


def cylinder_points(rng, xyz, n_features):
    """Cartesian xyz (n, 3) -> the cylinder layout [rho, phi, z, x, y,
    then uniform extras up to ``n_features`` columns]."""
    r = np.hypot(xyz[:, 0], xyz[:, 1])
    a = np.arctan2(xyz[:, 1], xyz[:, 0])
    cols = [r, a, xyz[:, 2], xyz[:, 0], xyz[:, 1]]
    cols += [rng.rand(len(xyz)) for _ in range(n_features - len(cols))]
    return np.stack(cols, 1).astype(np.float32)


def scene_range(voxel_generator):
    """The (rho, phi, z) range :func:`synthetic_scene` draws a sweep in for a
    configuration's ``voxel_generator``: its own range on a cylinder grid;
    on a cuboid grid the disc its square holds (a lidar's footprint is
    round), from 0.3 m."""
    r = voxel_generator["range"]
    if voxel_generator.get("voxel_shape", "cylinder") == "cylinder":
        return list(r)
    return [0.3, -np.pi, r[2], min(r[3], r[4]), np.pi, r[5]]


def point_columns(rng, xyz, n_features, layout):
    """Cartesian xyz (n, 3) -> the point rows of a grid ``layout``: the
    cylinder one [rho, phi, z, x, y, extras] (:func:`cylinder_points`) or
    the cuboid one [x, y, z, extras], the extras uniform up to
    ``n_features`` columns."""
    if layout == "cylinder":
        return cylinder_points(rng, xyz, n_features)
    cols = [xyz[:, 0], xyz[:, 1], xyz[:, 2]]
    cols += [rng.rand(len(xyz)) for _ in range(n_features - len(cols))]
    return np.stack(cols, 1).astype(np.float32)


def serve_sweep(rng, voxel_generator, n_points, rows, max_boxes,
                n_features):
    """One served sweep: :func:`synthetic_scene`'s boxes with half the
    points on them, the other half a :func:`log_uniform_background`, in
    :func:`scene_range` and in the grid's point layout, padded to ``rows``
    -> (points (1, rows, C) f32, mask (1, rows) bool, boxes (nb, 7))."""
    pc_range = scene_range(voxel_generator)
    boxes, xyz = synthetic_scene(rng, pc_range, n_points, max_boxes)
    nb = len(boxes)
    n_on = (n_points // (2 * nb)) * nb
    xyz[n_on:] = log_uniform_background(rng, pc_range, n_points - n_on)
    pts = np.zeros((1, rows, n_features), np.float32)
    pts[0, :n_points] = point_columns(
        rng, xyz, n_features, voxel_generator.get("voxel_shape", "cylinder"))
    mask = np.zeros((1, rows), bool)
    mask[0, :n_points] = True
    return pts, mask, boxes
