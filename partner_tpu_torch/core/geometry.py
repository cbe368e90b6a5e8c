"""Geometry helpers of the inference path.

Counterparts of ``bev_cell_centers`` and ``wrap_angle_pi`` in
``partner_tpu/core/geometry.py``. ``bev_cell_centers`` is numpy (the grid
is a constant of the model); ``wrap_angle_pi`` works on tensors.
"""

import numpy as np
import torch


def wrap_angle_pi(angle):
    """Wrap to (-pi, pi] by a single +/- 2*pi correction (input assumed
    within (-3*pi, 3*pi), as in the JAX twin)."""
    angle = torch.where(angle > np.pi, angle - 2 * np.pi, angle)
    return torch.where(angle < -np.pi, angle + 2 * np.pi, angle)


def bev_cell_centers(grid_hw, voxel_size, pc_range, out_size_factor,
                     voxel_shape, center_offset=0.5):
    """Cartesian (x, y) and polar (rho, phi) positions of BEV feature cells.

    Returns an (H_r, W_az, 4) float32 array [x, y, rho, phi] for
    ``cylinder`` grids (rho along axis 0); same arithmetic as the JAX twin.
    """
    nr, naz = grid_hw
    r_idx = ((np.arange(nr, dtype=np.float32) + center_offset)
             * voxel_size[0] * out_size_factor)
    a_idx = ((np.arange(naz, dtype=np.float32) + center_offset)
             * voxel_size[1] * out_size_factor)
    if voxel_shape == "cylinder":
        rho = r_idx + pc_range[0]
        phi = a_idx + pc_range[1]
        rho_g, phi_g = np.meshgrid(rho, phi, indexing="ij")
        x = rho_g * np.cos(phi_g)
        y = rho_g * np.sin(phi_g)
        return np.stack([x, y, rho_g, phi_g], axis=-1)
    x = r_idx + pc_range[0]
    y = a_idx + pc_range[1]
    x_g, y_g = np.meshgrid(x, y, indexing="ij")
    rho_g = np.sqrt(x_g ** 2 + y_g ** 2)
    phi_g = np.arctan2(y_g, x_g)
    return np.stack([x_g, y_g, rho_g, phi_g], axis=-1)
