"""Detection evaluation of the Waymo and nuScenes val paths (counterpart of ``partner_tpu/eval``)."""
