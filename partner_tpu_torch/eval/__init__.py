"""Detection evaluation of the Waymo val path (counterpart of ``partner_tpu/eval``)."""
