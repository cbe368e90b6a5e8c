"""A frozen copy of ``partner_tpu_torch``'s plain path for the benchmark's
two configurations: the device voxelizer, the sparse backbone, the
SetBlock, neck and heads, decode and rotated NMS (the detectors' loss
modules come along, as the detectors build them), with the window
attention's kernel wrapper replaced by its plain PyTorch twin, and in one
process (no mesh, no seg head, no deformable conv). The benchmark builds
it in float32 and judges the port against it; the port may change, this
copy does not. It imports nothing of ``partner_tpu_torch``."""
