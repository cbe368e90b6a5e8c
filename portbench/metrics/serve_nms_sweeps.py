"""serve_nms_sweeps: the rotated NMS's fixpoint sweeps a frame in the
window, each ending in a read on the host (the program's own counter
``ops.nms.sweeps``)."""


def read(records):
    return records.get("counters", {}).get("nms_sweeps")
