"""serve_backbone_ms: device ms a frame of the span ``backbone``, its CUDA
events summed over the window's frames outside the profiled slice,
over those frames."""


def read(records):
    return records.get("spans", {}).get("backbone")
