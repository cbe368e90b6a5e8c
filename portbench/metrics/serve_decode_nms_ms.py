"""serve_decode_nms_ms: device ms a frame of the span ``decode_nms``, its CUDA
events summed over the window's frames outside the profiled slice,
over those frames."""


def read(records):
    return records.get("spans", {}).get("decode_nms")
