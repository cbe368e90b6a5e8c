"""serve_launches: kernels a frame on the card in the profiled slice
(torch.profiler's device events other than copies and memsets)."""


def read(records):
    return (records.get("trace") or {}).get("launches")
