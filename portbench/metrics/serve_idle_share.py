"""serve_idle_share: percent of the window in which no operation ran on
the card: one less the device's busy seconds a frame (torch.profiler's
device events, merged, in the slice profiled after the window) over the
window's seconds a frame. The profiled slice's own length is not the
base: the profiler slows the host, which sets this loop's pace."""


def read(records):
    trace = records.get("trace") or {}
    if trace.get("busy_s") is None or not records.get("frames"):
        return None
    busy = trace["busy_s"] / trace["items"]
    return 100.0 * (1.0 - busy / (records["window_s"] / records["frames"]))
