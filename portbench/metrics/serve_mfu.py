"""serve_mfu: percent of the card's bf16 dense peak that a frame's FLOPs
reach at the window's seconds a frame. A frame's FLOPs are counted over
the plain reference (``yardstick``): the configuration's frozen dense
part plus the sparse backbone's convs by active pairs, averaged over the
window's frames."""

from portbench import yardstick


def read(records):
    if not records.get("flops") or not records.get("frames"):
        return None
    return yardstick.mfu(records["flops"],
                         records["window_s"] / records["frames"])
