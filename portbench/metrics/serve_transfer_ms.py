"""serve_transfer_ms: device ms a frame of the served entry's copies, the
point buffer in plus the detections out (spans ``transfer_in`` and
``transfer_out``)."""


def read(records):
    spans = records.get("spans", {})
    if "transfer_in" not in spans or "transfer_out" not in spans:
        return None
    return spans["transfer_in"] + spans["transfer_out"]
