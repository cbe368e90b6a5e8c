"""Minimal hand-rolled protobuf encoder for the Waymo devkit's
``objects.bin`` (metrics_pb2.Objects), so the proto path executes without
``waymo_open_dataset`` installed (VERDICT r4 next #8).

A copy of ``partner_tpu/eval/waymo_proto.py``: the port imports nothing of
the JAX package, not even its numpy-only modules.

Schema transcribed from the public waymo-open-dataset protos
(waymo_open_dataset/protos/metrics.proto + waymo_open_dataset/label.proto),
exactly the fields the reference writer populates
(the reference's det3d/datasets/waymo/waymo_common.py:52-115):

  Objects        { repeated Object objects = 1; }
  Object         { Label object = 1; float score = 2;
                   string context_name = 4;
                   int64 frame_timestamp_micros = 5; }
  Label          { Box box = 1; Type type = 3 (enum); string id = 4; }
  Label.Box      { double center_x=1, center_y=2, center_z=3,
                   length=4, width=5, height=6, heading=7; }

Wire format: tag = (field_number << 3) | wire_type; wire 0 = varint,
1 = 64-bit LE, 2 = length-delimited, 5 = 32-bit LE. Fields are emitted in
field-number order — byte-identical to python-protobuf's serializer for
the same set fields (proto2 presence: the reference assigns every field
explicitly, so every field serializes even when zero). Golden-validated
against a protoc-compiled twin of the schema in
tests/test_waymo_writer.py.
"""

import struct


def _varint(n):
    n &= (1 << 64) - 1  # two's-complement for negative int64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field, wire):
    return _varint((field << 3) | wire)


def _double(field, v):
    return _tag(field, 1) + struct.pack("<d", float(v))


def _float(field, v):
    return _tag(field, 5) + struct.pack("<f", float(v))


def _bytes(field, b):
    if isinstance(b, str):
        b = b.encode("utf-8")
    return _tag(field, 2) + _varint(len(b)) + b


def _int(field, v):
    return _tag(field, 0) + _varint(int(v))


def encode_box(center_x, center_y, center_z, length, width, height,
               heading):
    """Label.Box: seven doubles, fields 1-7."""
    return b"".join(
        _double(i + 1, v)
        for i, v in enumerate(
            (center_x, center_y, center_z, length, width, height, heading))
    )


def encode_label(box_bytes, obj_type, obj_id=None):
    """Label: box=1 (message), type=3 (enum varint), id=4 (string)."""
    out = _bytes(1, box_bytes) + _int(3, obj_type)
    if obj_id is not None:
        out += _bytes(4, obj_id)
    return out


def encode_object(label_bytes, score, context_name,
                  frame_timestamp_micros):
    """metrics.Object: object=1, score=2 (float), context_name=4,
    frame_timestamp_micros=5 (int64)."""
    return (
        _bytes(1, label_bytes)
        + _float(2, score)
        + _bytes(4, context_name)
        + _int(5, frame_timestamp_micros)
    )


def encode_objects(object_bytes_list):
    """metrics.Objects: repeated object=1."""
    return b"".join(_bytes(1, ob) for ob in object_bytes_list)
