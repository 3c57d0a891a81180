"""A SentencePiece model file (``*.model``), read without protobuf.

The file is a serialised ``sentencepiece.ModelProto`` (SentencePiece's
``sentencepiece_model.proto``). The card's machine has neither
``sentencepiece`` nor ``google.protobuf``, so :func:`read_model_proto` walks
protobuf's wire format itself: each field is a varint key (field number << 3
| wire type) followed by a varint (type 0), 8 bytes (type 1), a
length-delimited payload (type 2) or 4 bytes (type 5). Fields it does not
need are skipped by their wire type, so a file written by a newer
SentencePiece reads the same.

What it reads (the field numbers of ``sentencepiece_model.proto``):

* ``ModelProto.pieces`` (1): ``piece`` (1, string), ``score`` (2, float),
  ``type`` (3, enum: 1 normal, 2 unknown, 3 control, 4 user-defined,
  5 unused, 6 byte);
* ``ModelProto.trainer_spec`` (2): ``model_type`` (3, enum: 1 Unigram,
  2 BPE, 3 word, 4 char);
* ``ModelProto.normalizer_spec`` (3): ``precompiled_charsmap`` (2, bytes).

Absent fields take the proto's defaults (Unigram, no charsmap). The rest
(the unknown piece, byte fallback, the dummy prefix) plays no part in the
pipelines ``transformers`` converts for the classes read here.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterator, List, Tuple

NORMAL, CONTROL, USER_DEFINED = 1, 3, 4  # SentencePiece.Type
UNIGRAM, BPE = 1, 2  # TrainerSpec.ModelType


@dataclass
class Piece:
    piece: str = ""
    score: float = 0.0
    type: int = NORMAL


@dataclass
class ModelProto:
    pieces: List[Piece] = field(default_factory=list)
    model_type: int = UNIGRAM
    precompiled_charsmap: bytes = b""


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        if i >= len(buf):
            raise ValueError("a SentencePiece model ends inside a varint")
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field in ``buf``: an int for
    types 0, 1 and 5 (the raw little-endian bits), bytes for type 2."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _varint(buf, i)
        elif wire == 1:
            val, i = int.from_bytes(buf[i : i + 8], "little"), i + 8
        elif wire == 2:
            size, i = _varint(buf, i)
            val, i = buf[i : i + size], i + size
        elif wire == 5:
            val, i = int.from_bytes(buf[i : i + 4], "little"), i + 4
        else:
            raise ValueError(f"a SentencePiece model holds protobuf wire type {wire} (field {num})")
        if i > n:
            raise ValueError(f"a SentencePiece model ends inside field {num}")
        yield num, wire, val


def _int32(v: int) -> int:
    """A varint read as protobuf's int32 (a negative one is ten bytes of
    two's complement)."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def _f32(bits: int) -> float:
    return struct.unpack("<f", bits.to_bytes(4, "little"))[0]


def _piece(buf: bytes) -> Piece:
    p = Piece()
    for num, wire, val in _fields(buf):
        if num == 1 and wire == 2:
            p.piece = val.decode("utf-8")
        elif num == 2 and wire == 5:
            p.score = _f32(val)
        elif num == 3 and wire == 0:
            p.type = _int32(val)
    return p


def read_model_proto(data: bytes) -> ModelProto:
    """The fields above of a serialised ``ModelProto``."""
    m = ModelProto()
    for num, wire, val in _fields(data):
        if num == 1 and wire == 2:
            m.pieces.append(_piece(val))
        elif num == 2 and wire == 2:
            for f, w, v in _fields(val):
                if f == 3 and w == 0:
                    m.model_type = _int32(v)
        elif num == 3 and wire == 2:
            for f, w, v in _fields(val):
                if f == 2 and w == 2:
                    m.precompiled_charsmap = bytes(v)
    return m


def read_model_file(path: str) -> ModelProto:
    with open(path, "rb") as f:
        return read_model_proto(f.read())
