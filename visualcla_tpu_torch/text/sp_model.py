"""SentencePiece ``.model`` protobuf reader and writer (no sentencepiece,
protobuf or transformers dependency).

The reference's tokenizer core is the C++ ``sentencepiece`` library behind HF's
``LlamaTokenizer`` (reference models/visualcla/modeling_utils.py:94).  That
package is not available here, so we parse the ``ModelProto`` wire format
ourselves (plain Python: varints, 32- and 64-bit and length-delimited fields;
unknown fields are skipped by wire type) and run our own SP-compatible BPE
(see ``sp_bpe.py`` for the Python spec and ``csrc/host/`` for the native core).
Only the fields the tokenizer uses are read and written: the pieces (piece,
score, type), the trainer's model type and special ids, and the normalizer's
whitespace flags.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Iterator, List, Optional, Tuple

# piece types (sentencepiece.ModelProto.SentencePiece.Type)
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
BYTE = 6
UNUSED = 5

_MODEL_TYPES = {1: "UNIGRAM", 2: "BPE", 3: "WORD", 4: "CHAR"}
# field numbers of sentencepiece_model.proto
_PIECES, _TRAINER, _NORMALIZER = 1, 2, 3  # ModelProto
_PIECE, _SCORE, _TYPE = 1, 2, 3  # ModelProto.SentencePiece
_MODEL_TYPE, _BYTE_FALLBACK, _UNK, _BOS, _EOS, _PAD = 3, 35, 40, 41, 42, 43  # TrainerSpec
_NAME, _DUMMY_PREFIX, _REMOVE_EXTRA_WS, _ESCAPE_WS = 1, 3, 4, 5  # NormalizerSpec
_VARINT, _FIXED64, _BYTES, _FIXED32 = 0, 1, 2, 5  # wire types


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint in tokenizer model")
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint longer than 10 bytes in tokenizer model")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of one message: an int
    for a varint, the raw bytes otherwise."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wire = key >> 3, key & 7
        if wire == _VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire in (_FIXED64, _FIXED32):
            end = pos + (8 if wire == _FIXED64 else 4)
            value, pos = buf[pos:end], end
        elif wire == _BYTES:
            size, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + size], pos + size
        else:
            raise ValueError(f"unsupported wire type {wire} in tokenizer model")
        if pos > len(buf):
            raise ValueError("truncated field in tokenizer model")
        yield number, wire, value


def _scalars(buf: bytes, wanted) -> Dict[int, object]:
    """The last value of each wanted scalar field of a message (absent fields
    are absent from the result; every other field is skipped)."""
    return {n: v for n, _, v in _fields(buf) if n in wanted}


def _int32(value: int) -> int:
    """A varint as the int32 it encodes (negatives are sign-extended to 64 bits)."""
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >= 1 << 31 else value


def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1  # a negative int32 is written as its 64-bit two's complement
    out = bytearray()
    while value >= 0x80:
        out.append(value & 0x7F | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _key(number: int, wire: int) -> bytes:
    return _varint(number << 3 | wire)


def _varint_field(number: int, value: int) -> bytes:
    return _key(number, _VARINT) + _varint(int(value))


def _bytes_field(number: int, payload: bytes) -> bytes:
    return _key(number, _BYTES) + _varint(len(payload)) + payload


@dataclasses.dataclass
class SPModel:
    """Parsed SentencePiece model: vocabulary + scores + normalizer flags."""

    pieces: List[str]
    scores: List[float]
    types: List[int]
    unk_id: int
    bos_id: int
    eos_id: int
    pad_id: int
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = False
    escape_whitespaces: bool = True
    model_type: str = "BPE"
    piece_to_id: Dict[str, int] = dataclasses.field(default_factory=dict)
    byte_to_id: Optional[List[int]] = None

    def __post_init__(self):
        if not self.piece_to_id:
            self.piece_to_id = {p: i for i, p in enumerate(self.pieces)}
        if self.byte_to_id is None and any(t == BYTE for t in self.types):
            table = [-1] * 256
            for i, (p, t) in enumerate(zip(self.pieces, self.types)):
                if t == BYTE:
                    table[int(p[1:-1], 16)] = i  # piece "<0xAB>"
            self.byte_to_id = table

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    @property
    def has_byte_fallback(self) -> bool:
        return self.byte_to_id is not None

    @classmethod
    def load(cls, path: str) -> "SPModel":
        """Parse a ``tokenizer.model`` file."""
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    def save(self, path: str) -> None:
        """Serialize to a real sentencepiece ``.model`` protobuf (round-trips
        through ``load``; used to mint test fixtures and converted vocabs)."""
        with open(path, "wb") as f:
            f.write(self.to_bytes())

    def to_bytes(self) -> bytes:
        """The ``ModelProto`` wire format of this model."""
        out = bytearray()
        for p, s, t in zip(self.pieces, self.scores, self.types):
            out += _bytes_field(_PIECES, _bytes_field(_PIECE, p.encode("utf-8"))
                                + _key(_SCORE, _FIXED32) + struct.pack("<f", s)
                                + _varint_field(_TYPE, t))
        model_type = {name: n for n, name in _MODEL_TYPES.items()}[self.model_type]
        out += _bytes_field(_TRAINER, _varint_field(_MODEL_TYPE, model_type)
                            + _varint_field(_BYTE_FALLBACK, self.has_byte_fallback)
                            + _varint_field(_UNK, self.unk_id) + _varint_field(_BOS, self.bos_id)
                            + _varint_field(_EOS, self.eos_id) + _varint_field(_PAD, self.pad_id))
        out += _bytes_field(_NORMALIZER, _bytes_field(_NAME, b"identity")
                            + _varint_field(_DUMMY_PREFIX, self.add_dummy_prefix)
                            + _varint_field(_REMOVE_EXTRA_WS, self.remove_extra_whitespaces)
                            + _varint_field(_ESCAPE_WS, self.escape_whitespaces))
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "SPModel":
        """Parse the ``ModelProto`` wire format.  Absent fields take these
        defaults: piece type NORMAL and score 0 (the schema's), model type
        UNIGRAM (the schema's), unk / bos / eos / pad ids 0 / 1 / 2 / -1,
        ``add_dummy_prefix`` and ``escape_whitespaces`` True, and
        ``remove_extra_whitespaces`` False (unlike sentencepiece's own)."""
        pieces, scores, types = [], [], []
        trainer, normalizer = b"", b""
        for number, wire, value in _fields(data):
            if wire != _BYTES:
                continue
            if number == _PIECES:
                f = _scalars(value, (_PIECE, _SCORE, _TYPE))
                pieces.append(f.get(_PIECE, b"").decode("utf-8"))
                scores.append(struct.unpack("<f", f[_SCORE])[0] if _SCORE in f else 0.0)
                types.append(_int32(f.get(_TYPE, NORMAL)))
            elif number == _TRAINER:  # a repeated sub-message merges: later fields win
                trainer += value
            elif number == _NORMALIZER:
                normalizer += value
        ts = _scalars(trainer, (_MODEL_TYPE, _UNK, _BOS, _EOS, _PAD))
        ns = _scalars(normalizer, (_DUMMY_PREFIX, _REMOVE_EXTRA_WS, _ESCAPE_WS))
        return cls(
            pieces=pieces, scores=scores, types=types,
            unk_id=_int32(ts.get(_UNK, 0)), bos_id=_int32(ts.get(_BOS, 1)),
            eos_id=_int32(ts.get(_EOS, 2)), pad_id=_int32(ts.get(_PAD, -1)),
            add_dummy_prefix=bool(ns.get(_DUMMY_PREFIX, True)),
            remove_extra_whitespaces=bool(ns.get(_REMOVE_EXTRA_WS, False)),
            escape_whitespaces=bool(ns.get(_ESCAPE_WS, True)),
            model_type=_MODEL_TYPES.get(_int32(ts.get(_MODEL_TYPE, 1)), "BPE"),
        )


def build_test_model(
    vocab: List[str],
    scores: List[float],
    *,
    byte_fallback: bool = True,
    add_dummy_prefix: bool = True,
) -> SPModel:
    """Fabricate an SPModel for tests: ``<unk>/<s>/</s>`` + optional byte table
    + caller vocab (scores = -merge_rank for BPE semantics)."""
    pieces = ["<unk>", "<s>", "</s>"]
    types = [UNKNOWN, CONTROL, CONTROL]
    sc = [0.0, 0.0, 0.0]
    if byte_fallback:
        for b in range(256):
            pieces.append(f"<0x{b:02X}>")
            types.append(BYTE)
            sc.append(0.0)
    pieces += list(vocab)
    types += [NORMAL] * len(vocab)
    sc += list(scores)
    return SPModel(
        pieces=pieces, scores=sc, types=types,
        unk_id=0, bos_id=1, eos_id=2, pad_id=-1,
        add_dummy_prefix=add_dummy_prefix,
    )
