"""SentencePiece ``.model`` protobuf reader (no sentencepiece dependency).

The reference's tokenizer core is the C++ ``sentencepiece`` library behind HF's
``LlamaTokenizer`` (reference models/visualcla/modeling_utils.py:94).  That
package is not available here, so we parse the model proto ourselves (via the
protobuf schema bundled with transformers) and run our own SP-compatible BPE
(see ``sp_bpe.py`` for the Python spec and ``csrc/host/`` for the native core).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

# piece types (sentencepiece.ModelProto.SentencePiece.Type)
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
BYTE = 6
UNUSED = 5


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
        from transformers.convert_slow_tokenizer import import_protobuf

        pb2 = import_protobuf()
        proto = pb2.ModelProto()
        with open(path, "rb") as f:
            proto.ParseFromString(f.read())
        return cls.from_proto(proto)

    def save(self, path: str) -> None:
        """Serialize to a real sentencepiece ``.model`` protobuf (round-trips
        through ``load``; used to mint test fixtures and converted vocabs)."""
        from transformers.convert_slow_tokenizer import import_protobuf

        pb2 = import_protobuf()
        proto = pb2.ModelProto()
        for p, s, t in zip(self.pieces, self.scores, self.types):
            sp = proto.pieces.add()
            sp.piece = p
            sp.score = s
            sp.type = t
        proto.trainer_spec.model_type = (
            {"UNIGRAM": 1, "BPE": 2, "WORD": 3, "CHAR": 4}[self.model_type]
        )
        proto.trainer_spec.unk_id = self.unk_id
        proto.trainer_spec.bos_id = self.bos_id
        proto.trainer_spec.eos_id = self.eos_id
        proto.trainer_spec.pad_id = self.pad_id
        proto.trainer_spec.byte_fallback = self.has_byte_fallback
        proto.normalizer_spec.name = "identity"
        proto.normalizer_spec.add_dummy_prefix = self.add_dummy_prefix
        proto.normalizer_spec.remove_extra_whitespaces = self.remove_extra_whitespaces
        proto.normalizer_spec.escape_whitespaces = self.escape_whitespaces
        with open(path, "wb") as f:
            f.write(proto.SerializeToString())

    @classmethod
    def from_proto(cls, proto) -> "SPModel":
        pieces = [p.piece for p in proto.pieces]
        scores = [p.score for p in proto.pieces]
        types = [p.type for p in proto.pieces]
        ts = proto.trainer_spec
        ns = proto.normalizer_spec
        model_type = {1: "UNIGRAM", 2: "BPE", 3: "WORD", 4: "CHAR"}.get(
            ts.model_type, "BPE"
        )
        return cls(
            pieces=pieces,
            scores=scores,
            types=types,
            unk_id=ts.unk_id if ts.HasField("unk_id") else 0,
            bos_id=ts.bos_id if ts.HasField("bos_id") else 1,
            eos_id=ts.eos_id if ts.HasField("eos_id") else 2,
            pad_id=ts.pad_id if ts.HasField("pad_id") else -1,
            add_dummy_prefix=(
                ns.add_dummy_prefix if ns.HasField("add_dummy_prefix") else True
            ),
            remove_extra_whitespaces=(
                ns.remove_extra_whitespaces
                if ns.HasField("remove_extra_whitespaces")
                else False
            ),
            escape_whitespaces=(
                ns.escape_whitespaces if ns.HasField("escape_whitespaces") else True
            ),
            model_type=model_type,
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
