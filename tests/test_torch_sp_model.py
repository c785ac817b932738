"""The port's plain-Python ``tokenizer.model`` reader and writer
(``visualcla_tpu_torch/text/sp_model.py``) against the protobuf path of the
JAX package (``visualcla_tpu/text/sp_model.py``, the schema bundled with
transformers): a file written by protobuf parses to an equal ``SPModel``, a
file written by the port parses with protobuf to the same fields, both
round-trip, absent fields take the documented defaults, a negative ``pad_id``
survives (a 10-byte varint) and unknown fields are skipped by wire type.
Exact equality everywhere: scores are float32 on the wire on both paths."""
import dataclasses
import struct

import pytest

from visualcla_tpu.text.sp_model import SPModel as JSPModel
from visualcla_tpu_torch.text import sp_model as t_sp
from visualcla_tpu_torch.text.sp_model import SPModel, build_test_model

pytest.importorskip("transformers")


def models():
    """SPModels that differ in every field the tokenizer reads."""
    plain = build_test_model(["▁a", "b", "▁ab", "你好", "▁你"], [-1.0, -2.0, -0.5, -3.25, -7.0])
    odd = SPModel(
        pieces=["<pad>", "<unk>", "<s>", "</s>", "x", "▁yz", "<user>"],
        scores=[0.0, 0.0, 0.0, 0.0, -0.1, -123.456, 0.0],
        types=[t_sp.CONTROL, t_sp.UNKNOWN, t_sp.CONTROL, t_sp.CONTROL, t_sp.NORMAL,
               t_sp.NORMAL, t_sp.USER_DEFINED],
        unk_id=1, bos_id=2, eos_id=3, pad_id=0, add_dummy_prefix=False,
        remove_extra_whitespaces=True, escape_whitespaces=False, model_type="UNIGRAM")
    no_bytes = build_test_model(["a"], [-1.0], byte_fallback=False, add_dummy_prefix=False)
    return {"byte_fallback": plain, "every_field_off_default": odd, "no_byte_table": no_bytes}


def as_dict(m):
    d = dataclasses.asdict(m)
    d["scores"] = [struct.unpack("<f", struct.pack("<f", s))[0] for s in d["scores"]]
    return d


@pytest.mark.parametrize("name", list(models()))
def test_file_written_by_protobuf_parses_to_an_equal_model(tmp_path, name):
    want = models()[name]
    path = str(tmp_path / "tokenizer.model")
    JSPModel(**{f.name: getattr(want, f.name) for f in dataclasses.fields(SPModel)
                if f.name not in ("piece_to_id", "byte_to_id")}).save(path)
    got = SPModel.load(path)
    assert as_dict(got) == as_dict(JSPModel.load(path)) == as_dict(want)


@pytest.mark.parametrize("name", list(models()))
def test_file_written_by_the_port_parses_with_protobuf(tmp_path, name):
    want = models()[name]
    path = str(tmp_path / "tokenizer.model")
    want.save(path)
    assert as_dict(JSPModel.load(path)) == as_dict(want)
    assert as_dict(SPModel.load(path)) == as_dict(want)  # and round-trips
    # protobuf writes the same bytes for the same fields
    again = str(tmp_path / "again.model")
    JSPModel.load(path).save(again)
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()


def test_negative_pad_id_is_a_ten_byte_varint(tmp_path):
    m = models()["byte_fallback"]
    assert m.pad_id == -1
    data = m.to_bytes()
    pad_field = t_sp._key(t_sp._PAD, t_sp._VARINT) + b"\xff" * 9 + b"\x01"
    assert pad_field in data
    assert SPModel.from_bytes(data).pad_id == -1
    for pad in (-1, -7, 0, 5):
        assert SPModel.from_bytes(dataclasses.replace(m, pad_id=pad).to_bytes()).pad_id == pad


def test_absent_fields_take_the_documented_defaults():
    """An empty trainer and normalizer spec, a piece without score or type:
    ids 0 / 1 / 2 / -1, UNIGRAM, dummy prefix and escaping on, and
    ``remove_extra_whitespaces`` False (unlike sentencepiece's own default),
    as the protobuf path's ``HasField`` tests give."""
    from transformers.convert_slow_tokenizer import import_protobuf

    proto = import_protobuf().ModelProto()
    proto.pieces.add().piece = "a"
    proto.trainer_spec.SetInParent()
    proto.normalizer_spec.SetInParent()
    data = proto.SerializeToString()
    got, want = SPModel.from_bytes(data), JSPModel.from_proto(proto)
    assert as_dict(got) == as_dict(want)
    assert (got.unk_id, got.bos_id, got.eos_id, got.pad_id) == (0, 1, 2, -1)
    assert (got.add_dummy_prefix, got.remove_extra_whitespaces, got.escape_whitespaces) == (
        True, False, True)
    assert got.model_type == "UNIGRAM" and got.types == [t_sp.NORMAL] and got.scores == [0.0]
    assert as_dict(SPModel.from_bytes(b"")) == as_dict(JSPModel.from_proto(
        import_protobuf().ModelProto()))


def test_unknown_fields_are_skipped_by_wire_type(tmp_path):
    """Fields the reader does not know, of every wire type, inside and beside
    the messages it reads (a real file carries vocab_size, input paths, the
    precompiled charsmap, self-test data ...)."""
    from transformers.convert_slow_tokenizer import import_protobuf

    pb2 = import_protobuf()
    m = models()["byte_fallback"]
    path = str(tmp_path / "tokenizer.model")
    m.save(path)
    proto = pb2.ModelProto()
    with open(path, "rb") as f:
        proto.ParseFromString(f.read())
    proto.trainer_spec.vocab_size = 70000  # varint
    proto.trainer_spec.input.append("corpus.txt")  # length-delimited
    proto.trainer_spec.character_coverage = 0.9995  # 32-bit
    proto.trainer_spec.input_sentence_size = 1 << 40  # a long varint
    proto.normalizer_spec.precompiled_charsmap = bytes(range(256)) * 3
    proto.self_test_data.samples.add().input = "hello"
    data = proto.SerializeToString()
    # a 64-bit field and a field number above 15 (a two-byte key) at the top level
    data += t_sp._key(1000, t_sp._FIXED64) + b"\x01\x02\x03\x04\x05\x06\x07\x08"
    assert as_dict(SPModel.from_bytes(data)) == as_dict(m)
    with pytest.raises(ValueError, match="truncated"):
        SPModel.from_bytes(data[:-3])
    with pytest.raises(ValueError, match="wire type"):
        SPModel.from_bytes(t_sp._key(7, 3))  # a group


def test_tokenizer_loads_a_saved_model(tmp_path):
    """``VisualCLATokenizer.from_pretrained`` reads a directory holding only a
    ``tokenizer.model`` written by the port, and tokenizes as before."""
    from visualcla_tpu_torch.fixtures import PROMPT, make_tokenizer
    from visualcla_tpu_torch.text import VisualCLATokenizer

    tok = make_tokenizer(49958)  # the 7B vocabulary
    tok.sp.save(str(tmp_path / "tokenizer.model"))
    loaded = VisualCLATokenizer.from_pretrained(str(tmp_path))
    assert as_dict(loaded.sp) == as_dict(tok.sp)
    assert loaded.encode(PROMPT) == tok.encode(PROMPT)
