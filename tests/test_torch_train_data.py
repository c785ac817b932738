"""The training data pipeline of the PyTorch port against the JAX package's:
each example's ids, labels, marker position and pixels token for token and
bit for bit, label masking, caption and text-only records, the bucketed
batches of the prefetching loader (the same seeded order), ``.npy`` images,
and the producer's error re-raised in the consumer."""
import json

import numpy as np
import pytest

from visualcla_tpu.processor import ImageProcessor as JImageProcessor
from visualcla_tpu.text import VisualCLATokenizer as JTokenizer
from visualcla_tpu.text import build_test_model as j_build_test_model
from visualcla_tpu.train import data as j_data
from visualcla_tpu_torch.processor import ImageProcessor
from visualcla_tpu_torch.text import VisualCLATokenizer, build_test_model
from visualcla_tpu_torch.train.data import IGNORE, DataLoader, ExampleBuilder, load_records

CHARS = sorted(set("abcdefgh 你好图片描述这张。"))
SPECIALS = ("<pad>", "<img>", "</img>", "<img_token>")


def _tok(build, klass):
    sp = build(CHARS + ["ab", "描述"], [-100.0] * len(CHARS) + [-1.0, -2.0])
    t = klass(sp, use_native=False)
    t.add_special_tokens(SPECIALS)
    return t


@pytest.fixture(scope="module")
def tok():
    return _tok(build_test_model, VisualCLATokenizer)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    from PIL import Image

    tmp = tmp_path_factory.mktemp("imgs")
    arr = np.random.default_rng(0).integers(0, 256, (40, 40, 3), dtype=np.uint8)
    Image.fromarray(arr).save(str(tmp / "x.png"))
    np.save(str(tmp / "x.npy"), arr)
    return str(tmp)


@pytest.fixture(scope="module")
def builders(tok, images):
    jt = _tok(j_build_test_model, JTokenizer)
    port = ExampleBuilder(tok, ImageProcessor(image_size=28, crop_size=28), num_patch=4,
                          image_dir=images, max_len=256)
    ref = j_data.ExampleBuilder(jt, JImageProcessor(image_size=28, crop_size=28), num_patch=4,
                                image_dir=images, max_len=256)
    return port, ref


RECORDS = [
    {"image": "x.png", "instruction": "ab", "response": "gh"},
    {"image": "x.png", "caption": "图片"},
    {"image": None, "instruction": "ab", "response": "ab"},
    {"instruction": "你好", "response": "cd",
     "history": [{"type": "instruction", "value": "ab"}, {"type": "response", "value": "gh"}]},
    {"image": "x.png", "instruction": "描述", "output": "a b"},
    {"image": "x.png", "instruction": "ab" * 150, "response": "gh"},  # cut at max_len
    {"instruction": "ab"},  # no response: skipped
]


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_examples_match_jax(builders, i):
    port, ref = builders
    a, b = port.build(RECORDS[i]), ref.build(RECORDS[i])
    if b is None:
        assert a is None
        return
    assert set(a) == set(b)
    np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    assert a["img_start_pos"] == b["img_start_pos"]
    if b["pixel_values"] is None:
        assert a["pixel_values"] is None
    else:
        np.testing.assert_array_equal(a["pixel_values"], b["pixel_values"])


def test_multimodal_example_labels(builders, tok):
    ex = builders[0].build({"image": "x.png", "instruction": "ab", "response": "gh"})
    ids, labels = ex["input_ids"], ex["labels"]
    assert ex["pixel_values"].shape == (3, 28, 28)
    assert ids[ex["img_start_pos"]] == tok.img_start_token_id
    n_sup = int((labels != IGNORE).sum())
    assert labels[-n_sup:].tolist() == tok.encode("gh") + [tok.eos_token_id]
    assert (labels[:-n_sup] == IGNORE).all()
    assert ids[-1] == tok.eos_token_id


def test_text_only_example(builders, tok):
    ex = builders[0].build({"image": None, "instruction": "ab", "response": "ab"})
    assert ex["pixel_values"] is None and ex["img_start_pos"] == -1
    assert tok.img_token_id not in ex["input_ids"].tolist()


def test_npy_image_equals_png(builders):
    port = builders[0]
    a = port.build({"image": "x.png", "instruction": "ab", "response": "gh"})
    b = port.build({"image": "x.npy", "instruction": "ab", "response": "gh"})
    np.testing.assert_array_equal(a["pixel_values"], b["pixel_values"])


def test_loader_batches_match_jax(builders, tok):
    port, ref = builders
    records = ([{"image": "x.png", "instruction": "ab", "response": "gh"}] * 3
               + [{"instruction": "ab" * 40, "response": "cd"}] * 3
               + [{"image": "x.png", "caption": "图片"}])
    kw = dict(batch_size=2, image_size=28, buckets=(64, 128, 256), pad_id=tok.pad_token_id,
              seed=3)
    got = list(DataLoader(records, port, **kw))
    want = list(j_data.DataLoader(records, ref, **kw))
    assert len(got) == len(want) == 3  # the remainder is dropped
    for a, b in zip(got, want):
        assert set(a) == set(b) == {"input_ids", "attention_mask", "labels",
                                    "img_start_pos", "pixel_values"}
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        B, L = a["input_ids"].shape
        assert B == 2 and L in (64, 128, 256)
        assert ((a["labels"] != IGNORE) <= (a["attention_mask"] == 1)).all()
    tail = list(DataLoader(records, port, drop_remainder=False, **kw))
    assert len(tail) == 4 and tail[-1]["input_ids"].shape[0] == 1


def test_loader_reraises_the_producers_error(builders):
    records = [{"image": "missing.png", "instruction": "ab", "response": "gh"}] * 2
    with pytest.raises(OSError):
        list(DataLoader(records, builders[0], batch_size=1, image_size=28))


def test_load_records_json_and_jsonl(tmp_path):
    p = str(tmp_path / "d.jsonl")
    with open(p, "w") as f:
        f.write(json.dumps({"instruction": "a", "response": "b"}) + "\n\n")
        f.write(json.dumps({"instruction": "c", "response": "d"}) + "\n")
    assert load_records(p) == j_data.load_records(p) and len(load_records(p)) == 2
    p2 = str(tmp_path / "d.json")
    with open(p2, "w") as f:
        json.dump([{"instruction": "a", "response": "b"}], f)
    assert load_records(p2) == j_data.load_records(p2) and len(load_records(p2)) == 1
