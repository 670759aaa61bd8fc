"""The CJK segmenters (``nlp/segmentation.py``, ``nlp/dict_build.py`` and
the two lexicons in ``nlp/data/``) against the JAX package's.

The port's segmenters must give the reference's tokens sentence by
sentence on both graded fixtures (jieba's segmentation of Chinese text,
a held-out Japanese corpus), with the bundled lexicon and with the
embedded core alone. The port reads its own copy of each lexicon; their
SHA-256 equal the reference's, so the copies cannot drift.
"""
import hashlib
import json
import os
import pathlib

import pytest

from deeplearning4j_tpu import nlp as jnlp
from deeplearning4j_tpu.nlp import dict_build as jdict
from deeplearning4j_tpu.nlp import segmentation as jseg
from deeplearning4j_tpu_torch import nlp as tnlp
from deeplearning4j_tpu_torch.nlp import dict_build as tdict
from deeplearning4j_tpu_torch.nlp import segmentation as tseg

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _data(name):
    with open(FIXTURES / name, encoding="utf-8") as f:
        return json.load(f)["data"]


@pytest.fixture(scope="module")
def segmenters():
    return {(lang, bundled): (getattr(tseg, cls)(use_bundled=bundled),
                              getattr(jseg, cls)(use_bundled=bundled))
            for lang, cls in (("zh", "ChineseSegmenter"),
                              ("ja", "JapaneseSegmenter"))
            for bundled in (True, False)}


@pytest.mark.parametrize("bundled", [True, False], ids=["bundled", "core"])
@pytest.mark.parametrize("lang,fixture", [("zh", "zh_gold_jieba.json"),
                                          ("ja", "ja_heldout_gold.json")])
def test_segmenters_give_the_references_tokens(segmenters, lang, fixture,
                                               bundled):
    port, ref = segmenters[(lang, bundled)]
    assert len(port) == len(ref)
    data = _data(fixture)
    assert len(data) >= 20
    for item in data:
        s = item["sentence"]
        assert port.segment(s) == ref.segment(s), s


def test_lexicon_copies_are_the_references():
    for name in ("zh_dict.tsv", "ja_dict.tsv"):
        ours = ROOT / "deeplearning4j_tpu_torch" / "nlp" / "data" / name
        theirs = ROOT / "deeplearning4j_tpu" / "nlp" / "data" / name
        assert hashlib.sha256(ours.read_bytes()).hexdigest() == \
            hashlib.sha256(theirs.read_bytes()).hexdigest()
    # the port loads its own copy
    assert os.path.dirname(tseg._DATA_DIR) == os.path.dirname(
        os.path.abspath(tseg.__file__))


def test_pos_of_and_user_dictionary(segmenters):
    port, ref = segmenters[("zh", True)]
    for w in ("天气", "不存在的词汇串", "学习"):
        assert port.pos_of(w) == ref.pos_of(w)
    text = "量子纠错码非常重要"
    seg = tseg.ChineseSegmenter()
    assert "量子纠错码" not in seg.segment(text)
    seg.add_word("量子纠错码", 100000, pos="n")
    assert "量子纠错码" in seg.segment(text) and seg.pos_of("量子纠错码") == "n"
    ja, jref = tseg.JapaneseSegmenter(), jseg.JapaneseSegmenter()
    for s in ("コンピュータは面白いです", "量子計算を勉強します"):
        assert ja.segment(s) == jref.segment(s)
    ja.add_word("量子計算", 100)
    jref.add_word("量子計算", 100)
    assert ja.segment("量子計算を勉強します") == \
        jref.segment("量子計算を勉強します")
    assert "量子計算" in ja.segment("量子計算を勉強します")


def test_dict_build_round_trip_crosses_packages(tmp_path):
    tokens = [("猫", "名詞"), ("猫", "名詞"), ("走る", "動詞"), ("猫", "代名詞"),
              ("ｶﾀｶﾅ", "名詞"), ("。", "記号")]
    entries = tdict.compile_dictionary(tokens)
    assert entries == jdict.compile_dictionary(tokens)
    assert entries["猫"] == (3, "名詞")
    ours, theirs = str(tmp_path / "port.tsv"), str(tmp_path / "jax.tsv")
    tdict.write_dict_tsv(entries, ours, header="test dict")
    jdict.write_dict_tsv(entries, theirs, header="test dict")
    assert pathlib.Path(ours).read_bytes() == pathlib.Path(theirs).read_bytes()
    assert jdict.read_dict_tsv(ours) == tdict.read_dict_tsv(theirs) == entries
    seg = tseg.LatticeSegmenter().load_tsv(ours)
    assert "猫" in seg and seg.pos_of("猫") == "名詞"


ZH = ["我们在北京大学学习机器学习", "今天天气很好", "他们的老师现在在中国工作",
      "今天天气很好。我喜欢吃苹果！"]
JA = ["私は東京大学の学生です", "彼女は毎日日本語を勉強しています",
      "この本はとても面白いです"]


@pytest.mark.parametrize("lang,texts", [("zh", ZH), ("ja", JA)])
def test_cjk_factory_uses_the_ports_segmenter(lang, texts):
    tf = tnlp.CJKTokenizerFactory(language=lang)
    assert type(tf.segmenter).__module__ == tseg.__name__
    jf = jnlp.CJKTokenizerFactory(language=lang)
    for t in texts:
        assert tf.create(t).get_tokens() == jf.create(t).get_tokens()
    assert "。" not in tf.create(ZH[-1]).get_tokens()


def test_word2vec_over_segmented_chinese():
    corpus = (["我们 学习 机器学习", "学生 在 大学 学习", "老师 教 学生 机器学习",
               "今天 天气 很 好", "明天 天气 不 好", "天气 好 我们 高兴"] * 10)
    corpus = ["".join(s.split()) for s in corpus]
    w2v = tnlp.Word2Vec(layer_size=16, window=3, min_word_frequency=1,
                        epochs=5, negative=3, seed=4, device="cpu",
                        tokenizer_factory=tnlp.CJKTokenizerFactory(
                            language="zh"))
    w2v.fit(corpus)
    assert w2v.has_word("机器学习") and w2v.has_word("天气")
