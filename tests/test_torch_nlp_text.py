"""The NLP library's text side (tokenizers, iterators, vocabulary, Huffman
coding, the unigram table, vectorizers, POS tags and lemmas) against the
JAX package's.

These modules are copies of the reference's pure-Python and numpy code, so
every comparison here is exact: the same tokens, the same vocabulary
order, the same Huffman codes and points, the same padded arrays and a
bitwise-equal unigram table (every negative a fit samples is read from
it). The cases are the reference tests' (``tests/test_nlp.py``,
``tests/test_lemmatizer.py``) run through both packages.
"""
import numpy as np
import pytest

from deeplearning4j_tpu import nlp as jnlp
from deeplearning4j_tpu.nlp import vectorizers as jvec
from deeplearning4j_tpu_torch import nlp as tnlp
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nlp import vectorizers as tvec

TEXTS = ["Hello, World! 123 foo", "a b c", "The quick (brown) fox; it's ok",
         "  spaced   out\ttabs\nnewline  ", "",
         "CJK 混合 text 今日は晴れ 한국어 문장 abc123",
         "今天天气很好。我喜欢吃苹果！", "the children were running"]


def _tokens(pkg, factory, *args, **kw):
    return [getattr(pkg, factory)(*args, **kw).create(t).get_tokens()
            for t in TEXTS]


@pytest.mark.parametrize("factory,args,kw", [
    ("DefaultTokenizerFactory", (), {}),
    ("NGramTokenizerFactory", (1, 2), {}),
    ("NGramTokenizerFactory", (2, 3), {}),
    ("CJKTokenizerFactory", (), {}),
    ("CJKTokenizerFactory", (), {"bigrams": False}),
], ids=["default", "ngram12", "ngram23", "cjk_bigrams", "cjk_unigrams"])
def test_tokenizers_equal_the_reference(factory, args, kw):
    assert _tokens(tnlp, factory, *args, **kw) == \
        _tokens(jnlp, factory, *args, **kw)


@pytest.mark.parametrize("pre", ["CommonPreprocessor", "LowCasePreProcessor"])
def test_preprocessors_equal_the_reference(pre):
    got = [tnlp.DefaultTokenizerFactory(getattr(tnlp, pre)()).create(t)
           .get_tokens() for t in TEXTS]
    want = [jnlp.DefaultTokenizerFactory(getattr(jnlp, pre)()).create(t)
            .get_tokens() for t in TEXTS]
    assert got == want
    assert got[0] == (["hello", "world", "foo"]
                      if pre == "CommonPreprocessor"
                      else ["hello,", "world!", "123", "foo"])


def test_cjk_custom_segmenter_and_korean_fallback():
    seg = lambda s: list(s)   # noqa: E731
    for text in TEXTS:
        assert tnlp.CJKTokenizerFactory(segmenter=seg).create(text) \
            .get_tokens() == jnlp.CJKTokenizerFactory(segmenter=seg) \
            .create(text).get_tokens()
    assert tnlp.CJKTokenizerFactory(language="ko").segmenter is None
    with pytest.raises(ValueError, match="Unknown CJK language"):
        tnlp.CJKTokenizerFactory(language="xx")


def test_sentence_iterators_equal_the_reference(tmp_path):
    p = tmp_path / "lines.txt"
    p.write_text("first line\n\n  second line  \nthird\n", encoding="utf-8")
    assert list(tnlp.BasicLineIterator(str(p))) == \
        list(jnlp.BasicLineIterator(str(p)))
    docs = [("a", "x y"), ("b", "z")]
    got = [(d.labels, d.content) for d in tnlp.SimpleLabelAwareIterator(docs)]
    want = [(d.labels, d.content) for d in jnlp.SimpleLabelAwareIterator(docs)]
    assert got == want
    assert list(tnlp.CollectionSentenceIterator(TEXTS)) == TEXTS


def _corpus(seed, n=200):
    r = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(60)]
    return [[words[int(i) % 60] for i in r.zipf(1.3, r.integers(0, 15))]
            for _ in range(n)]


@pytest.mark.parametrize("seed,min_freq", [(0, 1), (1, 2), (2, 5)])
def test_vocab_huffman_and_unigram_table_bitwise(seed, min_freq):
    corpus = _corpus(seed)
    jv = jnlp.VocabCache.build(corpus, min_freq)
    tv = tnlp.VocabCache.build(corpus, min_freq)
    jv.build_huffman()
    tv.build_huffman()
    assert len(tv) == len(jv) > 3 and tv.total_count == jv.total_count
    for i in range(len(jv)):
        a, b = tv.word_for(tv.word_at(i)), jv.word_for(jv.word_at(i))
        assert (a.word, a.count, a.index, a.code, a.points) == \
            (b.word, b.count, b.index, b.code, b.points)
    for got, want in zip(tv.huffman_arrays(), jv.huffman_arrays()):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    got, want = tv.unigram_table(), jv.unigram_table()
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(tv.unigram_table(1000, 0.5),
                          jv.unigram_table(1000, 0.5))
    for sample in (0.0, 1e-3, 1e-1):
        a, b = tv.subsample_keep_probs(sample), jv.subsample_keep_probs(sample)
        assert (a is None and b is None) or np.array_equal(a, b)


def test_vocab_order_and_small_cases():
    vc = tnlp.VocabCache.build([["b", "a", "a", "c", "b", "a", "d", "c"]])
    assert [vc.word_at(i) for i in range(len(vc))] == ["a", "b", "c", "d"]
    assert vc.index_of("zzz") == -1 and vc.word_frequency("zzz") == 0
    one = tnlp.VocabCache.build([["solo", "solo"]])
    codes, points, mask = one.huffman_arrays()
    assert codes.shape == (1, 1) and mask.sum() == 0
    empty = tnlp.VocabCache.build([])
    empty.build_huffman()
    assert len(empty) == 0


def test_bag_of_words_and_tfidf_equal_the_reference(tmp_path):
    docs = ["apple banana apple", "banana cherry",
            "apple cherry cherry date", "the end of the apple"]
    for kw in ({}, {"min_word_frequency": 2}, {"stop_words": ["the", "of"]}):
        tb, jb = tvec.BagOfWordsVectorizer(**kw).fit(docs), \
            jvec.BagOfWordsVectorizer(**kw).fit(docs)
        assert tb.vocab == jb.vocab
        assert np.array_equal(tb.transform_documents(docs),
                              jb.transform_documents(docs))
        tt, jt = tvec.TfidfVectorizer(**kw).fit(docs), \
            jvec.TfidfVectorizer(**kw).fit(docs)
        assert np.array_equal(tt.idf(), jt.idf())
        for d in docs + ["apple date unknown"]:
            assert np.array_equal(tt.transform(d), jt.transform(d))
            assert tt.tfidf_word("apple", d) == jt.tfidf_word("apple", d)
    ds = tvec.BagOfWordsVectorizer().fit(docs).vectorize(
        "apple banana", "fruit", ["fruit", "other"])
    want = jvec.BagOfWordsVectorizer().fit(docs).vectorize(
        "apple banana", "fruit", ["fruit", "other"])
    assert isinstance(ds, DataSet)
    assert np.array_equal(ds.features, want.features)
    assert np.array_equal(ds.labels, want.labels)
    for i, d in enumerate(docs):
        (tmp_path / f"d{i}.txt").write_text(d)
    assert list(tvec.FileDocumentIterator(str(tmp_path))) == \
        list(jvec.FileDocumentIterator(str(tmp_path)))
    assert len(list(tvec.CollectionDocumentIterator(docs))) == 4


LEMMA_CASES = [
    ("running", "run"), ("makes", "make"), ("driving", "drive"),
    ("tried", "try"), ("wanted", "want"), ("stopped", "stop"),
    ("cities", "city"), ("dogs", "dog"), ("boxes", "box"),
    ("churches", "church"), ("heroes", "hero"), ("leaves", "leaf"),
    ("was", "be"), ("is", "be"), ("been", "be"), ("has", "have"),
    ("went", "go"), ("taken", "take"), ("children", "child"),
    ("women", "woman"), ("wrote", "write"), ("bigger", "big"),
    ("best", "good"), ("earliest", "early"),
    ("this", "this"), ("news", "news"), ("glass", "glass"),
    ("series", "series"), ("run", "run"), ("red", "red"),
    ("opened", "open"), ("happened", "happen"), ("visited", "visit"),
    ("listened", "listen"), ("covered", "cover"), ("opening", "open"),
    ("believed", "believe"), ("received", "receive"), ("danced", "dance"),
    ("argued", "argue"), ("loved", "love")]


def test_lemmas_equal_the_reference():
    t, j = tnlp.RuleBasedLemmatizer(), jnlp.RuleBasedLemmatizer()
    for word, lemma in LEMMA_CASES:
        assert t.lemmatize(word) == j.lemmatize(word) == lemma, word
    for word, tag, lemma in (("lives", "VBZ", "live"),
                             ("lives", "NNS", "life"),
                             ("leaves", "VBZ", "leave"),
                             ("leaves", "NNS", "leaf"),
                             ("children", "VB", "child"),
                             ("went", "NN", "go")):
        assert t.lemmatize(word, tag) == j.lemmatize(word, tag) == lemma


def test_lemmatizing_factory_equals_the_reference():
    text = ("the dog runs . the dogs ran . a dog is running . "
            "dogs have run . the children were running and the dogs barked")
    got = tnlp.LemmatizingTokenizerFactory(tnlp.DefaultTokenizerFactory())
    want = jnlp.LemmatizingTokenizerFactory(jnlp.DefaultTokenizerFactory())
    assert got.create(text).get_tokens() == want.create(text).get_tokens()
    got.set_token_pre_processor(tnlp.CommonPreprocessor())
    want.set_token_pre_processor(jnlp.CommonPreprocessor())
    assert got.create("Dogs, running!").get_tokens() == \
        want.create("Dogs, running!").get_tokens()


POS_TEXTS = ["the quick dog quickly ate 42 sandwiches in London",
             "Running works", "She was running and ate quickly",
             "the hungry dog quickly ate two big sandwiches in the kitchen"]


def test_pos_tags_and_filters_equal_the_reference():
    t, j = tnlp.RuleBasedPosTagger(), jnlp.RuleBasedPosTagger()
    for s in POS_TEXTS:
        assert t.tag(s.split()) == j.tag(s.split())
    tags = t.tag(POS_TEXTS[0].split())
    assert [tags[i] for i in (0, 3, 4, 5, 6, 7, 8)] == [
        "DT", "RB", "VBD", "CD", "NNS", "IN", "NNP"]
    assert t.tag(["Running", "works"])[0] == "VBG"
    for tags, pre in ((["NN*"], None), (["VBD", "VBG"], "CommonPreprocessor")):
        tf = tnlp.PosFilterTokenizerFactory(
            tags, pre_processor=pre and getattr(tnlp, pre)())
        jf = jnlp.PosFilterTokenizerFactory(
            tags, pre_processor=pre and getattr(jnlp, pre)())
        for s in POS_TEXTS:
            assert tf.create(s).get_tokens() == jf.create(s).get_tokens()


def test_pos_filtered_word2vec_vocabulary():
    """The reference's POS-filtered Word2Vec case, on the port."""
    corpus = ["the dog quickly ate the food in the house",
              "a cat slowly drank the water in the kitchen"] * 20
    w2v = tnlp.Word2Vec(layer_size=16, window=3, min_word_frequency=1,
                        epochs=3, negative=3, seed=4, device="cpu",
                        tokenizer_factory=tnlp.PosFilterTokenizerFactory(
                            ["NN*"]))
    w2v.fit(corpus)
    assert w2v.has_word("dog") and w2v.has_word("kitchen")
    assert not w2v.has_word("quickly") and not w2v.has_word("the")
    assert w2v.syn0.dtype == np.float32 and np.isfinite(w2v.syn0).all()
