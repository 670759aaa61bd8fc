"""Tokenization SPI.

Counterpart of ``deeplearning4j_tpu/nlp/tokenizer.py``, copied unchanged
(pure Python); ``CJKTokenizerFactory(language=...)`` imports the port's own
``segmentation`` lazily, as the reference does.

Reference: text/tokenization/tokenizer/Tokenizer.java SPI + DefaultTokenizer,
NGramTokenizer, preprocessors (CommonPreprocessor lowercases and strips
punctuation). Language packs (UIMA/ansj/kuromoji) are out of scope for round 1
(SURVEY.md §7 stage 9) — the SPI accepts pluggable tokenizers the same way.
"""
from __future__ import annotations

import re
from typing import Callable, Iterable, List, Optional


class TokenPreProcessor:
    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcessor):
    """Reference text/tokenization/tokenizer/preprocessor/CommonPreprocessor."""
    _punct = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._punct.sub("", token).lower()


class LowCasePreProcessor(TokenPreProcessor):
    def pre_process(self, token: str) -> str:
        return token.lower()


class Tokenizer:
    def __init__(self, tokens: List[str]):
        self._tokens = tokens
        self._i = 0

    def has_more_tokens(self) -> bool:
        return self._i < len(self._tokens)

    def next_token(self) -> str:
        t = self._tokens[self._i]
        self._i += 1
        return t

    def count_tokens(self) -> int:
        return len(self._tokens)

    def get_tokens(self) -> List[str]:
        return list(self._tokens)


class TokenizerFactory:
    def __init__(self, pre_processor: Optional[TokenPreProcessor] = None):
        self.pre_processor = pre_processor

    def set_token_pre_processor(self, p: TokenPreProcessor):
        self.pre_processor = p
        return self

    def _post(self, tokens: Iterable[str]) -> List[str]:
        if self.pre_processor is None:
            return [t for t in tokens if t]
        out = []
        for t in tokens:
            t = self.pre_processor.pre_process(t)
            if t:
                out.append(t)
        return out

    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenizer (reference DefaultTokenizerFactory)."""

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(self._post(text.split()))


class NGramTokenizerFactory(TokenizerFactory):
    """Reference NGramTokenizerFactory: emit n-grams joined by spaces."""

    def __init__(self, min_n: int = 1, max_n: int = 2, pre_processor=None):
        super().__init__(pre_processor)
        self.min_n = min_n
        self.max_n = max_n

    def create(self, text: str) -> Tokenizer:
        base = self._post(text.split())
        out = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(base) - n + 1):
                out.append(" ".join(base[i:i + n]))
        return Tokenizer(out)


class CJKTokenizerFactory(TokenizerFactory):
    """Language pack for Chinese/Japanese/Korean text (reference
    deeplearning4j-nlp-{chinese,japanese,korean} vendor ansj/kuromoji
    segmenters).

    ``language='zh'`` / ``'ja'`` selects the built-in dictionary + Viterbi
    lattice segmenter (nlp/segmentation.py — the ansj/kuromoji mechanism)
    as the DEFAULT. Any callable ``segmenter=`` (str -> List[str])
    overrides it — the reference's pluggable-tokenizer capability. Without
    either, the robust zero-dependency fallback applies: contiguous
    Latin/digit runs stay whole words; CJK ideographs are emitted as
    overlapping character bigrams (standard CJK IR fallback; unigrams when
    ``bigrams=False``); hangul syllable runs stay whole (Korean is
    space-delimited)."""

    _runs = re.compile(
        r"[A-Za-z0-9']+"                 # latin / digits
        r"|[一-鿿぀-ヿ]+"  # CJK ideographs + kana
        r"|[가-힯]+"             # hangul syllables
    )
    _cjk = re.compile(r"[一-鿿぀-ヿ]")

    def __init__(self, pre_processor: Optional[TokenPreProcessor] = None,
                 bigrams: bool = True, segmenter: Optional[Callable] = None,
                 language: Optional[str] = None):
        super().__init__(pre_processor)
        self.bigrams = bigrams
        if segmenter is None and language is not None:
            from .segmentation import ChineseSegmenter, JapaneseSegmenter
            lang = language.lower()
            if lang in ("zh", "chinese", "zh-cn"):
                segmenter = ChineseSegmenter()
            elif lang in ("ja", "japanese", "jp"):
                segmenter = JapaneseSegmenter()
            elif lang in ("ko", "korean"):
                segmenter = None   # hangul runs are space-delimited; fallback
            else:
                raise ValueError(f"Unknown CJK language {language!r} "
                                 f"(zh / ja / ko)")
        self.segmenter = segmenter

    def create(self, text: str) -> Tokenizer:
        if self.segmenter is not None:
            # drop pure punctuation/symbol tokens (。、！…) so they can't
            # pollute the vocabulary — the fallback's run regex never emits
            # them, and the reference segmenters tag them as punctuation
            toks = [t for t in self.segmenter(text)
                    if any(c.isalnum() for c in t)]
        else:
            toks = []
            for run in self._runs.findall(text):
                if self._cjk.match(run):
                    if self.bigrams and len(run) > 1:
                        toks.extend(run[i:i + 2] for i in range(len(run) - 1))
                    else:
                        toks.extend(run)
                else:
                    toks.append(run)
        if self.pre_processor is not None:
            toks = [self.pre_processor.pre_process(t) for t in toks]
        return Tokenizer([t for t in toks if t])
