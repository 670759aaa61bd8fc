"""Sentence/document iteration SPI.

Counterpart of ``deeplearning4j_tpu/nlp/sentence_iterator.py``, copied
unchanged (pure Python).

Reference: text/sentenceiterator/SentenceIterator.java + BasicLineIterator,
CollectionSentenceIterator, LabelAwareIterator family.
"""
from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Sequence, Tuple


class SentenceIterator:
    def __iter__(self) -> Iterator[str]:
        raise NotImplementedError

    def reset(self):
        pass


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Sequence[str]):
        self.sentences = list(sentences)

    def __iter__(self):
        return iter(self.sentences)


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file (reference BasicLineIterator)."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self):
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line


class LabelledDocument:
    def __init__(self, content: str, labels: List[str]):
        self.content = content
        self.labels = labels


class LabelAwareIterator:
    """Documents with labels (reference documentiterator/LabelAwareIterator) —
    consumed by ParagraphVectors."""

    def __iter__(self) -> Iterator[LabelledDocument]:
        raise NotImplementedError


class SimpleLabelAwareIterator(LabelAwareIterator):
    def __init__(self, docs: Sequence[Tuple[str, str]]):
        """docs: (label, content) pairs."""
        self.docs = list(docs)

    def __iter__(self):
        for label, content in self.docs:
            yield LabelledDocument(content, [label])
