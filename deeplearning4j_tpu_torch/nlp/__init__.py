"""Natural-language processing: tokenizers, vocabularies, CJK segmenters,
POS tagging and lemmas, vectorizers, and the SequenceVectors engine with
Word2Vec, ParagraphVectors, GloVe and DistributedWord2Vec.

Counterpart of ``deeplearning4j_tpu/nlp/__init__.py``: the same exports,
name for name.
"""
from .distributed_w2v import DistributedWord2Vec
from .glove import Glove
from .sentence_iterator import (BasicLineIterator, CollectionSentenceIterator,
                                LabelAwareIterator, LabelledDocument,
                                SentenceIterator, SimpleLabelAwareIterator)
from .sequence_vectors import SequenceVectors
from .serde import (read_binary_word_vectors, read_word_vectors,
                    write_binary_word_vectors, write_word_vectors)
from .lemmatizer import LemmatizingTokenizerFactory, RuleBasedLemmatizer
from .pos import PosFilterTokenizerFactory, RuleBasedPosTagger
from .segmentation import (ChineseSegmenter, JapaneseSegmenter,
                           LatticeSegmenter)
from .tokenizer import (CJKTokenizerFactory, CommonPreprocessor,
                        DefaultTokenizerFactory, LowCasePreProcessor,
                        NGramTokenizerFactory, TokenizerFactory)
from .vectorizers import (BagOfWordsVectorizer, CollectionDocumentIterator,
                          DocumentIterator, FileDocumentIterator,
                          TfidfVectorizer)
from .vocab import VocabCache, VocabWord
from .word2vec import ParagraphVectors, Word2Vec

__all__ = [n for n in dir() if not n.startswith("_")]
