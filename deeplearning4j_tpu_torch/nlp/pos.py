"""Part-of-speech tagging + POS-filtered tokenization.

Counterpart of ``deeplearning4j_tpu/nlp/pos.py``, copied unchanged (pure
Python).

Reference: deeplearning4j-nlp-uima — `UimaTokenizerFactory` runs a UIMA
analysis engine (tokenizer + POS tagger) and `PosUimaTokenizerFactory`
keeps only tokens whose POS tag is in an allowed set (e.g. noun-only
Word2Vec corpora); `text/annotator/PoStagger` wires the ClearTK tagger.

The capability is reproduced with a self-contained rule+lexicon English
tagger (no UIMA/model downloads): embedded lexicon of frequent closed-class
and common open-class words, then morphology/suffix rules, then a
capitalization heuristic, defaulting to NN — the classic rule-baseline
design. Simplified Penn tagset (NN, NNS, NNP, VB, VBD, VBG, VBZ, JJ, RB,
DT, IN, PRP, PRP$, CC, CD, TO, MD). Accuracy is baseline-grade (~90% on
plain prose), which is what the reference's POS FILTERING use case needs;
a better tagger plugs in via the ``tagger=`` seam.
"""
from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence

from .tokenizer import (DefaultTokenizerFactory, TokenPreProcessor, Tokenizer,
                        TokenizerFactory)

# closed classes + frequent open-class words (lowercased)
_LEXICON = {
    # determiners / pronouns / conjunctions / prepositions / modals
    "the": "DT", "a": "DT", "an": "DT", "this": "DT", "that": "DT",
    "these": "DT", "those": "DT", "some": "DT", "any": "DT", "no": "DT",
    "each": "DT", "every": "DT",
    "i": "PRP", "you": "PRP", "he": "PRP", "she": "PRP", "it": "PRP",
    "we": "PRP", "they": "PRP", "me": "PRP", "him": "PRP", "her": "PRP",
    "us": "PRP", "them": "PRP",
    "my": "PRP$", "your": "PRP$", "his": "PRP$", "its": "PRP$",
    "our": "PRP$", "their": "PRP$",
    "and": "CC", "or": "CC", "but": "CC", "nor": "CC", "yet": "CC",
    "in": "IN", "on": "IN", "at": "IN", "by": "IN", "for": "IN",
    "with": "IN", "from": "IN", "of": "IN", "about": "IN", "into": "IN",
    "over": "IN", "under": "IN", "after": "IN", "before": "IN",
    "between": "IN", "through": "IN", "during": "IN", "against": "IN",
    "if": "IN", "because": "IN", "while": "IN", "than": "IN", "as": "IN",
    "to": "TO",
    "can": "MD", "could": "MD", "will": "MD", "would": "MD", "shall": "MD",
    "should": "MD", "may": "MD", "might": "MD", "must": "MD",
    # frequent verbs
    "is": "VBZ", "are": "VB", "was": "VBD", "were": "VBD", "be": "VB",
    "been": "VBD", "being": "VBG", "am": "VB",
    "have": "VB", "has": "VBZ", "had": "VBD", "do": "VB", "does": "VBZ",
    "did": "VBD", "go": "VB", "goes": "VBZ", "went": "VBD", "gone": "VBD",
    "make": "VB", "made": "VBD", "get": "VB", "got": "VBD", "take": "VB",
    "took": "VBD", "see": "VB", "saw": "VBD", "seen": "VBD", "know": "VB",
    "knew": "VBD", "think": "VB", "thought": "VBD", "say": "VB",
    "said": "VBD", "use": "VB", "used": "VBD", "run": "VB", "ran": "VBD",
    "eat": "VB", "ate": "VBD", "give": "VB", "gave": "VBD", "find": "VB",
    "found": "VBD", "want": "VB", "like": "VB", "work": "VB", "train": "VB",
    "learn": "VB", "read": "VB", "write": "VB", "wrote": "VBD",
    # frequent adverbs / adjectives
    "not": "RB", "very": "RB", "also": "RB", "only": "RB", "now": "RB",
    "here": "RB", "there": "RB", "then": "RB", "well": "RB", "too": "RB",
    "never": "RB", "always": "RB", "often": "RB", "again": "RB",
    "good": "JJ", "new": "JJ", "old": "JJ", "big": "JJ", "small": "JJ",
    "large": "JJ", "long": "JJ", "high": "JJ", "low": "JJ", "fast": "JJ",
    "slow": "JJ", "deep": "JJ", "great": "JJ", "other": "JJ", "first": "JJ",
    "last": "JJ", "same": "JJ", "own": "JJ", "few": "JJ", "many": "JJ",
    "much": "JJ", "more": "JJR", "most": "JJS", "best": "JJS",
    "better": "JJR",
    # frequent nouns (incl. the domain's)
    "time": "NN", "day": "NN", "year": "NN", "man": "NN", "woman": "NN",
    "world": "NN", "people": "NNS", "way": "NN", "thing": "NN",
    "model": "NN", "data": "NNS", "network": "NN", "dog": "NN", "cat": "NN",
    "house": "NN", "car": "NN", "city": "NN", "water": "NN", "food": "NN",
    "word": "NN", "sentence": "NN", "child": "NN", "children": "NNS",
    "machine": "NN", "learning": "NN", "computer": "NN", "science": "NN",
}

_NUM = re.compile(r"^[\d][\d,.\-]*$")


class RuleBasedPosTagger:
    """Lexicon + suffix-rule tagger (see module docstring)."""

    def __init__(self, extra_lexicon: Optional[dict] = None):
        self.lexicon = dict(_LEXICON)
        if extra_lexicon:
            self.lexicon.update({k.lower(): v for k, v in extra_lexicon.items()})

    def tag_word(self, word: str, sentence_initial: bool = False) -> str:
        low = word.lower()
        if low in self.lexicon:
            return self.lexicon[low]
        if _NUM.match(word):
            return "CD"
        if word[:1].isupper() and not sentence_initial:
            return "NNP"            # mid-sentence capitalization
        # morphology (ordered most- to least-specific)
        if low.endswith("ing") and len(low) > 4:
            return "VBG"
        if low.endswith("ed") and len(low) > 3:
            return "VBD"
        if low.endswith("ly") and len(low) > 3:
            return "RB"
        if low.endswith(("tion", "sion", "ment", "ness", "ity", "ship",
                         "ance", "ence", "ism")):
            return "NN"
        if low.endswith(("ous", "ful", "ive", "ic", "able", "ible", "al",
                         "ish")):
            return "JJ"
        if low.endswith("est") and len(low) > 4:
            return "JJS"
        if low.endswith("er") and len(low) > 3:
            return "NN"             # runner/teacher; (comparatives hit lexicon)
        if low.endswith("s") and not low.endswith(("ss", "us", "is")) \
                and len(low) > 3:
            return "NNS"
        return "NN"

    def tag(self, tokens: Sequence[str]) -> List[str]:
        return [self.tag_word(t, sentence_initial=(k == 0))
                for k, t in enumerate(tokens)]


class PosFilterTokenizerFactory(TokenizerFactory):
    """Keep only tokens whose POS tag is allowed (reference
    PosUimaTokenizerFactory(allowedPosTags) — e.g. nouns-only corpora).
    Tags may be exact ("NN") or prefixes ("NN*" matches NN/NNS/NNP)."""

    def __init__(self, allowed_tags: Iterable[str],
                 base: Optional[TokenizerFactory] = None,
                 tagger: Optional[RuleBasedPosTagger] = None,
                 pre_processor: Optional[TokenPreProcessor] = None):
        super().__init__(pre_processor)
        self.allowed = list(allowed_tags)
        self.base = base or DefaultTokenizerFactory()
        self.tagger = tagger or RuleBasedPosTagger()

    def _allowed(self, tag: str) -> bool:
        for a in self.allowed:
            if a.endswith("*"):
                if tag.startswith(a[:-1]):
                    return True
            elif tag == a:
                return True
        return False

    def create(self, text: str) -> Tokenizer:
        toks = self.base.create(text).get_tokens()
        tags = self.tagger.tag(toks)
        kept = [t for t, tag in zip(toks, tags) if self._allowed(tag)]
        return Tokenizer(self._post(kept))
