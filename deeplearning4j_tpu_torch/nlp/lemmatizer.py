"""English lemmatization on the tokenizer seam.

Counterpart of ``deeplearning4j_tpu/nlp/lemmatizer.py``, copied unchanged
(pure Python).

Reference: the UIMA pack's tokenizers emit LEMMAS when the analysis engine
provides them (deeplearning4j-nlp-uima .../tokenizer/PosUimaTokenizer.java:76-77
``this.tokens.add(t.getLemma())``; UimaTokenizerFactory wires the ClearNLP
lemma engine). No UIMA/ClearNLP models are downloadable on an egress-less
rig, so this is a self-contained rule lemmatizer in the same spirit as
nlp/pos.py's rule tagger: an irregular-form table, then POS-aware
suffix-stripping morphology (verbs -ing/-ed/-s with consonant-doubling and
-e restoration, noun plurals -s/-es/-ies, adjective -er/-est), defaulting
to the surface form. Deterministic, no data files, and accurate on the
frequent forms that matter for Word2Vec-style vocabulary folding — the use
case the reference's lemma path serves.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from .pos import RuleBasedPosTagger
from .tokenizer import Tokenizer, TokenizerFactory

# surface -> lemma: VERB irregulars (a separate table from the noun
# plurals so a caller-supplied POS tag can disambiguate forms like
# "lives" — VBZ strips to "live" via the regular rules, NNS hits the noun
# table's "life")
_IRREGULAR_V = {
    # be / auxiliaries
    "am": "be", "is": "be", "are": "be", "was": "be", "were": "be",
    "been": "be", "being": "be",
    "has": "have", "had": "have", "having": "have",
    "does": "do", "did": "do", "done": "do", "doing": "do",
    # frequent irregular verbs (past / participle -> base)
    "went": "go", "gone": "go", "goes": "go",
    "said": "say", "says": "say",
    "made": "make", "took": "take", "taken": "take",
    "came": "come", "saw": "see", "seen": "see",
    "knew": "know", "known": "know", "got": "get", "gotten": "get",
    "gave": "give", "given": "give", "found": "find", "thought": "think",
    "told": "tell", "became": "become", "left": "leave", "felt": "feel",
    "put": "put", "brought": "bring", "began": "begin", "begun": "begin",
    "kept": "keep", "held": "hold", "wrote": "write", "written": "write",
    "stood": "stand", "heard": "hear", "let": "let", "meant": "mean",
    "set": "set", "met": "meet", "ran": "run", "paid": "pay",
    "sat": "sit", "spoke": "speak", "spoken": "speak", "lay": "lie",
    "led": "lead", "read": "read", "grew": "grow", "grown": "grow",
    "lost": "lose", "fell": "fall", "fallen": "fall", "sent": "send",
    "built": "build", "understood": "understand", "drew": "draw",
    "drawn": "draw", "broke": "break", "broken": "break",
    "spent": "spend", "cut": "cut", "rose": "rise", "risen": "rise",
    "drove": "drive", "driven": "drive", "bought": "buy", "wore": "wear",
    "worn": "wear", "chose": "choose", "chosen": "choose",
    "slept": "sleep", "ate": "eat", "eaten": "eat", "drank": "drink",
    "drunk": "drink", "sang": "sing", "sung": "sing", "swam": "swim",
    "flew": "fly", "flown": "fly", "threw": "throw", "thrown": "throw",
    "caught": "catch", "taught": "teach", "fought": "fight",
    "sold": "sell", "won": "win", "wound": "wind", "spread": "spread",
    "hit": "hit", "hurt": "hurt", "cost": "cost", "shut": "shut",
}

# NOUN irregular plurals
_IRREGULAR_N = {
    "children": "child", "men": "man", "women": "woman", "people": "person",
    "feet": "foot", "teeth": "tooth", "mice": "mouse", "geese": "goose",
    "lives": "life", "wives": "wife", "knives": "knife", "leaves": "leaf",
    "selves": "self", "shelves": "shelf",
}

_COMPARATIVES = {
    # comparatives — irregular, plus frequent regulars the NN-default POS
    # tagger would otherwise leave untouched (stripping -er on every NN
    # would wreck "teacher"/"river", so frequent forms are enumerated)
    "better": "good", "best": "good", "worse": "bad", "worst": "bad",
    "more": "much", "most": "much", "less": "little", "least": "little",
    "bigger": "big", "biggest": "big", "smaller": "small",
    "smallest": "small", "larger": "large", "largest": "large",
    "higher": "high", "highest": "high", "lower": "low", "lowest": "low",
    "older": "old", "oldest": "old", "younger": "young",
    "youngest": "young", "faster": "fast", "fastest": "fast",
    "slower": "slow", "slowest": "slow", "stronger": "strong",
    "strongest": "strong", "earlier": "early", "earliest": "early",
    "later": "late", "latest": "late", "greater": "great",
    "greatest": "great", "longer": "long", "longest": "long",
    "shorter": "short", "shortest": "short", "newer": "new",
    "newest": "new", "easier": "easy", "easiest": "easy",
}

_VOWELS = set("aeiou")
# -s forms that are NOT plural/3sg strips
_S_KEEP = {"this", "his", "its", "has", "was", "is", "us", "thus", "yes",
           "gas", "bus", "plus", "news", "series", "species", "analysis",
           "basis", "crisis", "physics", "mathematics", "politics",
           "economics", "always", "perhaps"}


def _vowel_groups(stem: str) -> int:
    n, prev = 0, False
    for c in stem:
        v = c in _VOWELS or c == "y"
        if v and not prev:
            n += 1
        prev = v
    return n


def _restore_e(stem: str) -> str:
    """-ing/-ed stripping heuristic: mak- -> make, tak- -> take. A doubled
    final consonant signals the doubling rule (running -> run). The +e
    restoration applies to stems that always dropped one — endings in
    v/c/u ("believ", "danc", "argu") — and otherwise ONLY to
    single-syllable CVC stems: multi-syllable verbs with an unstressed
    final syllable ("open", "visit", "happen") never dropped an e, and
    inventing "opene" would SPLIT the vocabulary this exists to fold."""
    if len(stem) >= 2 and stem[-1] == stem[-2] and stem[-1] not in _VOWELS:
        return stem[:-1]                       # running -> runn -> run
    if stem[-1] in "vcu":
        return stem + "e"                      # believ -> believe, danc -> dance
    if (_vowel_groups(stem) == 1 and len(stem) >= 3
            and stem[-1] not in _VOWELS
            and stem[-2] in _VOWELS and stem[-3] not in _VOWELS
            and stem[-1] not in "wxy"):
        return stem + "e"                      # mak -> make, driv -> drive
    return stem


class RuleBasedLemmatizer:
    """POS-aware rule lemmatizer (the TPU build's stand-in for the UIMA
    lemma engine). ``lemmatize(word, pos)`` takes a Penn tag from
    RuleBasedPosTagger; ``lemmatize_tokens`` tags internally."""

    def __init__(self, tagger: Optional[RuleBasedPosTagger] = None,
                 extra_irregulars: Optional[dict] = None):
        self.tagger = tagger or RuleBasedPosTagger()
        self.irregular_v = dict(_IRREGULAR_V)
        self.irregular_n = dict(_IRREGULAR_N)
        if extra_irregulars:
            self.irregular_v.update(extra_irregulars)

    def _verb_rules(self, w: str) -> Optional[str]:
        if len(w) <= 3:
            return None
        if w.endswith("ing") and len(w) > 5:
            return _restore_e(w[:-3])
        if w.endswith("ied") and len(w) > 4:
            return w[:-3] + "y"                # tried -> try
        if w.endswith("ed") and len(w) > 4:
            return _restore_e(w[:-2])
        if w.endswith("ies") and len(w) > 4:
            return w[:-3] + "y"
        if w.endswith(("ches", "shes", "sses", "xes", "zes")):
            return w[:-2]
        if w.endswith("s") and not w.endswith("ss") and w not in _S_KEEP:
            return w[:-1]
        return None

    def _noun_rules(self, w: str) -> Optional[str]:
        if (len(w) <= 3 or w in _S_KEEP or not w.endswith("s")
                or w.endswith("ss")):
            return None
        if w.endswith("ies") and len(w) > 4:
            return w[:-3] + "y"                # cities -> city
        if w.endswith(("ches", "shes", "sses", "xes", "zes")):
            return w[:-2]                      # boxes -> box
        if w.endswith("oes"):
            return w[:-2]                      # heroes -> hero
        return w[:-1]                          # dogs -> dog

    def lemmatize(self, word: str, pos: Optional[str] = None) -> str:
        w = word.lower()
        if not w.isalpha():
            return w
        if w in _COMPARATIVES:     # unambiguous; the NN-default tagger
            return _COMPARATIVES[w]  # would otherwise route them wrongly
        pos = pos or self.tagger.tag_word(w)
        # the POS decides which irregular table wins for ambiguous forms:
        # "lives"/VBZ -> live (regular -s strip), "lives"/NNS -> life
        if pos.startswith("V"):
            if w in self.irregular_v:
                return self.irregular_v[w]
            out = self._verb_rules(w)
            if out is not None:
                return out
            # rule missed AND tag may be wrong — an unambiguous irregular
            # from the other table still folds (e.g. "children" mis-tagged)
            return self.irregular_n.get(w, w)
        if pos.startswith("N"):
            if w in self.irregular_n:
                return self.irregular_n[w]
            out = self._noun_rules(w)
            if out is not None:
                return out
            return self.irregular_v.get(w, w)
        if pos in ("JJR", "RBR") and w.endswith("er") and len(w) > 4:
            return _restore_e(w[:-2])          # bigger -> big, nicer -> nice
        if pos in ("JJS", "RBS") and w.endswith("est") and len(w) > 5:
            return _restore_e(w[:-3])
        # other POS (or tagger default): irregulars still fold
        return self.irregular_v.get(w, self.irregular_n.get(w, w))

    def lemmatize_tokens(self, tokens: Sequence[str]) -> List[str]:
        tags = self.tagger.tag(list(tokens))
        return [self.lemmatize(t, p) for t, p in zip(tokens, tags)]


class LemmatizingTokenizerFactory(TokenizerFactory):
    """Wrap any TokenizerFactory so every emitted token is its lemma —
    the UimaTokenizerFactory seam (PosUimaTokenizer.java:76-77: tokens are
    replaced by getLemma() when available). Composes with the POS filter
    exactly like the reference's UIMA pipeline; a pre-processor set on
    THIS factory runs BEFORE lemmatization (normalization first, so the
    lemmatizer sees clean surface forms — "Dogs," -> "dogs" -> "dog")."""

    def __init__(self, base: TokenizerFactory,
                 lemmatizer: Optional[RuleBasedLemmatizer] = None):
        super().__init__()
        self.base = base
        self.lemmatizer = lemmatizer or RuleBasedLemmatizer()

    def create(self, text: str) -> Tokenizer:
        toks = self._post(self.base.create(text).get_tokens())
        return Tokenizer(self.lemmatizer.lemmatize_tokens(toks))
