# -*- coding: utf-8 -*-
"""Dictionary compilation for the lattice segmenters.

Counterpart of ``deeplearning4j_tpu/nlp/dict_build.py``, copied unchanged
(pure Python).

Reference capability: the language packs' dictionaries are COMPILED
artifacts — kuromoji builds its prefix-dictionary/cost tables from the
mecab-ipadic CSV source (com/atilika/kuromoji/compile/
DictionaryCompilerBase.java), ansj ships core.dic built from corpus counts.
This module is that build step for our lattice engine: count a tokenized
corpus (or convert an existing word-freq-POS list) into the loadable
dictionary-file format.

Dictionary file format (the PRODUCTION path for real-scale segmentation —
the embedded cores in segmentation.py are only a bootstrap):

    word<TAB>freq<TAB>pos\n     (pos optional; '#' comments; UTF-8)

matching the user-dictionary seam of the reference packs (ansj user dicts
are word/nature/freq lines; kuromoji user dicts are word,reading,pos CSV).
"""
from __future__ import annotations

import unicodedata
from collections import Counter
from typing import Dict, Iterable, Optional, Tuple


def compile_dictionary(tokens: Iterable[Tuple[str, Optional[str]]],
                       *, min_freq: int = 1,
                       max_word_len: int = 12) -> Dict[str, Tuple[int, str]]:
    """Count a (word, pos) token stream into {word: (freq, pos)} — the
    corpus->dictionary compile step. POS is the majority tag per word."""
    freq: Counter = Counter()
    pos_votes: Dict[str, Counter] = {}
    for word, pos in tokens:
        word = unicodedata.normalize("NFKC", word).strip()
        if not word or len(word) > max_word_len:
            continue
        freq[word] += 1
        if pos:
            pos_votes.setdefault(word, Counter())[pos] += 1
    out = {}
    for w, f in freq.items():
        if f < min_freq:
            continue
        pos = (pos_votes[w].most_common(1)[0][0]
               if w in pos_votes else "")
        out[w] = (f, pos)
    return out


def write_dict_tsv(entries: Dict[str, Tuple[int, str]], path: str,
                   *, header: str = ""):
    """Write the dictionary-file format (sorted by freq desc for stable
    diffs and human inspection)."""
    with open(path, "w", encoding="utf-8") as f:
        for line in header.splitlines():
            f.write(f"# {line}\n")
        for w, (freq, pos) in sorted(entries.items(),
                                     key=lambda kv: (-kv[1][0], kv[0])):
            f.write(f"{w}\t{freq}\t{pos}\n" if pos else f"{w}\t{freq}\n")


def read_dict_tsv(path: str) -> Dict[str, Tuple[int, str]]:
    """Parse the dictionary-file format; tolerant of freq-less lines."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t") if "\t" in line else line.split()
            w = unicodedata.normalize("NFKC", parts[0])
            freq = int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else 1
            pos = parts[2] if len(parts) > 2 else ""
            out[w] = (freq, pos)
    return out
