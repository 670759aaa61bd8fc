# -*- coding: utf-8 -*-
"""Dictionary + Viterbi lattice segmentation for Chinese and Japanese.

Counterpart of ``deeplearning4j_tpu/nlp/segmentation.py``, copied unchanged
(pure Python); ``_BundledSegmenter`` reads the port's own copy of the two
lexicons in ``nlp/data/`` (the same bytes).

Reference: the language packs vendor full segmenters —
deeplearning4j-nlp-chinese vendors *ansj_seg* (org/ansj/: dictionary DAG +
n-gram path scoring) and deeplearning4j-nlp-japanese vendors *kuromoji*
(com/atilika/kuromoji/: prefix-dictionary lattice + Viterbi with word and
connection costs, character-class unknown-word grouping). This module
re-implements that mechanism — not the 19.8k-LoC vendored dictionaries — as
one lattice engine:

- a prefix dictionary proposes word edges at every position;
- unknown text proposes edges by CHARACTER CLASS (kuromoji's unknown-word
  handling): katakana/latin/digit runs group into one candidate, han/kana
  singles stay single-character candidates;
- Viterbi dynamic programming picks the min-cost path, word cost
  -log(freq/total) and a length-scaled unknown penalty.

The PRODUCTION dictionary path: real-scale lexicons ship as package data
(``nlp/data/zh_dict.tsv`` — 52k entries derived from the MIT-licensed jieba
dict; ``nlp/data/ja_dict.tsv`` — compiled from an ipadic-tokenized
public-domain corpus; built by ``tools/build_cjk_dicts.py``) and are loaded
by default by ``ChineseSegmenter``/``JapaneseSegmenter``. The compact
embedded cores below are only the fallback when the data files are absent.
User dictionaries extend via ``load_tsv`` / ``add_word`` — the same seam as
the reference packs' user-dictionary files. ``CJKTokenizerFactory(
language=...)`` in nlp/tokenizer.py uses these as its default segmenter.
"""
from __future__ import annotations

import math
import os
import unicodedata
from typing import Dict, Iterable, List, Optional, Tuple

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# memoized parses of dictionary files (keyed by path; bundled lexicons are
# immutable package data)
_TSV_CACHE: Dict[str, Dict[str, Tuple[int, str]]] = {}


def _char_class(ch: str) -> str:
    o = ord(ch)
    if 0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF:
        return "han"
    if 0x3040 <= o <= 0x309F:
        return "hiragana"
    if 0x30A0 <= o <= 0x30FF or o == 0x30FC:   # incl. long-vowel mark
        return "katakana"
    if 0xAC00 <= o <= 0xD7AF:
        return "hangul"
    if ch.isdigit():
        return "digit"
    if ch.isalpha():
        return "latin"
    if ch.isspace():
        return "space"
    return "other"


# classes whose unknown runs group into ONE candidate token (kuromoji
# groups KATAKANA/ALPHA/NUMERIC; KANJI stays per-character)
_GROUPING = {"katakana", "latin", "digit", "hangul"}


class LatticeSegmenter:
    """Prefix-dictionary + Viterbi lattice segmenter (the ansj/kuromoji
    mechanism; see module docstring)."""

    def __init__(self, dictionary: Optional[Dict[str, int]] = None, *,
                 unk_cost: float = 14.0, unk_char_cost: float = 3.0):
        self._freq: Dict[str, int] = {}
        self._pos: Dict[str, str] = {}
        self._prefixes = set()
        self._total = 0
        self._max_len = 1
        self.unk_cost = unk_cost
        self.unk_char_cost = unk_char_cost
        for w, f in (dictionary or {}).items():
            self.add_word(w, f)

    # ------------------------------------------------------------ dictionary
    def add_word(self, word: str, freq: int = 1, pos: str = ""):
        word = unicodedata.normalize("NFKC", word)
        if not word:
            return self
        self._total += max(freq, 1) - self._freq.get(word, 0)
        self._freq[word] = max(freq, 1)
        if pos:
            self._pos[word] = pos
        self._max_len = max(self._max_len, len(word))
        for i in range(1, len(word) + 1):
            self._prefixes.add(word[:i])
        return self

    def load_tsv(self, path: str):
        """Load the dictionary-file format 'word<TAB>freq<TAB>pos' (freq and
        pos optional, '#' comments) — the PRODUCTION dictionary path and the
        user-dictionary seam of the reference language packs (see
        nlp/dict_build.py for the compile step that produces these files).
        Parses are memoized per path: the bundled 52k-entry lexicon is
        immutable package data and every tokenizer-factory construction
        would otherwise re-parse it."""
        entries = _TSV_CACHE.get(path)
        if entries is None:
            from .dict_build import read_dict_tsv
            entries = _TSV_CACHE[path] = read_dict_tsv(path)
        for w, (freq, pos) in entries.items():
            self.add_word(w, freq, pos)
        return self

    def pos_of(self, word: str) -> str:
        """Dictionary POS tag for a word ('' when unknown) — the lexicon
        carries POS like the reference packs' dictionaries (ansj natures,
        ipadic features)."""
        return self._pos.get(unicodedata.normalize("NFKC", word), "")

    def __len__(self):
        return len(self._freq)

    def __contains__(self, w):
        return w in self._freq

    def _word_cost(self, w: str) -> float:
        return math.log(self._total + 1) - math.log(self._freq[w])

    # --------------------------------------------------------------- viterbi
    def _segment_run(self, text: str) -> List[str]:
        """Viterbi over the lattice of one contiguous non-space run."""
        n = len(text)
        INF = float("inf")
        best = [INF] * (n + 1)
        back: List[Tuple[int, str]] = [(0, "")] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == INF:
                continue
            # dictionary edges
            j = i + 1
            while j <= min(n, i + self._max_len):
                piece = text[i:j]
                if piece not in self._prefixes:
                    break
                if piece in self._freq:
                    c = best[i] + self._word_cost(piece)
                    if c < best[j]:
                        best[j], back[j] = c, (i, piece)
                j += 1
            # unknown edges by character class (kuromoji unknown handling)
            cls = _char_class(text[i])
            run_end = i + 1
            if cls in _GROUPING:
                while run_end < n and _char_class(text[run_end]) == cls:
                    run_end += 1
            for j in (i + 1, run_end):
                piece = text[i:j]
                c = best[i] + self.unk_cost + self.unk_char_cost * len(piece)
                if c < best[j]:
                    best[j], back[j] = c, (i, piece)
        out: List[str] = []
        j = n
        while j > 0:
            i, piece = back[j]
            out.append(piece)
            j = i
        return out[::-1]

    def segment(self, text: str) -> List[str]:
        """Segment ``text``; whitespace splits runs and is dropped."""
        text = unicodedata.normalize("NFKC", text)
        out: List[str] = []
        run = []
        for ch in text:
            if _char_class(ch) == "space":
                if run:
                    out.extend(self._segment_run("".join(run)))
                    run = []
            else:
                run.append(ch)
        if run:
            out.extend(self._segment_run("".join(run)))
        return out

    __call__ = segment


# --------------------------------------------------------------- embedded zh
# Compact core vocabulary (simplified Chinese): function words + everyday
# vocabulary + a little CS domain. Frequencies are coarse ranks, enough for
# the Viterbi to prefer real words over character soup.
_ZH_CORE = {
    "的": 5000, "了": 3000, "在": 2500, "是": 2500, "我": 2000, "你": 1500,
    "他": 1200, "她": 1000, "它": 600, "我们": 1200, "你们": 500,
    "他们": 700, "这": 1200, "那": 900, "这个": 600, "那个": 400,
    "有": 1500, "和": 1200, "不": 1500, "也": 800, "都": 700, "很": 900,
    "人": 1000, "大": 700, "小": 600, "中": 600, "上": 600, "下": 500,
    "中国": 800, "北京": 500, "上海": 400, "北京大学": 120,
    "大学": 600, "学生": 500, "老师": 400, "学习": 600, "学": 300,
    "朋友": 400, "孩子": 350, "家": 450, "工作": 500, "公司": 450,
    "今天": 500, "明天": 400, "昨天": 350, "现在": 450, "时间": 450,
    "天气": 300, "好": 900, "喜欢": 400, "爱": 350, "吃": 400, "饭": 250,
    "吃饭": 200, "喝": 200, "水": 250, "茶": 150, "苹果": 150,
    "说": 600, "去": 600, "来": 550, "看": 500, "听": 300, "读": 200,
    "写": 200, "书": 300, "电脑": 250, "手机": 300, "网络": 200,
    "软件": 180, "问题": 400, "知道": 450, "觉得": 300, "认为": 250,
    "什么": 500, "怎么": 300, "为什么": 200, "因为": 350, "所以": 300,
    "但是": 350, "可以": 500, "要": 600, "会": 550, "能": 450,
    "世界": 300, "国家": 300, "城市": 250, "钱": 250, "年": 400,
    "月": 300, "日": 250, "星期": 150, "小时": 200, "分钟": 150,
    "高兴": 200, "漂亮": 180, "机器": 200, "机器学习": 150,
    "深度学习": 100, "神经网络": 100, "数据": 250, "模型": 200,
    "训练": 180, "语言": 200, "中文": 150, "英文": 120, "使用": 250,
    "开发": 200, "程序": 180, "研究": 250, "科学": 220, "技术": 250,
}

# --------------------------------------------------------------- embedded ja
_JA_CORE = {
    "は": 5000, "が": 4000, "を": 4000, "に": 4000, "の": 5000, "で": 3000,
    "と": 3000, "も": 2000, "へ": 1000, "から": 1200, "まで": 800,
    "です": 2500, "でした": 800, "ます": 2000, "ました": 900,
    "ません": 500, "だ": 1000, "な": 900, "ね": 500, "よ": 500,
    "か": 1200, "私": 1500, "僕": 600, "あなた": 500, "彼": 600,
    "彼女": 500, "これ": 700, "それ": 700, "あれ": 400, "この": 800,
    "その": 800, "する": 1500, "します": 800, "した": 900, "して": 800,
    "いる": 1000, "います": 700, "ある": 900, "あります": 600,
    "なる": 700, "行く": 500, "行きます": 300, "来る": 450, "見る": 450,
    "見ます": 250, "食べる": 400, "食べます": 250, "飲む": 300,
    "読む": 300, "書く": 300, "話す": 300, "聞く": 300, "買う": 250,
    "今日": 600, "明日": 450, "昨日": 400, "今": 500, "時間": 400,
    "天気": 300, "いい": 600, "良い": 400, "悪い": 250, "大きい": 300,
    "小さい": 250, "新しい": 300, "古い": 200, "とても": 500,
    "少し": 350, "元気": 250, "大学": 450, "東京大学": 100,
    "学生": 400, "先生": 400, "学校": 400, "勉強": 350, "友達": 350,
    "日本": 600, "日本語": 350, "東京": 450, "京都": 250, "猫": 250,
    "犬": 250, "本": 350, "水": 250, "ご飯": 200, "仕事": 400,
    "会社": 400, "機械": 200, "学習": 250, "機械学習": 120,
    "深層学習": 80, "データ": 200, "モデル": 150, "研究": 300,
    "科学": 220, "技術": 250, "言葉": 200, "言語": 180, "使う": 300,
    "使います": 150, "作る": 300, "人": 600, "年": 400, "月": 300,
    "日": 300, "家": 350, "好き": 400, "お": 800, "毎日": 300,
    "面白い": 250, "楽しい": 250, "難しい": 220, "簡単": 200,
    "しています": 300, "ています": 350, "ください": 250, "ありがとう": 200,
}


class _BundledSegmenter(LatticeSegmenter):
    """Shared init: load the bundled real-scale lexicon when present (the
    PRODUCTION path), back-merge the embedded bootstrap core for entries
    the bundled file lacks (frequency cutoffs / corpus gaps drop some
    function words and domain compounds), then apply user extras on top."""

    _BUNDLED_FILE = ""           # subclasses set these
    _CORE: Dict[str, int] = {}

    def __init__(self, extra_words: Optional[Dict[str, int]] = None, *,
                 use_bundled: bool = True, **kw):
        super().__init__(**kw)
        bundled = os.path.join(_DATA_DIR, self._BUNDLED_FILE)
        if use_bundled and os.path.exists(bundled):
            self.load_tsv(bundled)
            for w, f in self._CORE.items():
                if w not in self:
                    self.add_word(w, f)
        else:
            for w, f in self._CORE.items():
                self.add_word(w, f)
        for w, f in (extra_words or {}).items():
            self.add_word(w, f)


class ChineseSegmenter(_BundledSegmenter):
    """Dictionary/DAG segmenter for simplified Chinese (the ansj capability,
    deeplearning4j-nlp-chinese org/ansj/). Loads the bundled real-scale
    lexicon (nlp/data/zh_dict.tsv, ~52k entries with POS) by default;
    ``use_bundled=False`` keeps only the embedded bootstrap core."""

    _BUNDLED_FILE = "zh_dict.tsv"
    _CORE = _ZH_CORE


class JapaneseSegmenter(_BundledSegmenter):
    """Lattice + Viterbi segmenter for Japanese (the kuromoji capability,
    deeplearning4j-nlp-japanese com/atilika/kuromoji/). Loads the bundled
    corpus-compiled lexicon (nlp/data/ja_dict.tsv) by default;
    ``use_bundled=False`` keeps only the embedded bootstrap core."""

    _BUNDLED_FILE = "ja_dict.tsv"
    _CORE = _JA_CORE
