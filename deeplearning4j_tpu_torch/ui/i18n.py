"""Train-UI internationalization.

Counterpart of ``deeplearning4j_tpu/ui/i18n.py``, copied unchanged (pure
Python): the same six languages and message tables.

Reference: deeplearning4j-ui-parent/deeplearning4j-play
.../i18n/DefaultI18N.java + the per-language ``dl4j_i18n/*.properties``
resources that TrainModule serves (TrainModule.java:94-110 renders every
page element through I18N.getMessage). Same contract here: a key/value
message table per language, English fallback for missing keys, and a
process-wide default language the dashboard uses when the request doesn't
pick one (``?lang=``).

The reference ships en/de/ja/ko/ru/zh; the same six are provided for every
string the dashboard renders.
"""
from __future__ import annotations

from typing import Dict

_EN = {
    "train.pagetitle": "Training overview",
    "train.session": "session",
    "train.worker": "worker",
    "train.sessions": "Sessions",
    "train.language": "Language",
    "train.model": "Model",
    "train.score": "Score vs. iteration",
    "train.throughput": "Throughput (iterations/sec)",
    "train.parammag": "Mean magnitudes: parameters",
    "train.ratio": "Update : parameter ratio (log10)",
    "train.histograms": "Parameter histograms",
    "train.activations": "Convolutional activations",
    "train.graph": "Model graph",
    "train.nodata": "no data yet",
    "train.telemetry": "Runtime telemetry",
    "train.performance": "Performance (MFU / roofline / memory)",
    "train.kernels": "Kernels (impl / blocks / roofline)",
    "train.fleet": "Serving fleet (replicas / SLO burn)",
}

_MESSAGES: Dict[str, Dict[str, str]] = {
    "en": _EN,
    "de": {
        "train.pagetitle": "Trainingsübersicht",
        "train.session": "Sitzung",
        "train.worker": "Worker",
        "train.sessions": "Sitzungen",
        "train.language": "Sprache",
        "train.model": "Modell",
        "train.score": "Score pro Iteration",
        "train.throughput": "Durchsatz (Iterationen/Sek.)",
        "train.parammag": "Mittlere Beträge: Parameter",
        "train.ratio": "Update-zu-Parameter-Verhältnis (log10)",
        "train.histograms": "Parameter-Histogramme",
        "train.activations": "Konvolutions-Aktivierungen",
        "train.graph": "Modellgraph",
        "train.nodata": "noch keine Daten",
        "train.telemetry": "Laufzeit-Telemetrie",
        "train.performance": "Leistung (MFU / Roofline / Speicher)",
        "train.kernels": "Kernel (Implementierung / Blöcke / Roofline)",
        "train.fleet": "Serving-Flotte (Replikate / SLO-Burn)",
    },
    "ja": {
        "train.pagetitle": "トレーニング概要",
        "train.session": "セッション",
        "train.worker": "ワーカー",
        "train.sessions": "セッション一覧",
        "train.language": "言語",
        "train.model": "モデル",
        "train.score": "スコア対イテレーション",
        "train.throughput": "スループット（イテレーション/秒）",
        "train.parammag": "パラメータの平均絶対値",
        "train.ratio": "更新とパラメータの比率 (log10)",
        "train.histograms": "パラメータのヒストグラム",
        "train.activations": "畳み込み活性化",
        "train.graph": "モデルグラフ",
        "train.nodata": "データなし",
        "train.telemetry": "ランタイムテレメトリ",
        "train.performance": "パフォーマンス（MFU / ルーフライン / メモリ）",
        "train.kernels": "カーネル（実装 / ブロック / ルーフライン）",
        "train.fleet": "サービングフリート（レプリカ / SLOバーン）",
    },
    "ko": {
        "train.pagetitle": "훈련 개요",
        "train.session": "세션",
        "train.worker": "워커",
        "train.sessions": "세션 목록",
        "train.language": "언어",
        "train.model": "모델",
        "train.score": "반복별 스코어",
        "train.throughput": "처리량 (반복/초)",
        "train.parammag": "파라미터 평균 크기",
        "train.ratio": "업데이트 대 파라미터 비율 (log10)",
        "train.histograms": "파라미터 히스토그램",
        "train.activations": "합성곱 활성화",
        "train.graph": "모델 그래프",
        "train.nodata": "데이터 없음",
        "train.telemetry": "런타임 텔레메트리",
        "train.performance": "성능 (MFU / 루프라인 / 메모리)",
        "train.kernels": "커널 (구현 / 블록 / 루프라인)",
        "train.fleet": "서빙 플릿 (레플리카 / SLO 번)",
    },
    "ru": {
        "train.pagetitle": "Обзор обучения",
        "train.session": "сессия",
        "train.worker": "воркер",
        "train.sessions": "Сессии",
        "train.language": "Язык",
        "train.model": "Модель",
        "train.score": "Ошибка по итерациям",
        "train.throughput": "Производительность (итераций/с)",
        "train.parammag": "Средние модули: параметры",
        "train.ratio": "Отношение обновления к параметру (log10)",
        "train.histograms": "Гистограммы параметров",
        "train.activations": "Свёрточные активации",
        "train.graph": "Граф модели",
        "train.nodata": "данных пока нет",
        "train.telemetry": "Телеметрия выполнения",
        "train.performance": "Производительность (MFU / roofline / память)",
        "train.kernels": "Ядра (реализация / блоки / roofline)",
        "train.fleet": "Флот обслуживания (реплики / расход SLO)",
    },
    "zh": {
        "train.pagetitle": "训练概览",
        "train.session": "会话",
        "train.worker": "工作节点",
        "train.sessions": "会话列表",
        "train.language": "语言",
        "train.model": "模型",
        "train.score": "得分随迭代变化",
        "train.throughput": "吞吐量（迭代/秒）",
        "train.parammag": "参数平均幅值",
        "train.ratio": "更新与参数比值 (log10)",
        "train.histograms": "参数直方图",
        "train.activations": "卷积激活",
        "train.graph": "模型图",
        "train.nodata": "暂无数据",
        "train.telemetry": "运行时遥测",
        "train.performance": "性能（MFU / 屋顶线 / 内存）",
        "train.kernels": "内核（实现 / 块 / 屋顶线）",
        "train.fleet": "服务集群（副本 / SLO 消耗）",
    },
}

_DEFAULT = "en"


def languages():
    """Supported language codes (the reference's six)."""
    return sorted(_MESSAGES)


def set_default_language(lang: str):
    """DefaultI18N.setDefaultLanguage equivalent."""
    global _DEFAULT
    if lang not in _MESSAGES:
        raise ValueError(f"unsupported language {lang!r}; "
                         f"available: {languages()}")
    _DEFAULT = lang


def get_message(key: str, lang: str = None) -> str:
    """DefaultI18N.getMessage: requested language, English fallback, key
    itself as the last resort (the reference renders the raw key too)."""
    table = _MESSAGES.get(lang or _DEFAULT, _EN)
    return table.get(key) or _EN.get(key) or key
