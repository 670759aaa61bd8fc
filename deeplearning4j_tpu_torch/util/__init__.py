"""Counterpart of ``deeplearning4j_tpu/util``: model zips
(``serialization``), the read side of checkpointing (``checkpointing``),
gradient checking (``gradcheck``), the time-series helpers
(``timeseries``), and the stdlib-only ``retry`` and ``httpjson``
helpers."""
