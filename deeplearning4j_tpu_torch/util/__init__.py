"""Counterpart of ``deeplearning4j_tpu/util``: model zips
(``serialization``), checkpoint directories and the resumable fit
(``checkpointing``), sharded and background checkpoints
(``distributed_checkpoint``, ``async_checkpoint``), CUDA-graph capture
(``graph_capture``),
gradient checking (``gradcheck``), the time-series helpers
(``timeseries``), and the stdlib-only ``retry`` and ``httpjson``
helpers."""
