"""GenerationEngine: the autoregressive-serving facade.

Counterpart of ``deeplearning4j_tpu/serving/generation/engine.py``
(``__init__``, ``generate`` ``:115``, ``metrics``, ``stop``): one model,
warmed at construction and scheduled by its continuous-batching runtime.

    eng = GenerationEngine(net, block_len=16, max_seq_len=1024,
                           decode_slots=8)
    tokens, reason = eng.generate([5, 7, 11], max_tokens=32)
    for tok in eng.generate([5, 7, 11], max_tokens=32, stream=True):
        ...

The engine runs on the CUDA card unless ``device="cpu"`` is given, and the
net must live on that device. ``adapter="auto"`` serves a transformer
graph through the paged K/V cache and a recurrent MultiLayerNetwork (the
char-RNN) through its recurrent state; ``models()`` reports which.
Several models per engine, hot-swap, the HTTP front end and the
speculative, prefix-cache and int8 options come with a later slice
(ROADMAP A2).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

from ...device import DeviceLike, check_same_device, resolve_device
from ..errors import DrainingError
from .programs import GenerationConfig, GenerationProgramSet
from .scheduler import ModelRuntime, TokenStream


class GenerationEngine:
    def __init__(self, net, *, model_name: str = "default",
                 config: Optional[GenerationConfig] = None,
                 adapter: str = "auto", device: DeviceLike = None,
                 draft=None, **config_kwargs):
        if draft is not None:
            raise NotImplementedError("speculative decoding (a transformer "
                                      "or an LSTM draft) is not ported yet "
                                      "(ROADMAP A2)")
        self.device = resolve_device(device)
        check_same_device("the net", net.device, self.device)
        ps = GenerationProgramSet(
            net, config=config or GenerationConfig(**config_kwargs),
            adapter=adapter).warm()
        self._rt = ModelRuntime(model_name, ps)
        self._draining = False

    def generate(self, prompt, *, max_tokens: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 stop: Sequence[int] = (),
                 timeout: Optional[float] = None, stream: bool = False
                 ) -> Union[TokenStream, Tuple[list, str]]:
        """Generate up to ``max_tokens`` tokens after ``prompt`` (a 1-D int
        token-id sequence). ``stream=True`` returns a TokenStream to
        iterate; otherwise blocks and returns (tokens, finish_reason).
        ``temperature<=0`` is greedy; ``top_k<=0`` disables the top-k cut;
        ``stop`` token ids end generation (and are not emitted)."""
        if self._draining:
            raise DrainingError("generation engine is draining")
        rt = self._rt
        ts = rt.submit(prompt,
                       max_new=(max_tokens if max_tokens is not None
                                else rt.config.default_max_tokens),
                       temperature=temperature, top_k=top_k, stop=stop,
                       timeout=timeout)
        return ts if stream else ts.result()

    def metrics(self) -> Dict[str, dict]:
        """{model name: metrics snapshot}, as the reference engine keys it."""
        return {self._rt.name: self._rt.metrics.snapshot()}

    def models(self) -> Dict[str, dict]:
        """{model name: its adapter and capacity plan}, a subset of the
        reference engine's rows."""
        rt = self._rt
        cfg = rt.config
        return {rt.name: {
            "adapter": rt.ps.adapter, "decode_slots": cfg.decode_slots,
            "block_len": cfg.block_len, "capacity": cfg.capacity,
            "num_blocks": cfg.num_blocks,
            "prompt_rungs": list(cfg.prompt_rungs),
            "prefill_batches": list(cfg.prefill_batches)}}

    def stop(self, drain: bool = True, timeout: float = 10.0) -> None:
        self._draining = True
        self._rt.stop(drain=drain, timeout=timeout)
