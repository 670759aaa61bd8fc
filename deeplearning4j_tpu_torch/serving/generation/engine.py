"""GenerationEngine: the autoregressive-serving facade.

Counterpart of ``deeplearning4j_tpu/serving/generation/engine.py``: a
multi-model registry (``add_model`` / ``remove_model`` / ``names`` /
``default_name``), warm-up before traffic, continuous batching (a
``ModelRuntime`` per model) with the prefix cache, speculative decoding
(``draft=``) and the int8 KV tier as per-model options, per-token
streaming, zero-downtime ``hot_swap`` with the finish-on-old-weights
cutover rule, and drain-then-stop.

    eng = GenerationEngine(net, block_len=16, max_seq_len=1024,
                           decode_slots=8, draft=truncated_draft(net, 1))
    tokens, reason = eng.generate([5, 7, 11], max_tokens=32)
    for tok in eng.generate([5, 7, 11], max_tokens=32, stream=True):
        ...

The engine runs on the CUDA card unless ``device="cpu"`` is given, and
every net (and draft) must live on that device. On the card each model's
decode step runs as a CUDA graph captured after warm-up (``graphs.py``).
``adapter="auto"`` serves a transformer graph through the paged K/V cache
and a recurrent MultiLayerNetwork (the char-RNN) through its recurrent
state. Loading a net from a path (``hot_swap`` with a path,
``reload_from_checkpoint``) is ROADMAP A2b; ``publish_metrics`` is A8; a
mesh is A7b.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple, Union

from ...device import DeviceLike, check_same_device, resolve_device
from ..errors import DrainingError, UnknownModelError
from ..registry import load_net
from .metrics import GenerationMetrics
from .programs import GenerationConfig, GenerationProgramSet
from .scheduler import ModelRuntime, TokenStream


class GenerationEngine:
    def __init__(self, net=None, *, model_name: str = "default",
                 config: Optional[GenerationConfig] = None,
                 adapter: str = "auto", warm: bool = True, draft=None,
                 mesh=None, device: DeviceLike = None, **config_kwargs):
        if mesh is not None:
            raise NotImplementedError("head-sharded generation over a mesh "
                                      "is not ported yet (ROADMAP A7b)")
        self.device = resolve_device(device)
        self._models: Dict[str, ModelRuntime] = {}
        self._default: Optional[str] = None
        self._lock = threading.Lock()
        self._draining = False
        self._trace_count = 0
        if net is not None:
            self.add_model(model_name, net, config=config, adapter=adapter,
                           warm=warm, default=True, draft=draft,
                           **config_kwargs)

    # ------------------------------------------------------------------ models
    def add_model(self, name: str, net, *,
                  config: Optional[GenerationConfig] = None,
                  adapter: str = "auto", warm: bool = True,
                  default: bool = False, draft=None, mesh=None,
                  **config_kwargs) -> ModelRuntime:
        """Register a generation model. Per-model options: ``draft=``
        attaches a speculative-decoding draft (a ``truncated_draft`` of the
        target or an LSTM char model; the config's ``spec_k`` proposals per
        verify window, default 4); ``prefix_cache=`` disables or forces
        prompt-prefix K/V sharing (default: on for transformer models);
        ``kv_cache_dtype="int8"`` stores the K/V pools as int8."""
        if mesh is not None:
            raise NotImplementedError("head-sharded generation over a mesh "
                                      "is not ported yet (ROADMAP A7b)")
        check_same_device("the net", net.device, self.device)
        if draft is not None:
            check_same_device("the draft", draft.device, self.device)
        with self._lock:
            if name in self._models:
                raise ValueError(f"generation model '{name}' already "
                                 "registered (use hot_swap to replace)")
        cfg = config or GenerationConfig(**config_kwargs)
        self._pause_watch()
        try:
            ps = GenerationProgramSet(net, config=cfg, adapter=adapter,
                                      draft_net=draft,
                                      trace_hook=self._on_trace)
            if warm:
                ps.warm()
        finally:
            self._resume_watch()
        rt = ModelRuntime(name, ps, GenerationMetrics(name=name))
        with self._lock:
            if name in self._models:      # lost a registration race
                rt.stop(drain=False, timeout=1.0)
                raise ValueError(f"generation model '{name}' already "
                                 "registered")
            self._models[name] = rt
            if default or self._default is None:
                self._default = name
        return rt

    def remove_model(self, name: str) -> None:
        rt = self._get(name)
        with self._lock:
            self._models.pop(name, None)
            if self._default == name:
                self._default = next(iter(self._models), None)
        rt.stop(drain=True)

    def _get(self, name: Optional[str]) -> ModelRuntime:
        with self._lock:
            key = name or self._default
            if key is None or key not in self._models:
                raise UnknownModelError(
                    f"no generation model {key!r} (registered: "
                    f"{sorted(self._models)})")
            return self._models[key]

    def runtime(self, name: Optional[str] = None) -> ModelRuntime:
        """The model's scheduler (its cohorts, and their decode graphs on
        the card)."""
        return self._get(name)

    def names(self):
        with self._lock:
            return sorted(self._models)

    @property
    def default_name(self) -> Optional[str]:
        return self._default

    # ------------------------------------------------------------- generation
    def generate(self, prompt, *, model: Optional[str] = None,
                 max_tokens: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 stop: Sequence[int] = (),
                 timeout: Optional[float] = None, stream: bool = False,
                 speculative: bool = True
                 ) -> Union[TokenStream, Tuple[list, str]]:
        """Generate up to ``max_tokens`` tokens after ``prompt`` (a 1-D int
        token-id sequence). ``stream=True`` returns a TokenStream to
        iterate; otherwise blocks and returns (tokens, finish_reason).
        ``temperature<=0`` is greedy; ``top_k<=0`` disables the top-k cut;
        ``stop`` token ids end generation (and are not emitted);
        ``speculative=False`` opts this request out of draft-verify decode
        on a speculating model (sampling requests opt out by themselves —
        the exact-output guarantee is greedy-only)."""
        if self._draining:
            raise DrainingError("generation engine is draining")
        rt = self._get(model)
        ts = rt.submit(prompt,
                       max_new=(max_tokens if max_tokens is not None
                                else rt.config.default_max_tokens),
                       temperature=temperature, top_k=top_k, stop=stop,
                       timeout=timeout, speculative=speculative)
        return ts if stream else ts.result()

    # --------------------------------------------------------------- hot-swap
    def hot_swap(self, name: str, net_or_path, draft=None) -> int:
        """Replace model ``name`` with zero downtime. Cutover rule:
        generations in flight at swap time FINISH on the old weights and
        the old draft (their cohort keeps its program set, pool, prefix
        cache, draft cache and decode graph until it drains); every
        admission after the swap runs the new weights. A same-architecture
        swap shares the warmed programs (the draft carries over unless a
        new one is given); a changed architecture warms a full new program
        set BEFORE the cutover. Returns the new version."""
        rt = self._get(name)
        net = load_net(net_or_path) if isinstance(net_or_path, str) \
            else net_or_path
        check_same_device("the net", net.device, self.device)
        if draft is not None:
            check_same_device("the draft", draft.device, self.device)
        with rt.swap_lock:
            old = rt.active_ps
            try:
                new_ps = old.with_params_from(net, draft_net=draft)
            except ValueError:
                self._pause_watch()
                try:
                    new_ps = GenerationProgramSet(
                        net, config=old.config, adapter="auto",
                        draft_net=(old.draft_net if draft is None
                                   else draft),
                        trace_hook=self._on_trace).warm()
                finally:
                    self._resume_watch()
            rt.active_ps = new_ps         # atomic: the next admission cohort
            rt.version += 1
            rt.metrics.record_swap()
            return rt.version

    def reload_from_checkpoint(self, name: str, path: str) -> int:
        return self.hot_swap(name, load_net(path))

    # ---------------------------------------------------------- observability
    def metrics(self) -> Dict[str, dict]:
        with self._lock:
            rts = list(self._models.values())
        return {rt.name: rt.metrics.snapshot() for rt in rts}

    def models(self) -> Dict[str, dict]:
        with self._lock:
            rts = list(self._models.values())
        return {rt.name: {
            "version": rt.version,
            "adapter": rt.active_ps.adapter,
            "warmed": rt.active_ps.warmed,
            "decode_slots": rt.config.decode_slots,
            "block_len": rt.config.block_len,
            "capacity": rt.config.capacity,
            "num_blocks": rt.config.num_blocks,
            "prompt_rungs": list(rt.config.prompt_rungs),
            "prefill_batches": list(rt.config.prefill_batches),
            "in_flight": rt.in_flight,
            "queue_depth": rt.queue_depth,
            "prefix_cache": rt.active_ps.prefix_enabled,
            "kv_cache_dtype": rt.config.kv_cache_dtype,
            "kv_bytes_per_token": rt.active_ps.kv_bytes_per_token(),
            "model_shards": rt.active_ps.model_shards,
            "kv_pool_bytes_per_chip": rt.active_ps.kv_pool_chip_bytes,
            "speculative": {
                "enabled": rt.active_ps.spec_k > 0,
                "k": rt.active_ps.spec_k,
                "draft_adapter": rt.active_ps.draft_adapter,
            },
        } for rt in rts}

    def queue_depths(self) -> Dict[str, int]:
        with self._lock:
            rts = list(self._models.values())
        return {rt.name: rt.queue_depth for rt in rts}

    def steering(self) -> dict:
        """Per-model routing signals and the worst-case aggregate a fleet
        router steers on: total queue depth, max slot occupancy, min
        block-pool free fraction and the request-weighted prefix hit rate
        across models."""
        with self._lock:
            rts = list(self._models.values())
        per = {rt.name: rt.steering() for rt in rts}
        rows = list(per.values())
        hits = sum(r["prefix_hit_rate"] * r["prefix_lookups"] for r in rows)
        lookups = sum(r["prefix_lookups"] for r in rows)
        return {
            "queue_depth": sum(r["queue_depth"] for r in rows),
            "in_flight": sum(r["in_flight"] for r in rows),
            "slot_occupancy": max(
                (r["slot_occupancy"] for r in rows), default=0.0),
            "block_pool_free_frac": min(
                (r["block_pool_free_frac"] for r in rows), default=1.0),
            "prefix_hit_rate": round(hits / lookups, 4) if lookups else 0.0,
            "prefix_lookups": lookups,
            "block_len": per.get(self._default, {}).get(
                "block_len", rows[0]["block_len"] if rows else None),
            "models": per,
        }

    def publish_metrics(self, storage, session_id: str = "generation"):
        raise NotImplementedError("publishing generation metrics to a "
                                  "StatsStorage backend is not ported yet "
                                  "(ROADMAP A8)")

    @property
    def trace_count(self) -> int:
        """Warm runs of this engine's programs (one per program and shape
        per warmed set); traffic must not move it."""
        return self._trace_count

    def _on_trace(self):
        self._trace_count += 1
        with self._lock:
            rts = list(self._models.values())
        for rt in rts:
            if rt.watching:
                rt.warm_runs_while_serving += 1

    @property
    def draining(self) -> bool:
        return self._draining

    def _pause_watch(self):
        """Warm-up runs are legitimate: keep them out of the serving
        runtimes' counts."""
        with self._lock:
            rts = list(self._models.values())
        for rt in rts:
            rt.watching = False

    def _resume_watch(self):
        with self._lock:
            rts = list(self._models.values())
        for rt in rts:
            rt.watching = True

    # ------------------------------------------------------------- lifecycle
    def stop(self, drain: bool = True, timeout: float = 10.0) -> None:
        with self._lock:
            self._draining = True
            rts = list(self._models.values())
        for rt in rts:
            rt.stop(drain=drain, timeout=timeout)
