"""Serving engines: the static batch and continuous batching.

``Engine.generate`` keeps the reference's signature and semantics: stop
tokens, the position bookkeeping, and the order of draws.  Greedy is
``argmax``; sampling is Gumbel-max over ``logits / temperature`` with
uniforms drawn from the caller's ``torch.Generator`` (the reference uses
``jax.random.categorical``, which is the same draw rule on other bits).
Both engines run under ``torch.inference_mode()``; a backend, a block
policy (``blocks_policy``: ``"heuristic"``, ``"autotune"`` or a callable,
``dispatch.resolve_blocks``) and an accumulator dtype (``accum_dtype``:
``"bfloat16"`` rounds every full-precision GEMM, convolution and flash
kernel's sums at the reference's block ends; the quantized GEMMs of a
quant tier keep their own accumulator), when given, scope prefill and
decode through ``dispatch.use``, as the reference's ``_tier_context``
does: under
``"autotune"`` the first call at each kernel shape pays the measured
search (or reads ``REPRO_TORCH_TUNING_CACHE``) and later ones reuse the
winner.  A VLM config (``cfg.n_patches``) takes ``patch_embeds`` (B,
n_patches, d_model) beside the tokens, whose positions then start past the
patch prefix (``pos_off``), as in the reference.  The encoder-decoder
(seamless-m4t) takes ``src_embeds`` (B, src_len, d_model) of the stub
frontend beside the tokens (``ServeConfig.src_len`` /
``PoolConfig.src_len`` size its cross-KV; a request's ``src_embeds`` of
another length raises); its positions start at 0, the encoder runs at
prefill or with a chunked prompt's first chunk, and its cross K and V stay
in the pool's slot for every later chunk and decode step.  The quant tiers
are the reference's: prefill runs under ``use(quant=quant)``, decode under
``use(quant=decode_quant)``, which defaults to ``quant`` (the canonical
production mix is ``quant=None`` with ``decode_quant="int8"``: prefill is
compute-bound, decode streams the weights).  A calibrated model
(``quant.calibrate_params``) runs its GEMMs quantized in both phases
without any tier (the encoder-decoder's too: its encoder, cross K and V
and head are GEMMs like the others), every family alike: the MoE experts
run on the quantized batched GEMM, MLA's projections and the recurrent
families' on the quantized GEMM, as in the reference (whose XLA expert
branch, full precision whatever the tier, the port does not follow).  A
recurrent config serves from the slotted pool only (a page size is ignored
and chunked or bucketed prefill raise, as in the reference), and an xLSTM
prompt that breaks mLSTM's chunk rule (at most ``mlstm_chunk`` tokens, or
a multiple of it) raises before any state is written.  In the static
engine an MoE decode routes the batch as one group; the continuous
engine's slot decode routes each slot as its own
(``api.decode_step_slots``), as the reference's ``vmap`` does.

``ContinuousEngine`` is the port of the reference's continuous-batching
loop (``repro/serve/engine.py``): a slotted or paged KV pool
(``serve/kv_cache.py``), the admission scheduler (``serve/scheduler.py``),
per-request prefill (one-shot, bucketed, or in chunks under a per-step
token budget), one batched decode step over every slot with per-slot
positions, preemption when the page pool runs dry, cancellation,
streaming callbacks, serving metrics and request spans (``obs``).  Greedy
outputs match the static ``Engine`` token for token.  The reference's
``key`` is a ``torch.Generator`` here (by default one on the engine's
device, seeded 0, so sampling draws no uniforms on the host); its
``interpret`` has no counterpart on the card.

Both engines take the reference's ``mesh`` and ``axis_specs``
(``_tier_context``: an unset mesh falls back to the one the launcher
installed, ``sharding.annotate.current_mesh``, read at each call).  They
only scope dispatch, as the reference's do: every kernel's plan is chosen
for the shard its op would run on that mesh (``dispatch.resolve_blocks``),
while the engine runs the whole problem on its one device and shards
nothing.  So the mesh is an abstract one (``sharding.local.
abstract_mesh``, ``launch.mesh.make_production_mesh``); serving over the
ranks of a running mesh is not ported yet (ROADMAP queue 1, item 6.4).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ArchCfg
from repro_torch.core import dispatch
from repro_torch.core.quantize import as_quant_config
from repro_torch.models import api
from repro_torch.serve.kv_cache import PagedKVCache, SlotKVCache
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import Request, RequestState, Scheduler
from repro_torch.sharding import annotate


def completed_lengths(ids, stop_tokens) -> np.ndarray:
    """Per-row generated length of a (B, T) id array: index of the first
    stop token + 1 (the stop token is part of the output), else T."""
    arr = np.asarray(ids)
    lens = np.full(arr.shape[0], arr.shape[1], np.int64)
    stops = list(stop_tokens)
    if not stops:
        return lens
    for b in range(arr.shape[0]):
        hits = np.nonzero(np.isin(arr[b], stops))[0]
        if hits.size:
            lens[b] = hits[0] + 1
    return lens


def _gumbel(shape, generator, device):
    """Gumbel noise from the generator's uniforms, on ``device``."""
    u = torch.rand(shape, generator=generator,
                   device=generator.device).to(device)
    return -torch.log(-torch.log(u.clamp_min(1e-20)))


def _tier(quant):
    return as_quant_config(quant) if quant is not None else None


def _tier_context(backend, blocks_policy, accum_dtype, mesh=None,
                  axis_specs=None, quant=None):
    """The ``dispatch.use`` kwargs of one serving tier, read at the call:
    an unset mesh falls back to the one the launcher installed
    (``sharding.annotate.use_rules``)."""
    return dict(backend=backend, blocks_policy=blocks_policy,
                accum_dtype=accum_dtype,
                mesh=mesh if mesh is not None else annotate.current_mesh(),
                axis_specs=axis_specs, quant=quant)


def _check_mesh(mesh, axis_specs):
    """An engine's mesh: None, or one that models a layout (a running
    mesh's ranks would each serve the whole problem)."""
    dispatch.check_axis_specs(axis_specs)
    if mesh is not None and not mesh.is_abstract and mesh.size > 1:
        raise NotImplementedError(
            f"serving over the {mesh.size} ranks of a running mesh is not "
            f"ported yet (ROADMAP.md queue 1, item 6.4); an abstract mesh "
            f"(sharding.local.abstract_mesh) chooses per-shard plans")
    return mesh


def _accum(accum_dtype):
    """An engine's accumulator dtype, validated at construction."""
    return (dispatch.as_accum_dtype(accum_dtype) if accum_dtype is not None
            else None)


def _pos_off(cfg: ArchCfg) -> int:
    """Positions a prompt's tokens start at: past a VLM's patch prefix (an
    encoder-decoder's frames are the encoder's, not the decoder's)."""
    return 0 if api.is_encdec(cfg) else cfg.n_patches or 0


def _as_batch1(x, name: str, device):
    if x is None:
        raise ValueError(f"request requires {name} for this architecture")
    x = torch.as_tensor(x, device=device)
    return x if x.dim() == 3 else x[None]


def _src_embeds(x, src_len: int, where: str):
    """An encoder-decoder's ``src_embeds``, which must hold ``src_len``
    frames."""
    if x.shape[1] != src_len:
        raise ValueError(f"src_embeds length {x.shape[1]} != {where} src_len "
                         f"{src_len}")
    return x


@dataclasses.dataclass
class ServeConfig:
    max_len: int
    temperature: float = 0.0   # 0 => greedy
    src_len: int = 0           # enc-dec encoder memory length


class Engine:
    def __init__(self, cfg: ArchCfg, params, scfg: ServeConfig, *,
                 backend: str | None = None, device="cuda", quant=None,
                 decode_quant=None, blocks_policy=None, accum_dtype=None,
                 mesh=None, axis_specs=None):
        self.device = dispatch.check_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.backend = backend
        # Normalized (so validated) here, not at the first call.
        self.blocks_policy = dispatch.check_blocks_policy(blocks_policy)
        self.accum_dtype = _accum(accum_dtype)
        self.mesh = _check_mesh(mesh, axis_specs)
        self.axis_specs = axis_specs
        self.quant = _tier(quant)
        self.decode_quant = _tier(decode_quant) or self.quant

    def _sample(self, logits, generator):
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        gumbel = _gumbel(logits.shape, generator, logits.device)
        return torch.argmax(logits / self.scfg.temperature + gumbel,
                            dim=-1).to(torch.int32)

    def generate(self, batch, *, n_tokens: int,
                 generator: torch.Generator | None = None,
                 stop_tokens=None):
        """batch: ``{"tokens": (B, T) ints}``, and for a VLM config
        ``"patch_embeds"`` (B, n_patches, d_model), for an encoder-decoder
        ``"src_embeds"`` (B, ``scfg.src_len``, d_model).  Returns (B, T')
        int32 ids on the engine's device, T' <= n_tokens.

        ``stop_tokens=None`` defaults to ``(cfg.eos_token,)`` when the config
        has one (pass ``()`` to disable).  With stop tokens the loop ends as
        soon as every row has emitted one; rows that finish early keep
        decoding until the slowest row is done.  ``generator`` (default: a
        generator on the engine's device, seeded 0) feeds sampling and is
        unused when greedy.
        """
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        if stop_tokens is None:
            stop_tokens = ((self.cfg.eos_token,)
                           if self.cfg.eos_token is not None else ())
        stops = tuple(stop_tokens)
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        b, prompt_len = tokens.shape
        api.check_prompt_len(self.cfg, prompt_len)
        inputs = {"tokens": tokens}
        if self.cfg.n_patches:
            inputs["patch_embeds"] = torch.as_tensor(batch["patch_embeds"],
                                                     device=self.device)
        if api.is_encdec(self.cfg):
            inputs["src_embeds"] = _src_embeds(_as_batch1(
                batch.get("src_embeds"), "src_embeds", self.device),
                self.scfg.src_len, "ServeConfig")
        with torch.inference_mode(), dispatch.use(**_tier_context(
                self.backend, self.blocks_policy, self.accum_dtype,
                self.mesh, self.axis_specs)):
            cache = api.init_cache(self.cfg, b, self.scfg.max_len,
                                   self.scfg.src_len, device=self.device)
            with dispatch.use(quant=self.quant):
                logits, cache = api.prefill(self.params, inputs, self.cfg,
                                            cache)
            tok = self._sample(logits, generator)
            out = [tok]
            finished = (np.isin(tok.cpu().numpy(), stops) if stops
                        else None)
            pos = prompt_len + _pos_off(self.cfg)
            for _ in range(n_tokens - 1):
                if stops and finished.all():
                    break
                with dispatch.use(quant=self.decode_quant):
                    logits, cache = api.decode_step(
                        self.params, tok[:, None], self.cfg, cache, pos)
                tok = self._sample(logits, generator)
                out.append(tok)
                if stops:
                    finished |= np.isin(tok.cpu().numpy(), stops)
                pos += 1
            return torch.stack(out, dim=1)


# ==========================================================================
# continuous batching
# ==========================================================================

@dataclasses.dataclass
class PoolConfig:
    """KV pool sizing + prefill shaping (the reference's).

    ``n_slots`` bounds concurrent requests (decode cost is O(n_slots) every
    step, so size it to the target batch).  ``max_len`` bounds prompt +
    generated tokens per slot.  ``prefill_bucket`` rounds prompt lengths up
    to a multiple (right-padding); only valid where pad tokens cannot
    perturb real ones (full causal attention, no capacity-routed MoE, no
    recurrence).

    ``page_size`` switches the engine to the paged KV cache: KV memory is
    then budgeted in pages, and slots only hold page tables.  ``n_pages``
    is the page budget (default: every slot at full ``max_len``; size it
    below that to overcommit, and the engine preempts the newest request
    when the pool runs dry).  Where paging cannot apply the engine takes
    the slotted pool.

    ``prefill_chunk`` caps prefill work per scheduler step: prompts longer
    than the chunk are split into ``prefill_chunk``-token chunks processed
    one per step, so a long prompt never stalls running decodes for more
    than one chunk's compute; shorter prompts share the same per-step
    token budget.  ``kv_quant="int8"`` stores paged KV as int8 with
    per-page scales (requires ``page_size``).  ``src_len`` is an
    encoder-decoder's memory length: every request's ``src_embeds`` holds
    that many frames, and each slot that many cross K and V.
    """
    n_slots: int
    max_len: int
    prefill_bucket: int | None = None
    page_size: int | None = None
    n_pages: int | None = None
    prefill_chunk: int | None = None
    kv_quant: str | None = None
    src_len: int = 0


def _supports_bucketing(cfg: ArchCfg) -> bool:
    return (cfg.block in ("dense", "encdec") and not cfg.window
            and not cfg.n_patches)


def _sample_tokens(logits, temps, top_k, generator):
    """Per-slot sampling: greedy where temp == 0, else Gumbel-max at that
    slot's temperature, top-k filtered where top_k > 0 (the reference's
    rule: logits below the k-th largest are masked out)."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    v = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = top_k.clamp(1, v).long() - 1
    thresh = sorted_desc.gather(-1, kth[:, None])
    masked = torch.where((top_k[:, None] > 0) & (logits < thresh),
                         -torch.inf, logits)
    t = torch.where(temps > 0, temps, torch.ones_like(temps))
    samp = torch.argmax(masked / t[:, None]
                        + _gumbel(logits.shape, generator, logits.device),
                        dim=-1)
    return torch.where(temps > 0, samp, greedy).to(torch.int32)


class ContinuousEngine:
    """Continuous-batching engine: ``submit() + step()`` or ``serve()``.

    Each step admits waiting requests into free KV-cache slots (prefill +
    first token), runs one batched decode step over the full slot pool
    with per-slot positions, and evicts finished requests the same step.
    Greedy outputs match the static ``Engine`` token for token.  Pools and
    every op run on ``device`` (the card unless ``"cpu"`` is passed), under
    ``torch.inference_mode()``.
    """

    def __init__(self, cfg: ArchCfg, params, pool: PoolConfig, *,
                 backend: str | None = None, quant=None, decode_quant=None,
                 blocks_policy=None, accum_dtype=None, mesh=None,
                 axis_specs=None, priority_fn=None,
                 generator: torch.Generator | None = None,
                 trace_sample_rate: int | None = None,
                 clock: Callable[[], float] = time.perf_counter,
                 device="cuda"):
        if pool.prefill_bucket is not None and not _supports_bucketing(cfg):
            raise ValueError(
                f"prefill_bucket is not supported for block={cfg.block!r} "
                f"(window={cfg.window}, n_patches={cfg.n_patches}): pad "
                "tokens could perturb real ones")
        if pool.prefill_chunk is not None and not api.supports_paging(cfg):
            raise ValueError(
                f"prefill_chunk is not supported for block={cfg.block!r} "
                f"(window={cfg.window}, n_patches={cfg.n_patches}): chunk "
                "attention needs position-indexed, length-masked KV")
        if pool.prefill_chunk is not None and pool.prefill_bucket is not None:
            raise ValueError("prefill_chunk and prefill_bucket are "
                             "mutually exclusive")
        if (pool.prefill_chunk is not None and pool.page_size
                and pool.prefill_chunk % pool.page_size):
            raise ValueError(
                f"prefill_chunk ({pool.prefill_chunk}) must be a multiple "
                f"of page_size ({pool.page_size}) so chunks stay "
                "page-aligned")
        if pool.kv_quant is not None and not pool.page_size:
            raise ValueError("kv_quant requires page_size (paged pool)")
        self.device = dispatch.check_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.pool_cfg = pool
        self.backend = backend
        self.blocks_policy = dispatch.check_blocks_policy(blocks_policy)
        self.accum_dtype = _accum(accum_dtype)
        self.mesh = _check_mesh(mesh, axis_specs)
        self.axis_specs = axis_specs
        self._pos_off = _pos_off(cfg)
        self.quant = _tier(quant)
        # decode streams the weights, so it gets its own quant tier
        self.decode_quant = _tier(decode_quant) or self.quant
        # paged pool where the architecture allows it, else slotted
        self.paged = bool(pool.page_size) and api.supports_paging(cfg)
        if self.paged:
            self.pool = PagedKVCache(cfg, pool.n_slots, pool.max_len,
                                     page_size=pool.page_size,
                                     n_pages=pool.n_pages,
                                     src_len=pool.src_len,
                                     kv_quant=pool.kv_quant,
                                     device=self.device)
        else:
            self.pool = SlotKVCache(cfg, pool.n_slots, pool.max_len,
                                    src_len=pool.src_len,
                                    device=self.device)
        self.scheduler = Scheduler(priority_fn=priority_fn)
        self.metrics = ServeMetrics()
        # every lifecycle stamp (submit/admit/prefill-end/first-token)
        # comes from this one clock, so TTFT breakdown segments telescope
        # exactly; injectable for deterministic tests
        self._clock = clock
        self._generator = (generator if generator is not None else
                           torch.Generator(self.device).manual_seed(0))
        # Host-side per-slot sampling state, copied to the device each
        # step; free slots hold zeros and decode as ignored garbage.
        self._tokens = np.zeros(pool.n_slots, np.int32)
        self._temps = np.zeros(pool.n_slots, np.float32)
        self._topk = np.zeros(pool.n_slots, np.int32)
        # request_id -> on_token callback for streaming consumers
        self._on_token: dict[int, Any] = {}
        # chunked prefill in flight (at most one: head-of-line admission
        # keeps staging memory bounded to a single batch-1 view)
        self._staging: dict | None = None
        # sampled per-request tracing: every Nth submitted request gets
        # the full span tree; counters stay always-on for the rest
        self.trace_sample_rate = trace_sample_rate
        self._trace_count = 0
        self._trace_ids: set[int] = set()

    # ---------------- request lifecycle ----------------

    def submit(self, request: Request, *,
               on_token: Callable[[int, int, bool], Any] | None = None,
               trace: str | None = None) -> int:
        """Queue a request; returns its id (see ``scheduler.finished``).

        ``on_token(request_id, token, finished)`` streams the request's
        tokens as they are produced: it fires once per event, inside the
        ``step()`` that generated the token and in generation order, and
        never again after the ``finished=True`` call.  Exceptions from the
        callback propagate out of ``step()``/``serve()``.

        ``trace`` is an opaque trace id stamped onto the request's spans
        and events; defaults to ``req<id>``.  An explicit id forces the
        request to be span-sampled; ``""`` opts it out; ``None`` defers to
        the engine's ``trace_sample_rate`` (every Nth submitted request
        gets the full span tree; ``None`` rate samples everything).
        """
        n_prompt = len(request.prompt)
        if n_prompt < 1:
            raise ValueError("empty prompt")
        api.check_prompt_len(self.cfg, n_prompt)
        need = self._pos_off + n_prompt + request.max_tokens
        if need > self.pool_cfg.max_len:
            raise ValueError(
                f"prompt ({n_prompt}) + max_tokens ({request.max_tokens}) "
                f"exceeds pool max_len ({self.pool_cfg.max_len})")
        stops = request.stop_tokens
        if stops is None:
            stops = ((self.cfg.eos_token,)
                     if self.cfg.eos_token is not None else ())
        self.metrics.requests_submitted += 1
        self._trace_count += 1
        if trace == "":
            sampled, trace = False, None
        elif trace is not None:
            sampled = True
        else:
            rate = self.trace_sample_rate
            sampled = (rate is None or rate <= 1
                       or (self._trace_count - 1) % rate == 0)
        rid = self.scheduler.submit(request, stop_tokens=tuple(stops),
                                    step=self.metrics.steps,
                                    now=self._clock(), trace=trace)
        if trace is None:
            self.scheduler.waiting[-1].trace = f"req{rid}"
        if sampled:
            self._trace_ids.add(rid)
        if on_token is not None:
            self._on_token[rid] = on_token
        obs.event("engine.submit", request_id=rid,
                  trace=self.scheduler.waiting[-1].trace,
                  prompt_len=n_prompt, max_tokens=request.max_tokens)
        return rid

    def _emit(self, request_id: int, token: int, finished: bool):
        """Build one step event, streaming it to the request's callback."""
        cb = self._on_token.get(request_id)
        if cb is not None:
            cb(request_id, token, finished)
            if finished:
                self._on_token.pop(request_id, None)
        return request_id, token, finished

    def _tokens_on_device(self, tokens) -> torch.Tensor:
        return torch.tensor(np.asarray(tokens, np.int32)[None],
                            device=self.device)

    def _prompt_batch(self, request: Request):
        """(batch dict, logit_pos) for one request's prefill, optionally
        right-padded to the prefill bucket."""
        n = len(request.prompt)
        pad_to = n
        bucket = self.pool_cfg.prefill_bucket
        if bucket:
            pad_to = min(self.pool_cfg.max_len, -(-n // bucket) * bucket)
        tokens = np.zeros(pad_to, np.int32)
        tokens[:n] = request.prompt
        batch = {"tokens": self._tokens_on_device(tokens)}
        if api.is_encdec(self.cfg):
            batch["src_embeds"] = self._request_src(request)
        if self.cfg.n_patches:
            batch["patch_embeds"] = _as_batch1(request.patch_embeds,
                                               "patch_embeds", self.device)
        return batch, self._pos_off + n - 1

    def _request_src(self, request: Request):
        """A request's ``src_embeds`` as a batch of one, ``src_len`` long."""
        return _src_embeds(_as_batch1(request.src_embeds, "src_embeds",
                                      self.device),
                           self.pool_cfg.src_len, "pool")

    def _span(self, name: str, state: RequestState, **attrs):
        """A span of a traced request, else the no-op span."""
        tr = obs.current_tracer()
        if tr is None or state.request_id not in self._trace_ids:
            return obs.NULL_SPAN
        return tr.span(name, request_id=state.request_id, trace=state.trace,
                       **attrs)

    def _admit(self, state: RequestState, slot: int):
        """Prefill + first token; returns the (id, token, finished) event."""
        req = state.request
        state.admit_time = self._clock()
        batch, logit_pos = self._prompt_batch(req)
        with self._span("prefill", state, prompt_len=len(req.prompt),
                        slot=slot):
            logits, rcache = self._prefill(batch, self.pool.request_cache(),
                                           logit_pos)
            if self.paged:
                n_valid = self._pos_off + len(req.prompt)
                if not self.pool.insert(slot, rcache, n_valid):
                    # step() pre-checks the page budget, so this only
                    # trips on a logic error: fail loudly, not silently
                    raise RuntimeError(
                        f"page pool exhausted admitting request "
                        f"{state.request_id}")
            else:
                self.pool.insert(slot, rcache)
        return self._first_token(state, slot, logits)

    def _prefill(self, batch, cache, logit_pos):
        """One-shot prefill of a request's batch into its cache view, in
        the engine's quant tier: (logits, cache).  With ``step`` and
        ``_decode``, one of the entry points a fault injector wraps
        (``serve/faults.py``)."""
        with dispatch.use(quant=self.quant):
            return api.prefill(self.params, batch, self.cfg, cache,
                               logit_pos=logit_pos)

    def _first_token(self, state: RequestState, slot: int, logits):
        """Sample the first token from prefill logits and activate the
        slot.  Shared tail of one-shot admission (``_admit``) and chunked
        prefill completion (``_staging_step``)."""
        req = state.request
        # prefill runs asynchronously on the card; the sample below syncs,
        # so the first_decode segment includes waiting out the prefill tail
        state.prefill_end_time = self._clock()
        self.metrics.prefills += 1
        self.scheduler.start(state, slot, self.metrics.steps)

        # first token comes from the prefill logits
        if req.temperature <= 0.0:
            tok = int(torch.argmax(logits[0]))
        else:
            tok = int(_sample_tokens(
                logits,
                torch.full((1,), req.temperature, device=self.device),
                torch.full((1,), req.top_k, device=self.device),
                self._generator)[0])
        self.metrics.tokens_generated += 1
        # a preempted request re-admits with its tokens folded into the
        # prompt: its TTFT was already recorded at first admission
        first = state.first_token_time is None
        if first:
            self.metrics.ttft_steps_sum += (self.metrics.steps
                                            - state.submit_step)
            self.metrics.ttft_count += 1
        finished = self.scheduler.record_token(state, tok,
                                               self.metrics.steps,
                                               now=self._clock())
        # first token always lands at admission => wall-clock TTFT is known
        if first and state.ttft_s is not None:
            self.metrics.ttft_s_sum += state.ttft_s
            self.metrics.ttft_hist.observe(state.ttft_s)
        if finished:
            self._evict(state)
            return state.request_id, tok, True
        n_valid = self._pos_off + len(req.prompt)
        self._tokens[slot] = tok
        self._temps[slot] = req.temperature
        self._topk[slot] = req.top_k
        self.pool.positions[slot] = n_valid   # next decode writes here
        self.pool.lengths[slot] = n_valid
        return state.request_id, tok, False

    def _evict(self, state: RequestState) -> None:
        self._release_slot(state.slot)
        self.metrics.requests_completed += 1
        tr = obs.current_tracer()
        if tr is not None and state.request_id in self._trace_ids:
            self._trace_request(tr, state)
        self._trace_ids.discard(state.request_id)

    def _trace_request(self, tracer, state: RequestState) -> None:
        """Emit the request's lifecycle as synthetic spans at eviction.

        A request lives across many ``step()`` calls, so its spans can't be
        open context managers; instead the scheduler's lifecycle stamps are
        replayed as one ``request`` span with ``request.queue`` /
        ``request.prefill`` / ``request.first_decode`` children cut from
        the same stamps as ``ttft_breakdown`` (they telescope exactly).
        """
        end = (state.finish_time if state.finish_time is not None
               else self._clock())
        root = tracer.add_span(
            "request", state.submit_time, end,
            request_id=state.request_id, trace=state.trace,
            status=state.status, finish_reason=state.finish_reason,
            tokens=len(state.generated), ttft_s=state.ttft_s)
        if state.ttft_breakdown is None:
            return
        for name, t0, t1 in (
                ("request.queue", state.submit_time, state.admit_time),
                ("request.prefill", state.admit_time,
                 state.prefill_end_time),
                ("request.first_decode", state.prefill_end_time,
                 state.first_token_time)):
            tracer.add_span(name, t0, t1, parent_id=root.span_id,
                            trace=state.trace)

    def _release_slot(self, slot: int) -> None:
        self.pool.free(slot)
        self._tokens[slot] = 0
        self._temps[slot] = 0.0
        self._topk[slot] = 0

    # ---------------- chunked prefill / preemption ----------------

    def _start_staging(self, state: RequestState, slot: int) -> None:
        """Begin a chunked prefill: the prompt is longer than the per-step
        prefill budget, so its chunks run one per ``step()`` against a
        private batch-1 cache view; the finished view is inserted into the
        pool in one write.  At most one request stages at a time
        (head-of-line admission bounds staging memory to one view)."""
        state.admit_time = self._clock()
        self._staging = {"state": state, "slot": slot,
                         "cache": self.pool.request_cache(),
                         "pos": 0, "first": True, "logits": None,
                         "ready": False}
        obs.event("engine.prefill_chunk_start", request_id=state.request_id,
                  trace=state.trace, prompt_len=len(state.request.prompt),
                  chunk=self.pool_cfg.prefill_chunk)

    def _staging_step(self):
        """Advance the in-flight chunked prefill by one chunk (or retry a
        page-starved pool insert).  Returns ``(prefill tokens consumed,
        event or None)``: the event fires on the chunk that completes the
        prompt *and* lands in the pool."""
        st = self._staging
        state, slot = st["state"], st["slot"]
        prompt = state.request.prompt
        consumed = 0
        if not st["ready"]:
            pos = st["pos"]
            width = min(self.pool_cfg.prefill_chunk, len(prompt) - pos)
            batch = {"tokens": self._tokens_on_device(prompt[pos:pos
                                                             + width])}
            if api.is_encdec(self.cfg) and st["first"]:
                batch["src_embeds"] = self._request_src(state.request)
            with self._span("prefill.chunk", state, pos=pos, width=width,
                            slot=slot), dispatch.use(quant=self.quant):
                logits, st["cache"] = api.prefill_chunk(
                    self.params, batch, self.cfg, st["cache"], pos,
                    first_chunk=st["first"])
            st["first"] = False
            st["pos"] = pos + width
            self.metrics.prefill_chunks += 1
            consumed = width
            if st["pos"] < len(prompt):
                return consumed, None
            st["ready"] = True
            st["logits"] = logits
        # prompt fully prefilled: move the view into the pool (page-
        # starved inserts return False and are retried next step)
        if self.paged:
            n_valid = self._pos_off + len(prompt)
            if not self.pool.insert(slot, st["cache"], n_valid):
                return consumed, None
        else:
            self.pool.insert(slot, st["cache"])
        logits = st["logits"]
        self._staging = None
        return consumed, self._first_token(state, slot, logits)

    def _preempt(self, state: RequestState) -> None:
        """Evict a running request to reclaim its pages: its generated
        tokens fold into the prompt and it requeues first-in-line, so a
        greedy re-admission prefill recomputes the same KV and continues
        with the correct next token; nothing is emitted twice."""
        slot = state.slot
        obs.event("engine.preempt", request_id=state.request_id,
                  trace=state.trace, generated=len(state.generated))
        self.scheduler.preempt(state)
        self._release_slot(slot)
        self.metrics.preemptions += 1

    def _ensure_pages(self) -> None:
        """Paged pools only: guarantee every running slot owns the page
        its next decode write lands in, preempting the newest admissions
        while the free list is dry (newest-first keeps FCFS fairness and
        minimizes recompute)."""
        for slot in sorted(self.scheduler.running):
            state = self.scheduler.running.get(slot)
            if state is None:
                continue   # preempted earlier in this pass
            while not self.pool.ensure(slot, int(self.pool.positions[slot])):
                victim = max(self.scheduler.running.values(),
                             key=lambda s: (s.admit_step, s.request_id))
                self._preempt(victim)
                if victim is state:
                    break

    def gauges(self) -> dict[str, float]:
        """Point-in-time pool gauges (slot occupancy; page stats when
        paged) for metrics exporters."""
        g = {"kv_occupancy": self.pool.occupancy}
        if self.paged:
            g["kv_page_occupancy"] = self.pool.page_occupancy
            g["kv_page_fragmentation"] = self.pool.fragmentation
            g["kv_free_pages"] = float(self.pool.n_free_pages)
        return g

    def has_work(self) -> bool:
        """Whether any request is waiting, staging, or running."""
        return self._staging is not None or self.scheduler.has_work()

    def cancel(self, request_id: int) -> bool:
        """Cancel a waiting, staging or running request mid-flight.

        A running request's KV slot is freed the same step (available to
        the next admission sweep).  Its streaming callback is dropped
        without a ``finished=True`` call: cancellation is not a generated
        token.  Returns False when the id is unknown or already finished.
        """
        if (self._staging is not None
                and self._staging["state"].request_id == request_id):
            st, self._staging = self._staging, None
            self.scheduler._finish(st["state"], "cancelled",
                                   self.metrics.steps)
            self._release_slot(st["slot"])
        else:
            state = self.scheduler.cancel(request_id,
                                          step=self.metrics.steps)
            if state is None:
                return False
            if state.slot is not None:
                self._release_slot(state.slot)
        self._on_token.pop(request_id, None)
        self._trace_ids.discard(request_id)
        self.metrics.requests_cancelled += 1
        return True

    # ---------------- the serving loop ----------------

    def step(self):
        """One scheduler step: admit, batched decode, evict finished.

        Returns a list of ``(request_id, token, finished)`` events.
        """
        with torch.inference_mode(), dispatch.use(**_tier_context(
                self.backend, self.blocks_policy, self.accum_dtype,
                self.mesh, self.axis_specs)):
            return self._step()

    def _step(self):
        t0 = self._clock()
        self.metrics.steps += 1
        step = self.metrics.steps
        depth = self.scheduler.queue_depth
        self.metrics.queue_depth_sum += depth
        self.metrics.max_queue_depth = max(self.metrics.max_queue_depth,
                                           depth)

        events = []
        # per-step prefill token budget (prefill_chunk): the in-flight
        # chunked prefill advances first, then one-shot admissions share
        # whatever is left, so decodes never stall more than one chunk
        budget = self.pool_cfg.prefill_chunk
        spent = 0
        if self._staging is not None:
            consumed, event = self._staging_step()
            spent += consumed
            if event is not None:
                events.append(self._emit(*event))
        while self.pool.n_free and self.scheduler.waiting:
            if budget is not None and spent >= budget:
                break
            state = self.scheduler.next_waiting()
            n_prompt = len(state.request.prompt)
            if budget is not None and n_prompt > budget:
                # prompt longer than a whole step's budget: chunk it.
                # Staging starts only on a step with no prefill work yet,
                # so every chunk gets the full (page-aligned) budget.
                if self._staging is not None or spent:
                    self.scheduler.requeue(state)
                    break
                slot = self.pool.alloc()
                self._start_staging(state, slot)
                consumed, event = self._staging_step()
                spent += consumed
                if event is not None:
                    events.append(self._emit(*event))
                break
            if budget is not None and spent + n_prompt > budget:
                self.scheduler.requeue(state)
                break
            if (self.paged and -(-(self._pos_off + n_prompt)
                                 // self.pool.page_size)
                    > self.pool.n_free_pages):
                # not enough pages for the prompt: hold admission (decode
                # progress frees pages as running requests finish)
                self.scheduler.requeue(state)
                break
            slot = self.pool.alloc()
            try:
                event = self._admit(state, slot)
            except Exception:
                # retry-safe admission: a failed prefill frees the slot
                # and puts the request back first-in-line, so a retried
                # step neither loses nor duplicates it
                self.scheduler.running.pop(slot, None)
                self._release_slot(slot)
                self.scheduler.requeue(state)
                raise
            events.append(self._emit(*event))
            spent += n_prompt

        if self.paged:
            self._ensure_pages()
        active = sorted(self.scheduler.running.items())
        if active:
            tr = obs.current_tracer()
            dspan = (tr.span("decode", step=step, n_active=len(active))
                     if tr is not None else obs.NULL_SPAN)
            td0 = self._clock()
            with dspan:
                toks = self._decode()
            # toks came to the host above, so td1 - td0 is the real decode
            # latency every active slot's token paid this step
            td1 = self._clock()
            self.metrics.token_latency_hist.observe(td1 - td0,
                                                    n=len(active))
            self.metrics.decode_steps += 1
            self.metrics.slot_steps += len(active)
            self.metrics.slot_capacity_steps += self.pool.n_slots
            for slot, state in active:
                self.pool.positions[slot] += 1
                self.pool.lengths[slot] += 1
                tok = int(toks[slot])
                self.metrics.tokens_generated += 1
                finished = self.scheduler.record_token(state, tok, step,
                                                       now=td1)
                events.append(self._emit(state.request_id, tok, finished))
                if finished:
                    self._evict(state)
                else:
                    self._tokens[slot] = tok
        self.metrics.wall_time_s += self._clock() - t0
        return events

    def _decode(self) -> np.ndarray:
        """One decode step over every slot; the sampled tokens on the
        host."""
        tokens = torch.tensor(self._tokens[:, None], device=self.device)
        with dispatch.use(quant=self.decode_quant):
            if self.paged:
                logits, _, _ = api.decode_step_paged(
                    self.params, tokens, self.cfg, self.pool.data,
                    self.pool.page_tables, self.pool.positions,
                    page_size=self.pool.page_size, scales=self.pool.scales,
                    view_dtype=self.pool.view_dtype)
            else:
                logits, _ = api.decode_step_slots(
                    self.params, tokens, self.cfg, self.pool.cache,
                    self.pool.positions)
        if not np.any(self._temps > 0):
            toks = torch.argmax(logits, dim=-1)
        else:
            toks = _sample_tokens(
                logits, torch.tensor(self._temps, device=self.device),
                torch.tensor(self._topk, device=self.device),
                self._generator)
        return toks.cpu().numpy()

    def serve(self, requests, *, generator: torch.Generator | None = None
              ) -> dict[int, list[int]]:
        """Run ``requests`` to completion; returns {request_id: token ids}.

        Requests beyond the slot capacity queue and join mid-stream as
        earlier ones finish.  More can be ``submit()``-ed between
        ``step()`` calls when driving the loop manually.  ``generator``
        replaces the engine's sampling generator from here on.
        """
        if generator is not None:
            self._generator = generator
        ids = [self.submit(r) for r in requests]
        while self.has_work():
            self.step()
        return {rid: list(self.scheduler.finished[rid].generated)
                for rid in ids}
