"""Admission + step scheduler for continuous batching.

The port of ``repro/serve/scheduler.py``, unchanged: pure host-side
bookkeeping (no tensors).  Requests queue on submission, are
admitted into KV-cache slots as capacity frees up (FCFS by default, with a
priority hook), and are evicted the step they finish (stop token,
``max_tokens``, or ``cancel()``).  The engine drives it:

    state = scheduler.next_waiting()     # admission order
    scheduler.start(state, slot, step)   # after prefill
    scheduler.record_token(state, tok, step)  # True => finished + evicted
    scheduler.cancel(request_id, step=step)   # waiting or running

The scheduler never touches device state; slot recycling is the engine's
job (``SlotKVCache.free``).  Wall-clock stamps (``submit_time``,
``first_token_time``) are recorded on each state so time-to-first-token
can be reported in seconds, not just scheduler steps.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Optional, Sequence

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"


@dataclasses.dataclass
class Request:
    """One generation request.

    ``stop_tokens=None`` defers to the engine default (``cfg.eos_token``
    when set); pass ``()`` to disable early stop.  ``temperature=0`` is
    greedy; ``top_k=0`` disables top-k filtering.  ``src_embeds`` (enc-dec
    encoder memory) and ``patch_embeds`` (VLM prefix) are per-request
    modality inputs, shaped with or without the leading batch-1 axis.
    """
    prompt: Sequence[int]
    max_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    stop_tokens: Optional[Sequence[int]] = None
    priority: float = 0.0
    src_embeds: Any = None
    patch_embeds: Any = None


@dataclasses.dataclass
class RequestState:
    """Scheduler-tracked lifecycle of one request."""
    request: Request
    request_id: int
    stop_tokens: tuple
    status: str = WAITING
    slot: Optional[int] = None
    generated: list = dataclasses.field(default_factory=list)
    submit_step: int = 0
    admit_step: Optional[int] = None
    first_token_step: Optional[int] = None
    finish_step: Optional[int] = None
    finish_reason: Optional[str] = None   # "stop" | "length" | "cancelled"
    submit_time: float = 0.0              # wall clock (time.perf_counter)
    first_token_time: Optional[float] = None
    # TTFT breakdown stamps (engine clock, same domain as submit_time):
    # admission start and prefill completion split TTFT into queue wait /
    # prefill / first-decode segments that telescope exactly
    admit_time: Optional[float] = None
    prefill_end_time: Optional[float] = None
    finish_time: Optional[float] = None
    trace: Optional[str] = None           # trace id (obs), None untraced

    @property
    def ttft_s(self) -> Optional[float]:
        """Wall-clock time-to-first-token in seconds (None before it)."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def ttft_breakdown(self) -> Optional[dict]:
        """Where TTFT went: ``{"queue_s", "prefill_s", "first_decode_s"}``.

        The three segments are cut from contiguous stamps on one clock
        (submit -> admit -> prefill end -> first token), so they sum to
        ``ttft_s`` exactly.  None until the first token (or when the
        engine never stamped the admission, e.g. states finished by
        ``cancel`` while waiting).
        """
        if (self.first_token_time is None or self.admit_time is None
                or self.prefill_end_time is None):
            return None
        return {
            "queue_s": self.admit_time - self.submit_time,
            "prefill_s": self.prefill_end_time - self.admit_time,
            "first_decode_s": self.first_token_time
            - self.prefill_end_time,
        }


class Scheduler:
    """FCFS admission with a priority hook.

    ``priority_fn(request) -> float`` overrides the admission order:
    higher priority first, FCFS (submission order) among ties.  Without it,
    ``Request.priority`` is used the same way (all-zero priorities degrade
    to pure FCFS).
    """

    def __init__(self, *, priority_fn: Callable[[Request], float] | None
                 = None):
        self.priority_fn = priority_fn
        self.waiting: collections.deque[RequestState] = collections.deque()
        self.running: dict[int, RequestState] = {}    # slot -> state
        self.finished: dict[int, RequestState] = {}   # request_id -> state
        self._next_id = 0

    # ---------------- submission / admission ----------------

    def submit(self, request: Request, *, stop_tokens: tuple = (),
               step: int = 0, now: float | None = None,
               trace: str | None = None) -> int:
        """Queue a request; returns its id.  ``stop_tokens`` is the
        engine-resolved stop set (request override already applied);
        ``trace`` is an opaque trace id threaded onto the request's
        spans (router ticket ids propagate here)."""
        state = RequestState(request=request, request_id=self._next_id,
                             stop_tokens=tuple(stop_tokens),
                             submit_step=step, trace=trace,
                             submit_time=(time.perf_counter()
                                          if now is None else now))
        self._next_id += 1
        self.waiting.append(state)
        return state.request_id

    def next_waiting(self) -> RequestState | None:
        """Pop the next request to admit (priority, then FCFS)."""
        if not self.waiting:
            return None
        key = self.priority_fn or (lambda req: req.priority)
        # max() is stable over first occurrence: FCFS among equal priority.
        best = max(self.waiting, key=lambda s: key(s.request))
        self.waiting.remove(best)
        return best

    def requeue(self, state: RequestState) -> None:
        """Put an un-admitted state back at the head of the queue.

        The engine's prefill-failure path: admission popped the state and
        allocated a slot, prefill raised, the slot was freed — the state
        goes back first-in-line so a retried step picks it up again
        (retry-safe admission: no work is lost, none duplicated)."""
        state.status = WAITING
        state.slot = None
        state.admit_step = None
        state.admit_time = None
        state.prefill_end_time = None
        self.waiting.appendleft(state)

    def preempt(self, state: RequestState) -> None:
        """Kick a *running* state back to the head of the queue (the
        engine reclaims its KV pages).  Generated tokens are folded into
        the prompt, so the re-admission prefill recomputes the same KV and
        the next sampled token continues the sequence; ``state.generated``
        keeps the emitted tokens, so ``max_tokens`` still counts the total
        and nothing is emitted twice.  TTFT stamps survive — preemption
        does not reset a request's first token."""
        state.request = dataclasses.replace(
            state.request,
            prompt=tuple(state.request.prompt) + tuple(state.generated))
        if state.slot is not None:
            self.running.pop(state.slot, None)
        state.status = WAITING
        state.slot = None
        state.admit_step = None
        state.admit_time = None
        state.prefill_end_time = None
        self.waiting.appendleft(state)

    def start(self, state: RequestState, slot: int, step: int) -> None:
        state.status = RUNNING
        state.slot = slot
        state.admit_step = step
        self.running[slot] = state

    # ---------------- token accounting / eviction ----------------

    def record_token(self, state: RequestState, token: int,
                     step: int, now: float | None = None) -> bool:
        """Append a generated token; returns True when the request is
        finished (and has been moved out of ``running``)."""
        state.generated.append(int(token))
        if state.first_token_step is None:
            state.first_token_step = step
            state.first_token_time = (time.perf_counter()
                                      if now is None else now)
        reason = None
        if int(token) in state.stop_tokens:
            reason = "stop"
        elif len(state.generated) >= state.request.max_tokens:
            reason = "length"
        if reason is None:
            return False
        self._finish(state, reason, step, now=now)
        return True

    def _finish(self, state: RequestState, reason: str, step: int,
                now: float | None = None) -> None:
        state.status = FINISHED
        state.finish_reason = reason
        state.finish_step = step
        state.finish_time = time.perf_counter() if now is None else now
        if state.slot is not None:
            self.running.pop(state.slot, None)
        self.finished[state.request_id] = state

    def cancel(self, request_id: int, *, step: int = 0
               ) -> RequestState | None:
        """Cancel a waiting *or* running request (same-step eviction).

        Returns the cancelled state (``finish_reason="cancelled"``) so the
        caller can free its KV slot (``state.slot``, set only if it was
        running), or None when the id is unknown or already finished —
        a cancelled request never leaks its slot until ``max_tokens``.
        """
        for state in self.waiting:
            if state.request_id == request_id:
                self.waiting.remove(state)
                self._finish(state, "cancelled", step)
                return state
        for state in list(self.running.values()):
            if state.request_id == request_id:
                self._finish(state, "cancelled", step)
                return state
        return None

    # ---------------- introspection ----------------

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def n_running(self) -> int:
        return len(self.running)
