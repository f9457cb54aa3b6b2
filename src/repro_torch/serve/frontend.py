"""Asyncio serving front-end over the engine router.

The port of ``repro/serve/frontend.py``.  ``AsyncFrontend`` turns the
synchronous ``EngineRouter.submit()/step()`` host loop into a service:
requests arrive on an asyncio queue from any number of concurrent client
coroutines, while ``router.step()`` (host code that launches the kernels
and waits on the card, releasing the GIL there) runs in an executor
thread so the event loop stays responsive between steps.

Executor threads do not inherit the loop's contextvars.  The tracer is
carried across explicitly (a tracer scoped around the front end is
re-activated around each step).  Nothing else is: a
``repro_torch.use(backend=..., blocks_policy=..., quant=...)`` entered
around the front end does not reach ``router.step()``, and neither does
``torch.inference_mode``, which is thread-local.  A replica's tier is
therefore its engine's own arguments (``ContinuousEngine(backend=,
blocks_policy=, quant=, decode_quant=)``), which ``ContinuousEngine.step``
enters itself, with inference mode, on whatever thread runs it.

One background task owns the router.  It alternates between applying
queued commands (submissions, cancellations) and awaiting the next
cluster step in the executor — router state is therefore only ever
touched from one logical thread at a time, with no locking.  Token
callbacks fire inside ``router.step()`` on the executor thread and are
bridged back onto the loop with ``call_soon_threadsafe``, preserving
generation order.

``await frontend.submit(request)`` resolves immediately to a
``RequestHandle``:

    handle = await frontend.submit(Request(prompt=..., max_tokens=8))
    async for token in handle:          # streams as steps complete
        ...
    result = await handle               # RequestResult(status, tokens, ...)

The handle's future resolves with a terminal status for every fate a
routed request can meet: ``"completed"``, ``"cancelled"``
(``handle.cancel()``), ``"timeout"`` (``deadline_s=``), ``"rejected"`` /
``"shed"`` (admission control at a bounded queue), or ``"failed"`` (the
cluster lost its last replica).  Token iteration always terminates:
the terminal status ends the stream.
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import Optional

from repro_torch import obs
from repro_torch.serve import cluster as _cluster
from repro_torch.serve.cluster import EngineRouter
from repro_torch.serve.scheduler import Request

_DONE = object()   # sentinel ending a handle's token stream


@dataclasses.dataclass
class RequestResult:
    """Terminal outcome of one routed request."""
    status: str                    # cluster status: completed/cancelled/...
    tokens: list                   # every token streamed to the client
    finish_reason: Optional[str]   # "stop"/"length", or the status


class RequestHandle:
    """Awaitable, async-iterable handle for one submitted request.

    ``async for token in handle`` yields tokens in generation order as the
    cluster produces them; ``await handle`` resolves to the
    ``RequestResult``.  Both may be used together (iteration first, then
    the await returns instantly) or independently.
    """

    def __init__(self, frontend: "AsyncFrontend"):
        self._frontend = frontend
        self._queue: asyncio.Queue = asyncio.Queue()
        self._result: asyncio.Future = (
            frontend._loop.create_future())
        self.request_id: Optional[int] = None   # ticket id, set on routing

    def __await__(self):
        return asyncio.shield(self._result).__await__()

    async def result(self) -> RequestResult:
        return await asyncio.shield(self._result)

    def done(self) -> bool:
        return self._result.done()

    async def tokens(self):
        while True:
            item = await self._queue.get()
            if item is _DONE:
                return
            yield item

    def __aiter__(self):
        return self.tokens()

    async def cancel(self) -> None:
        """Request cancellation; the result future resolves with status
        ``"cancelled"`` once the router frees the request's slot."""
        await self._frontend._enqueue(("cancel", self))

    # -- called on the event loop (via call_soon_threadsafe) --

    def _push_token(self, token: int) -> None:
        self._queue.put_nowait(token)

    def _finish(self, result: RequestResult) -> None:
        if not self._result.done():
            self._result.set_result(result)
        self._queue.put_nowait(_DONE)


class AsyncFrontend:
    """The async service layer; see the module docstring.

    Use as an async context manager (``async with AsyncFrontend(router)``)
    or call ``start()``/``stop()`` explicitly.  ``stop()`` drains by
    default — the loop keeps stepping until every routed request reaches
    a terminal status; ``stop(drain=False)`` cancels live requests
    instead.  ``frontend.error`` carries the exception if the cluster
    lost its last replica (every pending handle resolves ``"failed"``
    first, so awaiting clients never hang).
    """

    def __init__(self, router: EngineRouter, *, executor=None):
        self.router = router
        self.error: Optional[BaseException] = None
        self._executor = executor
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._inbox: Optional[asyncio.Queue] = None
        self._task: Optional[asyncio.Task] = None
        self._stopping: Optional[str] = None      # None | "drain" | "abort"
        self._handles: dict[int, RequestHandle] = {}

    async def __aenter__(self) -> "AsyncFrontend":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop(drain=exc == (None, None, None))

    async def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("frontend already started")
        self._loop = asyncio.get_running_loop()
        self._inbox = asyncio.Queue()
        self._stopping = None
        self.error = None
        self._task = asyncio.create_task(self._run(), name="serve-frontend")

    async def stop(self, *, drain: bool = True) -> None:
        """Stop the background loop.  ``drain=True`` finishes all live
        requests first; ``drain=False`` cancels them (their handles
        resolve with status ``"cancelled"``)."""
        if self._task is None:
            return
        self._stopping = "drain" if drain else "abort"
        await self._enqueue(("wake",))
        try:
            await self._task
        finally:
            self._task = None

    async def submit(self, request: Request, *, tier: str | None = None,
                     deadline_s: float | None = None) -> RequestHandle:
        """Queue a request for routing; returns its handle immediately.

        Admission control happens on the loop: a rejected or shed request
        resolves its handle with that status rather than raising here.
        """
        if self._task is None:
            raise RuntimeError("frontend is not started")
        handle = RequestHandle(self)
        if self._stopping == "abort" or self._task.done():
            # stop already landed: this submit will never be routed, so
            # resolve its handle terminally instead of leaving the
            # awaiter hanging on a command nobody will drain
            self._resolve_unrouted(handle)
            return handle
        await self._enqueue(("submit", handle, request, tier, deadline_s))
        if self._task.done() and not handle.done():
            # the loop exited between the check and the enqueue: the
            # command is in a dead inbox — resolve the handle here
            self._resolve_unrouted(handle)
        return handle

    @staticmethod
    def _resolve_unrouted(handle: RequestHandle) -> None:
        handle._finish(RequestResult(status=_cluster.CANCELLED, tokens=[],
                                     finish_reason=_cluster.CANCELLED))

    async def _enqueue(self, command: tuple) -> None:
        if self._inbox is None:
            raise RuntimeError("frontend is not started")
        await self._inbox.put(command)

    # ---------------- the background loop ----------------

    async def _run(self) -> None:
        loop = self._loop
        try:
            while True:
                while not self._inbox.empty():
                    self._apply(self._inbox.get_nowait())
                if self._stopping == "abort":
                    return
                if not self.router.has_work():
                    if self._stopping:
                        return
                    # idle: block until a client says something
                    self._apply(await self._inbox.get())
                    continue
                # executor threads don't inherit the loop's contextvars,
                # so a tracer scoped around the frontend (repro_torch.use
                # tracer=...) is re-activated around each step explicitly
                tr = obs.current_tracer()
                if tr is None:
                    await loop.run_in_executor(self._executor,
                                               self.router.step)
                else:
                    await loop.run_in_executor(self._executor,
                                               self._traced_step, tr)
        except Exception as exc:
            # total cluster failure: resolve every pending handle so no
            # client awaits forever, then surface the fault on .error
            self.error = exc
            for tid, handle in list(self._handles.items()):
                ticket = self.router.tickets.get(tid)
                handle._finish(RequestResult(
                    status=(ticket.status if ticket and ticket.done
                            else _cluster.FAILED),
                    tokens=list(ticket.tokens) if ticket else [],
                    finish_reason=(ticket.finish_reason
                                   if ticket and ticket.finish_reason
                                   else _cluster.FAILED)))
                self._handles.pop(tid, None)
        finally:
            # abort path: cancel whatever is still live (resolves handles
            # through the normal on_finish bridge)
            for tid in list(self._handles):
                self.router.cancel(tid)
            # commands still in the inbox were never applied (stop or a
            # cluster fault beat them): resolve their handles terminally
            # so no submitter awaits a dead loop
            while self._inbox is not None and not self._inbox.empty():
                command = self._inbox.get_nowait()
                if command[0] == "submit":
                    self._resolve_unrouted(command[1])

    def _traced_step(self, tracer) -> None:
        with obs.activate(tracer):
            self.router.step()

    def _apply(self, command: tuple) -> None:
        op = command[0]
        if op == "submit":
            _, handle, request, tier, deadline_s = command

            def on_token(tid, token, finished, handle=handle):
                self._loop.call_soon_threadsafe(handle._push_token, token)

            def on_finish(ticket, handle=handle):
                self._handles.pop(ticket.ticket_id, None)
                self._loop.call_soon_threadsafe(
                    handle._finish,
                    RequestResult(status=ticket.status,
                                  tokens=list(ticket.tokens),
                                  finish_reason=ticket.finish_reason))

            try:
                tid = self.router.submit(request, tier=tier,
                                         deadline_s=deadline_s,
                                         on_token=on_token,
                                         on_finish=on_finish)
            except ValueError as exc:
                # invalid request (e.g. prompt + max_tokens exceeds the
                # pool): resolve this handle, don't kill the service loop
                handle._finish(RequestResult(
                    status=_cluster.FAILED, tokens=[],
                    finish_reason=f"invalid request: {exc}"))
                return
            handle.request_id = tid
            if not self.router.tickets[tid].done:   # rejected => resolved
                self._handles[tid] = handle
        elif op == "cancel":
            handle = command[1]
            if handle.request_id is not None:
                self.router.cancel(handle.request_id)
        # "wake" carries no action: it just unblocks the idle await
