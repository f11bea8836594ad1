"""Spans: the port's own record of where its host time goes.

``with span("forward"): ...`` (or ``@spanned("cache")`` on a function)
times a piece of the program on the host with ``time.perf_counter_ns``.
Each thread keeps its own stack of open spans, so a span has a parent
(the innermost span open on its thread when it opened) and a self time
(its length less that of the children it held on its thread).

**Totals, always on.**  Every span adds its count, seconds and self
seconds to a table keyed by its name, one table a thread, summed by
:func:`totals`.  That costs 0.77-0.84 us a span on the host of an H100
machine (an empty ``with`` 0.20 us there), under 0.1 % of a training
step, and adds no device operation and no autograd node.

**Tracing, while a torch.profiler session records or inside**
:func:`recording`.  Then each span is also kept raw (name, parent,
thread id, start, end; :func:`session`), and while the profiler records
it opens a ``torch.profiler.record_function`` of its name, so the
program's spans lie in the profiler's Chrome trace as ``user_annotation``
events on the device trace's own clock.  A session starts at
:func:`recording`'s start, or at the first span traced after an untraced
span or after :func:`recording`'s end (two profiler sessions with no span
between them are one); its raw spans are kept until the next session
starts.  While tracing, :func:`backward_span` puts an identity autograd
node at the root of a loss: the engine runs it first, and it opens the
``backward`` span on the engine's thread (the card's autograd thread on
CUDA), which closes once the engine has run every node, every
parameter's gradient included (a final callback of the engine).
Where the engine raises, that callback never runs: the span stays open
in the session, and the thread drops its frame at its next traced span
outside the engine (:meth:`Recorder.open`).  Untraced, the loss is
returned as it is.

The program's spans (tools/idle_by_span.py lays device idle against
them; README "Profiling"): ``forward`` (``TIP.loss``, ``DDModel.loss``,
``DecagonModel.loss``) holding ``encode`` (``pp_gcn``, ``hierarchy``,
``rgcn``; Decagon's ``rel_conv``, once a layer, around the D-D relation
convolution; CompGCN's ``kg_conv`` around its layer, holding ``rel_scaled``
around each kernel B16 call) and ``loss`` (Decagon's ``dedicom_bce``
inside it);
``backward`` holding each custom autograd op's backward under the op's
name (``dense_bce_sym``, ``dense_bce``, ``dense_bce_nn``,
``typed_neighbor_sum``, ``gcn_spmm``, ``distmult_logits``, ``nn_logits``,
``distmult_v1``, ``nn_v1``, ``ring_spmm``, ``pp_aggregate``,
``rel_aggregate``, ``dedicom_bce``, ``rgcn_contract``, ``rel_scaled``)
and, under remat, the
recomputed ``encode``; ``eval`` holding ``encode``, ``score`` and
``rank``; set-up's ``cache`` (``cached_trigraph``), ``device_graph``
(``make_graph_arrays``, ``make_dd_graph_arrays``) and ``kernel_load``
(``kernels.load`` loading or building a kernel's library).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

_clock = time.perf_counter_ns
# the autograd node this thread runs now, or None outside the engine's work
_node = getattr(torch._C, "_current_autograd_node", lambda: None)

# a traced span's record: [name, start ns, end ns, its record_function
# (False without a profiler), parent record or None, thread id, opened by
# Recorder.open inside an autograd node]
_NAME, _START, _END, _RF, _PARENT, _TID, _HAND = range(7)


class _Thread:
    """One thread's spans.  ``top`` is the innermost open frame, a tuple
    (the frame below it, ``done`` at its open, its record or None
    untraced, start ns); ``done`` is the self ns of every span closed on
    the thread so far, so the children a span held took ``done`` at its
    close less ``done`` at its open; ``totals`` {name: [count, ns, self
    ns]}; ``hand``, the spans :meth:`Recorder.open` opened inside an
    autograd node that are still open."""

    __slots__ = ("top", "done", "totals", "tid", "hand")

    def __init__(self):
        self.top, self.done, self.hand = None, 0, 0
        self.totals: dict = {}
        self.tid = threading.get_native_id()


def _account(st: _Thread, totals: dict, name: str, done: int, start: int,
             end: int) -> None:
    """Add a span closed at ``end`` to ``totals`` and ``st.done``."""
    dur = end - start
    own = dur - st.done + done
    st.done += own
    row = totals.get(name)
    if row is None:
        row = totals[name] = [0, 0, 0]
    row[0] += 1
    row[1] += dur
    row[2] += own


class _Span:
    """A reusable context manager for one name (its state is on the
    thread's frames, so it nests and runs on any thread).  Untraced, it
    reads two flags, pushes a frame and adds to the totals."""

    __slots__ = ("rec", "tls", "name")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.tls, self.name = rec, rec._tls, name

    def __enter__(self):
        try:
            st = self.tls.st
        except AttributeError:
            st = self.rec._thread()
        if _profiler._is_profiler_enabled or self.rec._live:
            self.rec._enter_slow(self.name, st)
        else:
            st.top = (st.top, st.done, None, _clock())

    def __exit__(self, exc_type, exc, tb):
        # _account inlined: every span, traced or not, pays this path
        end = _clock()
        st = self.tls.st
        st.top, done, record, start = st.top
        dur = end - start
        own = dur - st.done + done
        st.done += own
        row = st.totals.get(self.name)
        if row is None:
            row = st.totals[self.name] = [0, 0, 0]
        row[0] += 1
        row[1] += dur
        row[2] += own
        if record is not None:
            _end_traced(st, record, end)


def _end_traced(st: _Thread, record: list, end: int) -> None:
    record[_END] = end
    if record[_HAND]:
        st.hand -= 1
    if record[_RF]:
        record[_RF].__exit__(None, None, None)


class Recorder:
    """Span frames, totals and the last traced session (the module's
    functions use one process-wide :data:`RECORDER`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._tables: list = []  # every thread's totals
        self._spans: dict = {}
        self._recording = 0
        # whether the session goes on: set by a traced span, cleared by
        # the first untraced one (and by recording()'s end)
        self._live = False
        self._session: list = []

    def _thread(self) -> _Thread:
        """This thread's frames and totals, made at its first span."""
        st = _Thread()
        with self._lock:
            self._tables.append(st.totals)
        self._tls.st = st
        return st

    def tracing(self) -> bool:
        """Whether spans are traced now: inside :meth:`recording` or while
        a torch.profiler session records (on any thread)."""
        return bool(self._recording or _profiler._is_profiler_enabled)

    def span(self, name: str) -> _Span:
        s = self._spans.get(name)
        if s is None:
            s = self._spans.setdefault(name, _Span(self, name))
        return s

    def spanned(self, name: str):
        """Decorator: the function's calls as spans named ``name``."""
        s = self.span(name)

        def wrap(fn):
            @functools.wraps(fn)
            def call(*args, **kwargs):
                with s:
                    return fn(*args, **kwargs)
            return call
        return wrap

    def _enter_slow(self, name: str, st: _Thread) -> None:
        """Open a span while tracing, or the first untraced one after a
        session (which ends it)."""
        if not self.tracing():
            self._live = False
            st.top = (st.top, st.done, None, _clock())
            return
        if st.hand and _node() is None:
            self._drop_stale(st)
        if not self._live:
            self._live = True
            self._session = []
        # the record_function only where a profiler records it: False
        # marks a span traced without one (recording())
        rf = (_profiler.record_function(name)
              if _profiler._is_profiler_enabled else False)
        record = [name, 0, None, rf, None if st.top is None else st.top[2],
                  st.tid, False]
        self._session.append(record)
        if rf:
            rf.__enter__()
        record[_START] = start = _clock()
        st.top = (st.top, st.done, record, start)

    @staticmethod
    def _drop_stale(st: _Thread) -> None:
        """Take the thread's stale frames (:meth:`open`) off it, with
        every frame above them."""
        f, keep = st.top, st.top
        while f is not None:
            if f[2] is not None and f[2][_HAND]:
                keep = f[0]
            f = f[0]
        st.top, st.hand = keep, 0

    def open(self, name: str) -> tuple:
        """Open a span that :meth:`close` ends, on any thread.  One opened
        inside an autograd node (``backward``) is stale once this thread
        opens a traced span outside the engine's work, or opens another
        such span: the engine raised before the final callback closing it
        ran.  Stale, it leaves the thread's frames with every frame above
        it, and stays open in the session."""
        try:
            st = self._tls.st
        except AttributeError:
            st = self._thread()
        if st.hand:
            self._drop_stale(st)
        self.span(name).__enter__()
        if st.top[2] is not None and _node() is not None:
            st.top[2][_HAND] = True
            st.hand += 1
        return st.top, st, name

    def close(self, handle: tuple) -> None:
        """End a span :meth:`open` began, on any thread (its totals go to
        the closing thread's table); spans it left open go with it."""
        end = _clock()
        frame, st, name = handle
        f = st.top
        while f is not None and f is not frame:
            f = f[0]
        if f is None:  # dropped as stale
            return
        st.top, done, record, start = frame
        try:
            totals = self._tls.st.totals
        except AttributeError:
            totals = self._thread().totals
        _account(st, totals, name, done, start, end)
        if record is not None:
            _end_traced(st, record, end)

    def backward_span(self, loss: torch.Tensor) -> torch.Tensor:
        """``loss`` with the identity node that opens ``backward``, while
        tracing; ``loss`` itself otherwise."""
        if not loss.requires_grad or not self.tracing():
            return loss
        return _BackwardMark.apply(loss, self)

    @contextlib.contextmanager
    def recording(self):
        """Trace without the profiler: a new session starts here, and ends
        here unless a profiler session goes on."""
        with self._lock:
            self._recording += 1
            self._live = True
            self._session = []
        try:
            yield self
        finally:
            with self._lock:
                self._recording -= 1
                if not self.tracing():
                    self._live = False

    def totals(self, since: dict | None = None) -> dict:
        """{name: {"count", "s", "self_s"}} summed over the threads; less
        an earlier result ``since`` where given."""
        with self._lock:
            tables = list(self._tables)
        acc: dict = {}
        for table in tables:
            for name, (n, ns, self_ns) in list(table.items()):
                a = acc.setdefault(name, [0, 0, 0])
                a[0] += n
                a[1] += ns
                a[2] += self_ns
        out = {}
        for name, (n, ns, self_ns) in acc.items():
            was = (since or {}).get(name, {"count": 0, "s": 0.0,
                                           "self_s": 0.0})
            if n > was["count"]:
                out[name] = {"count": n - was["count"],
                             "s": ns / 1e9 - was["s"],
                             "self_s": self_ns / 1e9 - was["self_s"]}
        return out

    def session(self) -> list:
        """The last traced session's spans in the order they opened:
        {"name", "parent" (index in this list, or None), "tid",
        "start_ns", "end_ns" (None while open)}."""
        records = list(self._session)
        index = {id(r): i for i, r in enumerate(records)}
        return [{"name": r[_NAME],
                 "parent": (None if r[_PARENT] is None
                            else index.get(id(r[_PARENT]))),
                 "tid": r[_TID], "start_ns": r[_START], "end_ns": r[_END]}
                for r in records]


class _BackwardMark(torch.autograd.Function):
    """Identity; its backward, the engine's first node, opens
    ``backward`` and queues its close for the end of the engine's run."""

    @staticmethod
    def forward(ctx, loss, rec):
        ctx.rec = rec
        return loss.view_as(loss)

    @staticmethod
    def backward(ctx, g):
        frame = ctx.rec.open("backward")
        torch.autograd.Variable._execution_engine.queue_callback(
            functools.partial(ctx.rec.close, frame))
        return g, None


RECORDER = Recorder()
span = RECORDER.span
spanned = RECORDER.spanned
backward_span = RECORDER.backward_span
recording = RECORDER.recording
tracing = RECORDER.tracing
totals = RECORDER.totals
session = RECORDER.session
