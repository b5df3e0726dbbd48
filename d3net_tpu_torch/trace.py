"""Spans and counters at the port's layer boundaries, on the profiler's clock.

``span(name)`` (a context manager) and ``count(name, n)`` record only while
a ``torch.profiler`` session records: the benchmark's traced unit, a run's
``log.profile_step`` window, ``scripts/profile_ops.py``. The tracer learns
of a session from torch's own start and stop hooks
(``torch.autograd.profiler._run_on_profiler_start``/``_stop``, which every
``torch.profiler.profile`` calls), so threads the profiler does not record
(the loaders' collate workers) follow the session too. Off, a span or a
count is one check and a return.

A span that is on enters ``record_function("d3net.<name>")`` where the
profiler records its thread, so it lies in the Chrome trace beside the
kernels, and is kept in memory: its name, thread, start and end
(``clock_ns``: Unix time, the Chrome trace's ``ts`` plus its
``baseTimeNanoseconds``), the span that was open around it, the id shared
by the spans of one step or one batch (a batch's is ``(epoch, index)``, so
a worker's ``data.collate`` and the main thread's spans of that batch
join), and the counters charged to it. A span opened inside an open span
of the same name on its thread is that span. ``begin(name)`` starts a span
that lies on no thread's stack and ends with ``.end()`` on any thread (a
batch whose rows several loader threads collate); a span opened on
another thread with ``under=`` it is inside it. ``last_window()`` holds the
latest session's spans and counters; a new session clears it.

Counters are charged to the innermost open span of their thread and summed
over the window (``CapStats``). ``host_syncs`` counts every time the host
waits for the card inside a torch call (``.item()``, ``.cpu()``,
``.tolist()``, ``nonzero``, a pageable upload): while a session records on
an initialised card, torch's sync check (``torch.cuda.set_sync_debug_mode``)
warns at each, and the warning is counted with its ``file:line`` and not
shown; the mode and the warning filters come back at the session's end.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

import torch
from torch.autograd import profiler as _profiler

clock_ns = time.time_ns          # the Chrome trace's clock
SYNC_WARNING = "called a synchronizing CUDA operation"
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))


class CapStats:
    """Thread-safe named counters; ``reset`` returns what they held and
    starts ``keys`` (and any key added later) from 0."""

    def __init__(self, keys: Iterable[str] = ()):
        self._keys = tuple(keys)
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> Dict[str, int]:
        with self._lock:
            snap = dict(getattr(self, "_c", {}))
            self._c = dict.fromkeys(self._keys, 0)
        return snap

    def add(self, **kw: int) -> None:
        with self._lock:
            for k, v in kw.items():
                self._c[k] = self._c.get(k, 0) + int(v)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)


class _Null:
    """The span of a tracer that is off: records and stamps nothing."""

    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def drop(self) -> None:
        pass

    def end(self) -> None:
        pass

    def count(self, name: str, n: int = 1) -> None:
        pass


_NULL = _Null()


class Stamp(_Null):
    """A span that stamps its start and end on ``clock_ns`` and records
    nothing (``span(..., timed=True)`` while the tracer is off)."""

    __slots__ = ("id", "t0", "t1")

    def __init__(self, id=None):
        self.id = id
        self.t0 = self.t1 = 0

    def __enter__(self):
        self.t0 = clock_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = clock_ns()
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


class Span(Stamp):
    """A span that is on. After ``last_window()``: ``parent`` is the
    recorded span that was open around it (None at the top of its thread)
    and ``id`` the nearest given one up its parents."""

    __slots__ = ("name", "parent", "tid", "thread", "counts", "traced",
                 "detached", "_up", "_gen", "_rf", "_dropped")

    def __init__(self, name: str, id, up: Optional["Span"]):
        super().__init__(id)
        self.name, self.parent, self.counts = name, None, {}
        self.tid, self.thread = _LOCAL.tid, _LOCAL.thread
        self._up = up
        self._gen, self._rf, self._dropped = _STATE.gen, None, False
        self.traced = self.detached = False

    def __enter__(self):
        _LOCAL.stack.append(self)
        if torch.autograd._profiler_enabled():   # this thread is recorded
            self._rf = _profiler.record_function("d3net." + self.name)
            self._rf.__enter__()
            self.traced = True
        self.t0 = clock_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = clock_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _LOCAL.stack.pop()
        self._keep()
        return False

    def end(self) -> None:
        """End a span of ``begin``, on any thread."""
        self.t1 = clock_ns()
        self._keep()

    def _keep(self) -> None:
        if not self._dropped and self._gen == _STATE.gen:
            _STATE.spans.append(self)

    def count(self, name: str, n: int = 1) -> None:
        """Charge ``n`` to counter ``name`` of this span, from any thread
        (one thread at a time), and to the window's sum."""
        self.counts[name] = self.counts.get(name, 0) + n
        _STATE.totals.add(**{name: n})

    def drop(self) -> None:
        """Keep this span out of the record (a loop's last ask that got
        nothing); the spans inside it are kept, with no parent."""
        self._dropped = True


class _Local(threading.local):
    def __init__(self):
        self.stack: List[Span] = []
        self.tid = threading.get_native_id()
        self.thread = threading.current_thread().name


@dataclass
class Window:
    """One session's record: spans in the order they ended, the counters'
    sums and the ``file:line`` of each host sync."""

    start_ns: int = 0
    spans: List[Span] = field(default_factory=list)
    counts: Dict[str, int] = field(default_factory=dict)
    sync_sites: Dict[str, int] = field(default_factory=dict)

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def under(self, name: str, counter: str) -> List[int]:
        """For each span called ``name``: ``counter`` charged to it and to
        the spans inside it."""
        tops = {id(s): 0 for s in self.named(name)}
        for s in self.spans:
            n = s.counts.get(counter)
            p = s
            while n and p is not None:
                if id(p) in tops:
                    tops[id(p)] += n
                    break
                p = p.parent
        return list(tops.values())


class _State:
    def __init__(self):
        self.on = False
        self.gen = 0
        self.spans: List[Span] = []
        self.totals = CapStats()
        self.sites: Counter = Counter()
        self.lock = threading.Lock()
        self.start_ns = 0
        self.restore = None


_STATE = _State()
_LOCAL = _Local()


def enabled() -> bool:
    return _STATE.on


def span(name: str, id=None, timed: bool = False, under=None):
    """A span of ``name`` (``id``: the step's or batch's, else the nearest
    given one up the open spans). ``timed`` stamps its start and end
    (``.t0``, ``.t1``) while the tracer is off too. ``under``: the span it
    lies inside, where that one is not on this thread's stack (``begin``'s
    span of a batch, around a row on a loader thread)."""
    if not _STATE.on:
        return Stamp(id) if timed else _NULL
    stack = _LOCAL.stack
    up = under if isinstance(under, Span) else (stack[-1] if stack else None)
    if up is not None and up.name == name:
        return Stamp(id) if timed else _NULL
    return Span(name, id, up)


def begin(name: str, id=None):
    """A span of ``name`` started now on no thread's stack, ended by its
    ``.end()`` on any thread; its counters are charged with its
    ``.count()``. The exported trace shows it as an async slice."""
    if not _STATE.on:
        return _NULL
    s = Span(name, id, None)
    s.detached = True
    s.t0 = clock_ns()
    return s


def count(name: str, n: int = 1) -> None:
    """Charge ``n`` to counter ``name``: to this thread's innermost open
    span and to the window's sum."""
    if not _STATE.on:
        return
    stack = _LOCAL.stack
    if stack:
        c = stack[-1].counts
        c[name] = c.get(name, 0) + n
    _STATE.totals.add(**{name: n})


def tag(id) -> None:
    """Give this thread's outermost open span, and so the spans inside it,
    the id ``id`` if it has none (the loader names the batch it hands
    over)."""
    if not _STATE.on:
        return
    stack = _LOCAL.stack
    if stack and stack[0].id is None:
        stack[0].id = id


def last_window() -> Window:
    """The spans and counters of the latest session (the one under way,
    so far)."""
    spans = list(_STATE.spans)
    recorded = {id(s) for s in spans}
    for s in spans:
        s.parent = s._up if id(s._up) in recorded else None
    for s in spans:
        p = s.parent
        while s.id is None and p is not None:
            s.id, p = p.id, p.parent
    with _STATE.lock:
        sites = dict(_STATE.sites)
    return Window(_STATE.start_ns, spans, _STATE.totals.snapshot(), sites)


# ---------------------------------------------------------------------------
# the session hooks and the host syncs
# ---------------------------------------------------------------------------

def _sync_seen(shown):
    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            return shown(message, category, filename, lineno, file, line)
        count("host_syncs")
        for root, prefix in ((_ROOT, ""), (_TORCH, "torch/")):
            if filename.startswith(root + os.sep):
                filename = prefix + os.path.relpath(filename, root)
                break
        site = f"{filename}:{lineno}"
        with _STATE.lock:
            _STATE.sites[site] += 1
    return show


def _begin() -> None:
    _STATE.gen += 1
    _STATE.spans = []
    _STATE.totals.reset()
    with _STATE.lock:
        _STATE.sites = Counter()
    _STATE.start_ns = clock_ns()
    # the first record_function of a process resolves its ops: before the
    # profiler records, so that a span's stamps lie at its trace event's
    with _profiler.record_function("d3net"):
        pass
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        mode = torch.cuda.get_sync_debug_mode()
        filters = warnings.catch_warnings()
        filters.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        # setting the mode warns once that the check is a prototype
        warnings.filterwarnings("ignore", message="Synchronization debug")
        warnings.showwarning = _sync_seen(warnings.showwarning)
        torch.cuda.set_sync_debug_mode("warn")
        _STATE.restore = (mode, filters)
    _STATE.on = True


def _end() -> None:
    _STATE.on = False
    if _STATE.restore is not None:
        mode, filters = _STATE.restore
        _STATE.restore = None
        torch.cuda.set_sync_debug_mode(mode)
        filters.__exit__(None, None, None)


def _install() -> None:
    start = _profiler._run_on_profiler_start
    stop = _profiler._run_on_profiler_stop
    if getattr(start, "d3net_trace", False):
        return

    def on_start():
        start()
        _begin()

    def on_stop():
        _end()
        stop()

    on_start.d3net_trace = True
    _profiler._run_on_profiler_start = on_start
    _profiler._run_on_profiler_stop = on_stop


_install()


# ---------------------------------------------------------------------------
# the exporter
# ---------------------------------------------------------------------------

def export_chrome_trace(prof, path: str) -> None:
    """``prof``'s Chrome trace at ``path``, with the latest window's spans
    of the threads the profiler does not record merged in on the same
    clock, a row for each thread."""
    prof.export_chrome_trace(path)
    extra = [s for s in last_window().spans if not s.traced]
    if not extra:
        return
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = next((e["pid"] for e in events
                if e.get("cat") in ("cpu_op", "user_annotation")),
               os.getpid())
    threads = {s.tid: s.thread for s in extra}
    events.extend({"ph": "M", "name": "thread_name", "pid": pid, "tid": t,
                   "args": {"name": f"{name} (d3net spans)"}}
                  for t, name in threads.items())
    for n, s in enumerate(extra):
        ev = {"cat": "user_annotation", "name": "d3net." + s.name,
              "pid": pid, "tid": s.tid, "ts": (s.t0 - base) / 1e3,
              "args": {"id": repr(s.id), **s.counts}}
        if s.detached:
            # started and ended on other threads: an async slice, which
            # may overlap its thread's own
            events.append({**ev, "ph": "b", "id": n})
            events.append({**ev, "ph": "e", "id": n,
                           "ts": (s.t1 - base) / 1e3, "args": {}})
        else:
            events.append({**ev, "ph": "X", "dur": (s.t1 - s.t0) / 1e3})
    with open(path, "w") as f:
        json.dump(doc, f)
