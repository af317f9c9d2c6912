"""Host-side span tracer — the timeline half of the observation law (the
port's copy of ``repro.obs.trace``, the same events and export).

The drive entry points (``RafiContext.run_until_done``,
``tune.autotune_forward``) record typed, wall-clock-stamped events into the
installed :class:`Tracer`: burst boundaries, autotune re-plans with
old→new capacities.  The tracer is host code and nothing else: it reads
only values the drive already returns, so tracing adds no collective and
no kernel launch.

Two ways to turn it on:

* explicitly — ``with trace.capture() as tr: ...; tr.save(path)``;
* ambiently — set ``RAFI_TRACE=1`` (record only) or ``RAFI_TRACE=/path.json``
  (record + flush the Perfetto JSON there at process exit).  The env tracer
  is installed lazily on the first ``enabled()`` check.

Export is Chrome/Perfetto ``trace_event`` JSON: spans are complete ``"X"``
events, instants ``"i"``; one process track per rank and one thread track
per tier (host-only spans on rank 0, tier 0).

This module imports nothing from the rest of the package.
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import json
import os
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "Tracer",
    "Span",
    "capture",
    "current",
    "enabled",
    "event",
    "install",
    "span",
    "to_perfetto",
    "uninstall",
]

ENV_VAR = "RAFI_TRACE"

# Event-type vocabulary (the ``cat`` field) — one name per law so the
# analyzer and the Perfetto UI can filter per subsystem.
CAT_DRIVE = "drive"          # run_until_done bursts, segment boundaries
CAT_RECOVERY = "recovery"    # checkpoint saves, resumes, preemptions
CAT_TUNE = "tune"            # autotune re-plans
CAT_HEALTH = "health"        # health-mask transitions
CAT_CHAOS = "chaos"          # scenario runs, fault injections
CAT_ROUTE = "route"          # rebalance / cycling trace-time records
CAT_PHASE = "phase"          # device per-phase timings


def _now_us() -> float:
    return time.perf_counter() * 1e6


class Span:
    """An open span — ``set(**attrs)`` attaches results before it closes."""

    __slots__ = ("name", "cat", "t0", "args", "rank", "tier", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 rank: int, tier: int, args: Dict[str, Any]):
        self._tracer = tracer
        self.name, self.cat = name, cat
        self.rank, self.tier = rank, tier
        self.args = dict(args)
        self.t0 = _now_us()

    def set(self, **attrs: Any) -> "Span":
        self.args.update(attrs)
        return self

    def close(self) -> None:
        self._tracer._record(
            name=self.name, cat=self.cat, ph="X", ts=self.t0,
            dur=_now_us() - self.t0, rank=self.rank, tier=self.tier,
            args=self.args,
        )


class Tracer:
    """Bounded in-memory event recorder (oldest events evicted past
    ``max_events`` so an ambient tracer can ride a long benchmark run)."""

    def __init__(self, max_events: int = 65536):
        self.events: collections.deque = collections.deque(maxlen=max_events)
        self.t_start = _now_us()

    # -- recording -------------------------------------------------------
    def _record(self, **ev: Any) -> None:
        self.events.append(ev)

    def event(self, name: str, cat: str = CAT_DRIVE, *,
              rank: int = 0, tier: int = 0, **args: Any) -> None:
        """One instant event (``ph="i"``)."""
        self._record(name=name, cat=cat, ph="i", ts=_now_us(), dur=0.0,
                     rank=rank, tier=tier, args=args)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = CAT_DRIVE, *,
             rank: int = 0, tier: int = 0, **args: Any):
        """Timed span; yields the open :class:`Span` for ``.set(...)``."""
        sp = Span(self, name, cat, rank, tier, args)
        try:
            yield sp
        finally:
            sp.close()

    def phase_event(self, name: str, *, ts_us: float, dur_us: float,
                    rank: int = 0, tier: int = 0, **args: Any) -> None:
        """A device phase timing placed explicitly on the (rank, tier)
        track, where a device phase timer merges its timeline in."""
        self._record(name=name, cat=CAT_PHASE, ph="X", ts=ts_us, dur=dur_us,
                     rank=rank, tier=tier, args=args)

    # -- views -----------------------------------------------------------
    def select(self, cat: Optional[str] = None,
               name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [
            e for e in self.events
            if (cat is None or e["cat"] == cat)
            and (name is None or e["name"] == name)
        ]

    def to_perfetto(self) -> Dict[str, Any]:
        return to_perfetto(list(self.events), t0=self.t_start)

    def save(self, path: str) -> str:
        """Write the Perfetto ``trace_event`` JSON; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_perfetto(), f)
        return path


def to_perfetto(events: List[Dict[str, Any]], *, t0: float = 0.0) -> Dict[str, Any]:
    """Events → Chrome/Perfetto ``trace_event`` JSON.  Track layout: one
    process per rank (``pid = rank``), one thread per tier (``tid = tier``);
    metadata events name each so the UI shows ``rank N`` / ``tier L``."""
    out: List[Dict[str, Any]] = []
    tracks = set()
    for e in events:
        tracks.add((int(e.get("rank", 0)), int(e.get("tier", 0))))
        rec = {
            "name": e["name"],
            "cat": e["cat"],
            "ph": e["ph"],
            "ts": round(float(e["ts"]) - t0, 3),
            "pid": int(e.get("rank", 0)),
            "tid": int(e.get("tier", 0)),
            "args": {k: _jsonable(v) for k, v in (e.get("args") or {}).items()},
        }
        if e["ph"] == "X":
            rec["dur"] = round(float(e.get("dur", 0.0)), 3)
        if e["ph"] == "i":
            rec["s"] = "t"  # thread-scoped instant
        out.append(rec)
    for rank, tier in sorted(tracks):
        out.append({"name": "process_name", "ph": "M", "pid": rank, "tid": 0,
                    "args": {"name": f"rank {rank}"}})
        out.append({"name": "thread_name", "ph": "M", "pid": rank, "tid": tier,
                    "args": {"name": f"tier {tier}"}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def _jsonable(v: Any) -> Any:
    """Host attrs may arrive as numpy/jax scalars or small arrays."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    try:
        import numpy as np

        a = np.asarray(v)
        if a.ndim == 0:
            return a.item()
        return a.tolist()
    except Exception:  # noqa: BLE001 — attrs are best-effort labels
        return str(v)


# -------------------------------------------------- installation plumbing
_CURRENT: Optional[Tracer] = None
_ENV_CHECKED = False


def install(tracer: Optional[Tracer] = None) -> Tracer:
    """Make ``tracer`` (a fresh one if ``None``) the ambient tracer."""
    global _CURRENT
    _CURRENT = tracer if tracer is not None else Tracer()
    return _CURRENT


def uninstall() -> None:
    global _CURRENT
    _CURRENT = None


def _check_env() -> None:
    """Lazily honour ``RAFI_TRACE``: any non-empty value installs an ambient
    tracer; a path-looking value ("/" or .json) also flushes there at exit."""
    global _ENV_CHECKED
    if _ENV_CHECKED:
        return
    _ENV_CHECKED = True
    val = os.environ.get(ENV_VAR, "")
    if not val or val == "0":
        return
    tr = install()
    if "/" in val or val.endswith(".json"):
        atexit.register(lambda: tr.save(val))


def current() -> Optional[Tracer]:
    """The ambient tracer, or ``None`` (env toggle consulted lazily)."""
    if _CURRENT is None:
        _check_env()
    return _CURRENT


def enabled() -> bool:
    return current() is not None


@contextlib.contextmanager
def capture(max_events: int = 65536):
    """Install a fresh tracer for the block; restore the previous after."""
    prev = _CURRENT
    tr = install(Tracer(max_events))
    try:
        yield tr
    finally:
        install(prev) if prev is not None else uninstall()


# No-op-when-disabled conveniences — what the drive entry points call.
def event(name: str, cat: str = CAT_DRIVE, **kw: Any) -> None:
    tr = current()
    if tr is not None:
        tr.event(name, cat, **kw)


@contextlib.contextmanager
def span(name: str, cat: str = CAT_DRIVE, **kw: Any):
    """Span on the ambient tracer; yields the :class:`Span` or a no-op
    stand-in when tracing is off (callers ``sp.set(...)`` unconditionally)."""
    tr = current()
    if tr is None:
        yield _NOOP_SPAN
        return
    with tr.span(name, cat, **kw) as sp:
        yield sp


class _NoopSpan:
    __slots__ = ()

    def set(self, **_attrs: Any) -> "_NoopSpan":
        return self


_NOOP_SPAN = _NoopSpan()
