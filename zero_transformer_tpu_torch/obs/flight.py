"""Flight recorder: a bounded ring of recent step summaries and events,
dumped to the run directory when something goes wrong.

Counterpart of ``zero_transformer_tpu/obs/flight.py`` (a copy: that module
imports no JAX). The metrics timeline holds only the log points; the
recorder keeps the last ``capacity`` summaries and events in memory (a
small dict each, no IO) and writes the window, spans included, when the
trainer escalates: an anomaly halt, a watchdog abort, a quarantined
checkpoint.

Dumps are best-effort: a full disk or a read-only run directory gives a
logged warning, never an error in the loop the recorder exists to explain.
"""
from __future__ import annotations

import json
import logging
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional

log = logging.getLogger("zero_transformer_tpu_torch")


class FlightRecorder:
    """Ring of tick summaries + events with crash-dump serialization.

    ``directory=None`` keeps recording (tests and facades can read the ring)
    but turns ``dump()`` into a counted no-op — dumping needs a run dir.
    """

    def __init__(
        self,
        directory: Optional[str] = None,
        capacity: int = 256,
        tracer=None,
        clock=time.monotonic,
        span_tail: int = 2000,
        max_dumps: int = 64,
    ):
        self.directory = str(directory) if directory else None
        self.tracer = tracer
        self.clock = clock
        self.span_tail = span_tail
        # dump-directory rotation: breaker flaps / repeated ejections / SLO
        # burns each write a dump, and a long-lived replica must not grow
        # flightrec/ without bound — past max_dumps the OLDEST dump this
        # recorder wrote is deleted (the newest always survives)
        self.max_dumps = max(1, int(max_dumps))
        self._ticks: deque = deque(maxlen=capacity)
        self._events: deque = deque(maxlen=capacity)
        self._n_dumps = 0
        self.dumps: List[str] = []  # paths written, oldest first

    # ------------------------------------------------------------- recording

    def tick(self, summary: Dict[str, Any]) -> None:
        """One scheduler-tick / train-step summary (small dict; the caller
        owns the keys — ``tick``/``step`` index at minimum)."""
        self._ticks.append((self.clock(), summary))

    def event(self, name: str, **fields: Any) -> None:
        self._events.append((self.clock(), name, fields))

    # --------------------------------------------------------------- reading

    def ticks(self) -> List[tuple]:
        return list(self._ticks)

    def events(self) -> List[tuple]:
        return list(self._events)

    # ---------------------------------------------------------------- dumps

    def dump(self, reason: str, extra: Optional[Dict[str, Any]] = None
             ) -> Optional[str]:
        """Serialize the ring (ticks, events, span tail) to
        ``<directory>/flightrec/<NNN>_<reason>.json``. Returns the path, or
        None when no directory is configured or the write failed."""
        self._n_dumps += 1
        if self.directory is None:
            return None
        doc = {
            "reason": reason,
            "written_at_unix": time.time(),
            "clock_now": self.clock(),
            "extra": extra or {},
            # snapshots: a migration's failure dumps from the shipper's
            # thread while the tick thread appends
            "ticks": [
                {"t": t, **summary} for t, summary in self.ticks()
            ],
            "events": [
                {"t": t, "event": name, **fields}
                for t, name, fields in self.events()
            ],
        }
        if self.tracer is not None:
            doc["spans"] = [
                {"track": s[1], "name": s[2], "t0": s[3], "t1": s[4],
                 "attrs": s[5]}
                for s in self.tracer.spans()[-self.span_tail:]
            ]
            doc["spans_dropped"] = self.tracer.dropped
        try:
            out_dir = Path(self.directory) / "flightrec"
            out_dir.mkdir(parents=True, exist_ok=True)
            safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)
            path = out_dir / f"{self._n_dumps:03d}_{safe}.json"
            path.write_text(json.dumps(doc, default=str, indent=1) + "\n")
        except Exception:
            log.exception("flight recorder: dump for %r failed (continuing)", reason)
            return None
        self.dumps.append(str(path))
        while len(self.dumps) > self.max_dumps:
            oldest = self.dumps.pop(0)
            try:
                Path(oldest).unlink()
            except OSError:
                pass  # already gone / permissions: rotation is best-effort
        log.warning("flight recorder: dumped %d ticks / %d events to %s "
                    "(reason: %s)", len(doc["ticks"]), len(doc["events"]),
                    path, reason)
        return str(path)
