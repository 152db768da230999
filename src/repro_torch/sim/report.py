"""``MetricsStream``: one JSON object per line, streamed as a run
progresses (reference ``repro.sim.report.MetricsStream``, without its
``append`` and ``header`` options, whose callers — resumed simulator runs
and run archives — are not ported).  The reference's ``SimReport`` and
``build_report`` are not ported yet.
"""
from __future__ import annotations

import json
import sys
from typing import IO, Optional


class MetricsStream:
    """Append one JSON object per line to a file or stdout, flushing each
    line so consumers see metrics live.

    ``close`` only closes handles this stream opened — never stdout, even
    if ``sys.stdout`` was rebound between open and close — and the stream
    is a context manager."""

    def __init__(self, path: str = "-"):
        self.path = path
        self._fh: Optional[IO] = None
        self._owns = False          # True iff we opened (and must close) it

    def _handle(self) -> IO:
        if self._fh is None:
            if self.path in ("-", ""):
                self._fh = sys.stdout
                self._owns = False
            else:
                import os
                d = os.path.dirname(os.path.abspath(self.path))
                os.makedirs(d, exist_ok=True)
                self._fh = open(self.path, "w")
                self._owns = True
        return self._fh

    def emit(self, record: dict) -> None:
        fh = self._handle()
        fh.write(json.dumps(record) + "\n")
        fh.flush()

    def close(self) -> None:
        if self._fh is not None and self._owns:
            self._fh.close()
        self._fh = None
        self._owns = False

    def __enter__(self) -> "MetricsStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
