"""Per-round JSONL metrics, with the JAX package's record contract.

Every record carries a ``schema`` version plus either ``round``
(per-round metrics) or ``event`` (provenance, summaries); ``log``
rejects records with neither, so tools that read the JAX package's
logs read the port's too. The JSONL handle is opened once
(line-buffered) and held until ``close()``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

# bump when a record's meaning changes incompatibly
SCHEMA_VERSION = 1


class MetricsLogger:
    def __init__(self, out_dir: Optional[str], run_name: str,
                 echo: bool = True):
        self.echo = echo
        self.path = None
        self._fh = None
        self._truncate = False
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self.path = os.path.join(out_dir, f"{run_name}.metrics.jsonl")
            # truncation is deferred to the first write: evaluate builds
            # a logger too and must not wipe the fit log
            self._truncate = True
        self.history = []

    def _handle(self):
        if self._fh is None:
            mode = "w" if self._truncate else "a"
            self._truncate = False
            self._fh = open(self.path, mode, buffering=1)
        return self._fh

    def log(self, record: Dict[str, Any]):
        if "event" not in record and "round" not in record:
            raise ValueError(
                f"metrics record must carry 'event' or 'round' "
                f"(SCHEMA_VERSION={SCHEMA_VERSION} contract): "
                f"{sorted(record)}"
            )
        record = dict(record, time=time.time(), schema=SCHEMA_VERSION)
        self.history.append(record)
        if self.path:
            self._handle().write(json.dumps(record) + "\n")
        if self.echo:
            shown = {k: v for k, v in record.items()
                     if k not in ("time", "schema")}
            print(json.dumps(shown), flush=True)

    def close(self):
        fh, self._fh = self._fh, None
        if fh is not None:
            fh.close()
