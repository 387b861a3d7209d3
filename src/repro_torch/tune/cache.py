"""JSON plan cache: repeated ``tune.search`` launches skip the sweep.
Port of ``repro.tune.cache``.

Keyed by a fingerprint of everything that determines the result —
config fields, the canonical mesh/strategy-space JSON, memory budget,
token count, and the cost-model constants — so a stale plan can never
be served for changed inputs.  One file per key under the cache
directory (default ``~/.cache/repro-torch-tune``, override with
``$REPRO_TORCH_TUNE_CACHE`` or the ``cache_dir`` argument).  The
directory and the variable are the port's own, not the JAX package's, so
neither package ever serves the other's entries.

Stored entries carry strategies (``core.strategy`` JSON documents), not
candidate field tuples.  Two version gates apply:

- ``CACHE_VERSION`` — part of the fingerprint AND checked on read: bump
  it whenever the *scoring semantics* change (proxy decomposition,
  chunk cost formula, peak-memory estimator rules), since those are not
  visible in the fingerprinted inputs but invalidate every prediction.
- ``strategy.SCHEMA_VERSION`` — also fingerprinted and checked on read:
  an entry written under a different strategy schema is ignored with a
  logged warning (its stored plan would not deserialize faithfully).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import pathlib
from typing import Any, Optional

from ..core.strategy import SCHEMA_VERSION as STRATEGY_SCHEMA_VERSION

log = logging.getLogger(__name__)

CACHE_VERSION = 3  # v3: entries store Strategy JSON, not Candidate tuples
CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"


def _jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _jsonable(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def fingerprint(**parts: Any) -> str:
    blob = json.dumps({"version": CACHE_VERSION,
                       "strategy_schema": STRATEGY_SCHEMA_VERSION,
                       **_jsonable(parts)},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


class PlanCache:
    def __init__(self, cache_dir: Optional[str] = None) -> None:
        self.dir = pathlib.Path(
            cache_dir
            or os.environ.get(CACHE_ENV)
            or pathlib.Path.home() / ".cache" / "repro-torch-tune")

    def _path(self, key: str) -> pathlib.Path:
        return self.dir / f"{key}.json"

    def get(self, key: str) -> Optional[dict]:
        p = self._path(key)
        if not p.exists():
            return None
        try:
            data = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError):
            return None
        if data.get("cache_version") != CACHE_VERSION:
            return None
        if data.get("strategy_schema") != STRATEGY_SCHEMA_VERSION:
            log.warning(
                "ignoring stale plan-cache entry %s: strategy schema %r "
                "!= current %r (re-searching)", p.name,
                data.get("strategy_schema"), STRATEGY_SCHEMA_VERSION)
            return None
        return data

    def put(self, key: str, value: dict) -> pathlib.Path:
        self.dir.mkdir(parents=True, exist_ok=True)
        p = self._path(key)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps(
            {"cache_version": CACHE_VERSION,
             "strategy_schema": STRATEGY_SCHEMA_VERSION,
             **value}, indent=1, sort_keys=True))
        tmp.replace(p)
        return p

    def clear(self) -> int:
        n = 0
        if self.dir.exists():
            for p in self.dir.glob("*.json"):
                p.unlink()
                n += 1
        return n
