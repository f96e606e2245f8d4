"""Write-ahead request journal of the serving router.

Counterpart of paddle_tpu/serving/journal.py, line for line in its
format: a journal either package writes replays in the other to the same
state.

  RouterJournal    an append-only JSONL journal under ServingRouter. Every
                   record that matters to at-most-once delivery is
                   appended before the tier forgets it can regenerate it:
                   registry records at submit, delivery-cursor advances
                   (the tokens the client has seen), finishes, ownership
                   changes (restore backfill, redistribution, handoff
                   migration) and each replica's periodic engine snapshot.
  replay(path)     rebuilds the registry and snapshot state, tolerating a
                   torn tail (the router died mid-append): each line
                   carries its own CRC-32, and replay stops at the first
                   short or corrupt line.
  compaction       every `compact_every` appends the journal rewrites
                   itself as ONE "state" record plus a fresh tail (tmp
                   file and an atomic os.replace), so the file stays
                   bounded by live state, not by run length.

Durability (`fsync`): "always" fsyncs every append, "interval" (default)
at most once per `fsync_interval_s` (a bounded loss window: engines are
deterministic and the cursor dedupes, so a lost suffix only means
recovery regenerates those tokens), "never" leaves flushing to the OS.
`ServingRouter.recover(runner_factory, journal_path)` replays the journal
and rebuilds the tier from it.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)

FSYNC_POLICIES = ("always", "interval", "never")


def _empty_state() -> dict:
    return {"reqs": {}, "snaps": {}, "store": None, "store_idx": None}


def _apply(state: dict, rec: dict) -> None:
    """Fold one journal record into the replayed state. Unknown record
    types and unknown request ids are skipped (forward compatibility +
    records whose submit line fell past a torn tail)."""
    t = rec.get("t")
    if t == "state":
        state["reqs"] = dict(rec.get("reqs", {}))
        state["snaps"] = {int(k): v
                          for k, v in rec.get("snaps", {}).items()}
        state["store"] = rec.get("store")
        state["store_idx"] = rec.get("store_idx")
    elif t == "sub":
        state["reqs"][rec["rid"]] = {
            "prompt": list(rec["prompt"]),
            "sampling": dict(rec["sampling"]),
            "tokens": [],
            "done": False,
            "reason": None,
            "ai": rec.get("ai"),
            "owner": rec.get("rep"),
        }
    elif t == "tok":
        # one record carries a whole step's cursor advances
        # ({rid: [tokens...]}) so the journal pays one line per STEP,
        # not one per token. Tokens extend the stream regardless of
        # the done flag: the writer orders tok-before-fin (done-ness
        # must never become durable before the tokens it claims), but
        # replay stays order-insensitive as defense in depth.
        for rid, toks in rec["d"].items():
            r = state["reqs"].get(rid)
            if r is not None:
                r["tokens"].extend(int(x) for x in toks)
    elif t == "fin":
        r = state["reqs"].get(rec["rid"])
        if r is not None and not r["done"]:
            r["done"], r["reason"] = True, rec["reason"]
    elif t == "own":
        r = state["reqs"].get(rec["rid"])
        if r is not None:
            r["owner"] = rec.get("rep")
    elif t == "snap":
        state["snaps"][int(rec["rep"])] = rec["snapshot"]
    elif t == "store":
        # the host-wide store's segment map: recover() reattaches (or
        # unlinks) the segments it names
        state["store"] = rec.get("spec")
    elif t == "store_idx":
        state["store_idx"] = rec.get("state")


class RouterJournal:
    """Append-only, CRC-per-line JSONL journal with periodic snapshot
    compaction. Thread-safe: the router appends from its submit path,
    delivery path (under the router lock) and worker threads (snapshot
    records, under replica locks)."""

    def __init__(self, path: str, *, fsync: str = "interval",
                 fsync_interval_s: float = 0.1,
                 compact_every: int = 512,
                 resume_state: Optional[dict] = None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync={fsync!r}; expected one of "
                             f"{FSYNC_POLICIES}")
        self.path = path
        self.fsync = fsync
        self.fsync_interval_s = float(fsync_interval_s)
        self.compact_every = max(1, int(compact_every))
        self._lock = threading.Lock()
        self._state = resume_state if resume_state is not None \
            else _empty_state()
        self._since_compact = 0
        self._last_fsync = 0.0
        self.records_appended = 0
        self.compactions = 0
        self.fsyncs = 0
        if resume_state is not None:
            # recovery re-opens an existing journal: rewrite it as one
            # compacted state record so a second crash replays the
            # recovered view, not the dead router's full history
            self._f = None
            self._compact_locked()
        else:
            self._f = open(path, "w")

    # ------------------------------------------------------------ write

    @staticmethod
    def _line(rec: dict) -> str:
        body = json.dumps(rec, separators=(",", ":"))
        crc = zlib.crc32(body.encode()) & 0xFFFFFFFF
        return f"{crc:08x} {body}\n"

    def append(self, rec: dict) -> None:
        with self._lock:
            if self._f is None:          # pragma: no cover — closed
                return
            _apply(self._state, rec)
            self._f.write(self._line(rec))
            self._f.flush()
            self.records_appended += 1
            self._since_compact += 1
            if self.fsync == "always":
                os.fsync(self._f.fileno())
                self.fsyncs += 1
            elif self.fsync == "interval":
                now = time.monotonic()
                if now - self._last_fsync >= self.fsync_interval_s:
                    os.fsync(self._f.fileno())
                    self.fsyncs += 1
                    self._last_fsync = now
            if self._since_compact >= self.compact_every:
                self._compact_locked()

    def _compact_locked(self) -> None:
        """Rewrite the journal as ONE state record (tmp + atomic
        rename), dropping the replayable history it summarizes."""
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self._line({"t": "state", **self._state}))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        if self._f is not None:
            self._f.close()
        self._f = open(self.path, "a")
        self._since_compact = 0
        self.compactions += 1

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()
                try:
                    os.fsync(self._f.fileno())
                except OSError:          # pragma: no cover
                    pass
                self._f.close()
                self._f = None

    # ------------------------------------------------------------- read

    @staticmethod
    def replay(path: str) -> Tuple[dict, int]:
        """Rebuild (state, discarded_lines) from a journal file. Replay
        STOPS at the first torn or corrupt line — a router killed mid-
        append leaves a short tail, and anything after a corrupt line
        cannot be trusted; everything before it is intact by CRC."""
        state = _empty_state()
        discarded = 0
        with open(path, "r") as f:
            raw = f.read()
        lines = raw.split("\n")
        # a file not ending in "\n" has a torn final record
        torn_tail = bool(lines and lines[-1])
        complete = lines[:-1]
        for i, line in enumerate(complete):
            try:
                crc_hex, body = line.split(" ", 1)
                if int(crc_hex, 16) != zlib.crc32(body.encode()) \
                        & 0xFFFFFFFF:
                    raise ValueError("crc mismatch")
                rec = json.loads(body)
            except (ValueError, json.JSONDecodeError):
                discarded = len(complete) - i + int(torn_tail)
                logger.warning(
                    "journal %s: corrupt line %d — replaying the %d "
                    "intact records before it, discarding %d",
                    path, i, i, discarded)
                return state, discarded
            _apply(state, rec)
        return state, int(torn_tail)

    # ----------------------------------------------------------- status

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "journal_records": float(self.records_appended),
                "journal_compactions": float(self.compactions),
                "journal_fsyncs": float(self.fsyncs),
                "journal_bytes": float(os.path.getsize(self.path)
                                       if os.path.exists(self.path)
                                       else 0),
            }
