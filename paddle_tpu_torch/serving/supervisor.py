"""Crash-restarting supervisor of the serving router.

Counterpart of paddle_tpu/serving/supervisor.py:

  state machine per replica (status field on EngineReplica):

      live --(worker catches BaseException)--> crashed
      live --(process backend: the replica's process exited, seen by a
              waitpid probe before any command surfaced it)--> crashed
      live --(has work, no step-progress heartbeat for
              heartbeat_timeout_s)--> hung
      crashed/hung --(recover: fence, fresh runner, restore from the
              last snapshot, backfill from the router registry,
              redistribute)--> live (new epoch)
      crashed/hung --(max_restarts exhausted)--> retired
              (its requests re-route to surviving replicas; with no
              survivors they finish with reason "error")

  detection   `poll()`, called by the supervisor thread AND inline by
              router.drain(), so recovery needs no live thread to make
              progress. A hung step holds the replica lock, so health is
              judged lock-free from the heartbeat and status fields.
  fencing     the failed EngineReplica is fenced BEFORE any recovery:
              whatever its stuck thread later reports is discarded
              (at-most-once; the un-hung thread sees `stop` and exits,
              and its engine, pools, graphs and host tier go with it).
  restore     a FRESH runner from the router's factory (never the
              possibly wedged old one; it shares the model's weights),
              `ServingEngine.restore` on the replica's last snapshot,
              token-exact by recompute-on-resume. On the process backend
              the old child is SIGKILLed first (a SIGSTOP'd one too) and
              a NEW child restores the snapshot: a dead or stopped
              process is never reused.
  backfill    requests the snapshot missed are resubmitted from the
              router's registry with their full delivered prefix; the
              delivery cursor absorbs any overlap.
  redistribute the restored queue re-routes through the normal policy
              (affinity entries for the dead pool are purged first).

With a host-wide store (`ServingRouter(shared_kv_pages=)`) recovery first
reaps the dead incarnation's store refs, and so does retiring a replica.
"""

from __future__ import annotations

import logging
import threading
import weakref
from typing import Optional

logger = logging.getLogger(__name__)


class Supervisor:
    """Health-checks a ServingRouter's replicas and restarts the dead.

    Usually constructed by ServingRouter(supervise=True); `poll()` is
    safe to call from any thread at any time (an internal mutex
    serializes recoveries, and each failed EngineReplica object is
    recovered at most once)."""

    def __init__(self, router, *, heartbeat_timeout_s: float = 5.0,
                 poll_interval_s: float = 0.2, redistribute: bool = True,
                 max_restarts: Optional[int] = None):
        if heartbeat_timeout_s is not None and heartbeat_timeout_s <= 0:
            raise ValueError("heartbeat_timeout_s must be positive "
                             "(None disables hang detection)")
        self.router = router
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.poll_interval_s = poll_interval_s
        self.redistribute = redistribute
        self.max_restarts = max_restarts
        self.restarts = 0
        self._mutex = threading.Lock()
        # the EngineReplicas handled, held weakly: a recovered replica's
        # engine must be freed, and an id() set would match a later
        # replica that reuses a freed one's address
        self._recovered = weakref.WeakSet()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------- thread

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-supervisor")
        self._thread.start()

    def stop(self, timeout_s: float = 2.0) -> None:
        self._stop_evt.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout_s)

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.poll_interval_s):
            try:
                self.poll()
            except BaseException:        # pragma: no cover - must never
                # kill the loop (a respawned replica dying mid-backfill
                # lands here: the next poll's probe recovers it again)
                logger.exception("supervisor poll failed")

    # ------------------------------------------------------- detection

    def _hung(self, rep) -> bool:
        """Step-progress heartbeat check, deliberately LOCK-FREE: a hung
        step holds rep.lock, so health must be judged from fields the
        worker wrote before it wedged. A replica is hung when it has
        work but its last completed step (or last intake) is older than
        the timeout."""
        if self.heartbeat_timeout_s is None:
            return False
        try:
            busy = rep.engine.has_work()
        except Exception:                # racing a teardown
            return False
        if not busy:
            return False
        return (self.router._clock() - rep.last_beat
                > self.heartbeat_timeout_s)

    def poll(self) -> int:
        """One health pass over every replica; returns the number of
        recoveries performed."""
        recovered = 0
        with self._mutex:
            for rep in list(self.router._replicas):
                if rep in self._recovered:
                    continue
                if rep.status == "crashed":
                    self._recover(rep, "crash")
                    recovered += 1
                elif (rep.status == "live"
                        and self.router._replica_dead(rep)):
                    # the replica PROCESS exited (SIGKILL, OOM, segfault)
                    # before any command surfaced it: an idle replica's
                    # corpse is found here, not on traffic
                    rep.status = "crashed"
                    rep.fenced = True
                    rep.stop = True
                    rc = rep.engine.proc.poll()
                    rep.crash = f"process exited rc={rc}"
                    self.router.metrics.replica_crashes.inc()
                    logger.warning("replica %d process died (rc=%s)",
                                   rep.index, rc)
                    self._recover(rep, "crash")
                    recovered += 1
                elif rep.status == "live" and self._hung(rep):
                    rep.status = "hung"
                    rep.fenced = True
                    rep.stop = True
                    self.router.metrics.replica_hangs.inc()
                    logger.warning(
                        "replica %d hung: no step progress for %.2fs "
                        "with work pending", rep.index,
                        self.router._clock() - rep.last_beat)
                    self._recover(rep, "hang")
                    recovered += 1
        return recovered

    # -------------------------------------------------------- recovery

    def _recover(self, rep, reason: str) -> None:
        router = self.router
        t0 = router._clock()             # fence-to-live recovery latency
        self._recovered.add(rep)
        rep.fenced = True
        rep.stop = True
        rep.wake.set()
        # the dead engine's counters join the tier history so aggregate
        # metrics survive the restart (reading without rep.lock is safe:
        # plain python floats, and the worker is fenced)
        try:
            router._retired_metrics.append(rep.engine.metrics.snapshot())
        except BaseException:            # pragma: no cover
            pass
        # release every host-wide store ref the dead incarnation held: its
        # offload and transfer slots are reclaimed by refcount, while
        # content the index owns and the siblings' refs survive it
        router._reap_store_owner(rep)
        orphans = router._orphans(rep.index, rep.epoch)
        if self.max_restarts is not None \
                and self.restarts >= self.max_restarts:
            self._retire(rep, orphans)
            return
        self.restarts += 1
        # NEVER reuse the dead runner: a hung thread may still be inside
        # one of its calls (its pools and graphs die with it once the
        # thread exits)
        snap = rep.last_snapshot
        try:
            engine, runner = router._revive_engine(rep, snap)
        except BaseException as e:       # respawn itself failed: the
            logger.error(                # replica retires, tier degrades
                "replica %d revive failed (%s); retiring", rep.index, e)
            self._retire(rep, orphans)
            return
        new = router._spawn(rep.index, engine, runner, start=False)
        # reconcile the restored engine against the router registry
        # BEFORE its worker starts (no lock races: the thread is ours)
        restored_live = {rid for rid, r in engine._requests.items()
                         if not r.done}
        for rec in orphans:
            if rec.request_id in restored_live:
                router._adopt(new, rec)
            else:
                # lost between snapshot and death — the registry is the
                # backstop; the cursor dedupes any regenerated overlap
                router._inject(new, rec)
        # zombies: the snapshot resurrected requests the tier already
        # finished (aborted while the replica was down, or completed in
        # the dying step) — don't burn compute on them
        with router._lock:
            done_ids = [rid for rid in restored_live
                        if router._reqs.get(rid) is not None
                        and router._reqs[rid].done]
        for rid in done_ids:
            engine.abort(rid, "aborted")
        if self.redistribute:
            router._redistribute_from(new)
        router._start_worker(new)
        router.metrics.replica_restarts.inc()
        # replica recovery latency: fence -> restarted worker live
        router.metrics.recovery_s.observe(router._clock() - t0)
        router._completion.set()
        logger.warning("replica %d recovered from %s (epoch %d -> %d, "
                       "%d in-flight requests, snapshot=%s)",
                       rep.index, reason, rep.epoch, new.epoch,
                       len(orphans), "yes" if snap is not None else "no")

    def _retire(self, rep, orphans) -> None:
        """Restart budget exhausted: the replica stays down and its
        requests re-route to the survivors (or fail loudly with reason
        'error' when none remain) — degraded, never wedged."""
        rep.status = "retired"
        self.router._reap_store_owner(rep)
        with self.router._lock:
            self.router.metrics.live_replicas.set(
                sum(1 for r in self.router._replicas
                    if r.status == "live"))
        for rec in orphans:
            try:
                target, _ = self.router._choose(
                    self.router._affinity_chain(rec.prompt_tokens))
            except Exception:
                with self.router._lock:
                    if not rec.done:
                        self.router._finish(rec, "error")
                continue
            self.router._inject(target, rec)
        self.router._completion.set()
        logger.error("replica %d retired after %d restarts",
                     rep.index, self.restarts)
