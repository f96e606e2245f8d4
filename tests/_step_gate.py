"""A step gate for a serving-tier replica, for tests that must act while a
replica is known to be between steps: a stand-in for the replica's lock
(`EngineReplica.lock`, which the router only uses as a context manager)."""

import threading
import time


class StepGate:
    """Installed as ``rep.lock``: while the gate is closed the replica's
    worker thread waits at the door for a permit (`step_once`) before each
    pass of its step loop (unless the replica is stopping), and every other
    thread (the test, submit, a drain, the supervisor) takes the lock as
    before. So with the gate
    closed the replica takes no step the test did not allow, and a test
    holding the lock reads a state no step can move."""

    def __init__(self, rep):
        self._lock = rep.lock
        self._rep = rep
        self._closed = False
        self._permits = threading.Semaphore(0)
        self._entered = threading.Event()
        rep.lock = self

    def close(self) -> None:
        self._closed = True

    def open(self) -> None:
        self._closed = False
        self._permits.release()         # a worker waiting at the door

    def step_once(self, timeout_s: float = 30.0) -> None:
        """Let the worker through the door once and wait until that pass
        of its loop (a step, when it has work) has ended."""
        self._entered.clear()
        self._permits.release()
        if not self._entered.wait(timeout_s):
            raise AssertionError("the replica's worker never came to the "
                                 "door")
        with self._lock:                # the pass holds it to its end
            pass

    def __enter__(self):
        if threading.current_thread() is self._rep.thread:
            # a stopping replica (a drain) passes: its loop only flushes
            while self._closed and not self._rep.stop:
                if self._permits.acquire(timeout=0.01):
                    break
            self._lock.acquire()
            self._entered.set()
            return self
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


def wait_until(cond, timeout_s: float = 60.0, what: str = "condition"):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} not reached in {timeout_s} s")
        time.sleep(0.002)
