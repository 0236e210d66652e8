"""Live pose/status streaming during hardware execution.

The reference mirrors encoder state into the 3-D scene on every 150 ms task
tick (`setRobotPose(encoder_angles)`, Mamri/Mamri.py:537) and refreshes its
status panel at 4 Hz (Mamri.py:582-648, heavy updates throttled at :595).
Headless, the equivalent is a pub/sub pose stream: the executor publishes
one frame per control tick (wired up in `MamriEngine.attach_hardware`), and
any number of subscribers — SSE clients on the server's `GET /watch`, the
CLI's `hw --watch`, user scripts — consume concurrently without ever
back-pressuring the control loop: each subscription owns a bounded
drop-oldest queue, and `publish` never blocks.

Frame contract (JSON-serializable dicts):
  {"event": "pose", "t": ..., "steps": [...], "angles_deg": [...],
   "mode": ..., "target_steps": [...], "keyframe_index"/"num_keyframes",
   "tcp_world": [x, y, z]?}              one per executor tick
  {"event": "task_finished", "outcome": ..., "message": ..., "t": ...}
                                         terminal, from the runner
  {"event": "status", ...}               server heartbeat (>= 4 Hz) when no
                                         pose frame arrived — encoder-only,
                                         never touches the serial command
                                         channel from the watcher thread
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Iterator, List, Optional


class PoseSubscription:
    """One consumer's bounded view of the stream. Iterate with `get()` or
    `frames()`; always `close()` (or use as a context manager)."""

    def __init__(self, stream: "PoseStream", maxlen: int):
        self._stream = stream
        self._buf: deque = deque(maxlen=maxlen)
        self._cond = threading.Condition()
        self.dropped = 0  # frames lost to the bounded queue (slow consumer)
        self.closed = False

    # called by PoseStream under its registry lock
    def _push(self, frame: dict) -> None:
        with self._cond:
            if self._buf.maxlen is not None and len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(frame)
            self._cond.notify()

    def _end(self) -> None:
        with self._cond:
            self.closed = True
            self._cond.notify()

    def get(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Next frame, or None on timeout / closed-and-drained."""
        with self._cond:
            if not self._buf and not self.closed:
                self._cond.wait(timeout)
            if self._buf:
                return self._buf.popleft()
            return None

    def frames(
        self, max_frames: Optional[int] = None, idle_timeout_s: float = 5.0
    ) -> Iterator[dict]:
        """Yield frames until a terminal frame, `max_frames`, the stream
        closing, or `idle_timeout_s` with nothing published."""
        n = 0
        while max_frames is None or n < max_frames:
            fr = self.get(timeout=idle_timeout_s)
            if fr is None:
                return
            yield fr
            n += 1
            if fr.get("event") == "task_finished":
                return

    def close(self) -> None:
        self._stream._unsubscribe(self)
        self._end()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PoseStream:
    """Thread-safe fan-out broker. `publish` is wait-free for the producer
    (the 150 ms control loop): it appends to each subscriber's bounded deque
    and never blocks on a slow consumer."""

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: List[PoseSubscription] = []
        self._seq = 0
        self.last_frame: Optional[dict] = None  # most recent, for snapshots

    def subscribe(self, maxlen: int = 512) -> PoseSubscription:
        sub = PoseSubscription(self, maxlen)
        with self._lock:
            self._subs.append(sub)
        return sub

    def _unsubscribe(self, sub: PoseSubscription) -> None:
        with self._lock:
            try:
                self._subs.remove(sub)
            except ValueError:
                pass

    def publish(self, frame: dict) -> None:
        with self._lock:
            self._seq += 1
            frame = dict(frame, seq=self._seq)
            self.last_frame = frame
            subs = list(self._subs)
        for sub in subs:
            sub._push(frame)

    @property
    def num_subscribers(self) -> int:
        with self._lock:
            return len(self._subs)

    def close(self) -> None:
        with self._lock:
            subs, self._subs = self._subs, []
        for sub in subs:
            sub._end()
