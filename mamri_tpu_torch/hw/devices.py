"""Drivers for the MAMRI motor controller and encoder serial protocols.

Wire protocols (ASCII lines, parity with Mamri/Mamri.py):
  Motor controller (:1064-1219):
    "X"                -> handshake, replies a line containing "Hello world!"
    "P"                -> replies CSV step counts (>= 6 ints; first 6 used)
    "S<8 csv ints>"    -> force internal counters (6 joints + 2 spare)
    "<letter><steps>"  -> absolute per-joint move, letters A..F
  Encoder (:1108-1153, :1250-1277):
    streams 6 CSV ints continuously; non-numeric lines are status messages
    "R"                -> reset counters to zero

The encoder driver owns a daemon listener thread feeding `latest_position`
under a lock, with clean-shutdown semantics (stop flag + join timeout),
mirroring the reference's concurrency discipline (SURVEY.md §5).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Sequence

from mamri_tpu_torch.hw.transport import Transport

logger = logging.getLogger(__name__)

HANDSHAKE_REPLY = "Hello world!"
NUM_JOINTS = 6


class MotorControllerLink:
    """Command link to the stepper controller."""

    def __init__(self, transport: Transport, motor_letters: Sequence[str] = "ABCDEF", settle_s: float = 0.0):
        self._tp = transport
        self._letters = list(motor_letters)
        self._settle_s = settle_s
        self._connected = False
        self.last_known_position: Optional[List[int]] = None

    def handshake(self) -> bool:
        """Send 'X', expect a hello line; reference settles 1.5 s first
        (Mamri.py:1075) — configurable here so sim tests run instantly."""
        if self._settle_s:
            time.sleep(self._settle_s)
        if hasattr(self._tp, "flush_input"):
            self._tp.flush_input()
        self._tp.write_line("X")
        reply = self._tp.read_line(timeout=1.0)
        self._connected = bool(reply and HANDSHAKE_REPLY in reply)
        if not self._connected:
            logger.error("motor controller handshake failed: got %r", reply)
        return self._connected

    @property
    def is_connected(self) -> bool:
        return self._connected and self._tp.is_open

    def disconnect(self) -> None:
        self._connected = False
        self._tp.close()

    def send_raw(self, command: str) -> bool:
        if not self.is_connected:
            logger.warning("cannot send %r: not connected", command)
            return False
        try:
            self._tp.write_line(command)
            return True
        except Exception:
            logger.exception("failed to send %r", command)
            return False

    def query_positions(self) -> Optional[List[int]]:
        """'P' round-trip -> first NUM_JOINTS step counts."""
        if not self.is_connected:
            return None
        try:
            self._tp.write_line("P")
            reply = self._tp.read_line(timeout=1.0)
            if not reply:
                return None
            positions = [int(p.strip()) for p in reply.split(",")]
            self.last_known_position = positions[:NUM_JOINTS]
            return self.last_known_position
        except Exception:
            logger.warning("position query failed", exc_info=True)
            return None

    def command_pose(self, steps: Sequence[int]) -> None:
        """Absolute per-joint moves: 'A<steps>' .. 'F<steps>' (Mamri.py:1196-1205)."""
        for letter, pos in zip(self._letters, steps):
            self.send_raw(f"{letter}{int(pos)}")

    def soft_stop(self) -> None:
        """Hold position: re-command the current (or last known) position
        (Mamri.py:1207-1219)."""
        current = self.last_known_position or self.query_positions()
        if current is None:
            logger.error("cannot soft-stop: no known position")
            return
        self.command_pose(current[:NUM_JOINTS])

    def force_counters(self, steps: Sequence[int]) -> None:
        """'S' counter overwrite; payload is 6 joint values + two zeros
        (Mamri.py:1246-1248)."""
        payload = ",".join(str(int(s)) for s in steps) + ",0,0"
        self.send_raw(f"S{payload}")

    def zero_counters(self) -> None:
        self.send_raw("S" + ",".join(["0"] * 8))


class EncoderLink:
    """Streaming link to the joint encoders with a background listener."""

    def __init__(self, transport: Transport, num_joints: int = NUM_JOINTS):
        self._tp = transport
        self.num_joints = num_joints
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._latest: List[int] = [0] * num_joints
        self._thread: Optional[threading.Thread] = None
        self._connected = False

    def handshake(self) -> bool:
        """Validate the stream: one line of num_joints CSV ints
        (Mamri.py:1115-1125), then start the listener thread."""
        line = self._tp.read_line(timeout=2.0)
        parts = (line or "").split(",")
        ok = len(parts) == self.num_joints and all(p.strip().lstrip("-").isdigit() for p in parts)
        if not ok:
            logger.error("encoder handshake failed: got %r", line)
            return False
        with self._lock:
            self._latest = [int(p) for p in parts]
        self._stop.clear()
        self._thread = threading.Thread(target=self._listen, daemon=True)
        self._thread.start()
        self._connected = True
        return True

    @property
    def is_connected(self) -> bool:
        return self._connected and self._tp.is_open

    def _listen(self) -> None:
        """Parse the stream forever; malformed/status lines are logged and
        skipped; errors don't kill the thread (Mamri.py:1250-1277)."""
        while not self._stop.is_set():
            try:
                line = self._tp.read_line(timeout=0.1)
                if not line:
                    continue
                if not (line[0].isdigit() or line[0] == "-"):
                    logger.info("encoder status: %r", line)
                    continue
                parts = line.split(",")
                if len(parts) != self.num_joints:
                    logger.warning("malformed encoder line: %r", line)
                    continue
                values = [int(p.strip()) for p in parts]
                with self._lock:
                    self._latest = values
            except Exception:
                if self._stop.is_set():
                    break
                logger.exception("encoder listener error; continuing")

    @property
    def latest_position(self) -> List[int]:
        with self._lock:
            return list(self._latest)

    def send_raw(self, command: str) -> bool:
        if not self.is_connected:
            logger.warning("cannot send %r to encoder: not connected", command)
            return False
        try:
            self._tp.write_line(command)
            return True
        except Exception:
            logger.exception("encoder send failed")
            return False

    def reset_counters(self) -> bool:
        return self.send_raw("R")

    def disconnect(self, join_timeout: float = 1.0) -> None:
        self._stop.set()
        if self._thread and self._thread.is_alive():
            self._thread.join(timeout=join_timeout)
            if self._thread.is_alive():
                logger.warning("encoder listener did not stop cleanly")
        self._tp.close()
        self._thread = None
        self._connected = False
