"""Simulated MAMRI hardware: motor controller + encoders with fault injection.

The reference has no test hardware stand-in at all (SURVEY.md §4). This
simulator speaks the exact wire protocols of mamri_tpu_torch/hw/devices.py over
LoopbackTransport, with a controllable clock so closed-loop executor tests run
deterministically and instantly.

Physical model:
  * the controller drives its internal step counters toward the commanded
    targets at `speed_steps_per_s`;
  * the TRUE joint position lags by `missed_steps` (stall/slip injection),
    which is what the encoders report;
  * "S" overwrites the controller counters (the sync mechanism's lever);
  * "R" zeroes the encoder counters.

Fault injection: `inject_stall(joints)` freezes true motion while the
controller keeps counting (belt slip); `garbage(...)`/status lines exercise
the listener's malformed-line handling.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence

from mamri_tpu_torch.hw.transport import LoopbackTransport

NUM_JOINTS = 6


class SimulatedRobot:
    """Shared mechanical state for the controller + encoder pair."""

    def __init__(
        self,
        speed_steps_per_s: float = 400.0,
        clock: Callable[[], float] = time.time,
    ):
        self.clock = clock
        self.speed = speed_steps_per_s
        self.controller_counts = [0.0] * NUM_JOINTS  # what the controller believes
        self.targets = [0.0] * NUM_JOINTS
        self.encoder_offset = [0.0] * NUM_JOINTS  # subtracted on 'R'
        self.missed_steps = [0.0] * NUM_JOINTS  # slip: true = counts - missed
        self.stalled_joints: set[int] = set()
        self._last_t = clock()
        # one rig can be driven from several threads at once (runner tick,
        # free-running encoder emitter, sync monitor) — all state transitions
        # go through this re-entrant lock
        self.lock = threading.RLock()

    def advance(self) -> None:
        """Integrate motion up to the current clock time."""
        with self.lock:
            self._advance_locked()

    def _advance_locked(self) -> None:
        now = self.clock()
        dt = max(0.0, now - self._last_t)
        self._last_t = now
        if dt == 0.0:
            return
        max_delta = self.speed * dt
        for j in range(NUM_JOINTS):
            err = self.targets[j] - self.controller_counts[j]
            step = max(-max_delta, min(max_delta, err))
            self.controller_counts[j] += step
            if j in self.stalled_joints:
                # controller counts move; the mechanism does not
                self.missed_steps[j] += step

    def true_position(self) -> List[int]:
        with self.lock:
            return [
                int(round(self.controller_counts[j] - self.missed_steps[j] - self.encoder_offset[j]))
                for j in range(NUM_JOINTS)
            ]

    def inject_stall(self, joints: Sequence[int]) -> None:
        with self.lock:
            self.stalled_joints.update(joints)

    def clear_stall(self, joints: Optional[Sequence[int]] = None) -> None:
        with self.lock:
            if joints is None:
                self.stalled_joints.clear()
            else:
                self.stalled_joints.difference_update(joints)


class SimulatedMotorController:
    """Protocol endpoint for the controller link."""

    def __init__(self, robot: SimulatedRobot, letters: str = "ABCDEF"):
        self.robot = robot
        self.letters = letters
        self._tp: Optional[LoopbackTransport] = None

    def attach_transport(self, tp: LoopbackTransport) -> None:
        self._tp = tp

    def handle_line(self, line: str) -> None:
        with self.robot.lock:
            self._handle_locked(line)

    def _handle_locked(self, line: str) -> None:
        self.robot.advance()
        if not line:
            return
        if line == "X":
            self._tp.push_from_device("Hello world!")
        elif line == "P":
            counts = [str(int(round(c))) for c in self.robot.controller_counts]
            self._tp.push_from_device(",".join(counts + ["0", "0"]))
        elif line.startswith("S"):
            try:
                vals = [int(v) for v in line[1:].split(",")]
            except ValueError:
                return
            for j in range(min(NUM_JOINTS, len(vals))):
                delta = vals[j] - self.robot.controller_counts[j]
                self.robot.controller_counts[j] = float(vals[j])
                # retargeting frame shift: a counter overwrite redefines where
                # the controller thinks it is; outstanding targets keep their
                # numeric value (matches real firmware 'set position' semantics)
                self.robot.missed_steps[j] += delta
        elif line[0] in self.letters:
            try:
                target = int(line[1:])
            except ValueError:
                return
            j = self.letters.index(line[0])
            self.robot.targets[j] = float(target)


class SimulatedEncoder:
    """Protocol endpoint for the encoder link; emits position lines on demand.

    Real encoders stream continuously; here `emit()` pushes one line (tests
    call it per tick, or `auto_emit` wraps reads)."""

    def __init__(self, robot: SimulatedRobot):
        self.robot = robot
        self._tp: Optional[LoopbackTransport] = None
        self.garbage_every: int = 0  # fault injection: push noise line every N emits
        self._emit_count = 0

    def attach_transport(self, tp: LoopbackTransport) -> None:
        self._tp = tp

    def handle_line(self, line: str) -> None:
        with self.robot.lock:
            self._handle_locked(line)

    def _handle_locked(self, line: str) -> None:
        self.robot.advance()
        if line == "R":
            for j in range(NUM_JOINTS):
                self.robot.encoder_offset[j] = (
                    self.robot.controller_counts[j] - self.robot.missed_steps[j]
                )
            self._tp.push_from_device("Encoders reset")

    def emit(self) -> None:
        with self.robot.lock:
            self._emit()

    def _emit(self) -> None:
        self.robot.advance()
        self._emit_count += 1
        if self.garbage_every and self._emit_count % self.garbage_every == 0:
            self._tp.push_from_device("!!corrupt@@line##")
        self._tp.push_from_device(",".join(str(v) for v in self.robot.true_position()))


def simulated_hardware(engine, speed_steps_per_s: float = 1500.0, emit_hz: float = 250.0):
    """Attach a complete simulated hardware rig to `engine` and start a
    free-running encoder stream — everything the reference needs two USB
    cables for, in-process (controller + encoder protocol endpoints, a
    kinematic step integrator, and the ~250 Hz encoder emitter).

    Returns `(stack, robot, shutdown)`: the engine's `HardwareStack`, the
    `SimulatedRobot` (for `inject_stall` etc.), and a `shutdown()` that stops
    the emitter thread and disconnects both links. Used by the CLI `hw --sim`
    and available for user scripts/demos."""
    import threading

    robot = SimulatedRobot(speed_steps_per_s=speed_steps_per_s, clock=time.time)
    mc_dev = SimulatedMotorController(robot)
    enc_dev = SimulatedEncoder(robot)
    tp_mc = LoopbackTransport(mc_dev)
    tp_enc = LoopbackTransport(enc_dev)

    stop_emit = threading.Event()
    period = 1.0 / max(emit_hz, 1.0)

    def emitter():
        while not stop_emit.is_set():
            enc_dev.emit()
            time.sleep(period)

    thread = threading.Thread(target=emitter, daemon=True, name="sim-encoder-emit")
    thread.start()
    try:
        stack = engine.attach_hardware(tp_mc, tp_enc)
    except Exception:
        stop_emit.set()
        thread.join(timeout=2.0)
        raise

    def shutdown():
        stop_emit.set()
        thread.join(timeout=2.0)
        stack.disconnect()

    return stack, robot, shutdown
