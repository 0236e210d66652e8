"""Closed-loop robot task executor.

Host-side port of the reference widget's task engine
(`_startRobotTask`/`_onRobotTaskStep`/`_stopRobotTask`, Mamri/Mamri.py:367-581)
with identical control semantics, but decoupled from Qt: `step()` is a pure
tick the caller schedules (asyncio, a thread loop, or a test harness with a
fake clock).

Semantics preserved:
  * modes: move_to_pose / trajectory / homing / jog
  * 120 s task timeout (:495); arrival tolerance 0 steps (:543-544)
  * trajectory keyframe advancing on arrival (:545-557)
  * stall detection: encoder unchanged > 2 s -> re-issue the move command,
    rate-limited to >= 1 s since the last command (:559-569)
  * user stop flag -> soft stop (re-command current position) (:519-522)
"""

from __future__ import annotations

import enum
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from mamri_tpu_torch.hw.devices import EncoderLink, MotorControllerLink

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 120.0
STALL_THRESHOLD_S = 2.0
COMMAND_BACKOFF_S = 1.0
ARRIVAL_TOLERANCE_STEPS = 0
TICK_INTERVAL_S = 0.15


class TaskOutcome(enum.Enum):
    RUNNING = "running"
    SUCCESS = "success"
    STOPPED = "stopped"
    TIMEOUT = "timeout"


@dataclass
class TaskState:
    mode: str
    target_steps: np.ndarray
    keyframes: Optional[List[np.ndarray]] = None
    keyframe_index: int = 0
    start_time: float = 0.0
    timeout_s: float = DEFAULT_TIMEOUT_S
    last_command_time: float = 0.0
    stall_start_time: float = 0.0
    last_encoder_pos: Optional[np.ndarray] = None
    outcome: TaskOutcome = TaskOutcome.RUNNING
    message: str = ""


class RobotTaskRunner:
    """Drives the controller toward targets using encoder feedback."""

    def __init__(
        self,
        controller: MotorControllerLink,
        encoder: EncoderLink,
        angles_to_steps: Optional[Callable] = None,
        pose_callback: Optional[Callable] = None,
        finish_callback: Optional[Callable] = None,
        clock: Callable[[], float] = time.time,
        arrival_tolerance: int = ARRIVAL_TOLERANCE_STEPS,
        stall_threshold_s: float = STALL_THRESHOLD_S,
        command_backoff_s: float = COMMAND_BACKOFF_S,
    ):
        self.controller = controller
        self.encoder = encoder
        self.angles_to_steps = angles_to_steps
        self.pose_callback = pose_callback  # fed live encoder steps each tick
        self.finish_callback = finish_callback  # fed the final TaskState once
        self.clock = clock
        self.arrival_tolerance = arrival_tolerance
        self.stall_threshold_s = stall_threshold_s
        self.command_backoff_s = command_backoff_s
        self.stop_requested = False
        self.state: Optional[TaskState] = None

    @property
    def is_active(self) -> bool:
        return self.state is not None and self.state.outcome is TaskOutcome.RUNNING

    def start(
        self,
        mode: str,
        target_steps: Optional[Sequence[int]] = None,
        keyframes: Optional[Sequence[np.ndarray]] = None,
        timeout_s: float = DEFAULT_TIMEOUT_S,
    ) -> TaskState:
        if self.is_active:
            raise RuntimeError("a robot task is already running")
        self.stop_requested = False
        now = self.clock()
        if mode == "trajectory":
            if not keyframes:
                raise ValueError("trajectory mode requires keyframes")
            kf_steps = [np.asarray(self._to_steps(k), dtype=int) for k in keyframes]
            target = kf_steps[0]
            state = TaskState(mode=mode, target_steps=target, keyframes=kf_steps, timeout_s=timeout_s)
        else:
            if target_steps is None:
                raise ValueError(f"mode {mode!r} requires target_steps")
            target = np.asarray(target_steps, dtype=int)
            state = TaskState(mode=mode, target_steps=target, timeout_s=timeout_s)
        state.start_time = now
        self.controller.command_pose(state.target_steps)
        state.last_command_time = now
        state.stall_start_time = now
        self.state = state
        return state

    def request_stop(self) -> None:
        self.stop_requested = True

    def _to_steps(self, keyframe) -> np.ndarray:
        if self.angles_to_steps is not None:
            return np.asarray(self.angles_to_steps(keyframe))
        return np.asarray(keyframe)

    def _finish(self, outcome: TaskOutcome, message: str) -> TaskState:
        st = self.state
        st.outcome = outcome
        st.message = message
        logger.info("task %s finished: %s (%s)", st.mode, outcome.value, message)
        if self.finish_callback is not None:
            try:
                self.finish_callback(st)
            except Exception:
                # A broken observer must not change the task outcome.
                logger.exception("finish_callback failed; task outcome stands")
        return st

    def step(self) -> TaskState:
        """One control tick. Call at ~TICK_INTERVAL_S cadence while RUNNING."""
        st = self.state
        if st is None or st.outcome is not TaskOutcome.RUNNING:
            raise RuntimeError("no active task")
        now = self.clock()

        if self.stop_requested:
            self.controller.soft_stop()
            return self._finish(TaskOutcome.STOPPED, "Stopped by user.")
        if now - st.start_time > st.timeout_s:
            self.controller.soft_stop()
            return self._finish(TaskOutcome.TIMEOUT, "Task timed out.")

        if not self.encoder.is_connected:
            return st
        live = np.asarray(self.encoder.latest_position, dtype=int)
        self.controller.query_positions()  # keeps last_known_position fresh
        if self.pose_callback is not None:
            try:
                self.pose_callback(live)
            except Exception:
                # The mirror is an observer: a failure there (e.g. a dead
                # device backend inside a subscriber) must not kill the
                # control loop — stall/arrival/stop handling stays live.
                logger.exception("pose_callback failed; control loop continues")

        if np.all(np.abs(live - st.target_steps) <= self.arrival_tolerance):
            if st.mode == "trajectory":
                st.keyframe_index += 1
                if st.keyframe_index < len(st.keyframes):
                    st.target_steps = st.keyframes[st.keyframe_index]
                    self.controller.command_pose(st.target_steps)
                    st.last_command_time = now
                    st.stall_start_time = now
                    return st
                return self._finish(TaskOutcome.SUCCESS, "Trajectory executed successfully.")
            return self._finish(TaskOutcome.SUCCESS, f"Task '{st.mode}' finished.")

        moving = st.last_encoder_pos is None or not np.array_equal(live, st.last_encoder_pos)
        if moving:
            st.last_encoder_pos = live
            st.stall_start_time = now
        elif now - st.stall_start_time > self.stall_threshold_s:
            if now - st.last_command_time > self.command_backoff_s:
                logger.info("stall > %.1fs; re-issuing command", self.stall_threshold_s)
                self.controller.command_pose(st.target_steps)
                st.last_command_time = now
        return st

    def run(
        self,
        tick_interval_s: float = TICK_INTERVAL_S,
        on_tick: Optional[Callable] = None,
        sleep: Callable[[float], None] = time.sleep,
    ) -> TaskState:
        """Blocking loop around step() — the headless equivalent of the
        reference's 150 ms QTimer."""
        while self.is_active:
            st = self.step()
            if on_tick is not None:
                on_tick(st)
            if st.outcome is not TaskOutcome.RUNNING:
                return st
            sleep(tick_interval_s)
        return self.state
