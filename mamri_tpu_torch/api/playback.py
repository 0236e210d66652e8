"""Headless trajectory playback — the reference widget's simulation panel
(slider + play/pause + 50 ms animation stepping, Mamri/Mamri.py:287-317)
without Qt: an iterator/cursor over a planned path that pushes poses into a
callback (e.g. engine.set_pose or a renderer)."""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

ANIMATION_INTERVAL_S = 0.05  # reference animation timer (Mamri.py:118)


class TrajectoryPlayback:
    def __init__(self, path: np.ndarray, on_pose: Optional[Callable] = None):
        self.path = np.asarray(path)
        self.on_pose = on_pose
        self.index = 0
        self.playing = False

    def __len__(self) -> int:
        return len(self.path)

    def seek(self, index: int) -> np.ndarray:
        """Slider equivalent: jump to a sample and emit its pose."""
        self.index = int(np.clip(index, 0, len(self.path) - 1))
        pose = self.path[self.index]
        if self.on_pose is not None:
            self.on_pose(pose)
        return pose

    def step(self) -> bool:
        """Advance one frame; returns False (and stops) at the end."""
        if self.index >= len(self.path) - 1:
            self.playing = False
            return False
        self.seek(self.index + 1)
        return True

    def play(self, interval_s: float = ANIMATION_INTERVAL_S, sleep: Callable = time.sleep) -> None:
        """Blocking play loop at the reference's 50 ms cadence."""
        self.playing = True
        self.seek(self.index)
        while self.playing and self.step():
            sleep(interval_s)

    def pause(self) -> None:
        self.playing = False

    def rewind(self) -> None:
        self.seek(0)
