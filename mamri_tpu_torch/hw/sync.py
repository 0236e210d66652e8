"""Encoder <-> controller drift reconciliation.

Port of the reference's 250 ms sync timer (`_perform_sync_check`,
Mamri/Mamri.py:1279-1302): watch the encoder stream; when the robot settles
after a movement, compare controller counters against encoder truth and, on
any discrepancy beyond the threshold (reference default 0), overwrite the
controller counters with 'S<encoder>,0,0'.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from mamri_tpu_torch.hw.devices import EncoderLink, MotorControllerLink

logger = logging.getLogger(__name__)

SYNC_INTERVAL_S = 0.25
DISCREPANCY_THRESHOLD = 0


class SyncMonitor:
    def __init__(
        self,
        controller: MotorControllerLink,
        encoder: EncoderLink,
        discrepancy_threshold: int = DISCREPANCY_THRESHOLD,
    ):
        self.controller = controller
        self.encoder = encoder
        self.discrepancy_threshold = discrepancy_threshold
        self.last_pos: Optional[List[int]] = None
        self.movement_seen = False
        self.corrections = 0

    def step(self) -> bool:
        """One sync tick (call at ~SYNC_INTERVAL_S). Returns True if a
        correction was issued."""
        if not (self.controller.is_connected and self.encoder.is_connected):
            return False
        current = self.encoder.latest_position
        if self.last_pos is None:
            self.last_pos = current
            return False
        if any(a != b for a, b in zip(current, self.last_pos)):
            self.movement_seen = True
            self.last_pos = current
            return False
        if not self.movement_seen:
            return False
        controller_pos = self.controller.query_positions()
        if controller_pos is None:
            return False
        diff = np.abs(np.asarray(controller_pos) - np.asarray(current))
        if np.any(diff > self.discrepancy_threshold):
            logger.info("post-move discrepancy %s; forcing controller counters", diff.tolist())
            self.controller.force_counters(current)
            self.corrections += 1
            self.movement_seen = False
            return True
        self.movement_seen = False
        return False
