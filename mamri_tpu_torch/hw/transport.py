"""Byte transports for the two serial links (motor controller + encoder).

The reference talks pyserial directly at 115200 baud (Mamri/Mamri.py:1074,
:1113). Here the wire is abstracted behind `Transport` so the same drivers run
over real serial hardware (when pyserial is installed), a `LoopbackTransport`
bound to an in-process simulated device (mamri_tpu_torch/hw/sim.py), or anything
else line-oriented. pyserial is optional — the framework tests and simulator
need no external dependencies.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional, Protocol


class Transport(Protocol):
    def write_line(self, line: str) -> None: ...

    def read_line(self, timeout: Optional[float] = None) -> Optional[str]: ...

    def close(self) -> None: ...

    @property
    def is_open(self) -> bool: ...


def list_serial_ports() -> List[str]:
    """Available serial device names (empty when pyserial is absent)."""
    try:
        from serial.tools import list_ports  # type: ignore
    except ImportError:
        return []
    return [p.device for p in list_ports.comports()]


class SerialTransport:
    """pyserial-backed line transport @115200 baud (gated import)."""

    def __init__(self, port: str, baudrate: int = 115200, timeout: float = 0.05, write_timeout: float = 2.0):
        try:
            import serial  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "pyserial is not installed; real hardware requires it "
                "(use LoopbackTransport + SimulatedRobot otherwise)"
            ) from e
        self._ser = serial.Serial(port, baudrate, timeout=timeout, write_timeout=write_timeout)

    def write_line(self, line: str) -> None:
        self._ser.write(f"{line}\n".encode("ascii"))

    def read_line(self, timeout: Optional[float] = None) -> Optional[str]:
        if timeout is not None:
            self._ser.timeout = timeout
        raw = self._ser.readline()
        if not raw:
            return None
        return raw.decode("ascii", errors="replace").strip()

    def close(self) -> None:
        if self._ser.is_open:
            self._ser.close()

    @property
    def is_open(self) -> bool:
        return bool(self._ser.is_open)

    def flush_input(self) -> None:
        self._ser.reset_input_buffer()


class LoopbackTransport:
    """Thread-safe line transport bound to a simulated device object.

    The device implements `handle_line(line) -> None` and pushes responses via
    the transport's `push_from_device`. Used by the fake controller/encoder.
    """

    def __init__(self, device=None):
        self._device = device
        self._rx: deque[str] = deque()
        self._cv = threading.Condition()
        self._open = True
        if device is not None:
            device.attach_transport(self)

    def write_line(self, line: str) -> None:
        if not self._open:
            raise RuntimeError("transport closed")
        if self._device is not None:
            self._device.handle_line(line.strip())

    def push_from_device(self, line: str) -> None:
        with self._cv:
            self._rx.append(line)
            self._cv.notify_all()

    def read_line(self, timeout: Optional[float] = None) -> Optional[str]:
        with self._cv:
            if not self._rx:
                self._cv.wait(timeout=timeout if timeout is not None else 0.05)
            if self._rx:
                return self._rx.popleft()
            return None

    def close(self) -> None:
        self._open = False
        with self._cv:
            self._cv.notify_all()

    @property
    def is_open(self) -> bool:
        return self._open

    def flush_input(self) -> None:
        with self._cv:
            self._rx.clear()
