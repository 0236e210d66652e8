from mamri_tpu_torch.hw.devices import EncoderLink, MotorControllerLink
from mamri_tpu_torch.hw.executor import RobotTaskRunner, TaskOutcome, TaskState
from mamri_tpu_torch.hw.sim import SimulatedEncoder, SimulatedMotorController, SimulatedRobot
from mamri_tpu_torch.hw.sync import SyncMonitor
from mamri_tpu_torch.hw.transport import LoopbackTransport, SerialTransport, Transport, list_serial_ports

__all__ = [
    "MotorControllerLink",
    "EncoderLink",
    "RobotTaskRunner",
    "TaskState",
    "TaskOutcome",
    "SimulatedRobot",
    "SimulatedMotorController",
    "SimulatedEncoder",
    "SyncMonitor",
    "Transport",
    "SerialTransport",
    "LoopbackTransport",
    "list_serial_ports",
]
