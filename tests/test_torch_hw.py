"""The port's hardware loop: its copies of `hw/` driven through the scenarios
of tests/test_hw.py, tests/test_actions.py and tests/test_watch.py (the
broker and the executor wiring; the server's routes wait for the port's
server), and the engine's `attach_hardware` against mamri_tpu's.

Fake clocks keep the closed-loop scenarios deterministic; the one test on
the real wall clock runs for about a second, as the reference's soak does.
The twin-rig test gives a CPU engine of the port and mamri_tpu's engine the
same state and the same keyframes on two simulated rigs under one fake
clock: the published frames must be equal except for their wall-clock
`"t"` (`tcp_world` within 1e-3 mm: both take the float64 host FK), and the
final encoder steps and engine angles equal.
"""

import threading
import time

import numpy as np
import pytest

from mamri_tpu.api import MamriEngine as JaxEngine
from mamri_tpu.hw.sim import SimulatedEncoder as JaxSimEncoder
from mamri_tpu.hw.sim import SimulatedMotorController as JaxSimController
from mamri_tpu.hw.sim import SimulatedRobot as JaxSimRobot
from mamri_tpu.hw.transport import LoopbackTransport as JaxLoopback
from mamri_tpu_torch.api.engine import MamriEngine
from mamri_tpu_torch.hw.devices import EncoderLink, MotorControllerLink
from mamri_tpu_torch.hw.executor import RobotTaskRunner, TaskOutcome
from mamri_tpu_torch.hw.sim import SimulatedEncoder, SimulatedMotorController, SimulatedRobot, simulated_hardware
from mamri_tpu_torch.hw.stream import PoseStream
from mamri_tpu_torch.hw.sync import SyncMonitor
from mamri_tpu_torch.hw.transport import LoopbackTransport
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _engine():
    return MamriEngine(device="cpu")


@pytest.fixture()
def rig():
    clock = FakeClock()
    robot = SimulatedRobot(speed_steps_per_s=400.0, clock=clock)
    mc_dev = SimulatedMotorController(robot)
    enc_dev = SimulatedEncoder(robot)
    mc = MotorControllerLink(LoopbackTransport(mc_dev))
    enc = EncoderLink(LoopbackTransport(enc_dev))
    assert mc.handshake()
    enc_dev.emit()  # first line for the handshake
    assert enc.handshake()
    yield clock, robot, mc_dev, enc_dev, mc, enc
    enc.disconnect()
    mc.disconnect()


def _until(pred, timeout_s=2.0):
    """Poll `pred` until it holds or `timeout_s` passes; its last value.
    The encoder's listener is a thread, and a fixed sleep may end before
    the scheduler has run it."""
    deadline = time.time() + timeout_s
    while not pred() and time.time() < deadline:
        time.sleep(0.001)
    return pred()


def _tick(clock, robot, enc_dev, enc, dt=0.15):
    """Advance the fake clock, emit one encoder line and wait until the
    listener has parsed it (the fake clock stands still meanwhile, so the
    robot's position is the line's)."""
    clock.advance(dt)
    enc_dev.emit()
    assert _until(lambda: enc.latest_position == robot.true_position()), "the listener missed an encoder line"


# ------------------------------------------------------ tests/test_hw.py
def test_handshake_wrong_device():
    enc_dev = SimulatedEncoder(SimulatedRobot(clock=FakeClock()))
    assert not MotorControllerLink(LoopbackTransport(enc_dev)).handshake()


def test_position_query_roundtrip(rig):
    clock, robot, mc_dev, enc_dev, mc, enc = rig
    assert mc.query_positions() == [0] * 6
    mc.command_pose([100, -50, 30, 0, 0, 0])
    clock.advance(10.0)
    assert mc.query_positions() == [100, -50, 30, 0, 0, 0]


def test_encoder_listener_tracks_motion_and_skips_garbage(rig):
    clock, robot, mc_dev, enc_dev, mc, enc = rig
    enc_dev.garbage_every = 2  # every other line corrupt
    mc.command_pose([200, 0, 0, 0, 0, 0])
    clock.advance(10.0)
    for _ in range(4):
        enc_dev.emit()
    _until(lambda: enc.latest_position[0] == 200, timeout_s=1.0)
    assert enc.latest_position[0] == 200


def test_executor_move_to_pose_success(rig):
    clock, robot, mc_dev, enc_dev, mc, enc = rig
    runner = RobotTaskRunner(mc, enc, clock=clock)
    runner.start("move_to_pose", target_steps=[120, 40, -60, 10, 0, 5])
    for _ in range(100):
        _tick(clock, robot, enc_dev, enc)
        st = runner.step()
        if st.outcome is not TaskOutcome.RUNNING:
            break
    assert st.outcome is TaskOutcome.SUCCESS
    assert enc.latest_position == [120, 40, -60, 10, 0, 5]


def test_executor_trajectory_keyframes(rig):
    clock, robot, mc_dev, enc_dev, mc, enc = rig
    kfs = [np.array([50, 0, 0, 0, 0, 0]), np.array([50, 80, 0, 0, 0, 0]), np.array([0, 80, 20, 0, 0, 0])]
    runner = RobotTaskRunner(mc, enc, clock=clock)
    runner.start("trajectory", keyframes=kfs)
    seen = set()
    for _ in range(300):
        seen.add(tuple(runner.state.target_steps.tolist()))
        _tick(clock, robot, enc_dev, enc)
        st = runner.step()
        if st.outcome is not TaskOutcome.RUNNING:
            break
    assert st.outcome is TaskOutcome.SUCCESS
    assert len(seen) == 3  # visited every keyframe
    assert enc.latest_position == [0, 80, 20, 0, 0, 0]


def test_executor_stall_reissues_command(rig):
    clock, robot, mc_dev, enc_dev, mc, enc = rig
    robot.inject_stall([0])  # joint 0 slips: the controller counts, the mechanism does not
    runner = RobotTaskRunner(mc, enc, clock=clock)
    runner.start("jog", target_steps=[100, 0, 0, 0, 0, 0])
    reissues, last = 0, runner.state.last_command_time
    for _ in range(60):
        _tick(clock, robot, enc_dev, enc)
        st = runner.step()
        if st.last_command_time != last:
            reissues, last = reissues + 1, st.last_command_time
        if st.outcome is not TaskOutcome.RUNNING:
            break
    assert reissues >= 2


def test_executor_timeout(rig):
    clock, robot, mc_dev, enc_dev, mc, enc = rig
    robot.inject_stall([0])
    runner = RobotTaskRunner(mc, enc, clock=clock)
    runner.start("move_to_pose", target_steps=[500, 0, 0, 0, 0, 0], timeout_s=5.0)
    for _ in range(100):
        _tick(clock, robot, enc_dev, enc, dt=0.3)
        st = runner.step()
        if st.outcome is not TaskOutcome.RUNNING:
            break
    assert st.outcome is TaskOutcome.TIMEOUT


def test_executor_user_stop_soft_stops(rig):
    clock, robot, mc_dev, enc_dev, mc, enc = rig
    runner = RobotTaskRunner(mc, enc, clock=clock)
    runner.start("move_to_pose", target_steps=[10000, 0, 0, 0, 0, 0])
    _tick(clock, robot, enc_dev, enc, dt=0.5)
    runner.step()
    runner.request_stop()
    assert runner.step().outcome is TaskOutcome.STOPPED
    # the soft stop commanded the current position, not the far target
    assert abs(robot.targets[0] - robot.controller_counts[0]) < 500


def test_zeroing_protocol(rig):
    clock, robot, mc_dev, enc_dev, mc, enc = rig
    mc.command_pose([300, 0, 0, 0, 0, 0])
    _tick(clock, robot, enc_dev, enc, dt=10.0)
    assert enc.latest_position[0] == 300
    enc.reset_counters()
    mc.zero_counters()
    enc_dev.emit()
    _until(lambda: enc.latest_position[0] == 0)
    assert enc.latest_position[0] == 0 and mc.query_positions()[0] == 0


def test_sync_monitor_corrects_drift(rig):
    """A one-time slip of 30 steps mid-move: the settle check overwrites
    the controller's counters and the outstanding target re-drives the
    joint, until both agree at the target."""
    clock, robot, mc_dev, enc_dev, mc, enc = rig
    sync = SyncMonitor(mc, enc)
    mc.command_pose([150, 200, 0, 0, 0, 0])
    clock.advance(0.2)
    robot.advance()
    robot.missed_steps[1] += 30.0
    for _ in range(10):
        _tick(clock, robot, enc_dev, enc, dt=0.25)
        sync.step()
    assert sync.corrections >= 1
    for _ in range(20):
        _tick(clock, robot, enc_dev, enc, dt=0.25)
        sync.step()
    assert mc.query_positions() == enc.latest_position == [150, 200, 0, 0, 0, 0]


def test_wall_clock_soak_free_running_encoder():
    """About a second of real wall time: a free-running encoder thread with
    corrupt lines, the blocking `run` loop and the background sync loop
    together, through the port's engine; arrival, live updates throughout,
    the engine's pose following, and a clean shutdown."""
    robot = SimulatedRobot(speed_steps_per_s=1500.0, clock=time.time)
    enc_dev = SimulatedEncoder(robot)
    tp_mc, tp_enc = LoopbackTransport(SimulatedMotorController(robot)), LoopbackTransport(enc_dev)
    stop_emit = threading.Event()

    def emitter():
        while not stop_emit.is_set():
            enc_dev.emit()
            time.sleep(0.004)

    emit_thread = threading.Thread(target=emitter, daemon=True)
    emit_thread.start()
    engine = _engine()
    stack = engine.attach_hardware(tp_mc, tp_enc)
    enc_dev.garbage_every = 7
    stop_sync = stack.start_sync_loop(interval_s=0.05)
    observed = []
    engine_cb = stack.runner.pose_callback

    def spy_cb(steps):
        observed.append(np.asarray(steps).copy())
        engine_cb(steps)

    stack.runner.pose_callback = spy_cb
    target = [900, -600, 450, 300, -200, 120]
    stack.runner.start("move", target_steps=target, timeout_s=15.0)
    t0 = time.time()
    state = stack.runner.run(tick_interval_s=0.01)
    elapsed = time.time() - t0
    stop_sync()
    stop_emit.set()
    emit_thread.join(timeout=2.0)
    assert not emit_thread.is_alive()
    stack.disconnect()

    assert state.outcome is TaskOutcome.SUCCESS, (state.outcome, state.message)
    assert elapsed < 10.0
    assert len({tuple(p) for p in observed}) > 5
    np.testing.assert_array_equal(observed[-1], target)
    np.testing.assert_array_equal(engine.current_angles, engine.convert_steps_to_angles(np.asarray(target)))


# ------------------------------------------------- tests/test_actions.py
def _attach_sim(engine):
    robot = SimulatedRobot(speed_steps_per_s=2000.0)
    enc_dev = SimulatedEncoder(robot)
    enc_tp = LoopbackTransport(enc_dev)
    enc_dev.emit()  # a line for the encoder's handshake
    return engine.attach_hardware(LoopbackTransport(SimulatedMotorController(robot)), enc_tp), enc_dev


def test_gating_fresh_engine():
    eng = _engine()
    assert eng.hardware is None
    acts = eng.available_actions()
    assert not acts["estimate_pose"] and "input volume" in acts["estimate_pose"].reason
    for k in ("plan_trajectory", "zero_robot", "playback", "execute_trajectory", "stop_trajectory",
              "return_to_zero", "move_to_pose", "manual_control", "zero_hardware", "encoder_command"):
        assert not acts[k], k
    for k in ("connect_controller", "refresh_ports", "connect_encoder"):
        assert acts[k], k
    acts = eng.available_actions(have_volume=True)
    assert acts["estimate_pose"] and not acts["plan_trajectory"]


def test_gating_model_built_and_planned():
    eng = _engine()
    eng.baseplate_tf = np.eye(4, dtype=np.float32)
    acts = eng.available_actions(have_target=True, have_entry=True)
    assert acts["zero_robot"] and acts["plan_trajectory"]
    assert not _engine().available_actions(have_target=True, have_entry=True)["plan_trajectory"]
    assert not acts["playback"]
    eng.trajectory_path = np.zeros((5, 6), dtype=np.float32)
    assert eng.available_actions()["playback"]
    assert not acts["execute_trajectory"] and not acts["move_to_pose"]


def test_gating_hardware_and_execution():
    eng = _engine()
    hw, enc_dev = _attach_sim(eng)
    try:
        acts = eng.available_actions()
        assert acts["return_to_zero"] and acts["manual_control"]
        assert acts["zero_hardware"] and acts["encoder_command"]
        assert not acts["move_to_pose"]
        eng.last_estimated_steps = np.zeros(6, dtype=int)
        assert eng.available_actions()["move_to_pose"]
        assert not acts["execute_trajectory"]
        eng.trajectory_keyframes = np.zeros((4, 6), dtype=np.float32)
        assert eng.available_actions()["execute_trajectory"]
        hw.return_to_zero()
        running = eng.available_actions()
        assert running["stop_trajectory"]
        for k in ("execute_trajectory", "return_to_zero", "move_to_pose", "manual_control", "zero_hardware",
                  "encoder_command", "connect_controller", "refresh_ports", "connect_encoder"):
            assert not running[k], k
        hw.stop()
        enc_dev.emit()
        hw.runner.step()  # sees the stop request: the task retires
        assert not eng.available_actions()["stop_trajectory"]
    finally:
        hw.disconnect()


def test_pose_table_rows():
    eng = _engine()
    rows = eng.pose_table(title="Start Pose")
    assert rows[0] == ("Start Pose", "Steps", "Degrees (°)")
    assert len(rows) == 1 + eng.model.num_joints and all(r[1:] == ("...", "...") for r in rows[1:])
    pose = np.deg2rad([10.0, -15.0, 0.0, 5.0, 0.0, 90.0])
    rows = eng.pose_table(pose)
    assert [r[2] for r in rows[1:]] == ["10.00", "-15.00", "0.00", "5.00", "0.00", "90.00"]
    assert [r[1] for r in rows[1:]] == [str(int(s)) for s in eng.convert_angles_to_steps(pose)]


def test_joint_status_table():
    eng = _engine()
    hw, enc_dev = _attach_sim(eng)
    try:
        enc_dev.emit()
        rows = hw.joint_status_table()
        assert rows[0] == ("Joint", "Encoder (steps)", "Controller (steps)", "Target (steps)")
        assert len(rows) == 1 + eng.model.num_joints
        assert all(r[1] == "0" and r[2] == "0" and r[3] == "..." for r in rows[1:])
    finally:
        hw.disconnect()


# --------------------------------------------------- tests/test_watch.py
def test_pose_stream_fanout_and_seq():
    s = PoseStream()
    a, b = s.subscribe(), s.subscribe()
    s.publish({"event": "pose", "x": 1})
    s.publish({"event": "pose", "x": 2})
    assert a.get(0.1)["x"] == 1 and a.get(0.1)["x"] == 2
    assert b.get(0.1)["seq"] == 1 and s.last_frame["seq"] == 2
    a.close()
    s.publish({"event": "pose", "x": 3})
    assert b.get(0.1)["x"] == 2 and b.get(0.1)["x"] == 3
    assert s.num_subscribers == 1
    b.close()


def test_pose_stream_drop_oldest_never_blocks():
    s = PoseStream()
    sub = s.subscribe(maxlen=4)
    for i in range(10):
        s.publish({"i": i})
    assert sub.dropped == 6
    assert [sub.get(0.05)["i"] for _ in range(4)] == [6, 7, 8, 9]
    assert sub.get(0.05) is None
    sub.close()


def test_pose_stream_close_wakes_blocked_consumer():
    s = PoseStream()
    sub = s.subscribe()
    out = []
    t = threading.Thread(target=lambda: out.append(sub.get(timeout=5.0)))
    t.start()
    time.sleep(0.05)
    s.close()
    t.join(timeout=2.0)
    assert not t.is_alive() and out == [None] and sub.closed


def test_frames_stops_at_terminal():
    s = PoseStream()
    sub = s.subscribe()
    s.publish({"event": "pose"})
    s.publish({"event": "task_finished", "outcome": "success"})
    s.publish({"event": "pose"})
    assert [f["event"] for f in sub.frames(idle_timeout_s=0.2)] == ["pose", "task_finished"]
    sub.close()


@pytest.fixture()
def sim_rig():
    eng = _engine()
    stack, robot, shutdown = simulated_hardware(eng, speed_steps_per_s=4000.0)
    yield eng, stack, robot
    shutdown()


def test_executor_publishes_pose_frames_and_terminal(sim_rig):
    eng, stack, _ = sim_rig
    eng.baseplate_tf = np.eye(4, dtype=np.float32)  # frames carry tcp_world from here on
    sub = stack.stream.subscribe()
    stack.move_to_pose([400, 0, 0, 0, 0, 0], timeout_s=20.0)
    state = stack.runner.run(tick_interval_s=0.02)
    assert state.outcome.value == "success"
    frames = list(sub.frames(idle_timeout_s=0.5))
    sub.close()
    poses = [f for f in frames if f["event"] == "pose"]
    assert len(poses) >= 2 and frames[-1]["event"] == "task_finished" and frames[-1]["outcome"] == "success"
    p = poses[-1]
    assert p["target_steps"] == [400, 0, 0, 0, 0, 0]
    assert len(p["steps"]) == 6 and len(p["angles_deg"]) == 6 and len(p["tcp_world"]) == 3
    assert abs(eng.current_angles[0] - 400 * 2 * np.pi / 3332.0) < 0.05
    st = stack.status()
    assert st["controller_steps"] == [400, 0, 0, 0, 0, 0] and not st["task_active"]
    assert stack.passive_status()["outcome"] == "success"


def test_stack_watch_generator(sim_rig):
    _, stack, _ = sim_rig
    frames = []
    t = threading.Thread(target=lambda: frames.extend(stack.watch(idle_timeout_s=2.0)))
    t.start()
    stack.move_to_pose([200, 0, 0, 0, 0, 0], timeout_s=20.0)
    stack.runner.run(tick_interval_s=0.02)
    t.join(timeout=5.0)
    assert not t.is_alive() and frames and frames[-1]["event"] == "task_finished"


# ----------------------------------------- the engine against mamri_tpu's
BASE = np.array([[0.9553365, -0.2955202, 0.0, -60.0], [0.0, 0.0, 1.0, -120.0], [-0.2955202, -0.9553365, 0.0, 0.0],
                 [0.0, 0.0, 0.0, 1.0]], np.float32)
KEYFRAMES = np.array([[0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.05, -0.1, 0.08, 0.0, 0.0, 0.1],
                      [0.05, -0.1, 0.15, 0.1, -0.05, 0.2], [-0.02, 0.04, 0.1, 0.12, -0.08, 0.15]], np.float32)


def _twin(engine, robot_cls, ctl_cls, enc_cls, loop_cls, clock):
    robot = robot_cls(speed_steps_per_s=400.0, clock=clock)
    enc_dev = enc_cls(robot)
    enc_tp = loop_cls(enc_dev)
    enc_dev.emit()
    engine.baseplate_tf = BASE.copy()
    engine.current_angles = np.array([0.1, -0.2, 0.1, 0.0, 0.3, -0.1], np.float32)
    stack = engine.attach_hardware(loop_cls(ctl_cls(robot)), enc_tp)
    return stack, robot, enc_dev


def test_attach_hardware_matches_jax():
    clock = FakeClock()
    ours, theirs = MamriEngine(device="cpu"), JaxEngine()
    rigs = [_twin(ours, SimulatedRobot, SimulatedMotorController, SimulatedEncoder, LoopbackTransport, clock),
            _twin(theirs, JaxSimRobot, JaxSimController, JaxSimEncoder, JaxLoopback, clock)]
    subs = [stack.stream.subscribe() for stack, _, _ in rigs]
    try:
        for stack, _, _ in rigs:
            stack.execute_trajectory(list(KEYFRAMES), timeout_s=1e6)
        for _ in range(200):
            clock.advance(0.15)
            for stack, robot, enc_dev in rigs:
                enc_dev.emit()
                # the listener has parsed exactly this line
                _until(lambda: stack.encoder.latest_position == robot.true_position())
            states = [stack.runner.step() for stack, _, _ in rigs]
            assert states[0].outcome.value == states[1].outcome.value
            assert states[0].keyframe_index == states[1].keyframe_index
            if states[0].outcome is not TaskOutcome.RUNNING:
                break
        assert states[0].outcome is TaskOutcome.SUCCESS, states[0].message
        frames = [list(sub.frames(idle_timeout_s=0.2)) for sub in subs]
    finally:
        for sub in subs:
            sub.close()
        for stack, _, _ in rigs:
            stack.disconnect()
    assert len(frames[0]) == len(frames[1]) > 4 and frames[0][-1]["event"] == "task_finished"
    for got, want in zip(*frames):
        assert set(got) == set(want)
        tcp_got, tcp_want = got.pop("tcp_world", None), want.pop("tcp_world", None)
        if tcp_want is not None:
            np.testing.assert_allclose(tcp_got, tcp_want, atol=1e-3 + 1e-9)
        got.pop("t")
        want.pop("t")
        assert got == want
    last = ours.convert_angles_to_steps(KEYFRAMES[-1]).tolist()
    assert rigs[0][0].encoder.latest_position == rigs[1][0].encoder.latest_position == last
    np.testing.assert_array_equal(ours.current_angles, theirs.current_angles)
    np.testing.assert_array_equal(ours.current_angles, ours.convert_steps_to_angles(np.asarray(last)))


def test_available_serial_ports_and_playback():
    """`available_serial_ports` and `playback` as mamri_tpu's."""
    assert MamriEngine.available_serial_ports() == JaxEngine.available_serial_ports()
    eng = _engine()
    with pytest.raises(RuntimeError, match="no trajectory planned"):
        eng.playback()
    eng.trajectory_path = np.linspace(np.zeros(6), KEYFRAMES[-1], 5).astype(np.float32)
    cursor = eng.playback()
    slept = []
    cursor.play(sleep=slept.append)
    assert len(slept) == 4 and cursor.index == 4 and not cursor.playing
    np.testing.assert_array_equal(eng.current_angles, eng.trajectory_path[-1])
    cursor.rewind()
    np.testing.assert_array_equal(eng.current_angles, eng.trajectory_path[0])
