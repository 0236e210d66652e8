"""Multi-generation serving soak of the PyTorch port: frames through
`python -m mamri_tpu_torch serve --supervise` until its RSS budget has
recycled the worker N times.

The port's counterpart of tools/soak_supervised.py, with its protocol and
its JSON keys (SOAK_r05.json). It launches the real supervisor, measures a
first worker's warm host RSS (`base_rss_mb`) after one /estimate, then
starts a supervisor whose workers drain at `base + --budget-headroom-mb`
(`--max-rss-mb`: a drained worker exits 3 and the supervisor starts a fresh
one), posts path-mode /estimate frames of one NIfTI scan on disk, rides
through each recycle (503 while draining, then a refused connection, then
a fresh worker) and records the frames of each generation and the worker's
RSS. A worker whose RSS stays flat under the budget is never recycled: the
run then stops at --max-frames with fewer generations than asked, `ok`
false and `leak_mb_per_frame_est` null, which says that the worker's
memory levels off.

Prints one JSON line (and writes it to --out); exits 0 when `ok`.

    python tools/soak_supervised_torch.py [--size 128] [--generations 3]
        [--budget-headroom-mb 400] [--max-frames 2000] [--out FILE] [--cpu]
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np


def _free_port():
    """A loopback port that the kernel reports free now (bound to port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read(r):
    try:
        return json.loads(r.read() or b"{}")
    except (ValueError, OSError):
        return {}


def _get(url, timeout=600):
    # a 503 while draining is data here, not an error
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, _read(r)
    except urllib.error.HTTPError as e:
        return e.code, _read(e)


def _post(url, payload, timeout=1800):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, _read(r)
    except urllib.error.HTTPError as e:
        return e.code, _read(e)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--generations", type=int, default=3)
    ap.add_argument("--budget-headroom-mb", type=float, default=400.0,
                    help="RSS budget = the first worker's warm RSS + this")
    ap.add_argument("--max-frames", type=int, default=2000, help="hard stop")
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true", help="workers on the CPU (default: the card)")
    return ap.parse_args(argv)


def soak(args, data_root, scan):
    """The soak over a running supervisor; -> the JSON record."""
    port = _free_port()  # the server sets SO_REUSEADDR, so each worker rebinds it
    base_url = f"http://127.0.0.1:{port}"
    frame_mb = os.path.getsize(os.path.join(data_root, scan)) / 1e6
    log_path = os.path.join(data_root, "supervisor.log")

    def launch(budget_mb):
        cmd = [sys.executable, "-m", "mamri_tpu_torch", "serve", "--supervise",
               "--port", str(port), "--data-root", data_root,
               "--max-restarts", str(args.generations + 2)]
        if budget_mb is not None:
            cmd += ["--max-rss-mb", str(budget_mb)]
        if args.cpu:
            cmd += ["--platform", "cpu"]
        with open(log_path, "ab") as log:
            return subprocess.Popen(cmd, stdout=log, stderr=log, cwd=REPO)

    def wait_healthy(deadline_s=1200):
        t0 = time.time()
        while time.time() - t0 < deadline_s:
            try:
                if _get(f"{base_url}/healthz", timeout=10)[0] == 200:
                    return True
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
            time.sleep(0.25)
        return False

    def stop(sup):
        try:
            _post(f"{base_url}/shutdown", {}, timeout=60)
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        try:
            sup.wait(timeout=120)
        except subprocess.TimeoutExpired:
            sup.terminate()
            sup.wait(timeout=30)

    # phase 1: an unbudgeted worker gives the warm baseline RSS
    sup = launch(None)
    try:
        if not wait_healthy():
            raise RuntimeError("supervised worker never became healthy")
        _post(f"{base_url}/estimate", {"path": scan})  # warm
        base_rss = float(_get(f"{base_url}/status")[1]["rss_mb"])
    finally:
        stop(sup)

    budget = base_rss + args.budget_headroom_mb
    sup = launch(budget)
    gens = frames = failures = gen_frames = 0
    rss_at_drain, frames_per_gen, rss_max = [], [], 0.0
    t_start = time.time()
    try:
        if not wait_healthy():
            raise RuntimeError("budgeted worker never became healthy")
        while gens < args.generations and frames < args.max_frames:
            try:
                st, out = _post(f"{base_url}/estimate", {"path": scan})
            except (urllib.error.URLError, ConnectionError, OSError):
                # the worker is already gone (the 503 window can be shorter than
                # a request): count the generation and wait for the next worker
                if gen_frames:
                    gens += 1
                    frames_per_gen.append(gen_frames)
                    gen_frames = 0
                if not wait_healthy():
                    raise RuntimeError("worker did not come back after a recycle")
                continue
            if st == 503:  # draining
                gens += 1
                frames_per_gen.append(gen_frames)
                gen_frames = 0
                if not wait_healthy():
                    raise RuntimeError("worker did not come back after a drain")
                continue
            frames += 1
            gen_frames += 1
            if st != 200 or not out.get("success"):
                failures += 1
            if frames % 5 == 0 or gen_frames == 1:
                try:
                    stat = _get(f"{base_url}/status", timeout=60)[1]
                except (urllib.error.URLError, ConnectionError, OSError):
                    continue  # the worker went between two requests
                if "rss_mb" in stat:
                    rss_max = max(rss_max, float(stat["rss_mb"]))
                    if stat.get("draining"):
                        rss_at_drain.append(float(stat["rss_mb"]))
    finally:
        stop(sup)
    if gen_frames:
        frames_per_gen.append(gen_frames)

    leak = None
    if gens and frames_per_gen and frames_per_gen[0] > 1:
        leak = round(args.budget_headroom_mb / max(np.mean([f for f in frames_per_gen if f > 0]), 1), 2)
    return {
        "metric": "soak_supervised",
        "generations": gens,
        "frames": frames,
        "failures": failures,
        "frames_per_generation": frames_per_gen,
        "base_rss_mb": round(base_rss, 1),
        "budget_mb": round(budget, 1),
        "max_rss_mb": round(rss_max, 1),
        "rss_bounded": bool(rss_max <= budget * 1.15),
        "frame_file_mb": round(frame_mb, 2),
        "leak_mb_per_frame_est": leak,
        "wall_s": round(time.time() - t_start, 1),
        "ok": bool(gens >= args.generations and failures == 0 and rss_max <= budget * 1.15),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    from mamri_tpu_torch.api.demo import build_demo_scene
    from mamri_tpu_torch.api.engine import MamriEngine
    from mamri_tpu_torch.perception.io import save_nifti
    from mamri_tpu_torch.perception.volume import Volume

    # this process only builds the scan and speaks HTTP: the card belongs to
    # the workers under test; every request reads the file anew
    vol, _, _, _ = build_demo_scene(MamriEngine(device="cpu"), spacing=max(2.0, 320.0 / args.size))
    with tempfile.TemporaryDirectory(prefix="soak_sup_") as data_root:
        save_nifti(os.path.join(data_root, "frame.nii"),
                   Volume(np.asarray(vol.data).astype(np.int16), vol.spacing, vol.origin))
        try:
            out = soak(args, data_root, "frame.nii")
        except Exception:
            with open(os.path.join(data_root, "supervisor.log"), errors="replace") as f:
                sys.stderr.write(f.read()[-4000:])
            raise
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
