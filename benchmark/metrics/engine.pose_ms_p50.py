"""Host-clock ms of `MamriEngine.estimate_pose` (layer `api.engine`) timed as
the window times it, on a fresh host buffer of each scan: the median of
`probe_reps` calls over the first scenes of the window's seeded order. In
this cell the window's own median moves with the host's speed by more than
a bound can hold, so `pose_ms.p50` is reported here, per layer, and the
cell's end-to-end latency is `pose_ms.p90`."""


def read(run):
    import statistics
    import time

    import numpy as np

    from mamri_tpu_torch.perception.volume import Volume

    d = run.data
    ms = []
    for s in d["order"][:run.cell.params["probe_reps"]]:
        np.copyto(d["buffer"], d["scans"][s])
        t0 = time.perf_counter()
        run.engine.estimate_pose(Volume(data=d["buffer"], spacing=d["spacing"], origin=d["origin"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(statistics.median(ms))
