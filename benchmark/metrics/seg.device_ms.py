"""CUDA-event ms of the public `segment_volume` (layer
`perception.segmentation`) on the cell's first scan, resident on the card,
at the engine's segmentation settings: each call behind an L2-flushing read
and a spin kernel; the median of `probe_reps`. Kept in `run.facts` for the
roofline reader."""


def read(run):
    if run.cell.device != "cuda":
        return None
    import torch

    from benchmark.lib.trace import StageTimer
    from mamri_tpu_torch.perception.segmentation import segment_volume

    d, eng = run.data, run.engine
    scan = torch.as_tensor(d["scans"][0]).to("cuda")
    spacing = torch.as_tensor(d["spacing"], device="cuda")
    origin = torch.as_tensor(d["origin"], device="cuda")
    ms = StageTimer().ms(lambda: segment_volume(scan, spacing, origin, eng.seg_params), run.cell.params["probe_reps"])
    run.facts["seg_device_ms"] = ms
    run.facts["seg_scan"] = (tuple(scan.shape), scan.element_size())
    return ms
