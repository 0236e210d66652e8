"""`segment_volume`'s share of its roofline (layer `kernels`): the least
time its contract needs over `seg.device_ms`. The least time is bytes at the
H100's published 3.35 TB/s, counted from shapes whatever kernels implement
the stage: the scan read once at its dtype, the body mask (1 byte a voxel)
and the labels (int32) written once; the blob table is a few hundred bytes.
Integer work at the card's 67 T/s takes less. Needs `seg.device_ms` read
first in the same run."""

from benchmark.lib.common import PEAK_HBM_BYTES_PER_S


def least_bytes(shape, scan_itemsize: int) -> int:
    voxels = 1
    for n in shape:
        voxels *= n
    return voxels * (scan_itemsize + 1 + 4)


def read(run):
    ms = run.facts.get("seg_device_ms")
    if not ms:
        return None
    shape, itemsize = run.facts["seg_scan"]
    return 100.0 * least_bytes(shape, itemsize) / PEAK_HBM_BYTES_PER_S * 1e3 / ms
