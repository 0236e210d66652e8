from mamri_tpu_torch.perception.volume import Volume, synthetic_volume, lps_to_ras, ras_to_lps
from mamri_tpu_torch.perception.segmentation import SegmentationParams, SegmentationResult, segment_volume
from mamri_tpu_torch.perception.io import load_nifti, save_nifti, resample_to_axis_aligned, volume_from_affine
from mamri_tpu_torch.perception.formats import (
    load_metaimage,
    load_nrrd,
    load_seg_nrrd,
    load_volume,
    save_metaimage,
    save_nrrd,
    save_seg_nrrd,
    save_volume,
)
from mamri_tpu_torch.perception.dicom import (
    load_dicom,
    load_dicom_series,
    save_dicom_multiframe,
    save_dicom_series,
)

__all__ = [
    "Volume",
    "synthetic_volume",
    "lps_to_ras",
    "ras_to_lps",
    "SegmentationParams",
    "SegmentationResult",
    "segment_volume",
    "load_nifti",
    "save_nifti",
    "load_nrrd",
    "load_seg_nrrd",
    "save_nrrd",
    "save_seg_nrrd",
    "load_metaimage",
    "save_metaimage",
    "load_volume",
    "save_volume",
    "resample_to_axis_aligned",
    "volume_from_affine",
    "load_dicom",
    "load_dicom_series",
    "save_dicom_multiframe",
    "save_dicom_series",
]
