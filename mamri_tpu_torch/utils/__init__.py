from mamri_tpu_torch.utils.stl import load_stl, sample_surface_points
from mamri_tpu_torch.utils.trace import Tracer, span

__all__ = ["load_stl", "sample_surface_points", "Tracer", "span"]
