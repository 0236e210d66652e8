from mamri_tpu_torch.registration.kabsch import kabsch_rigid_transform
from mamri_tpu_torch.registration.lshape import (
    LShapeMatches,
    match_l_shaped_triplets,
    match_l_shaped_triplets_global,
    order_l_shape,
)

__all__ = [
    "kabsch_rigid_transform",
    "LShapeMatches",
    "match_l_shaped_triplets",
    "match_l_shaped_triplets_global",
    "order_l_shape",
]
