"""L-shaped fiducial-triplet matching over all C(K, 3) blob combinations.

Port of the `best` and `strict` modes of `mamri_tpu/registration/lshape.py`
(`_combo_table`, `order_l_shape`, `match_l_shaped_triplets`). All
combinations are scored at once; the greedy per-link consumption of blob
ids is reproduced with masked argmin/argmax. `torch.argmax`/`argmin` return
the first index among ties, as `jnp` does (bools are cast to int first).
"""

from __future__ import annotations

import itertools
import math
from functools import lru_cache
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch


class LShapeMatches(NamedTuple):
    points: torch.Tensor  # (J, 3, 3) matched & ordered marker world positions
    found: torch.Tensor  # (J,) bool
    member_ids: torch.Tensor  # (J, 3) blob indices used (or -1)


@lru_cache(maxsize=8)
def _combo_table(k: int) -> np.ndarray:
    """All C(k, 3) index triples in lexicographic (itertools) order."""
    return np.asarray(list(itertools.combinations(range(k), 3)), dtype=np.int64).reshape(-1, 3)


def expected_distances(l1: float, l2: float) -> Tuple[float, float, float]:
    return tuple(sorted([l1, l2, math.hypot(l1, l2)]))


def order_l_shape(points, l1: float, l2: float, tol: float, strict_reference_order: bool = False):
    """Order a triplet as (corner, short-arm end, long-arm end); the
    minimum-error in-tolerance candidate, or the reference's first match when
    `strict_reference_order`. Returns (ordered (3, 3), ordered_ok ())."""
    l_short, l_long = sorted((float(l1), float(l2)))
    orders, conds, errs = [], [], []
    for i in range(3):
        c, p1, p2 = points[i], points[(i + 1) % 3], points[(i + 2) % 3]
        d1 = torch.linalg.norm(c - p1)
        d2 = torch.linalg.norm(c - p2)
        for (first_arm, second_arm), perm in (
            ((l_short, l_long), torch.stack([c, p1, p2])),
            ((l_long, l_short), torch.stack([c, p2, p1])),
        ):
            e1 = torch.abs(d1 - first_arm)
            e2 = torch.abs(d2 - second_arm)
            conds.append((e1 <= tol) & (e2 <= tol))
            errs.append(e1 + e2)
            orders.append(perm)
    conds = torch.stack(conds)
    errs = torch.stack(errs)
    orders = torch.stack(orders)
    any_ok = conds.any()
    if strict_reference_order:
        choice = torch.argmax(conds.to(torch.int32))
    else:
        choice = torch.argmin(torch.where(conds, errs, torch.inf))
    return torch.where(any_ok, orders[choice], points), any_ok


def match_l_shaped_triplets(
    points,
    valid,
    arm_lengths: Sequence[Tuple[float, float]],
    tol: float = 5.0,
    strict_reference_order: bool = False,
) -> LShapeMatches:
    """Greedy per-link triplet assignment over K candidate blobs.

    points: (K, 3) blob centroids (RAS mm); valid: (K,) bool; arm_lengths:
    per marker link (l1, l2), in the order the greedy consumption follows.
    Default: each link takes its minimum-signature-error in-tolerance free
    combination; `strict_reference_order` takes the first in combination
    order, as the reference does."""
    k = points.shape[0]
    dev = points.device
    combos = torch.as_tensor(_combo_table(k), device=dev)
    p0, p1, p2 = points[combos[:, 0]], points[combos[:, 1]], points[combos[:, 2]]
    dists = torch.stack(
        [
            torch.linalg.norm(p0 - p1, dim=-1),
            torch.linalg.norm(p0 - p2, dim=-1),
            torch.linalg.norm(p1 - p2, dim=-1),
        ],
        dim=-1,
    )
    sig = torch.sort(dists, dim=-1).values
    members_valid = valid[combos[:, 0]] & valid[combos[:, 1]] & valid[combos[:, 2]]

    used = torch.zeros((k,), dtype=torch.bool, device=dev)
    out_points, out_found, out_ids = [], [], []
    for l1, l2 in arm_lengths:
        # float32 scalars: the same rounding as the reference's f32 array
        sig_err = torch.abs(torch.stack(
            [sig[:, i] - float(np.float32(e)) for i, e in enumerate(expected_distances(l1, l2))], dim=-1
        ))
        fits = (sig_err <= tol).all(-1)
        free = ~(used[combos[:, 0]] | used[combos[:, 1]] | used[combos[:, 2]])
        ok = fits & members_valid & free
        if strict_reference_order:
            choice = torch.argmax(ok.to(torch.int32))
        else:
            choice = torch.argmin(torch.where(ok, sig_err.sum(-1), torch.inf))
        found = ok.any()
        idx = combos[choice]
        ordered, _ = order_l_shape(points[idx], l1, l2, tol, strict_reference_order)
        used = used | (torch.zeros_like(used).index_fill(0, idx, True) & found)
        out_points.append(torch.where(found, ordered, 0.0))
        out_found.append(found)
        out_ids.append(torch.where(found, idx, -1))
    return LShapeMatches(
        points=torch.stack(out_points),
        found=torch.stack(out_found),
        member_ids=torch.stack(out_ids),
    )
