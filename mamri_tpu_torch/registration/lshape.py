"""L-shaped fiducial-triplet matching over all C(K, 3) blob combinations.

Port of `mamri_tpu/registration/lshape.py`: `_combo_table`,
`order_l_shape`, the greedy `best` and `strict` modes
(`match_l_shaped_triplets`) and the `global` mode
(`match_l_shaped_triplets_global`). All combinations are scored at once; the
greedy per-link consumption of blob ids is reproduced with masked
argmin/argmax. `torch.argmax`/`argmin` return the first index among ties, as
`jnp` does (bools are cast to int first). The combination tables are built
once per (K, device) and kept for the process: a captured CUDA graph reads
them by address.
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


@lru_cache(maxsize=None)
def _device_tables(k: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(combos (C, 3) int64, members (C, ceil(k/64)) int64) on `device`, made
    once per (k, device): the combination table, and each combination's
    blob set as bit masks of 64 blobs a word (built on the host, where every
    shift is below 64 and only blob b's own word gets bit b % 64)."""
    combos = _combo_table(k)
    members = np.zeros((len(combos), -(-k // 64)), dtype=np.uint64)
    rows = np.arange(len(combos))
    for m in range(3):
        members[rows, combos[:, m] // 64] |= np.left_shift(np.uint64(1), (combos[:, m] % 64).astype(np.uint64))
    return torch.as_tensor(combos, device=device), torch.as_tensor(members.view(np.int64), device=device)


@lru_cache(maxsize=None)
def _assignment_table(options: int, links: int, device: torch.device) -> torch.Tensor:
    """(options**links, links) int64 on `device`: row a holds the digits of
    a in base `options`, link 0 the least significant (the reference's
    `(a // options**j) % options`)."""
    a = np.arange(options**links, dtype=np.int64)
    return torch.as_tensor(np.stack([(a // options**j) % options for j in range(links)], axis=1), device=device)


def _signatures(points, valid, combos):
    """(C, 3) sorted pairwise distances of every combination, and whether
    its three blobs are all valid."""
    p0, p1, p2 = points[combos[:, 0]], points[combos[:, 1]], points[combos[:, 2]]
    dists = torch.stack(
        [
            torch.linalg.norm(p0 - p1, dim=-1),
            torch.linalg.norm(p0 - p2, dim=-1),
            torch.linalg.norm(p1 - p2, dim=-1),
        ],
        dim=-1,
    )
    members_valid = valid[combos[:, 0]] & valid[combos[:, 1]] & valid[combos[:, 2]]
    return torch.sort(dists, dim=-1).values, members_valid


def _signature_errors(sig, l1: float, l2: float):
    """(C, 3) |signature - expected| against one link's arms."""
    # float32 scalars: the same rounding as the reference's f32 array
    return torch.abs(torch.stack(
        [sig[:, i] - float(np.float32(e)) for i, e in enumerate(expected_distances(l1, l2))], dim=-1
    ))


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
    return torch.where(any_ok, orders.index_select(0, choice.reshape(1))[0], points), any_ok


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
    combos, _ = _device_tables(k, points.device)
    sig, members_valid = _signatures(points, valid, combos)

    used = torch.zeros((k,), dtype=torch.bool, device=points.device)
    out_points, out_found, out_ids = [], [], []
    for l1, l2 in arm_lengths:
        sig_err = _signature_errors(sig, l1, l2)
        fits = (sig_err <= tol).all(-1)
        free = ~(used[combos[:, 0]] | used[combos[:, 1]] | used[combos[:, 2]])
        ok = fits & members_valid & free
        if strict_reference_order:
            choice = torch.argmax(ok.to(torch.int32))
        else:
            choice = torch.argmin(torch.where(ok, sig_err.sum(-1), torch.inf))
        found = ok.any()
        idx = combos.index_select(0, choice.reshape(1))[0]
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


def match_l_shaped_triplets_global(
    points,
    valid,
    arm_lengths: Sequence[Tuple[float, float]],
    tol: float = 5.0,
    top_m: int = 8,
) -> LShapeMatches:
    """Globally optimal link <-> triplet assignment (the `global` mode).

    Per link, the `top_m` lowest-signature-error in-tolerance combinations
    are shortlisted (equal errors: the lower combination index first, as
    `jax.lax.top_k` orders ties); then every one of the (top_m + 1)^J
    choices of {shortlisted triplet | unmatched} per link is scored under
    pairwise disjointness of the chosen blob sets. The objective is
    lexicographic: the most matched links, then the least total signature
    error, in two exact stages (one combined f32 score would round away
    sub-0.5 mm differences), first index on ties. Blob sets are int64 bit
    masks of 64 blobs a word; two sets are disjoint when every word of
    their AND is zero, which for the J chosen sets is the reference's
    "popcount of the union = sum of popcounts"."""
    k = points.shape[0]
    dev = points.device
    nlinks = len(arm_lengths)
    combos, members = _device_tables(k, dev)
    sig, members_valid = _signatures(points, valid, combos)

    cand_idx, cand_err, cand_ok = [], [], []
    for l1, l2 in arm_lengths:
        e = _signature_errors(sig, l1, l2)
        fits = (e <= tol).all(-1) & members_valid
        err = (e[:, 0] + e[:, 1]) + e[:, 2]  # the reference's sum, in its order
        keys = torch.where(fits, -err, -torch.inf)
        vals, idx = torch.sort(keys, descending=True, stable=True)
        vals, idx = vals[:top_m], idx[:top_m]
        cand_idx.append(idx)
        cand_err.append(-vals)
        cand_ok.append(vals > -torch.inf)
    cand_idx = torch.stack(cand_idx)  # (J, M)
    cand_err = torch.stack(cand_err)  # inf where not fitting
    cand_ok = torch.stack(cand_ok)
    cand_mask = torch.where(cand_ok[..., None], members[cand_idx], 0)  # (J, M, W)

    # option M (the last): leave the link unmatched, zero error, no blobs
    opt_err = torch.cat([cand_err, cand_err.new_zeros((nlinks, 1))], 1)
    opt_mask = torch.cat([cand_mask, cand_mask.new_zeros((nlinks, 1, cand_mask.shape[-1]))], 1)
    opt_matched = torch.cat([cand_ok, cand_ok.new_zeros((nlinks, 1))], 1)

    digits = _assignment_table(top_m + 1, nlinks, dev)  # (A, J)
    link_ids = torch.arange(nlinks, device=dev)[None, :]
    a_err = opt_err[link_ids, digits]  # (A, J)
    a_mask = opt_mask[link_ids, digits]  # (A, J, W)
    a_matched = opt_matched[link_ids, digits]

    disjoint = torch.ones(digits.shape[0], dtype=torch.bool, device=dev)
    for i in range(nlinks):
        for j in range(i + 1, nlinks):
            disjoint &= ((a_mask[:, i] & a_mask[:, j]) == 0).all(-1)
    total_err = a_err[:, 0]
    for j in range(1, nlinks):
        total_err = total_err + a_err[:, j]
    n_matched = a_matched.sum(1)
    feasible = disjoint & torch.isfinite(total_err)
    best_matched = torch.where(feasible, n_matched, -1).max()
    tie = feasible & (n_matched == best_matched)
    best = torch.argmin(torch.where(tie, total_err, torch.inf)).reshape(1)

    opt = digits.index_select(0, best)[0]  # (J,) the chosen option per link
    found = opt_matched.gather(1, opt[:, None])[:, 0]
    chosen = cand_idx.gather(1, torch.clamp(opt, max=top_m - 1)[:, None])[:, 0]
    ids = combos.index_select(0, chosen)  # (J, 3)
    out_points = []
    for j, (l1, l2) in enumerate(arm_lengths):
        ordered, _ = order_l_shape(points.index_select(0, ids[j]), l1, l2, tol)
        out_points.append(torch.where(found[j], ordered, 0.0))
    return LShapeMatches(
        points=torch.stack(out_points),
        found=found,
        member_ids=torch.where(found[:, None], ids, -1),
    )
