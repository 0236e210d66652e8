"""The port's Kabsch fit, L-shape matchers (`best`, `strict`, `global`) and
batched LM against mamri_tpu's.

The global matcher is held to JAX's `match_l_shaped_triplets_global` (called
alone, eagerly) on the reference's own cases (tests/test_lshape.py): equal
`found` and `member_ids`, points within 1e-4 mm."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mamri_tpu.ik.lm import least_squares_lm as j_lm
from mamri_tpu.registration.kabsch import kabsch_rigid_transform as j_kabsch
from mamri_tpu.registration.lshape import match_l_shaped_triplets as j_match
from mamri_tpu.registration.lshape import match_l_shaped_triplets_global as j_global
from mamri_tpu.registration.lshape import order_l_shape as j_order
from mamri_tpu_torch.ik.lm import least_squares_lm as t_lm
from mamri_tpu_torch.registration.kabsch import kabsch_rigid_transform as t_kabsch
from mamri_tpu_torch.registration.lshape import match_l_shaped_triplets as t_match
from mamri_tpu_torch.registration.lshape import match_l_shaped_triplets_global as t_global
from mamri_tpu_torch.registration.lshape import order_l_shape as t_order
from kabsch_cases import random_rotation as _random_rotation
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

ARMS = [(40.0, 20.0), (70.0, 25.0), (70.0, 20.0), (45.0, 20.0)]  # the MAMRI signatures


def test_kabsch_matches_jax_batched():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(6, 3, 3)).astype(np.float32) * 30  # coplanar triplets, as on the markers
    tgt = np.stack([s @ _random_rotation(rng).T + rng.normal(size=3) * 50 for s in src]).astype(np.float32)
    tgt += rng.normal(size=tgt.shape).astype(np.float32) * 0.2
    want = np.asarray(j_kabsch(jnp.asarray(src), jnp.asarray(tgt)))
    got = t_kabsch(torch.as_tensor(src), torch.as_tensor(tgt)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)  # rotation entries and mm


def _l_triplet(rng, l1, l2):
    r = _random_rotation(rng)
    c = rng.uniform(-100, 100, 3)
    return np.stack([c, c + l2 * r[:, 0], c + l1 * r[:, 1]]) if l1 > l2 else np.stack(
        [c, c + l1 * r[:, 0], c + l2 * r[:, 1]]
    )


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_matcher_matches_jax(strict, seed):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([_l_triplet(rng, *a) for a in ARMS] + [rng.uniform(-150, 150, (5, 3))])
    pts = (pts + rng.normal(size=pts.shape) * 0.5).astype(np.float32)
    perm = rng.permutation(len(pts))
    pts = pts[perm]
    k = 24
    padded = np.zeros((k, 3), np.float32)
    padded[: len(pts)] = pts
    valid = np.arange(k) < len(pts)
    want = j_match(jnp.asarray(padded), jnp.asarray(valid), ARMS, strict_reference_order=strict)
    got = t_match(torch.as_tensor(padded), torch.as_tensor(valid), ARMS, strict_reference_order=strict)
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    np.testing.assert_array_equal(got.member_ids.numpy(), np.asarray(want.member_ids))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=1e-5)
    if not strict:  # first-match can hand a link another link's triplet
        assert bool(got.found.all())


def _pad(points, k=32):
    padded = np.zeros((k, 3), np.float32)
    padded[: len(points)] = points
    return padded, np.arange(k) < len(points)


def _global_both(points, arms, k=32):
    """(JAX's result, the port's) of the global matcher on the same padded
    inputs, after checking that they agree."""
    padded, valid = _pad(np.asarray(points, np.float32), k)
    want = j_global(jnp.asarray(padded), jnp.asarray(valid), arms)
    got = t_global(torch.as_tensor(padded), torch.as_tensor(valid), arms)
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    np.testing.assert_array_equal(got.member_ids.numpy(), np.asarray(want.member_ids))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=1e-4)
    return want, got


def _local_l(l1, l2, offset=(0.0, 0.0, 0.0)):
    """tests/test_lshape.py's `_l_triplet`: corner, short arm +y (l2), long
    arm +x (l1), translated by `offset`."""
    return np.array([[0.0, 0.0, 0.0], [0.0, l2, 0.0], [l1, 0.0, 0.0]], np.float32) + np.float32(offset)


def test_global_matches_jax_on_fk_markers():
    """tests/test_lshape.py's FK-generated markers: all four links found."""
    from mamri_tpu.core import transforms as jT
    from mamri_tpu.core.robot import load_robot_model as j_load
    from mamri_tpu.core.robot import marker_world_positions

    model = j_load()
    angles = jnp.array([0.4, -0.3, 0.6, 0.9, -0.5, 0.7])
    base = jT.translate(jnp.array([30.0, -40.0, 10.0])) @ jT.rot_z(jnp.float32(0.3))
    links = ["Baseplate", "Joint2", "Joint4", "Joint6"]
    pts = np.concatenate([np.asarray(marker_world_positions(model, angles, ln, base)) for ln in links])
    pts = pts[np.random.default_rng(11).permutation(len(pts))]
    _, got = _global_both(pts, [model.spec(ln).arm_lengths for ln in links])
    assert bool(got.found.all())


def test_global_does_not_steal_matches_jax():
    """Only the second link's triplet exists: the greedy hands it to the
    first link, the global mode to its owner (tests/test_lshape.py)."""
    arms = [(40.0, 20.0), (43.0, 20.0)]
    pts = _local_l(43.0, 20.0)
    greedy = t_match(*(torch.as_tensor(a) for a in _pad(pts)), arms)
    assert bool(greedy.found[0]) and not bool(greedy.found[1])
    _, got = _global_both(pts, arms)
    assert not bool(got.found[0]) and bool(got.found[1])
    assert sorted(got.member_ids[1].tolist()) == [0, 1, 2]


def _dropout_trials():
    """tests/test_lshape.py's 8 seeded dropout trials: links missing at
    random, 3 stray blobs, the blobs shuffled."""
    rng = np.random.default_rng(23)
    trials = []
    for _ in range(8):
        present = rng.random(4) > 0.35
        tris = [_local_l(a[0], a[1], rng.uniform(-150, 150, 3).astype(np.float32))
                for a, keep in zip(ARMS, present) if keep]
        noise = rng.uniform(-120, 120, size=(3, 3)).astype(np.float32)
        pts = np.concatenate(tris + [noise]) if tris else noise
        trials.append(pts[rng.permutation(len(pts))])
    return trials


@pytest.mark.parametrize("trial", range(8))
def test_global_dropout_trials_match_jax(trial):
    _global_both(_dropout_trials()[trial], ARMS)


def test_global_two_mask_words_match_jax():
    """K = 64 (two 32-bit mask words in the reference, one 64-bit word
    here): the four triplets among 52 stray blobs, in slots 40-63; then the
    same blobs in 128 slots (two 64-bit words) give the same assignment."""
    rng = np.random.default_rng(7)
    tris = [_l_triplet(rng, *a) for a in ARMS]
    pts = rng.uniform(-400, 400, (64, 3)).astype(np.float32)
    slots = rng.permutation(np.arange(40, 64))[:12]
    pts[slots] = np.concatenate(tris).astype(np.float32)
    _, got = _global_both(pts, ARMS, k=64)
    assert bool(got.found.all()) and int(got.member_ids.max()) >= 40
    got128 = t_global(torch.as_tensor(np.concatenate([pts, np.zeros((64, 3), np.float32)])),
                      torch.as_tensor(np.arange(128) < 64), ARMS)
    assert torch.equal(got128.member_ids, got.member_ids)  # 128 slots, two 64-bit words


def test_global_tied_keys_match_jax():
    """Exactly tied shortlist keys: each link's triplet twice, the copies
    shifted by whole millimetres so every difference, hence every distance
    and error, is bitwise equal between them. JAX's top_k puts the lower
    combination index first; so must the port (and the assignment then
    takes the first of the tied optima)."""
    tris = [_local_l(a[0], a[1], (float(200 * i), 0.0, 0.0)) for i, a in enumerate(ARMS)]
    twins = [t + np.float32([0.0, 500.0, 0.0]) for t in tris]
    pts = np.concatenate(twins[::-1] + tris)  # the twins take the lower slots
    want, got = _global_both(pts, ARMS)
    assert bool(got.found.all())
    # every link took a triplet with its lowest blob among the twins (slots 0-11)
    assert sorted(got.member_ids.min(1).values.tolist()) == [0, 3, 6, 9]


def test_order_l_shape_degenerate_matches_jax():
    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], dtype=np.float32)
    for strict in (False, True):
        j_pts, j_ok = j_order(jnp.asarray(pts), 40.0, 20.0, 5.0, strict)
        t_pts, t_ok = t_order(torch.as_tensor(pts), 40.0, 20.0, 5.0, strict)
        assert bool(t_ok) == bool(j_ok) is False
        np.testing.assert_array_equal(t_pts.numpy(), np.asarray(j_pts))


def test_lm_matches_jax_per_guess():
    """A bounded fit with one bound active: the batched torch LM against
    JAX's, vmapped over the same guesses."""
    rng = np.random.default_rng(4)
    t = np.linspace(0, 1, 12).astype(np.float32)
    y = (2.0 * np.exp(-1.3 * t) + 0.3).astype(np.float32)
    lower = np.array([0.0, 0.0, 0.5], np.float32)  # the offset's bound is active
    upper = np.array([5.0, 5.0, 5.0], np.float32)
    guesses = rng.uniform(lower, upper, (4, 3)).astype(np.float32)

    def j_res(p):
        return p[0] * jnp.exp(-p[1] * jnp.asarray(t)) + p[2] - jnp.asarray(y)

    def t_res(p):
        return p[0] * torch.exp(-p[1] * torch.as_tensor(t)) + p[2] - torch.as_tensor(y)

    want = jax.vmap(lambda g: j_lm(j_res, g, jnp.asarray(lower), jnp.asarray(upper), num_iters=30))(
        jnp.asarray(guesses)
    )
    got = t_lm(t_res, torch.as_tensor(guesses), torch.as_tensor(lower), torch.as_tensor(upper), num_iters=30)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=2e-4)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=1e-3, atol=1e-6)
    assert (got.x[:, 2] >= 0.5).all()


def test_multistart_lm_matches_jax():
    """The best of several LM runs (and its index) against JAX's
    `multistart_lm` on the same guesses."""
    from mamri_tpu.ik.lm import multistart_lm as j_multi
    from mamri_tpu_torch.ik.lm import multistart_lm as t_multi

    t = np.linspace(0, 1, 10).astype(np.float32)
    y = (1.5 * np.sin(2.0 * t) + 0.2).astype(np.float32)
    lower, upper = np.array([-3.0, 0.1, -1.0], np.float32), np.array([3.0, 4.0, 1.0], np.float32)
    guesses = np.array([[-2.5, 3.5, 0.9], [1.0, 1.0, 0.0], [2.9, 0.2, -0.9]], np.float32)

    def j_res(p):
        return p[0] * jnp.sin(p[1] * jnp.asarray(t)) + p[2] - jnp.asarray(y)

    def t_res(p):
        return p[0] * torch.sin(p[1] * torch.as_tensor(t)) + p[2] - torch.as_tensor(y)

    want, j_best = j_multi(j_res, jnp.asarray(guesses), jnp.asarray(lower), jnp.asarray(upper), num_iters=25)
    got, t_best = t_multi(t_res, torch.as_tensor(guesses), torch.as_tensor(lower), torch.as_tensor(upper),
                          num_iters=25)
    assert int(t_best) == int(j_best)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=2e-4)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-3, atol=1e-6)
