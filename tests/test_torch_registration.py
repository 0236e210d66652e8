"""The port's Kabsch fit, L-shape matcher and batched LM against mamri_tpu's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mamri_tpu.ik.lm import least_squares_lm as j_lm
from mamri_tpu.registration.kabsch import kabsch_rigid_transform as j_kabsch
from mamri_tpu.registration.lshape import match_l_shaped_triplets as j_match
from mamri_tpu.registration.lshape import order_l_shape as j_order
from mamri_tpu_torch.ik.lm import least_squares_lm as t_lm
from mamri_tpu_torch.registration.kabsch import kabsch_rigid_transform as t_kabsch
from mamri_tpu_torch.registration.lshape import match_l_shaped_triplets as t_match
from mamri_tpu_torch.registration.lshape import order_l_shape as t_order
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

ARMS = [(40.0, 20.0), (70.0, 25.0), (70.0, 20.0), (45.0, 20.0)]  # the MAMRI signatures


def _random_rotation(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


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
