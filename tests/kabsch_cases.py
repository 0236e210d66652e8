"""Point sets for the Kabsch fit's tests, on the CPU and on a card (no jax:
the card's machine has none).

`kabsch_case(name)` gives (source, target) float32 tensors on the CPU,
(..., N, 3) each (the "broadcast" case's source has no leading dimension).
The markers' triplets are L-shaped and coplanar; targets sit where the arm
puts them, a few hundred mm from the scanner's origin."""

import numpy as np
import torch

KABSCH_CASES = ["random", "l_shape", "noisy", "n4", "n9", "batch5", "batch2x4", "broadcast", "reflected", "zero",
                "nan"]
# the cases with a unique best rotation, where any two correct solvers agree
WELL_POSED = [c for c in KABSCH_CASES if c not in ("zero", "nan")]


def random_rotation(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _moved(rng, src, noise=0.0):
    """src rotated and moved by a random rigid motion (translations up to
    300 mm), plus N(0, noise) mm on every coordinate."""
    out = src @ random_rotation(rng).T + rng.uniform(-300, 300, 3)
    return out + rng.normal(size=out.shape) * noise


def _spread(rng, n, scale):
    """n points of N(0, scale) mm with no axis of their spread under half
    the widest (for n = 3, of the two in their plane): a best rotation that
    rounding cannot tip."""
    while True:
        pts = rng.normal(size=(n, 3)) * scale
        sv = np.linalg.svd(pts - pts.mean(0), compute_uv=False)[: min(n - 1, 3)]
        if sv[-1] >= 0.5 * sv[0]:
            return pts


def _l_triplet(rng):
    a, b = rng.choice([(40.0, 20.0), (70.0, 25.0), (70.0, 20.0), (45.0, 20.0)])  # the MAMRI arms
    return np.array([[0.0, 0.0, 0.0], [0.0, b, 0.0], [a, 0.0, 0.0]]) + rng.uniform(-30, 30, 3)


def kabsch_case(name, seed=0):
    rng = np.random.default_rng([seed, KABSCH_CASES.index(name)])
    if name == "random":
        src = _spread(rng, 3, 30)
        tgt = _moved(rng, src)
    elif name == "l_shape":
        src = _l_triplet(rng)
        tgt = _moved(rng, src)
    elif name == "noisy":
        src = _l_triplet(rng)
        tgt = _moved(rng, src, noise=0.5)
    elif name in ("n4", "n9"):
        src = _spread(rng, int(name[1:]), 40)
        tgt = _moved(rng, src, noise=0.3)
    elif name in ("batch5", "batch2x4"):
        lead = (5,) if name == "batch5" else (2, 4)
        src = np.stack([_l_triplet(rng) for _ in range(int(np.prod(lead)))])
        tgt = np.stack([_moved(rng, s, noise=0.2) for s in src])
        src, tgt = src.reshape(lead + (3, 3)), tgt.reshape(lead + (3, 3))
    elif name == "broadcast":  # one local triplet against five detections
        src = _l_triplet(rng)
        tgt = np.stack([_moved(rng, src, noise=0.2) for _ in range(5)])
    elif name == "reflected":  # no rotation reaches a mirror image of four points off one plane
        src = _spread(rng, 4, 40)
        tgt = _moved(rng, src * np.array([-1.0, 1.0, 1.0]))
    elif name == "zero":  # no spread at all: every rotation fits, the fit gives the identity
        src = tgt = np.zeros((3, 3))
    elif name == "nan":
        src = _l_triplet(rng)
        tgt = _moved(rng, src)
        tgt[1, 2] = np.nan
    else:
        raise KeyError(name)
    return (torch.as_tensor(np.asarray(src, np.float32)).contiguous(),
            torch.as_tensor(np.asarray(tgt, np.float32)).contiguous())


def assert_same_fit(got, want, rot_atol, mm_atol):
    """Two (..., 4, 4) fits: rotation entries within rot_atol, translations
    within mm_atol, the bottom row exactly [0, 0, 0, 1]; NaN where the other
    has NaN."""
    assert got.shape == want.shape and got.dtype == want.dtype
    got, want = got.cpu(), want.cpu()
    torch.testing.assert_close(got[..., :3, :3], want[..., :3, :3], rtol=0, atol=rot_atol, equal_nan=True)
    torch.testing.assert_close(got[..., :3, 3], want[..., :3, 3], rtol=0, atol=mm_atol, equal_nan=True)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(got.shape[:-2] + (4,))
    assert torch.equal(got[..., 3, :], bottom) and torch.equal(want[..., 3, :], bottom)
