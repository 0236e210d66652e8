"""The one launch seam (`mamri_tpu_torch/_build.py`) that every kernel
wrapper goes through, without a card: CPU tensors are taken for a card's,
and a stand-in library answers every entry. A launch counts once under its
wrapper's name in the one `LAUNCHES`; a CUDA error is raised with the
kernel's name and the library's string, and counts nothing. The counts
across threads are held in tests/test_torch_mesh.py."""

import pytest
import torch

from kabsch_cases import kabsch_case
from lm_cases import lm_scene
from mamri_tpu_torch import _build
from mamri_tpu_torch.ik import fused_lm
from mamri_tpu_torch.perception import gpu_ops
from mamri_tpu_torch.registration import kabsch
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)


class _FakeLibrary:
    """Every `mamri_*` entry records its name and returns `err`."""

    def __init__(self):
        self.err, self.entries = 0, []

    def __getattr__(self, entry):
        if not entry.startswith("mamri_"):
            raise AttributeError(entry)

        def call(*args):
            self.entries.append(entry)
            return self.err

        return call

    def mamri_error_string(self, err):
        return b"an illegal memory access was encountered"


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLibrary()

    class _Stream:
        cuda_stream = None

    monkeypatch.setattr(_build, "on_cuda", lambda *tensors: True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    _build.reset_launch_counts()
    return lib


def _wrapper_call(kernel):
    if kernel == "kabsch":
        src, tgt = kabsch_case("batch5")
        return lambda: kabsch.kabsch_rigid_transform(src, tgt)
    if kernel == "full_chain_lm":
        model, kw = lm_scene(1, 4, False, True, "cpu")
        return lambda: fused_lm.full_chain_lm(model, num_iters=2, **kw)
    reset = torch.zeros((8, 8, 8), dtype=torch.int8)
    return lambda: gpu_ops.reset_distances(reset, 0)


def _launched():
    return {name: n for name, n in _build.LAUNCHES.items() if n}


@pytest.mark.parametrize("kernel", ["kabsch", "full_chain_lm", "reset_distances"])
def test_a_launch_counts_once_and_an_error_counts_nothing(fake_card, kernel):
    call = _wrapper_call(kernel)
    call()
    assert fake_card.entries == [f"mamri_{kernel}"]
    assert _launched() == {kernel: 1}
    fake_card.err = 700
    with pytest.raises(RuntimeError) as err:
        call()
    assert str(err.value) == f"{kernel}: CUDA error 700 (an illegal memory access was encountered)"
    assert fake_card.entries == [f"mamri_{kernel}"] * 2
    assert _launched() == {kernel: 1}
