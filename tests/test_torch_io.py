"""The port's volume I/O against mamri_tpu's: copied modules, files both ways,
the native build, and the engine's files.

The port keeps its own copies of the JAX package's numpy-only modules (it may
import nothing of `mamri_tpu`); each copy is held to its original modulo the
package name, so the two cannot drift. Every format is written by one package
and read by the other, both ways, with data, dtype, spacing and origin equal;
the writers are deterministic, so the files are byte-equal too (with gzip's
timestamp field set aside).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from mamri_tpu.api import MamriEngine as JaxEngine
from mamri_tpu.perception import dicom as j_dicom
from mamri_tpu.perception import formats as j_formats
from mamri_tpu.perception import io as j_io
from mamri_tpu.perception.volume import Volume as JaxVolume
from mamri_tpu_torch.api.engine import MamriEngine
from mamri_tpu_torch.perception import dicom as t_dicom
from mamri_tpu_torch.perception import formats as t_formats
from mamri_tpu_torch.perception import io as t_io
from mamri_tpu_torch.perception.volume import Volume
from test_torch_engine import _one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cited(src: str) -> str:
    """`src` with every citation of the reference's `Mamri/Mamri.py` made
    relative (two of the originals give its path in a local checkout; the
    copies cite it as the rest of the repo does)."""
    return re.sub(r"[\w./-]*/(Mamri/Mamri\.py)", r"\1", src)


def _read(*parts) -> str:
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


COPIED = [
    "perception/io.py", "perception/formats.py", "perception/dicom.py", "perception/jpegll.py",
    "perception/jpegls.py", "perception/jpegdct.py", "perception/jpeg2000.py", "perception/reference_cpu.py",
    "perception/__init__.py", "utils/stl.py",
    "hw/__init__.py", "hw/transport.py", "hw/devices.py", "hw/executor.py", "hw/sim.py", "hw/sync.py",
    "hw/stream.py", "api/playback.py",
    "utils/scene.py", "utils/glb.py", "utils/html_viewer.py", "utils/render.py",
]

# native/__init__.py: the copy builds into the port's git-ignored build
# directory, and each process compiles to its own temporary name (the
# original shares one `path + ".tmp"` between concurrent builds)
NATIVE_EXCEPTED = {
    'Lazily compiled with g++ on first use (cached in ~/.cache/mamri_tpu_torch). All':
        'Lazily compiled with g++ on first use (into build/mamri_tpu_torch/native-<hash>/). All',
    '_CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache", "mamri_tpu_torch")':
        '_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(_SRC))), "build", '
        '"mamri_tpu_torch")',
    '    return os.path.join(_CACHE_DIR, f"libmamri_native-{digest}.so")':
        '    return os.path.join(_CACHE_DIR, f"native-{digest}", "libmamri_native.so")',
    '    os.makedirs(_CACHE_DIR, exist_ok=True)':
        '    os.makedirs(os.path.dirname(path), exist_ok=True)',
    '    tmp = path + ".tmp"':
        '    tmp = f"{path}.{os.getpid()}.tmp"  # per process: concurrent builds never share a file',
}


@pytest.mark.parametrize("rel", COPIED + ["native/ccl_native.cpp", "native/__init__.py"])
def test_copy_matches_original(rel):
    if rel.endswith(".cpp"):
        with open(os.path.join(REPO, "mamri_tpu", rel), "rb") as a, open(os.path.join(REPO, "mamri_tpu_torch", rel),
                                                                          "rb") as b:
            assert a.read() == b.read()
        return
    want = _cited(re.sub(r"\bmamri_tpu\b", "mamri_tpu_torch", _read("mamri_tpu", rel)))
    got = _cited(_read("mamri_tpu_torch", rel))
    if rel == "native/__init__.py":
        for line, repaired in NATIVE_EXCEPTED.items():
            assert want.count(line) == 1, line
            want = want.replace(line, repaired)
    assert got == want


# ------------------------------------------------------------------ files both ways
def _scan(pkg_volume):
    """A small int16 scan with uneven spacing and origin: every value and
    every geometry float must survive each format exactly."""
    rng = np.random.default_rng(3)
    data = rng.integers(-40, 1400, size=(21, 18, 5)).astype(np.int16)
    data[5:9, 4:12, 1:4] = 1200  # runs the codecs' predictors can use
    return pkg_volume(data, np.array([0.9765625, 1.2345678, 2.75], np.float32),
                      np.array([-101.5, 87.25, -33.125], np.float32))


def _writers(formats, io, dicom):
    """{case: (file name, writer(path, volume))} of one package."""
    return {
        "nrrd-raw": ("v.nrrd", lambda p, v: formats.save_nrrd(p, v, encoding="raw")),
        "nrrd-gzip": ("v.nrrd", lambda p, v: formats.save_nrrd(p, v, encoding="gzip")),
        "mha": ("v.mha", lambda p, v: formats.save_metaimage(p, v)),
        "mha-raw": ("v.mha", lambda p, v: formats.save_metaimage(p, v, compressed=False)),
        "nii": ("v.nii", lambda p, v: io.save_nifti(p, v)),
        "nii.gz": ("v.nii.gz", lambda p, v: io.save_nifti(p, v)),
        **{f"dicom-{t}": ("series", (lambda t: lambda p, v: dicom.save_dicom_series(p, v, transfer=t))(t))
           for t in ("explicit_le", "deflated", "rle", "jpegll", "jpegls", "j2k")},
        "dicom-multiframe": ("v.dcm", lambda p, v: dicom.save_dicom_multiframe(p, v)),
        "dicom-multiframe-jpegls": ("v.dcm", lambda p, v: dicom.save_dicom_multiframe(p, v, transfer="jpegls")),
    }


CASES = list(_writers(t_formats, t_io, t_dicom))


def _file_bytes(path):
    """{relative file: bytes} under `path`, each gzip member's timestamp
    field zeroed (gzip stamps the time of writing) and the writer's package
    name as the JAX package's (NRRD headers name it)."""
    files = sorted(os.listdir(path)) if os.path.isdir(path) else [None]
    out = {}
    for name in files:
        with open(path if name is None else os.path.join(path, name), "rb") as f:
            raw = bytearray(f.read())
        for m in re.finditer(rb"\x1f\x8b\x08", bytes(raw)):
            raw[m.start() + 4:m.start() + 8] = b"\0\0\0\0"
        out[name] = bytes(raw).replace(b"mamri_tpu_torch", b"mamri_tpu")
    return out


def _same_volume(got, want, what):
    assert got.data.dtype == want.data.dtype, what
    np.testing.assert_array_equal(got.data, want.data, err_msg=what)
    assert got.spacing.tobytes() == want.spacing.tobytes(), (what, got.spacing, want.spacing)
    assert got.origin.tobytes() == want.origin.tobytes(), (what, got.origin, want.origin)


@pytest.mark.parametrize("case", CASES)
def test_files_round_trip_between_packages(case, tmp_path):
    """Written by the port, read by mamri_tpu's `load_volume` and the port's;
    written by mamri_tpu, read by the port's; the two files byte-equal."""
    name, t_write = _writers(t_formats, t_io, t_dicom)[case]
    _, j_write = _writers(j_formats, j_io, j_dicom)[case]
    t_path, j_path = str(tmp_path / "port" / name), str(tmp_path / "jax" / name)
    os.makedirs(os.path.dirname(t_path))
    os.makedirs(os.path.dirname(j_path))
    t_vol, j_vol = _scan(Volume), _scan(JaxVolume)
    t_write(t_path, t_vol)
    j_write(j_path, j_vol)
    _same_volume(j_formats.load_volume(t_path), t_vol, f"{case}: port's file, mamri_tpu's reader")
    _same_volume(t_formats.load_volume(t_path), t_vol, f"{case}: port's file, port's reader")
    _same_volume(t_formats.load_volume(j_path), t_vol, f"{case}: mamri_tpu's file, port's reader")
    assert _file_bytes(t_path) == _file_bytes(j_path)


def test_detached_metaimage_reads_alike(tmp_path):
    """A `.mhd` header beside its `.raw` data (the layout no writer of either
    package emits) loads equal in both packages."""
    vol = _scan(Volume)
    (tmp_path / "v.raw").write_bytes(vol.data.astype("<i2").tobytes(order="F"))
    sp, org = vol.spacing.tolist(), vol.origin.tolist()
    (tmp_path / "v.mhd").write_text(
        "ObjectType = Image\nNDims = 3\nBinaryData = True\nCompressedData = False\n"
        f"Offset = {org[0]!r} {org[1]!r} {org[2]!r}\nElementSpacing = {sp[0]!r} {sp[1]!r} {sp[2]!r}\n"
        "DimSize = 21 18 5\nElementType = MET_SHORT\nElementDataFile = v.raw\n"
    )
    path = str(tmp_path / "v.mhd")
    _same_volume(t_formats.load_volume(path), vol, "port")
    _same_volume(j_formats.load_volume(path), vol, "mamri_tpu")


def test_seg_nrrd_round_trips_between_packages(tmp_path):
    rng = np.random.default_rng(4)
    body = rng.random((12, 10, 7)) < 0.4
    lesion = np.zeros_like(body)
    lesion[2:5, 3:6, 1:3] = True
    body &= ~lesion
    segments = {"Body": body, "Lesion": lesion}
    sp, org = np.array([1.5, 0.75, 2.0], np.float32), np.array([3.0, -4.5, 10.25], np.float32)
    t_path, j_path = str(tmp_path / "port.seg.nrrd"), str(tmp_path / "jax.seg.nrrd")
    t_formats.save_seg_nrrd(t_path, segments, sp, org)
    j_formats.save_seg_nrrd(j_path, segments, sp, org)
    for reader, path in ((j_formats.load_seg_nrrd, t_path), (t_formats.load_seg_nrrd, t_path),
                         (t_formats.load_seg_nrrd, j_path)):
        got, labelmap = reader(path)
        assert list(got) == ["Body", "Lesion"]
        for k in segments:
            np.testing.assert_array_equal(got[k], segments[k])
        assert labelmap.spacing.tobytes() == sp.tobytes() and labelmap.origin.tobytes() == org.tobytes()
    assert _file_bytes(t_path) == _file_bytes(j_path)


# ------------------------------------------------------------------ the native build
def test_concurrent_native_builds_share_one_directory(tmp_path):
    """Six processes (as many as the suite's workers) build the port's native
    library at once into one empty directory, and every one loads it: each
    compiles to its own temporary name and moves it into place. (With one
    shared temporary name, as in the JAX package, most such runs lose a
    build.)"""
    code = (
        "import sys\n"
        "import mamri_tpu_torch.native as n\n"
        "n._CACHE_DIR = sys.argv[1]\n"
        "assert n.available(), 'native library did not load'\n"
        "print(n._lib_path())\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    (lib,) = paths
    assert os.path.isfile(lib) and os.path.dirname(os.path.dirname(lib)) == str(tmp_path)
    assert os.listdir(os.path.dirname(lib)) == ["libmamri_native.so"]  # no temporary left behind


# ------------------------------------------------------------------ the engine's files
@pytest.fixture(scope="module")
def engines():
    return JaxEngine(), MamriEngine(device="cpu")


def _body(shape=(14, 12, 9)):
    mask = np.zeros(shape, bool)
    mask[3:11, 2:9, 2:7] = True
    return mask, np.array([2.0, 1.5, 3.0], np.float32), np.array([-20.0, 14.5, 3.25], np.float32)


def test_set_body_segmentation_from_seg_nrrd(engines, tmp_path):
    """`export_segmentation` writes the body as a `.seg.nrrd` that
    `set_body_segmentation` takes back, in either package: the named segment,
    else the only one, else the reference's error."""
    jeng, teng = engines
    mask, sp, org = _body()
    teng.set_body_segmentation(mask, sp, org)
    jeng.set_body_segmentation(mask, sp, org)
    t_path = teng.export_segmentation(str(tmp_path / "port.seg.nrrd"))
    j_path = jeng.export_segmentation(str(tmp_path / "jax.seg.nrrd"))
    assert _file_bytes(t_path) == _file_bytes(j_path)

    fresh = MamriEngine(device="cpu")
    fresh.last_collision_world = object()  # a world of the previous body
    fresh.set_body_segmentation(j_path)
    assert fresh.last_collision_world is None
    np.testing.assert_array_equal(fresh.body_mask(), mask)
    assert fresh.last_volume_geom[0].tobytes() == sp.tobytes() and fresh.last_volume_geom[1].tobytes() == org.tobytes()

    other = np.zeros_like(mask)
    other[0:2, 0:2, 0:2] = True
    two = str(tmp_path / "two.seg.nrrd")
    t_formats.save_seg_nrrd(two, {"Skin": other, "Liver": mask}, sp, org)
    fresh.set_body_segmentation(two, segment="Liver")
    np.testing.assert_array_equal(fresh.body_mask(), mask)
    for eng in (fresh, jeng):
        with pytest.raises(ValueError, match=r"no segment named 'Body' among \['Liver', 'Skin'\]"):
            eng.set_body_segmentation(two)
    only = str(tmp_path / "only.seg.nrrd")
    t_formats.save_seg_nrrd(only, {"Anything": other}, sp, org)
    fresh.set_body_segmentation(only)
    np.testing.assert_array_equal(fresh.body_mask(), other)

    with pytest.raises(RuntimeError, match="no body segmentation"):
        MamriEngine(device="cpu").export_segmentation(str(tmp_path / "none.seg.nrrd"))


def test_state_round_trips_between_packages(engines, tmp_path):
    """`save_state` / `load_state` and `save_baseplate` / `load_baseplate`:
    the same files as the reference's, read back by either package."""
    jeng, teng = engines
    rng = np.random.default_rng(6)
    base = np.eye(4, dtype=np.float32)
    base[:3, 3] = rng.normal(size=3) * 50
    angles = rng.uniform(-1, 1, 6).astype(np.float32)
    for eng in engines:
        eng.baseplate_tf = base.copy()
        eng.saved_baseplate = None
        eng.set_pose(angles)
    with pytest.raises(ValueError, match="expected 6 angles, got 5"):
        teng.set_pose(angles[:5])
    np.testing.assert_array_equal(teng.get_current_joint_angles(), angles)
    assert teng.get_current_joint_angles() is not teng.current_angles

    t_bp, j_bp = str(tmp_path / "port_bp.npz"), str(tmp_path / "jax_bp.npz")
    np.testing.assert_array_equal(teng.save_baseplate(t_bp), jeng.save_baseplate(j_bp))
    np.testing.assert_array_equal(MamriEngine(device="cpu").load_baseplate(j_bp), base)
    np.testing.assert_array_equal(JaxEngine().load_baseplate(t_bp), base)

    t_st, j_st = str(tmp_path / "port_state.npz"), str(tmp_path / "jax_state.npz")
    teng.save_state(t_st)
    jeng.save_state(j_st)
    with open(t_st + ".meta.json") as a, open(j_st + ".meta.json") as b:
        assert a.read() == b.read()
    for path in (t_st, j_st):
        back = MamriEngine(device="cpu")
        back.load_state(path)
        np.testing.assert_array_equal(back.current_angles, angles)
        np.testing.assert_array_equal(back.baseplate_tf, base)
        np.testing.assert_array_equal(back.saved_baseplate, base)
        assert back.current_angles.dtype == np.float32
    teng.zero_robot()
    assert not teng.current_angles.any() and teng.current_angles.dtype == np.float32
    with pytest.raises(RuntimeError, match="no baseplate transform"):
        MamriEngine(device="cpu").save_baseplate()
