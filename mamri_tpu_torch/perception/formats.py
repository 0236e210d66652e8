"""NRRD (.nrrd/.nhdr) and MetaImage (.mha/.mhd) volume IO + format dispatch.

The reference runs inside 3D Slicer, whose scene IO accepts every ITK image
format — its users' volumes are most often NRRD (Slicer's native research
format) or MetaImage, not just DICOM/NIfTI (Mamri/Mamri.py:1306 operates on
whatever volume node the scene holds). A standalone framework must ingest
those files itself. Both formats funnel through the same geometry
normalization as NIfTI/DICOM (`io.volume_from_affine`): axis-permutation /
flip orientations normalize exactly, oblique ones resample.

Implemented from the public format specifications (teem NRRD format spec;
ITK MetaIO documentation) — no external readers:

  * NRRD: magic NRRD0001-5, case-insensitive fields, `key:=value` pairs,
    comments; encodings raw / gzip / bzip2 / ascii; little/big endian;
    detached headers (`data file:`) with `byte skip` (incl. -1) and
    `line skip`; spaces LPS / RAS / LAS (+ their "left-posterior-superior"
    spellings) converted to the package's LPS convention; `space directions`
    (per-axis vectors, spacing included) or legacy `spacings`.
  * MetaImage: ObjectType Image, NDims 3, MET_* element types,
    TransformMatrix rows = per-axis direction cosines (ITK MetaImageIO
    layout), Offset/Origin/Position synonyms, zlib `CompressedData`,
    ElementDataFile LOCAL or a detached file. MetaIO's coordinate space is
    already LPS.

Both formats store the first axis fastest (Fortran order), like NIfTI.
Writers keep compact scanner dtypes and emit float32 otherwise
(`volume.storage_array`), with the package's axis-aligned LPS geometry;
`save_nrrd` defaults to gzip encoding (what Slicer writes), `save_metaimage`
to zlib-compressed data.
"""

from __future__ import annotations

import bz2
import gzip
import os
import re
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from mamri_tpu_torch.perception.io import _is_axis_aligned, load_nifti, save_nifti, volume_from_affine
from mamri_tpu_torch.perception.volume import Volume, storage_array

# ----------------------------------------------------------------------- NRRD

_NRRD_TYPES = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16, "short int": np.int16, "signed short": np.int16,
    "signed short int": np.int16, "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16,
    "unsigned short int": np.uint16, "uint16": np.uint16, "uint16_t": np.uint16,
    "int": np.int32, "signed int": np.int32, "int32": np.int32,
    "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "uint32_t": np.uint32,
    "longlong": np.int64, "long long": np.int64, "long long int": np.int64,
    "signed long long": np.int64, "signed long long int": np.int64,
    "int64": np.int64, "int64_t": np.int64,
    "ulonglong": np.uint64, "unsigned long long": np.uint64,
    "unsigned long long int": np.uint64, "uint64": np.uint64,
    "uint64_t": np.uint64,
    "float": np.float32, "double": np.float64,
}

# space name -> diagonal converting that space's coordinates to LPS
_NRRD_SPACES = {
    "left-posterior-superior": (1.0, 1.0, 1.0),
    "lps": (1.0, 1.0, 1.0),
    "right-anterior-superior": (-1.0, -1.0, 1.0),
    "ras": (-1.0, -1.0, 1.0),
    "left-anterior-superior": (1.0, -1.0, 1.0),
    "las": (1.0, -1.0, 1.0),
    "3d-left-handed": (1.0, 1.0, 1.0),  # generic: axes taken as given
    "3d-right-handed": (1.0, 1.0, 1.0),
}


def _parse_nrrd_vector(tok: str, path: str) -> Optional[np.ndarray]:
    tok = tok.strip()
    if tok.lower() == "none":
        return None
    if not (tok.startswith("(") and tok.endswith(")")):
        raise ValueError(f"{path}: malformed NRRD vector {tok!r}")
    try:
        return np.array([float(v) for v in tok[1:-1].split(",")], dtype=np.float64)
    except ValueError as e:
        raise ValueError(f"{path}: malformed NRRD vector {tok!r}") from e


def _parse_nrrd_header(raw: bytes, path: str) -> Tuple[Dict[str, str], Dict[str, str], int]:
    """-> (normalized field dict, key:=value metadata dict, data offset)."""
    if not raw.startswith(b"NRRD000"):
        raise ValueError(f"{path}: not a NRRD file (bad magic)")
    if raw[7:8] not in b"12345":
        raise ValueError(f"{path}: unsupported NRRD version {raw[4:8]!r}")
    fields: Dict[str, str] = {}
    kvs: Dict[str, str] = {}
    pos = raw.index(b"\n") + 1
    while True:
        if pos >= len(raw):
            raise ValueError(f"{path}: NRRD header not terminated by a blank line")
        end = raw.find(b"\n", pos)
        if end < 0:
            end = len(raw)
        line = raw[pos:end].rstrip(b"\r")
        pos = end + 1
        if not line:
            break  # blank line terminates the header; data follows
        if line.startswith(b"#"):
            continue
        text = line.decode("ascii", errors="replace")
        if ":=" in text:  # key/value metadata pair (keys ARE case-sensitive)
            key, _, value = text.partition(":=")
            kvs[key.strip()] = value.strip()
            continue
        if ": " not in text and not text.endswith(":"):
            raise ValueError(f"{path}: malformed NRRD header line {text!r}")
        name, _, value = text.partition(":")
        # field identifiers are case-insensitive with optional spaces
        key = re.sub(r"\s+", " ", name.strip().lower())
        fields[key] = value.strip()
    return fields, kvs, pos


def _nrrd_decode(payload: bytes, encoding: str, dt: np.dtype, count: int, path: str) -> np.ndarray:
    enc = encoding.lower()
    if enc == "raw":
        if len(payload) < count * dt.itemsize:
            raise ValueError(f"{path}: NRRD raw data truncated")
        return np.frombuffer(payload, dtype=dt, count=count)
    if enc in ("gzip", "gz"):
        try:
            payload = gzip.decompress(payload)
        except (EOFError, zlib.error, gzip.BadGzipFile) as e:
            raise ValueError(f"{path}: corrupt NRRD gzip data ({e})") from e
    elif enc in ("bzip2", "bz2"):
        try:
            payload = bz2.decompress(payload)
        except (OSError, ValueError, EOFError) as e:
            raise ValueError(f"{path}: corrupt NRRD bzip2 data ({e})") from e
    elif enc in ("ascii", "text", "txt"):
        try:
            toks = payload.decode("ascii").split()
            vals = np.array(toks, dtype=np.float64)
        except (UnicodeDecodeError, ValueError) as e:
            raise ValueError(f"{path}: malformed NRRD ascii data") from e
        if vals.size < count:
            raise ValueError(f"{path}: NRRD ascii data truncated ({vals.size} < {count})")
        return vals[:count].astype(np.dtype(dt).newbyteorder("="))
    else:
        raise ValueError(f"{path}: unsupported NRRD encoding {encoding!r}")
    if len(payload) < count * dt.itemsize:
        raise ValueError(f"{path}: NRRD compressed data truncated")
    return np.frombuffer(payload, dtype=dt, count=count)


def _nrrd_dtype(fields: Dict[str, str], path: str) -> np.dtype:
    """Element dtype from the type/endian header fields (endian validated)."""
    type_key = re.sub(r"\s+", " ", fields.get("type", "").strip().lower())
    if type_key not in _NRRD_TYPES:
        raise ValueError(f"{path}: unsupported NRRD type {fields.get('type')!r}")
    dt = np.dtype(_NRRD_TYPES[type_key])
    if dt.itemsize > 1:
        endian = fields.get("endian", "little").lower()
        if endian not in ("little", "big"):
            raise ValueError(f"{path}: bad NRRD endian {endian!r}")
        dt = dt.newbyteorder("<" if endian == "little" else ">")
    return dt


def _nrrd_affine(fields: Dict[str, str], path: str, vecs=None) -> np.ndarray:
    """3x4 voxel-index -> LPS affine from the header geometry fields.

    `vecs` overrides the space-direction vectors (the 4-D segmentation
    reader passes the spatial subset after stripping the layer axis).
    Headers without space directions fall back to the legacy `spacings`
    field (negative spacing = decreasing world coordinate — the diag affine
    lets the normalizer flip the axis) or unit spacing."""
    space = fields.get("space", "").strip().lower()
    if space and space not in _NRRD_SPACES:
        raise ValueError(f"{path}: unsupported NRRD space {fields.get('space')!r}")
    flip = np.array(_NRRD_SPACES.get(space, (1.0, 1.0, 1.0)), dtype=np.float64)
    if vecs is None:
        dirs_f = fields.get("space directions")
        if dirs_f:
            vecs = [
                _parse_nrrd_vector(tok, path)
                for tok in re.findall(r"\(.*?\)|none|NONE|None", dirs_f)
            ]
            vecs = [v for v in vecs if v is not None]
        else:
            vecs = []
    if vecs:
        if len(vecs) != 3 or any(v is None or v.shape != (3,) for v in vecs):
            raise ValueError(f"{path}: need 3 spatial NRRD space directions")
        origin = _parse_nrrd_vector(fields.get("space origin", "(0,0,0)"), path)
        if origin is None or origin.shape != (3,):
            raise ValueError(f"{path}: malformed NRRD space origin")
        affine = np.empty((3, 4), dtype=np.float64)
        for c, v in enumerate(vecs):
            affine[:, c] = v * flip
        affine[:, 3] = origin * flip
        return affine
    if "spacings" in fields:
        spac = np.array([float(s) for s in fields["spacings"].split()], dtype=np.float64)
        if spac.shape != (3,) or not np.all(np.abs(spac) > 0) or not np.all(np.isfinite(spac)):
            raise ValueError(f"{path}: malformed NRRD spacings {fields['spacings']!r}")
    else:
        spac = np.ones(3, dtype=np.float64)
    return np.concatenate([np.diag(spac), np.zeros((3, 1))], axis=1)


def load_nrrd(path: str) -> Volume:
    """Read a NRRD volume (attached .nrrd or detached .nhdr header)."""
    with open(path, "rb") as f:
        raw = f.read()
    fields, _, data_off = _parse_nrrd_header(raw, path)

    try:
        ndim = int(fields["dimension"])
        sizes = [int(s) for s in fields["sizes"].split()]
    except (KeyError, ValueError) as e:
        raise ValueError(f"{path}: NRRD header missing/invalid dimension or sizes") from e
    if ndim != 3 or len(sizes) != 3:
        raise ValueError(f"{path}: only 3-D scalar NRRD volumes are supported (dimension={ndim})")
    if any(s <= 0 for s in sizes):
        raise ValueError(f"{path}: non-positive NRRD sizes {sizes}")

    dt = _nrrd_dtype(fields, path)
    encoding = fields.get("encoding", "raw")
    datafile = fields.get("data file") or fields.get("datafile")
    if datafile:
        if datafile.upper().startswith("LIST") or "%" in datafile:
            raise ValueError(f"{path}: multi-file NRRD data ('{datafile}') is not supported")
        dpath = os.path.join(os.path.dirname(os.path.abspath(path)), datafile)
        with open(dpath, "rb") as f:
            payload = f.read()
        line_skip = int(fields.get("line skip", fields.get("lineskip", 0)))
        for _ in range(line_skip):
            nl = payload.find(b"\n")
            if nl < 0:
                raise ValueError(f"{path}: line skip exceeds the data file")
            payload = payload[nl + 1:]
        byte_skip = int(fields.get("byte skip", fields.get("byteskip", 0)))
        if byte_skip == -1:  # spec: read the LAST count*itemsize bytes (raw only)
            if encoding.lower() != "raw":
                raise ValueError(f"{path}: byte skip -1 requires raw encoding")
            payload = payload[len(payload) - int(np.prod(sizes)) * dt.itemsize:]
        elif byte_skip > 0:
            payload = payload[byte_skip:]
        elif byte_skip < -1:
            raise ValueError(f"{path}: invalid byte skip {byte_skip}")
    else:
        payload = raw[data_off:]

    count = int(np.prod(sizes))
    flat = _nrrd_decode(payload, encoding, dt, count, path)
    # first axis fastest; storage dtype passes through (Volume keeps
    # compact int dtypes and normalizes byte order / everything else)
    data = flat.reshape(sizes, order="F")
    return volume_from_affine(data, _nrrd_affine(fields, path))


def save_nrrd(path: str, volume: Volume, encoding: str = "gzip") -> None:
    """Write an NRRD0004 volume in LPS space (gzip or raw encoding). The
    volume's storage dtype is kept: compact scanner dtypes (int8/16,
    uint8/16) write as-is (half the bytes, and they re-load compact);
    everything else writes float32.

    A `.nhdr` path writes a DETACHED header whose data lives next to it in
    `<stem>.raw` / `<stem>.raw.gz`; anything else writes one attached file."""
    if encoding not in ("gzip", "raw"):
        raise ValueError(f"save_nrrd supports gzip/raw encodings, not {encoding!r}")
    data = storage_array(volume.data)
    type_name = {
        np.dtype(np.int8): "int8", np.dtype(np.uint8): "uchar",
        np.dtype(np.int16): "short", np.dtype(np.uint16): "ushort",
        np.dtype(np.float32): "float",
    }[data.dtype]
    detached = path.lower().endswith(".nhdr")
    datafile = ""
    if detached:
        stem = os.path.basename(path)[: -len(".nhdr")]
        datafile = stem + (".raw.gz" if encoding == "gzip" else ".raw")
    sx, sy, sz = (float(v) for v in volume.spacing)
    ox, oy, oz = (float(v) for v in volume.origin)
    hdr = (
        "NRRD0004\n"
        "# written by mamri_tpu_torch\n"
        f"type: {type_name}\n"
        "dimension: 3\n"
        "space: left-posterior-superior\n"
        f"sizes: {data.shape[0]} {data.shape[1]} {data.shape[2]}\n"
        f"space directions: ({sx!r},0,0) (0,{sy!r},0) (0,0,{sz!r})\n"
        "kinds: domain domain domain\n"
        "endian: little\n"
        f"encoding: {encoding}\n"
        f"space origin: ({ox!r},{oy!r},{oz!r})\n"
        + (f"data file: {datafile}\n" if detached else "")
        + "\n"
    ).encode("ascii")
    payload = data.astype(data.dtype.newbyteorder("<")).tobytes(order="F")
    if encoding == "gzip":
        payload = gzip.compress(payload, compresslevel=1)
    if detached:
        with open(path, "wb") as f:
            f.write(hdr)
        with open(os.path.join(os.path.dirname(os.path.abspath(path)), datafile), "wb") as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(hdr + payload)


def save_seg_nrrd(path: str, segments, spacing, origin) -> None:
    """Write a Slicer-compatible segmentation file (`.seg.nrrd`).

    `segments` is an ordered {name: bool array (nx, ny, nz)} mapping; masks
    share one uint8 labelmap layer with label values 1..N (later segments win
    where masks overlap, which the pipeline's disjoint components never do).
    The key:=value metadata follows Slicer's vtkSegmentationConverter
    conventions (master representation, per-segment ID/Name/Color/LabelValue/
    Layer/Extent), so Slicer loads the file directly as a segmentation node —
    the counterpart of the reference's in-scene "AutoBodySegmentation" node
    (Mamri/Mamri.py:1322-1341). Geometry is the package's axis-aligned LPS.
    """
    if not segments:
        raise ValueError("save_seg_nrrd needs at least one segment")
    names = list(segments.keys())
    first = np.asarray(segments[names[0]])
    labelmap = np.zeros(first.shape, dtype=np.uint8)
    meta_lines = []
    palette = [(0.9, 0.6, 0.3), (0.3, 0.7, 0.4), (0.4, 0.5, 0.9), (0.8, 0.3, 0.6)]
    for i, name in enumerate(names):
        if not name or not name.isascii() or not name.isprintable():
            raise ValueError(
                f"segment name {name!r} must be printable single-line ASCII "
                "(it is written verbatim into the NRRD header)"
            )
        m = np.asarray(segments[name]).astype(bool)
        if m.shape != labelmap.shape:
            raise ValueError(f"segment {name!r} shape {m.shape} != {labelmap.shape}")
        labelmap[m] = i + 1
        nz = np.nonzero(m)
        extent = (
            " ".join(f"{int(a.min())} {int(a.max())}" for a in nz)
            if m.any() else "0 -1 0 -1 0 -1"
        )
        r, g, b = palette[i % len(palette)]
        meta_lines += [
            f"Segment{i}_ID:=Segment_{i + 1}",
            f"Segment{i}_Name:={name}",
            f"Segment{i}_NameAutoGenerated:=0",
            f"Segment{i}_Color:={r} {g} {b}",
            f"Segment{i}_ColorAutoGenerated:=1",
            f"Segment{i}_LabelValue:={i + 1}",
            "Segment{}_Layer:=0".format(i),
            f"Segment{i}_Extent:={extent}",
            f"Segment{i}_Tags:=TerminologyEntry:Segmentation category and type"
            " - 3D Slicer General Anatomy list"
            "~SCT^123037004^Anatomical Structure~^^~^^~Anatomic codes - DICOM master list~^^~^^|",
        ]
    sx, sy, sz = (float(v) for v in np.asarray(spacing))
    ox, oy, oz = (float(v) for v in np.asarray(origin))
    hdr = (
        "NRRD0004\n"
        "# written by mamri_tpu_torch (Slicer segmentation conventions)\n"
        "type: unsigned char\n"
        "dimension: 3\n"
        "space: left-posterior-superior\n"
        f"sizes: {labelmap.shape[0]} {labelmap.shape[1]} {labelmap.shape[2]}\n"
        f"space directions: ({sx!r},0,0) (0,{sy!r},0) (0,0,{sz!r})\n"
        "kinds: domain domain domain\n"
        "encoding: gzip\n"
        f"space origin: ({ox!r},{oy!r},{oz!r})\n"
        "Segmentation_ContainedRepresentationNames:=Binary labelmap|\n"
        "Segmentation_MasterRepresentation:=Binary labelmap\n"
        + "".join(line + "\n" for line in meta_lines)
        + "\n"
    ).encode("ascii")
    with open(path, "wb") as f:
        f.write(hdr + gzip.compress(labelmap.tobytes(order="F"), compresslevel=1))


def load_seg_nrrd(path: str):
    """Read a Slicer segmentation file (`.seg.nrrd`).

    Returns `(segments, labelmap)` where `segments` is an ordered
    {name: bool (nx, ny, nz) mask} dict and `labelmap` is the merged label
    `Volume` (float32 label values; for multi-layer files, later layers win
    where segments overlap). Handles both layouts Slicer writes: a 3-D
    shared labelmap (non-overlapping segments) and a 4-D multi-layer
    labelmap (overlapping segments; the layer axis is the one whose space
    direction is `none`). Segment identity comes from the Segment{i}_* NRRD
    key:=value metadata. Oblique orientations are rejected — label values
    cannot be trilinearly resampled; permutation/flip orientations normalize
    exactly like every other loader here.
    """
    with open(path, "rb") as f:
        raw = f.read()
    fields, kvs, data_off = _parse_nrrd_header(raw, path)

    try:
        ndim = int(fields["dimension"])
        sizes = [int(s) for s in fields["sizes"].split()]
    except (KeyError, ValueError) as e:
        raise ValueError(f"{path}: missing/invalid dimension or sizes") from e
    if ndim not in (3, 4) or len(sizes) != ndim or any(s <= 0 for s in sizes):
        raise ValueError(f"{path}: unsupported segmentation layout (dimension={ndim}, sizes={sizes})")

    dt = _nrrd_dtype(fields, path)
    if fields.get("data file") or fields.get("datafile"):
        raise ValueError(f"{path}: detached segmentation headers are not supported")

    count = int(np.prod(sizes))
    flat = _nrrd_decode(raw[data_off:], fields.get("encoding", "raw"), dt, count, path)
    arr = flat.reshape(sizes, order="F")

    dir_toks = re.findall(r"\(.*?\)|none|NONE|None", fields.get("space directions", ""))
    vecs = [_parse_nrrd_vector(t, path) for t in dir_toks]
    if ndim == 4:
        layer_axes = [i for i, v in enumerate(vecs) if v is None]
        if len(vecs) != 4 or len(layer_axes) != 1:
            raise ValueError(f"{path}: a 4-D segmentation needs exactly one 'none' space direction")
        layer_axis = layer_axes[0]
        nlayers = sizes[layer_axis]
        layers = np.moveaxis(arr, layer_axis, 0)
        vecs = [v for v in vecs if v is not None]
    else:
        nlayers = 1
        layers = arr[None]
    # shared geometry resolution with load_nrrd (incl. the legacy `spacings`
    # fallback); labels additionally demand an axis-aligned orientation
    affine = _nrrd_affine(fields, path, vecs=vecs if vecs else None)
    if not _is_axis_aligned(affine[:, :3]):
        raise ValueError(
            f"{path}: oblique segmentation labelmaps cannot be resampled losslessly"
        )

    vols = [volume_from_affine(np.ascontiguousarray(layers[i]), affine) for i in range(nlayers)]
    geometry = vols[0]

    segments: Dict[str, np.ndarray] = {}
    merged = np.zeros(geometry.data.shape, dtype=np.float32)
    i = 0
    while f"Segment{i}_LabelValue" in kvs or f"Segment{i}_Name" in kvs:
        name = kvs.get(f"Segment{i}_Name", f"Segment_{i + 1}")
        if name in segments:  # duplicate names are legal in Slicer: keep both
            name = f"{name}_{i}"
        try:
            label = int(kvs.get(f"Segment{i}_LabelValue", i + 1))
            layer = int(kvs.get(f"Segment{i}_Layer", 0))
        except ValueError as e:
            raise ValueError(f"{path}: malformed Segment{i} metadata") from e
        if not 0 <= layer < nlayers:
            raise ValueError(f"{path}: Segment{i}_Layer {layer} out of range ({nlayers} layers)")
        mask = vols[layer].data == float(label)
        segments[name] = mask
        merged[mask] = float(label)
        i += 1
    if not segments:  # plain labelmap without Slicer metadata: one segment per value
        for label in np.unique(geometry.data):
            if label != 0.0:
                segments[f"Segment_{int(label)}"] = geometry.data == label
        merged = geometry.data
    labelmap = Volume(data=merged, spacing=geometry.spacing, origin=geometry.origin)
    return segments, labelmap


# ------------------------------------------------------------------ MetaImage

_MET_TYPES = {
    "MET_CHAR": np.int8, "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16, "MET_USHORT": np.uint16,
    "MET_INT": np.int32, "MET_UINT": np.uint32,
    "MET_LONG": np.int32, "MET_ULONG": np.uint32,
    "MET_LONG_LONG": np.int64, "MET_ULONG_LONG": np.uint64,
    "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
}

_MET_BOOL = {"true": True, "false": False, "1": True, "0": False}


def load_metaimage(path: str) -> Volume:
    """Read a MetaImage volume (.mha attached, or .mhd + detached data)."""
    with open(path, "rb") as f:
        raw = f.read()

    fields: Dict[str, str] = {}
    pos = 0
    data_off = None
    while pos < len(raw):
        end = raw.find(b"\n", pos)
        if end < 0:
            end = len(raw)
        line = raw[pos:end].rstrip(b"\r")
        pos = end + 1
        if not line.strip():
            continue
        try:
            text = line.decode("ascii")
        except UnicodeDecodeError as e:
            raise ValueError(f"{path}: binary garbage inside the MetaImage header") from e
        if "=" not in text:
            raise ValueError(f"{path}: malformed MetaImage header line {text!r}")
        key, _, value = text.partition("=")
        key = key.strip().lower()
        fields[key] = value.strip()
        if key == "elementdatafile":  # always the last header field
            data_off = pos
            break
    if data_off is None:
        raise ValueError(f"{path}: MetaImage header has no ElementDataFile")

    if fields.get("objecttype", "Image").lower() != "image":
        raise ValueError(f"{path}: unsupported ObjectType {fields.get('objecttype')!r}")
    if int(fields.get("ndims", 0)) != 3:
        raise ValueError(f"{path}: only NDims = 3 MetaImages are supported")
    if int(fields.get("elementnumberofchannels", 1)) != 1:
        raise ValueError(f"{path}: multi-channel MetaImages are not supported")
    try:
        sizes = [int(s) for s in fields["dimsize"].split()]
    except (KeyError, ValueError) as e:
        raise ValueError(f"{path}: missing/invalid DimSize") from e
    if len(sizes) != 3 or any(s <= 0 for s in sizes):
        raise ValueError(f"{path}: bad DimSize {fields.get('dimsize')!r}")

    et = fields.get("elementtype", "").upper()
    if et not in _MET_TYPES:
        raise ValueError(f"{path}: unsupported ElementType {fields.get('elementtype')!r}")
    msb = _MET_BOOL.get(
        fields.get("elementbyteordermsb", fields.get("binarydatabyteordermsb", "false")).lower(),
        False,
    )
    dt = np.dtype(_MET_TYPES[et]).newbyteorder(">" if msb else "<")

    datafile = fields["elementdatafile"]
    if datafile.upper() == "LIST" or "%" in datafile:
        raise ValueError(f"{path}: per-slice MetaImage data ('{datafile}') is not supported")
    if datafile.upper() == "LOCAL":
        payload = raw[data_off:]
    else:
        dpath = os.path.join(os.path.dirname(os.path.abspath(path)), datafile)
        with open(dpath, "rb") as f:
            payload = f.read()
    compressed = _MET_BOOL.get(fields.get("compresseddata", "false").lower(), False)
    header_skip = int(fields.get("headersize", 0))
    if header_skip > 0:
        payload = payload[header_skip:]
    elif header_skip == -1:
        # MetaIO defines HeaderSize -1 (count back from the end) only for
        # uncompressed data — the compressed byte count is unknowable here
        if compressed:
            raise ValueError(f"{path}: HeaderSize -1 requires uncompressed data")
        payload = payload[len(payload) - int(np.prod(sizes)) * dt.itemsize:]

    if compressed:
        try:
            payload = zlib.decompress(payload)
        except zlib.error as e:
            raise ValueError(f"{path}: corrupt MetaImage CompressedData ({e})") from e
    count = int(np.prod(sizes))
    if len(payload) < count * dt.itemsize:
        raise ValueError(f"{path}: MetaImage data truncated")
    data = np.frombuffer(payload, dtype=dt, count=count).reshape(sizes, order="F")

    spacing = np.array(
        [float(s) for s in fields.get(
            "elementspacing", fields.get("elementsize", "1 1 1")
        ).split()],
        dtype=np.float64,
    )
    offset_f = fields.get("offset") or fields.get("origin") or fields.get("position") or "0 0 0"
    origin = np.array([float(s) for s in offset_f.split()], dtype=np.float64)
    tm_f = (
        fields.get("transformmatrix")
        or fields.get("rotation")
        or fields.get("orientation")
        or "1 0 0 0 1 0 0 0 1"
    )
    tm = np.array([float(s) for s in tm_f.split()], dtype=np.float64)
    if spacing.shape != (3,) or origin.shape != (3,) or tm.shape != (9,):
        raise ValueError(f"{path}: malformed MetaImage geometry fields")
    # ITK MetaImageIO layout: row i of TransformMatrix = direction cosines of
    # axis i, and MetaIO's anatomical space is LPS — affine column c is
    # direction(c) * spacing(c)
    tm = tm.reshape(3, 3)
    affine = np.empty((3, 4), dtype=np.float64)
    for c in range(3):
        affine[:, c] = tm[c, :] * spacing[c]
    affine[:, 3] = origin
    return volume_from_affine(data, affine)


def save_metaimage(path: str, volume: Volume, compressed: bool = True) -> None:
    """Write a .mha (attached LOCAL data, zlib-compressed by default). The
    volume's storage dtype is kept: compact scanner dtypes write as-is and
    re-load compact; everything else writes MET_FLOAT."""
    data = storage_array(volume.data)
    met_name = {
        np.dtype(np.int8): "MET_CHAR", np.dtype(np.uint8): "MET_UCHAR",
        np.dtype(np.int16): "MET_SHORT", np.dtype(np.uint16): "MET_USHORT",
        np.dtype(np.float32): "MET_FLOAT",
    }[data.dtype]
    payload = data.astype(data.dtype.newbyteorder("<")).tobytes(order="F")
    if compressed:
        payload = zlib.compress(payload, 1)
    hdr = (
        "ObjectType = Image\n"
        "NDims = 3\n"
        "BinaryData = True\n"
        "BinaryDataByteOrderMSB = False\n"
        f"CompressedData = {'True' if compressed else 'False'}\n"
        + (f"CompressedDataSize = {len(payload)}\n" if compressed else "")
        + "TransformMatrix = 1 0 0 0 1 0 0 0 1\n"
        f"Offset = {float(volume.origin[0])!r} {float(volume.origin[1])!r} {float(volume.origin[2])!r}\n"
        "AnatomicalOrientation = LPS\n"
        f"ElementSpacing = {float(volume.spacing[0])!r} {float(volume.spacing[1])!r} {float(volume.spacing[2])!r}\n"
        f"DimSize = {data.shape[0]} {data.shape[1]} {data.shape[2]}\n"
        f"ElementType = {met_name}\n"
        "ElementDataFile = LOCAL\n"
    ).encode("ascii")
    with open(path, "wb") as f:
        f.write(hdr + payload)


# ------------------------------------------------------------------- dispatch

def load_volume(path: str) -> Volume:
    """Load any supported volume: DICOM series directory, single .dcm, NIfTI
    (.nii/.nii.gz), NRRD (.nrrd/.nhdr), or MetaImage (.mha/.mhd). Unknown
    extensions are sniffed by magic bytes."""
    if os.path.isdir(path):
        from mamri_tpu_torch.perception.dicom import load_dicom_series

        return load_dicom_series(path)
    low = path.lower()
    if low.endswith(".dcm"):
        from mamri_tpu_torch.perception.dicom import load_dicom

        return load_dicom(path)
    if low.endswith((".nii", ".nii.gz")):
        return load_nifti(path)
    if low.endswith((".nrrd", ".nhdr")):
        return load_nrrd(path)
    if low.endswith((".mha", ".mhd")):
        return load_metaimage(path)

    with open(path, "rb") as f:
        head = f.read(512)
    if head.startswith(b"NRRD000"):
        return load_nrrd(path)
    if head.lstrip()[:10].lower().startswith(b"objecttype"):
        return load_metaimage(path)
    if len(head) >= 132 and head[128:132] == b"DICM":
        from mamri_tpu_torch.perception.dicom import load_dicom

        return load_dicom(path)
    return load_nifti(path)  # NIfTI validates its own magic


# extensions save_volume dispatches on — the single source of truth callers
# (e.g. the CLI convert command) key their format routing off
SAVE_EXTENSIONS = (".nii", ".nii.gz", ".nrrd", ".nhdr", ".mha", ".mhd")


def save_volume(path: str, volume: Volume, **kwargs) -> None:
    """Save by extension (`SAVE_EXTENSIONS`; kwargs pass through to the
    format writer). DICOM output keeps its dedicated API
    (`save_dicom_series` / `save_dicom_multiframe` — it needs series knobs)."""
    low = path.lower()
    if low.endswith((".nii", ".nii.gz")):
        save_nifti(path, volume, **kwargs)
    elif low.endswith((".nrrd", ".nhdr")):
        save_nrrd(path, volume, **kwargs)
    elif low.endswith((".mha", ".mhd")):
        save_metaimage(path, volume, **kwargs)
    else:
        raise ValueError(f"cannot infer a volume format from {path!r}")
