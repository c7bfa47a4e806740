"""Stdlib-only GIFTI (.gii) reader/writer (the port's own copy of
``surface_vision_transformers_tpu.data.gifti``).

GIFTI is XML + (gzipped) base64 arrays, so this module reads and writes the
subset the framework needs with xml.etree + zlib + base64 only (no nibabel):

  * DataArray decoding for ASCII / Base64Binary / GZipBase64Binary encodings,
    all NIFTI numeric dtypes, both endiannesses, row/column-major order;
  * ``agg_data()``: per-vertex metric arrays (one DataArray per channel)
    stack to (num_darrays, V), as nibabel's does;
  * a writer emitting GZipBase64Binary files readable by nibabel /
    Connectome Workbench. A sphere surface is two arrays, the (G, 3)
    vertex coordinates then the (F, 3) triangles, which is how
    ``augmentation.sphere_path`` is read.
"""

from __future__ import annotations

import base64
import dataclasses
import os
import xml.etree.ElementTree as ET
import zlib

import numpy as np

_DTYPES = {
    "NIFTI_TYPE_UINT8": np.uint8,
    "NIFTI_TYPE_INT8": np.int8,
    "NIFTI_TYPE_UINT16": np.uint16,
    "NIFTI_TYPE_INT16": np.int16,
    "NIFTI_TYPE_UINT32": np.uint32,
    "NIFTI_TYPE_INT32": np.int32,
    "NIFTI_TYPE_UINT64": np.uint64,
    "NIFTI_TYPE_INT64": np.int64,
    "NIFTI_TYPE_FLOAT32": np.float32,
    "NIFTI_TYPE_FLOAT64": np.float64,
}
_DTYPE_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclasses.dataclass
class GiftiDataArray:
    data: np.ndarray
    intent: str = "NIFTI_INTENT_NONE"
    meta: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class GiftiImage:
    darrays: list
    meta: dict = dataclasses.field(default_factory=dict)

    def agg_data(self) -> np.ndarray:
        """Stack all data arrays along a new leading axis (1-D arrays of
        equal length -> (K, V)); single array returns as-is."""
        arrays = [d.data for d in self.darrays]
        if len(arrays) == 1:
            return arrays[0]
        if all(a.shape == arrays[0].shape for a in arrays):
            return np.stack(arrays, axis=0)
        return tuple(arrays)


def _decode_darray(el: ET.Element, ns: str) -> GiftiDataArray:
    attrs = el.attrib
    dtype = _DTYPES[attrs["DataType"]]
    ndim = int(attrs.get("Dimensionality", 1))
    shape = tuple(int(attrs[f"Dim{i}"]) for i in range(ndim))
    encoding = attrs.get("Encoding", "GZipBase64Binary")
    endian = attrs.get("Endian", "LittleEndian")
    order = attrs.get("ArrayIndexingOrder", "RowMajorOrder")

    data_el = el.find(f"{ns}Data")
    text = (data_el.text or "") if data_el is not None else ""

    np_dtype = np.dtype(dtype)
    if endian == "BigEndian":
        np_dtype = np_dtype.newbyteorder(">")

    if encoding == "ASCII":
        arr = np.array(text.split(), dtype=dtype)
    elif encoding in ("Base64Binary", "GZipBase64Binary"):
        raw = base64.b64decode(text)
        if encoding == "GZipBase64Binary":
            raw = zlib.decompress(raw, zlib.MAX_WBITS | 32)  # gzip or zlib
        arr = np.frombuffer(raw, dtype=np_dtype).astype(dtype)
    elif encoding == "ExternalFileBinary":
        raise NotImplementedError("ExternalFileBinary GIFTI not supported")
    else:
        raise ValueError(f"unknown GIFTI encoding {encoding!r}")

    arr = arr.reshape(shape, order="C" if order == "RowMajorOrder" else "F")

    meta = _read_meta(el, ns)
    return GiftiDataArray(
        data=arr, intent=attrs.get("Intent", "NIFTI_INTENT_NONE"), meta=meta
    )


def _read_meta(el: ET.Element, ns: str) -> dict:
    meta = {}
    md = el.find(f"{ns}MetaData")
    if md is not None:
        for m in md.findall(f"{ns}MD"):
            name = m.find(f"{ns}Name")
            value = m.find(f"{ns}Value")
            if name is not None and value is not None:
                meta[name.text] = value.text
    return meta


def load(path: str | os.PathLike) -> GiftiImage:
    """Read a .gii file (plain or .gii.gz)."""
    path = os.fspath(path)
    if path.endswith(".gz"):
        import gzip

        with gzip.open(path, "rb") as f:
            root = ET.fromstring(f.read())
    else:
        root = ET.parse(path).getroot()
    ns = root.tag[: -len("GIFTI")] if root.tag.endswith("GIFTI") else ""
    darrays = [_decode_darray(el, ns) for el in root.findall(f"{ns}DataArray")]
    return GiftiImage(darrays=darrays, meta=_read_meta(root, ns))


def save(
    data: np.ndarray | list,
    path: str | os.PathLike,
    intent: str | list = "NIFTI_INTENT_NONE",
) -> None:
    """Write array(s) as a GIFTI file (GZipBase64Binary), the equivalent of
    the reference's save_gifti (utils/utils.py:38-41). ``intent`` is one
    NIFTI intent for every array or a list of one per array."""
    arrays = data if isinstance(data, (list, tuple)) else [data]
    intents = [intent] * len(arrays) if isinstance(intent, str) else list(intent)
    root = ET.Element("GIFTI", Version="1.0", NumberOfDataArrays=str(len(arrays)))
    for arr, intent in zip(arrays, intents, strict=True):
        arr = np.asarray(arr)
        if arr.dtype not in _DTYPE_NAMES:
            arr = arr.astype(np.float32)
        attrs = {
            "Intent": intent,
            "DataType": _DTYPE_NAMES[arr.dtype],
            "ArrayIndexingOrder": "RowMajorOrder",
            "Dimensionality": str(arr.ndim),
            "Encoding": "GZipBase64Binary",
            "Endian": "LittleEndian",
        }
        for i, d in enumerate(arr.shape):
            attrs[f"Dim{i}"] = str(d)
        da = ET.SubElement(root, "DataArray", **attrs)
        payload = base64.b64encode(zlib.compress(arr.tobytes())).decode("ascii")
        ET.SubElement(da, "Data").text = payload
    tree = ET.ElementTree(root)
    ET.indent(tree)
    tree.write(path, xml_declaration=True, encoding="utf-8")


def save_sphere(verts: np.ndarray, faces: np.ndarray, path: str | os.PathLike) -> None:
    """A sphere surface (.surf.gii): (G, 3) float64 vertex coordinates as a
    POINTSET, then (F, 3) int32 triangles."""
    save([np.asarray(verts, np.float64), np.asarray(faces, np.int32)], path,
         intent=["NIFTI_INTENT_POINTSET", "NIFTI_INTENT_TRIANGLE"])
