"""Reader/writer for the OpenCV FileStorage YAML dialect.

The reference stores calibration in OpenCV `FileStorage` YAML
(intrinsics.yml / extrinsics.yml, read at main.cpp:61-78). The dialect is
almost-YAML: a `%YAML:1.0` directive (invalid per spec) and `!!opencv-matrix`
tagged mappings with `rows/cols/dt/data`. This module parses that dialect into
numpy arrays without requiring OpenCV.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np

_DT_TO_NUMPY = {
    "d": np.float64,
    "f": np.float32,
    "i": np.int32,
    "s": np.int16,
    "u": np.uint8,
}
_NUMPY_TO_DT = {np.dtype(v): k for k, v in _DT_TO_NUMPY.items()}


def _matrix_constructor(loader, node):
    mapping = loader.construct_mapping(node, deep=True)
    rows = int(mapping["rows"])
    cols = int(mapping["cols"])
    dtype = _DT_TO_NUMPY.get(mapping.get("dt", "d"), np.float64)
    data = np.asarray(mapping["data"], dtype=dtype)
    return data.reshape(rows, cols)


def _yaml():
    """PyYAML, imported at first use: only calibration files need it."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "reading OpenCV FileStorage calibration files needs PyYAML "
            "(the `yaml` module), which is not installed"
        ) from e
    return yaml


def _get_loader():
    yaml = _yaml()

    class _FSLoader(yaml.SafeLoader):
        pass

    # OpenCV writes `!!opencv-matrix` (resolved tag below); some writers emit
    # the single-bang local-tag form.
    _FSLoader.add_constructor("tag:yaml.org,2002:opencv-matrix", _matrix_constructor)
    _FSLoader.add_constructor("!opencv-matrix", _matrix_constructor)
    return _FSLoader


def read_filestorage(path: str) -> Dict[str, Any]:
    """Parse an OpenCV FileStorage YAML file into a dict.

    opencv-matrix nodes become numpy arrays; scalars and plain lists pass
    through (e.g. `ROI1: [49, 43, 233, 156]` -> list of ints).
    """
    with open(path, "r") as f:
        text = f.read()
    # Strip the non-standard `%YAML:1.0` directive (OpenCV emits it with a
    # colon, which standard YAML rejects).
    text = re.sub(r"^%YAML[:\s][^\n]*\n", "", text)
    data = _yaml().load(text, Loader=_get_loader())
    return data or {}


def _format_matrix(name: str, arr: np.ndarray) -> str:
    arr = np.atleast_2d(np.asarray(arr))
    dt = _NUMPY_TO_DT.get(arr.dtype, "d")
    if dt == "d":
        vals = ", ".join(repr(float(v)) for v in arr.ravel())
    else:
        vals = ", ".join(str(int(v)) for v in arr.ravel())
    return (
        f"{name}: !!opencv-matrix\n"
        f"   rows: {arr.shape[0]}\n"
        f"   cols: {arr.shape[1]}\n"
        f"   dt: {dt}\n"
        f"   data: [ {vals} ]\n"
    )


def write_filestorage(path: str, entries: Dict[str, Any]) -> None:
    """Write a dict to OpenCV FileStorage YAML (matrices, scalars, lists)."""
    out = ["%YAML:1.0\n"]
    for name, value in entries.items():
        if isinstance(value, np.ndarray):
            out.append(_format_matrix(name, value))
        elif isinstance(value, (list, tuple)):
            out.append(f"{name}: [ " + ", ".join(str(v) for v in value) + " ]\n")
        elif isinstance(value, float):
            out.append(f"{name}: {value!r}\n")
        else:
            out.append(f"{name}: {value}\n")
    with open(path, "w") as f:
        f.write("".join(out))
