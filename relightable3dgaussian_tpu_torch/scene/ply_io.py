"""PLY I/O: generic vertex-element codec + the gaussian attribute schema.

The port's own copy of relightable3dgaussian_tpu/scene/ply_io.py, numpy
only: the same bytes for the same parameters, so PLY files interchange with
the JAX package. The gaussian schema is that of the reference checkpoints
(gaussian_model.py:507-665): float32 properties
  x y z nx ny nz f_dc_{0..2} f_rest_{0..44} opacity scale_{0..2} rot_{0..3}
  [base_color_{0..2} roughness incidents_dc_{0..2} incidents_rest_{0..44}
   visibility_dc_0 visibility_rest_{0..14}]
with SH blocks flattened channel-major ([P, K, C] stored as C x K).
`save_gaussian_ply` takes the fields as a mapping of numpy arrays
(`GaussianModel.to_numpy()`).
"""
from __future__ import annotations

import os
from collections.abc import Mapping
from types import SimpleNamespace

import numpy as np

_HEADER_TYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "ushort": "<u2", "uint16": "<u2", "short": "<i2", "int16": "<i2",
    "uint": "<u4", "uint32": "<u4", "int": "<i4", "int32": "<i4",
}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the `vertex` element of a PLY file → {property: [N] array}."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        props: list[tuple[str, str]] = []
        counts: list[int] = []
        elements: list[tuple[str, int, list]] = []
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated header")
            tok = line.strip().split()
            if not tok:
                continue
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                cur = (tok[1].decode(), int(tok[2]), [])
                elements.append(cur)
            elif tok[0] == b"property":
                if tok[1] == b"list":
                    cur[2].append((tok[-1].decode(), "list",
                                   tok[2].decode(), tok[3].decode()))
                else:
                    cur[2].append((tok[-1].decode(), tok[1].decode()))
            elif tok[0] == b"end_header":
                break
        del props, counts
        if fmt == "ascii":
            return _read_ascii_vertices(f, elements)
        swap = fmt == "binary_big_endian"
        out = {}
        for name, count, plist in elements:
            if any(len(p) == 4 for p in plist):
                raise ValueError(f"{path}: list properties unsupported "
                                 f"in element {name}")
            dt = np.dtype([(p[0], _HEADER_TYPES[p[1]]) for p in plist])
            if swap:
                dt = dt.newbyteorder(">")
            raw = f.read(dt.itemsize * count)
            arr = np.frombuffer(raw, dtype=dt, count=count)
            if name == "vertex":
                out = {p[0]: np.ascontiguousarray(arr[p[0]]) for p in plist}
        return out


def _read_ascii_vertices(f, elements):
    out = {}
    for name, count, plist in elements:
        rows = [f.readline().split() for _ in range(count)]
        arr = np.asarray(rows, dtype=np.float64)
        if name == "vertex":
            out = {p[0]: arr[:, i].astype(np.float32)
                   for i, p in enumerate(plist)}
    return out


def write_ply(path: str, props: dict[str, np.ndarray],
              dtypes: dict[str, str] | None = None) -> None:
    """Write a binary-little-endian PLY with a single `vertex` element."""
    names = list(props)
    n = len(props[names[0]])
    dtypes = dtypes or {}
    dt = np.dtype([(k, dtypes.get(k, "<f4")) for k in names])
    arr = np.empty(n, dtype=dt)
    for k in names:
        arr[k] = np.asarray(props[k]).reshape(n)
    type_names = {"<f4": "float", "u1": "uchar", "<i4": "int", "<f8": "double"}
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property {type_names[dtypes.get(k, '<f4')]} {k}"
               for k in names]
    header.append("end_header")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(arr.tobytes())


# ---------------------------------------------------------------------------
# Point-cloud convenience (storePly / fetchPly equivalents)
# ---------------------------------------------------------------------------

def store_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray,
                      normals: np.ndarray | None = None) -> None:
    normals = np.zeros_like(xyz) if normals is None else normals
    props = {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "nx": normals[:, 0], "ny": normals[:, 1], "nz": normals[:, 2],
        "red": rgb[:, 0].astype(np.uint8),
        "green": rgb[:, 1].astype(np.uint8),
        "blue": rgb[:, 2].astype(np.uint8),
    }
    write_ply(path, props, dtypes={"red": "u1", "green": "u1", "blue": "u1"})


def fetch_point_cloud(path: str):
    """→ (points [N,3], colors [N,3] in [0,1], normals [N,3])."""
    v = read_ply(path)
    xyz = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    if "red" in v:
        col = np.stack([v["red"], v["green"], v["blue"]], -1)
        col = col.astype(np.float32) / 255.0
    else:
        col = np.full_like(xyz, 0.5)
    if "nx" in v:
        nrm = np.stack([v["nx"], v["ny"], v["nz"]], -1).astype(np.float32)
    else:
        nrm = np.zeros_like(xyz)
    return xyz, col, nrm


# ---------------------------------------------------------------------------
# Gaussian model schema
# ---------------------------------------------------------------------------

def _flatten_sh(x: np.ndarray) -> np.ndarray:
    """[P, K, C] → [P, C*K] channel-major (reference layout)."""
    return np.swapaxes(x, 1, 2).reshape(x.shape[0], -1)


def _unflatten_sh(flat: np.ndarray, channels: int) -> np.ndarray:
    """[P, C*K] channel-major → [P, K, C]."""
    p = flat.shape[0]
    k = flat.shape[1] // channels
    return np.swapaxes(flat.reshape(p, channels, k), 1, 2)


def save_gaussian_ply(path: str, params: Mapping[str, np.ndarray],
                      active: np.ndarray | None = None) -> None:
    """Serialize the gaussian fields (field name → array, as
    `GaussianModel.to_numpy()` gives them; active rows only) to the reference
    schema."""
    params = SimpleNamespace(**{"base_color": np.zeros((0, 3), np.float32),
                                **params})

    def np_(x):
        return np.asarray(x, dtype=np.float32)

    mask = (np.ones(np_(params.xyz).shape[0], bool) if active is None
            else np.asarray(active))
    use_pbr = np_(params.base_color).shape[0] == np_(params.xyz).shape[0]

    cols: dict[str, np.ndarray] = {}

    def add(name, arr):
        arr = arr[mask]
        if arr.ndim == 1:
            arr = arr[:, None]
        for i in range(arr.shape[1]):
            cols[name if arr.shape[1] == 1 and name in ("opacity", "roughness")
                 else f"{name}_{i}"] = arr[:, i]

    xyz = np_(params.xyz)[mask]
    nrm = np_(params.normal)[mask]
    for i, k in enumerate("xyz"):
        cols[k] = xyz[:, i]
    for i, k in enumerate(("nx", "ny", "nz")):
        cols[k] = nrm[:, i]
    add("f_dc", _flatten_sh(np_(params.shs_dc)))
    add("f_rest", _flatten_sh(np_(params.shs_rest)))
    add("opacity", np_(params.opacity))
    add("scale", np_(params.scaling))
    add("rot", np_(params.rotation))
    if use_pbr:
        add("base_color", np_(params.base_color))
        add("roughness", np_(params.roughness))
        add("incidents_dc", _flatten_sh(np_(params.incidents_dc)))
        add("incidents_rest", _flatten_sh(np_(params.incidents_rest)))
        add("visibility_dc", _flatten_sh(np_(params.visibility_dc)))
        add("visibility_rest", _flatten_sh(np_(params.visibility_rest)))
    write_ply(path, cols)


def _group(v: dict, prefix: str) -> np.ndarray:
    names = sorted((k for k in v if k.startswith(prefix)
                    and k[len(prefix):].lstrip("_").isdigit()),
                   key=lambda s: int(s.split("_")[-1]))
    return np.stack([v[k] for k in names], -1).astype(np.float32)


def load_gaussian_ply(path: str) -> dict[str, np.ndarray]:
    """Load the reference schema → dict of GaussianParams-style arrays
    (unpadded; caller pads to capacity)."""
    v = read_ply(path)
    p = len(v["x"])
    out = {
        "xyz": np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32),
        "normal": np.stack([v["nx"], v["ny"], v["nz"]], -1).astype(np.float32),
        "shs_dc": _unflatten_sh(_group(v, "f_dc_"), 3),
        "shs_rest": _unflatten_sh(_group(v, "f_rest_"), 3),
        "opacity": v["opacity"].astype(np.float32)[:, None],
        "scaling": _group(v, "scale_"),
        "rotation": _group(v, "rot_"),
    }
    if "base_color_0" in v:
        out.update({
            "base_color": _group(v, "base_color_"),
            "roughness": v["roughness"].astype(np.float32)[:, None],
            "incidents_dc": _unflatten_sh(_group(v, "incidents_dc_"), 3),
            "incidents_rest": _unflatten_sh(_group(v, "incidents_rest_"), 3),
            "visibility_dc": _unflatten_sh(_group(v, "visibility_dc_"), 1),
            "visibility_rest": _unflatten_sh(_group(v, "visibility_rest_"), 1),
        })
    assert out["xyz"].shape == (p, 3)
    return out
