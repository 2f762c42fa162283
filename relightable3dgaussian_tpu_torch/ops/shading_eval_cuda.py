"""Kernel K6: the stage-2 eval shading, fused, on the card.

K6 (`csrc/shading_eval.cu`) replaces no TPU kernel: the JAX package leaves
the eval shading to XLA's fusion
(relightable3dgaussian_tpu/models/render_neilf.py::_shade_chunk_reduced).
It runs once over every point: the env lookup (`models/lights.py::
equirect_query`), the local SH light, the GGX chain of
`ops/shading.py::rendering_equation` and the means over the samples, with
no per-sample value in device memory.

`rendering_equation_eval` takes `rendering_equation`'s inputs with the
light model `env` (an `EnvLight`, whose transform K6 applies, or a
`DirectLightMap`, whose activated image it reads) and returns (pbr,
extras), every entry a mean over the samples: pbr, the diffuse light, the
specular, the incident, local and global lights [P, 3] and the visibility
[P, 1] (`EXTRA_KEYS`):
  * CPU tensors → `rendering_equation_eval_reference`, the plain version:
    `rendering_equation` over chunks of at most `chunk_samples` samples
    (one chunk with None);
  * CUDA tensors → K6, or an exception. Nothing falls back.
The tracer's counter `k6.launches` counts K6's launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.lights import EnvLight, light_image, query_light
from ..utils import trace
from . import _build
from .shading import rendering_equation

KERNEL = "shading_eval"
N_SH = 16          # csrc/shading_eval.cu kSH: degree-3 local-light SH
# The means rendering_equation_eval returns beside pbr; all [P, 3] but the
# visibility's [P, 1].
EXTRA_KEYS = ("incident_lights", "local_incident_lights",
              "global_incident_lights", "diffuse_light", "specular",
              "visibility")


def rendering_equation_eval_reference(base_color, roughness, normals,
                                      viewdirs, incidents_shs, env,
                                      visibility, incident_dirs,
                                      incident_areas,
                                      chunk_samples: int | None = None):
    """The plain version: `rendering_equation` under the plain lookup
    `query_light(env, ., plain=True)` (grid_sample, on any device) over
    chunks of at most `chunk_samples` samples (a bound on its [chunk, S, 3]
    intermediates; None: one chunk), each per-sample light kept only as its
    mean over the samples."""
    P, S = visibility.shape[:2]
    chunk = P if chunk_samples is None else max(1, chunk_samples // S)
    parts = []
    for i in range(0, P, chunk):
        sl = slice(i, i + chunk)
        pbr, ex = rendering_equation(
            base_color[sl], roughness[sl], normals[sl], viewdirs[sl],
            incidents_shs[sl], lambda d: query_light(env, d, plain=True),
            visibility[sl], incident_dirs[sl], incident_areas[sl])
        parts.append((pbr, {k: (v if v.dim() == 2 else v.mean(-2))
                            for k, v in ex.items()}))
    extras = {k: torch.cat([ex[k] for _, ex in parts]) for k in parts[0][1]}
    extras["visibility"] = visibility.mean(-2)
    return torch.cat([p for p, _ in parts]), extras


def rendering_equation_eval(base_color, roughness, normals, viewdirs,
                            incidents_shs, env, visibility, incident_dirs,
                            incident_areas,
                            chunk_samples: int | None = None):
    """The eval shading: the plain version on CPU tensors (in chunks of
    `chunk_samples` samples), K6 on CUDA tensors in one launch. Returns
    (pbr [P, 3], {name: mean over the samples} for `EXTRA_KEYS`)."""
    args = (base_color, roughness, normals, viewdirs, incidents_shs,
            visibility, incident_dirs, incident_areas)
    devices = {a.device.type for a in (*args, _light_tensor(env))}
    if devices == {"cpu"}:
        return rendering_equation_eval_reference(
            base_color, roughness, normals, viewdirs, incidents_shs, env,
            visibility, incident_dirs, incident_areas, chunk_samples)
    if devices != {"cuda"}:
        raise ValueError(f"rendering_equation_eval: inputs on "
                         f"{sorted(devices)}; expected all on CPU or all on "
                         "CUDA")
    pbr, dif, spec, light, local, glob, vis = _launch(
        *kernel_inputs(base_color, roughness, normals, viewdirs,
                       incidents_shs, env, visibility, incident_dirs,
                       incident_areas))
    return pbr, dict(zip(EXTRA_KEYS, (light, local, glob, dif, spec,
                                      vis[:, None])))


def _light_tensor(env) -> torch.Tensor:
    """The tensor that holds the light model's map."""
    if isinstance(env, EnvLight):
        return env.envmap
    return env.env


def kernel_inputs(base_color, roughness, normals, viewdirs, incidents_shs,
                  env, visibility, incident_dirs, incident_areas):
    """K6's layout: [P, S, 3] dirs, [P, S] visibility and area, [P]
    roughness, [P, 48] SH as views of the inputs (no copy), the activated
    map [H, W, 3] and the light transform [3, 3] or None made contiguous
    (a map upsampled in training is a strided view). Raises unless every
    input is a contiguous float32 tensor of K6's shape on the visibility's
    device: the only check before a launch."""
    if visibility.dim() != 3:
        raise ValueError(f"K6 visibility: got shape {tuple(visibility.shape)}"
                         ", expected [P, S, 1]")
    P, S = visibility.shape[:2]
    env_map = light_image(env).detach().contiguous()
    transform = env.transform if isinstance(env, EnvLight) else None
    expect = {"base_color": (base_color, (P, 3)),
              "roughness": (roughness, (P, 1)), "normals": (normals, (P, 3)),
              "viewdirs": (viewdirs, (P, 3)),
              "incidents_shs": (incidents_shs, (P, N_SH, 3)),
              "visibility": (visibility, (P, S, 1)),
              "incident_dirs": (incident_dirs, (P, S, 3)),
              "incident_areas": (incident_areas, (P, S, 1)),
              "env": (env_map, (*env_map.shape[:2], 3))}
    if transform is not None:
        transform = transform.detach().contiguous()
        expect["transform"] = (transform, (3, 3))
    for name, (t, shape) in expect.items():
        if (t.device != visibility.device or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"K6 {name}: got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected float32 {shape} on "
                             f"{visibility.device}")
        if not t.is_contiguous():
            raise ValueError(f"K6 {name}: not contiguous")
    return (incident_dirs.detach(), visibility.detach().view(P, S),
            incident_areas.detach().view(P, S), base_color.detach(),
            roughness.detach().view(P), normals.detach(), viewdirs.detach(),
            incidents_shs.detach().view(P, 3 * N_SH), env_map, transform)


def _launch(dirs, vis, area, bc, rough, nrm, vdir, shs, env_map, transform):
    """K6 on `kernel_inputs`' layout: (pbr, diffuse_light, specular,
    incident, local and global lights), each [P, 3], and the visibility's
    mean [P]."""
    P, S = vis.shape
    H, W = env_map.shape[:2]
    outs = [torch.empty((P, 3), dtype=torch.float32, device=vis.device)
            for _ in range(6)]
    outs.append(torch.empty((P,), dtype=torch.float32, device=vis.device))
    fn = _build.load_library(KERNEL).r3dg_shade_eval
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 8)
        fn.restype = ctypes.c_int
    with torch.cuda.device(vis.device):
        stream = torch.cuda.current_stream(vis.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in (dirs, vis, area, bc, rough, nrm, vdir,
                                         shs, env_map)),
                None if transform is None else transform.data_ptr(),
                P, S, H, W, *(t.data_ptr() for t in outs), stream)
    if rc != 0:
        raise RuntimeError(f"K6 launch failed: cudaError_t {rc}")
    trace.count("k6.launches")
    return tuple(outs)
