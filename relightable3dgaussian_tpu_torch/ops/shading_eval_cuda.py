"""Kernel K6: the stage-2 eval shading, fused, on the card.

K6 (`csrc/shading_eval.cu`) replaces no TPU kernel: the JAX package leaves
the eval shading to XLA's fusion
(relightable3dgaussian_tpu/models/render_neilf.py::_shade_chunk_reduced).
It runs once over every point: the env lookup (`ops/env_lookup_cuda.py::
equirect_query`), the local SH light, the GGX chain of
`ops/shading.py::rendering_equation` and the means over the samples, with
no per-sample value in device memory.

`rendering_equation_eval` takes `rendering_equation`'s inputs with the
light model `env` (`models/lights.py`: K6 reads its activated map,
`env.get_env()`, and applies its `env.transform` where that is not None)
and returns (pbr,
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

import torch

from . import _build
from .env_lookup_cuda import equirect_query_plain
from .shading import rendering_equation

KERNEL = "shading_eval"
_K6 = _build.Entry(KERNEL, "r3dg_shade_eval", "pppppppppp iiii ppppppp", "K6",
                   ("k6.launches",))
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
    `equirect_query_plain` of the light (grid_sample, on any device) over
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
            incidents_shs[sl],
            lambda d: equirect_query_plain(env.get_env(), d, env.transform),
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
    env_map = env.get_env()
    devices = {a.device.type for a in (*args, env_map)}
    if devices == {"cpu"}:
        return rendering_equation_eval_reference(
            base_color, roughness, normals, viewdirs, incidents_shs, env,
            visibility, incident_dirs, incident_areas, chunk_samples)
    if devices != {"cuda"}:
        raise ValueError(f"rendering_equation_eval: inputs on "
                         f"{sorted(devices)}; expected all on CPU or all on "
                         "CUDA")
    pbr, dif, spec, light, local, glob, vis = _launch(
        *_layout(base_color, roughness, normals, viewdirs, incidents_shs,
                 env_map, env.transform, visibility, incident_dirs,
                 incident_areas))
    return pbr, dict(zip(EXTRA_KEYS, (light, local, glob, dif, spec,
                                      vis[:, None])))


def kernel_inputs(base_color, roughness, normals, viewdirs, incidents_shs,
                  env, visibility, incident_dirs, incident_areas):
    """K6's layout (`_layout`) of `rendering_equation_eval`'s inputs, the
    light model `env` read as its activated map and its transform."""
    return _layout(base_color, roughness, normals, viewdirs, incidents_shs,
                   env.get_env(), env.transform, visibility, incident_dirs,
                   incident_areas)


def _layout(base_color, roughness, normals, viewdirs, incidents_shs, env_map,
            transform, visibility, incident_dirs, incident_areas):
    """K6's layout: [P, S, 3] dirs, [P, S] visibility and area, [P]
    roughness, [P, 48] SH as views of the inputs (no copy), the map
    [H, W, 3] and the light transform [3, 3] or None made contiguous (a map
    upsampled in training is a strided view). Raises unless every input is
    a contiguous float32 tensor of K6's shape on the visibility's device:
    the only check before a launch."""
    if visibility.dim() != 3:
        raise ValueError(f"K6 visibility: got shape {tuple(visibility.shape)}"
                         ", expected [P, S, 1]")
    P, S = visibility.shape[:2]
    env_map = env_map.detach().contiguous()
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
    _build.check_tensors("K6", visibility.device, expect)
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
    _K6(vis.device, dirs, vis, area, bc, rough, nrm, vdir, shs, env_map,
        transform, P, S, H, W, *outs)
    return tuple(outs)
