"""The eval shading against the JAX package's
(relightable3dgaussian_tpu/models/render_neilf.py::_shade_chunk_reduced),
on seeded inputs kept in `tests/data/eval_shading_jax.npz` with JAX's
outputs for them in float32 and in float64, so that the card's kernel K6 is
held to JAX by `test_torch_shading_eval.py::test_k6_matches_jax` on a
machine without jax.

Here, on the CPU: the file holds what JAX computes today for the inputs it
holds, those inputs are `shading_inputs`' for their seed, and the port's
plain version (`rendering_equation_eval` on CPU tensors) matches JAX in
either precision.
Rewrite the file with
`JAX_PLATFORMS=cpu python tests/test_torch_shading_eval_jax.py`.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path[:0] = [str(Path(__file__).resolve().parents[i]) for i in (0, 1)]

from relightable3dgaussian_tpu.models import lights as jax_lights  # noqa: E402
from relightable3dgaussian_tpu.models.render_neilf import \
    _shade_chunk_reduced  # noqa: E402
from relightable3dgaussian_tpu_torch.models.lights import \
    EnvLight  # noqa: E402
from relightable3dgaussian_tpu_torch.ops import \
    shading_eval_cuda as K6  # noqa: E402
from test_torch_shading_eval import (JAX_CASES, JAX_FILE,  # noqa: E402
                                     JAX_INPUTS, TOL, jax_case,
                                     jax_torch_inputs, shading_inputs)


def case_inputs(case: str) -> dict:
    """{name: float32 array} of `shading_inputs` for the case: P points,
    S samples, the light "map" (a softplus'd raw 16 x 32 DirectLightMap) or
    "env" (a 16 x 32 EnvLight turned about z), the special directions
    (poles, the seam at theta = +-pi, views grazing the normal) included."""
    P, S, light, seed = JAX_CASES[case]
    x = shading_inputs(P, S, seed, light)
    env = x[5]
    out = {n: a.numpy() for n, a in zip(JAX_INPUTS, x[:5] + x[6:])}
    if isinstance(env, EnvLight):
        out["env"] = env.envmap.numpy()
        out["transform"] = env.transform.numpy()
    else:
        out["env"] = env.env.detach().numpy()
    return out


def jax_outputs(x: dict, dtype=np.float32) -> dict:
    """JAX's eval shading of the inputs in `dtype`: {"pbr", EXTRA_KEYS...},
    the visibility's mean [P, 1] under its port name."""
    if dtype == np.float64:
        with jax.enable_x64(True):
            return jax_outputs({k: v.astype(dtype) for k, v in x.items()})
    if "transform" in x:
        env = jax_lights.EnvLight(jnp.asarray(x["env"]),
                                  jnp.asarray(x["transform"]))
    else:
        env = jax_lights.DirectLightParams(env=jnp.asarray(x["env"]))
    pbr, red = _shade_chunk_reduced(env,
                                    *(jnp.asarray(x[n]) for n in JAX_INPUTS))
    red = dict(red)
    red["visibility"] = red.pop("incident_visibility")
    out = {"pbr": np.asarray(pbr)}
    out.update({k: np.asarray(red[k]) for k in K6.EXTRA_KEYS})
    return out


def write_cases(path: Path = JAX_FILE) -> None:
    arrays = {}
    for case in JAX_CASES:
        x = case_inputs(case)
        arrays.update({f"{case}/in/{k}": v for k, v in x.items()})
        for key, dtype in (("jax", np.float32), ("jax64", np.float64)):
            arrays.update({f"{case}/{key}/{k}": v
                           for k, v in jax_outputs(x, dtype).items()})
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


def _scale(a) -> float:
    return 1.0 + float(np.abs(a).max())


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_file_holds_jax_outputs_for_its_seeded_inputs(case):
    """The file's inputs are `shading_inputs`' for the case's seed, bit for
    bit, and its outputs are JAX's for them today, in float32 within 1e-6
    of each field's scale (1 + its largest entry), a rounding of the same
    program, and in float64 within 1e-12."""
    x, want, want64 = jax_case(case)
    for k, v in case_inputs(case).items():
        np.testing.assert_array_equal(x[k], v, err_msg=k)
    for dtype, w, tol in ((np.float32, want, 1e-6), (np.float64, want64, 1e-12)):
        got = jax_outputs(x, dtype)
        assert list(got) == list(w) == ["pbr", *K6.EXTRA_KEYS]
        for k in w:
            assert got[k].dtype == w[k].dtype == dtype, k
            assert got[k].shape == w[k].shape, k
            np.testing.assert_allclose(got[k], w[k], rtol=0,
                                       atol=tol * _scale(w[k]), err_msg=k)


@torch.no_grad()
@pytest.mark.parametrize("case", list(JAX_CASES))
def test_cpu_eval_shading_matches_jax(case):
    """The port's plain version on the CPU against JAX, every output: in
    float32 within TOL of the field's scale (K6's tolerance from float64;
    the two float32 programs part by up to ~2e-6 on these inputs), in
    float64 within 1e-7: JAX's lookup keeps its two einsums in float32
    (`preferred_element_type`) under x64 too, which moves its float64
    means by ~1e-8 of the scale."""
    x, want, want64 = jax_case(case)
    for dtype, w_all, tol in ((torch.float32, want, TOL),
                              (torch.float64, want64, 1e-7)):
        pbr, extras = K6.rendering_equation_eval(*jax_torch_inputs(x, dtype))
        got = {"pbr": pbr, **extras}
        assert list(got) == list(w_all)
        for k, w in w_all.items():
            g = got[k].numpy()
            assert g.shape == w.shape and g.dtype == w.dtype, k
            err = float(np.abs(g - w).max())
            assert err <= tol * _scale(w), (k, dtype, err, _scale(w))
    assert float(np.abs(want["pbr"]).max()) > 0.1


if __name__ == "__main__":
    write_cases()
    print(f"wrote {JAX_FILE}")
