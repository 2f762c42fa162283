"""LPIPS perceptual metric, VGG16 backbone (port of
relightable3dgaussian_tpu/losses/lpips.py).

The reference's vendored lpipsPyTorch: z-scored input, VGG16 features
tapped after each of its 5 conv stages, channels unit-normalized, learned
1x1 "lin" weights, spatial mean, summed over the stages. The convolutions
are `F.conv2d` (TF32 stays off, as the package sets it on import). No
pretrained weights ship with the repo; they load from a local file:

  * LPIPS_WEIGHTS=/path/to/weights: a torch .pth of the upstream LPIPS
    release or an .npz with the same tensor names; else
    ~/.cache/lpips_vgg.pth or ~/.cache/lpips_vgg.npz;
  * LPIPS_WEIGHTS=random: a seeded He-init backbone with uniform lin
    weights (the JAX package's, from the same numpy generator). Its values
    are self-consistent but not comparable to trained-VGG LPIPS, so the
    evals name it `lpips(random-vgg)`;
  * without weights `lpips()` returns NaN and `available()` is False, and
    the evals report PSNR and SSIM alone.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch
import torch.nn.functional as F

_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"]
_STAGE_ENDS = (1, 3, 6, 9, 12)  # conv indices after which features are tapped
# The input z-score of the reference's BaseNet (lpipsPyTorch/modules/
# networks.py:40-44), applied to [0, 1] images.
_MEAN = (-0.030, -0.088, -0.188)
_STD = (0.458, 0.448, 0.450)

_CACHE: dict = {}


def _weight_path() -> str | None:
    p = os.environ.get("LPIPS_WEIGHTS")
    if p and os.path.exists(p):
        return p
    for name in ("lpips_vgg.pth", "lpips_vgg.npz"):
        default = os.path.expanduser(os.path.join("~", ".cache", name))
        if os.path.exists(default):
            return default
    return None


def _random_weights(seed: int = 0) -> dict[str, np.ndarray]:
    """The seeded VGG16 of LPIPS_WEIGHTS=random: He-normal convolutions in
    torchvision's `features` numbering, zero biases, lin weights 1/C."""
    rng = np.random.default_rng(seed)
    w, c_in, idx, stage_chs = {}, 3, 0, []
    for item in _VGG16_CFG:
        if item == "M":
            idx += 1
            continue
        w[f"features.{idx}.weight"] = rng.normal(
            0, np.sqrt(2.0 / (c_in * 9)), (item, c_in, 3, 3)).astype(np.float32)
        w[f"features.{idx}.bias"] = np.zeros((item,), np.float32)
        stage_chs.append(item)
        c_in = item
        idx += 2
    for i, end in enumerate(_STAGE_ENDS):
        ch = stage_chs[end]
        w[f"lin{i}.model.1.weight"] = np.full((1, ch, 1, 1), 1.0 / ch,
                                              np.float32)
    return w


def _load_weights() -> dict[str, np.ndarray] | None:
    if "w" in _CACHE:
        return _CACHE["w"]
    if os.environ.get("LPIPS_WEIGHTS") == "random":
        _CACHE["w"], _CACHE["random"] = _random_weights(), True
        return _CACHE["w"]
    path = _weight_path()
    if path is None:
        raw = None
    elif path.endswith(".npz"):
        with np.load(path) as f:
            raw = {k: f[k] for k in f.files}
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        raw = {k: v.numpy() for k, v in state.items()}
    _CACHE["w"] = raw
    return raw


def available() -> bool:
    return _load_weights() is not None


def is_random_backbone() -> bool:
    """True when the backbone is LPIPS_WEIGHTS=random's seeded one."""
    _load_weights()
    return bool(_CACHE.get("random"))


def metric_name() -> str:
    """The name the evals give the metric: `lpips(random-vgg)` for the
    random backbone, else `lpips`."""
    return "lpips(random-vgg)" if is_random_backbone() else "lpips"


def _lin_keys(w: dict) -> list[str]:
    """The stage-ordered lin weight keys, in the upstream naming
    (`lin0.model.1.weight`) or the renamed one of the reference's
    get_state_dict (`0.1.weight`, lpipsPyTorch/modules/utils.py:22-28),
    ordered by the parsed stage index."""
    found = {}
    for k in w:
        m = re.fullmatch(r"(?:lin)?(\d+)\.(?:model\.)?1\.weight", k)
        if m:
            found[int(m.group(1))] = k
    if len(found) < 5:
        raise ValueError(f"weight file has {len(found)} lin layers, expected "
                         f"5: {sorted(w)[:10]}...")
    return [found[i] for i in sorted(found)]


def _device_weights(w: dict, device: torch.device):
    """(the 13 convolutions' (weight, bias), the 5 lin weights) as tensors
    on `device`, cached per device."""
    key = ("t", id(w), str(device))
    if key not in _CACHE:
        names = sorted((k for k in w if "features" in k
                        and k.endswith(".weight")),
                       key=lambda k: int(k.split(".")[-2]))

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        convs = [(t(w[k]), t(w[k.replace(".weight", ".bias")]))
                 for k in names]
        lins = [t(w[k]).reshape(1, -1, 1, 1) for k in _lin_keys(w)]
        _CACHE[key] = (convs, lins)
    return _CACHE[key]


def _vgg_features(x: torch.Tensor, convs) -> list[torch.Tensor]:
    """x [N, 3, H, W], z-scored → the 5 stage features."""
    feats, conv_i = [], 0
    for item in _VGG16_CFG:
        if item == "M":
            x = F.max_pool2d(x, 2, 2)
        else:
            weight, bias = convs[conv_i]
            x = F.relu(F.conv2d(x, weight, bias, padding=1))
            if conv_i in _STAGE_ENDS:
                feats.append(x)
            conv_i += 1
    return feats


@torch.no_grad()
def lpips(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Perceptual distance between [3, H, W] (or [N, 3, H, W]) images in
    [0, 1], on their device; NaN without weights."""
    w = _load_weights()
    if w is None:
        return torch.tensor(float("nan"), device=img1.device)
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    convs, lins = _device_weights(w, img1.device)
    mean = torch.tensor(_MEAN, device=img1.device)[None, :, None, None]
    std = torch.tensor(_STD, device=img1.device)[None, :, None, None]
    f1 = _vgg_features((img1.float() - mean) / std, convs)
    f2 = _vgg_features((img2.float() - mean) / std, convs)
    total = 0.0
    for a, b, lin in zip(f1, f2, lins):
        # normalize_activation (lpipsPyTorch/modules/utils.py:6-8): the eps
        # is added to the norm, not inside the square root
        a = a / (torch.sqrt((a ** 2).sum(1, keepdim=True)) + 1e-10)
        b = b / (torch.sqrt((b ** 2).sum(1, keepdim=True)) + 1e-10)
        total = total + ((a - b) ** 2 * lin).sum(1).mean((-1, -2))
    return total.mean()
