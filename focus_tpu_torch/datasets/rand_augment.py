"""RandAugment for video with box co-transforms (a copy of
``focus_tpu/datasets/rand_augment.py``).

Counterpart of the reference's timm-derived ``rand_augment.py`` plus
``boxes_autoaugment/`` (which re-applies geometric ops to boxes). Config
strings like ``rand-m7-n4-mstd0.5-inc1`` are parsed the timm way.
Geometric ops (shear, translate, rotate) move the boxes through the same
affine; photometric ops leave them as they are. Numpy and PIL on the host;
PIL is imported where an op runs.
"""

from __future__ import annotations

import functools
import math
import re
from typing import Optional

import numpy as np

_MAX_LEVEL = 10.0
_FILL = (128, 128, 128)


def _affine_boxes(boxes, matrix, w, h):
    """Apply the inverse-mapped PIL affine to xyxy boxes (PIL's matrix maps
    output coords -> input coords, so boxes move by the forward affine)."""
    if boxes is None:
        return None
    a, b, c, d, e, f = matrix
    # forward transform = inverse of PIL's (which is output->input)
    det = a * e - b * d
    ia, ib, ic = e / det, -b / det, (b * f - e * c) / det
    id_, ie, if_ = -d / det, a / det, (d * c - a * f) / det
    out = boxes.copy()
    corners = np.stack(
        [
            boxes[..., [0, 1]], boxes[..., [2, 1]],
            boxes[..., [0, 3]], boxes[..., [2, 3]],
        ],
        axis=-2,
    )  # [..., 4corners, 2]
    x = corners[..., 0] * ia + corners[..., 1] * ib + ic
    y = corners[..., 0] * id_ + corners[..., 1] * ie + if_
    out[..., 0] = x.min(-1)
    out[..., 1] = y.min(-1)
    out[..., 2] = x.max(-1)
    out[..., 3] = y.max(-1)
    return out


def _apply_affine(img, matrix, resample):
    from PIL import Image

    return img.transform(
        img.size, Image.AFFINE, matrix, resample, fillcolor=_FILL
    )


# Each op: (fn(img, level, boxes) -> (img, boxes), uses magnitude)

def _shear_x(img, v, boxes, resample):
    m = (1, v, 0, 0, 1, 0)
    return (_apply_affine(img, m, resample),
            _affine_boxes(boxes, m, *img.size))


def _shear_y(img, v, boxes, resample):
    m = (1, 0, 0, v, 1, 0)
    return (_apply_affine(img, m, resample),
            _affine_boxes(boxes, m, *img.size))


def _translate_x(img, v, boxes, resample):
    pixels = v * img.size[0]
    m = (1, 0, pixels, 0, 1, 0)
    return (_apply_affine(img, m, resample),
            _affine_boxes(boxes, m, *img.size))


def _translate_y(img, v, boxes, resample):
    pixels = v * img.size[1]
    m = (1, 0, 0, 0, 1, pixels)
    return (_apply_affine(img, m, resample),
            _affine_boxes(boxes, m, *img.size))


def _rotate(img, v, boxes, resample):
    w, h = img.size
    angle = math.radians(v)
    cos, sin = math.cos(angle), math.sin(angle)
    cx, cy = w / 2, h / 2
    # PIL rotate about center: output->input matrix
    m = (cos, sin, cx - cx * cos - cy * sin, -sin, cos, cy + cx * sin - cy * cos)
    return _apply_affine(img, m, resample), _affine_boxes(boxes, m, w, h)


def _solarize_add(im, v):
    from PIL import Image

    a = np.asarray(im)
    return Image.fromarray(
        np.where(a < 128, np.clip(a.astype(np.int32) + int(v), 0, 255),
                 a.astype(np.int32)).astype(np.uint8))


@functools.lru_cache(maxsize=None)
def _photometric_ops():
    """The photometric ops, ``fn(img, level) -> img``, by name."""
    from PIL import ImageEnhance, ImageOps

    return {
        "AutoContrast": lambda im, v: ImageOps.autocontrast(im),
        "Equalize": lambda im, v: ImageOps.equalize(im),
        "Invert": lambda im, v: ImageOps.invert(im),
        "Posterize": lambda im, v: ImageOps.posterize(im, max(1, int(v))),
        "Solarize": lambda im, v: ImageOps.solarize(im, int(v)),
        "SolarizeAdd": _solarize_add,
        "Color": lambda im, v: ImageEnhance.Color(im).enhance(v),
        "Contrast": lambda im, v: ImageEnhance.Contrast(im).enhance(v),
        "Brightness": lambda im, v: ImageEnhance.Brightness(im).enhance(v),
        "Sharpness": lambda im, v: ImageEnhance.Sharpness(im).enhance(v),
    }


_AFFINE = {
    "Rotate": _rotate,
    "ShearX": _shear_x,
    "ShearY": _shear_y,
    "TranslateXRel": _translate_x,
    "TranslateYRel": _translate_y,
}
_AFFINE_OPS = set(_AFFINE)

# the op names in the JAX package's order: the draws index this list
_RAND_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness", "ShearX",
    "ShearY", "TranslateXRel", "TranslateYRel",
]


def _level_to_arg(name, level, increasing):
    frac = level / _MAX_LEVEL
    if name in ("ShearX", "ShearY"):
        return frac * 0.3
    if name in ("TranslateXRel", "TranslateYRel"):
        return frac * 0.45
    if name == "Rotate":
        return frac * 30.0
    if name == "Posterize":
        if increasing:
            return 4 - int(frac * 4)
        return int(frac * 4) + 4
    if name == "Solarize":
        if increasing:
            return 256 - int(frac * 256)
        return int(frac * 256)
    if name == "SolarizeAdd":
        return int(frac * 110)
    if name in ("Color", "Contrast", "Brightness", "Sharpness"):
        if increasing:
            # the sign from numpy's global generator, as the JAX package
            return 1.0 + frac * 0.9 * (1 if np.random.rand() > 0.5 else -1)
        return frac * 1.8 + 0.1
    return frac


def parse_aa_config(config_str: str):
    """Parse a timm rand-augment string: rand-m{M}-n{N}-mstd{S}-inc{I}."""
    magnitude, num_layers, mstd, increasing = 9, 2, 0.0, False
    for part in config_str.split("-")[1:]:
        m = re.match(r"([a-z]+)([0-9.]+)", part)
        if not m:
            continue
        key, val = m.group(1), m.group(2)
        if key == "m":
            magnitude = float(val)
        elif key == "n":
            num_layers = int(val)
        elif key == "mstd":
            mstd = float(val)
        elif key == "inc":
            increasing = bool(int(val))
    return magnitude, num_layers, mstd, increasing


def _resample_choices(interpolation):
    """cfg.AUG.INTERPOLATION's PIL filters (timm's 'random': bilinear or
    bicubic, drawn per op); unknown names take bilinear."""
    from PIL import Image

    return {
        "bilinear": (Image.BILINEAR,),
        "bicubic": (Image.BICUBIC,),
        "nearest": (Image.NEAREST,),
        "random": (Image.BILINEAR, Image.BICUBIC),
    }.get(interpolation, (Image.BILINEAR,))


def rand_augment_video(
    frames: np.ndarray,
    boxes: Optional[np.ndarray],
    config_str: str,
    different_per_frame: bool = False,
    rng: Optional[np.random.RandomState] = None,
    interpolation: str = "bilinear",
):
    """frames: [T, H, W, C] uint8; boxes: [T, O, 4] xyxy pixels or None.
    ``interpolation`` (cfg.AUG.INTERPOLATION, timm semantics) selects
    the affine resampling filter. Returns (frames, boxes)."""
    from PIL import Image

    rng = rng or np.random.RandomState()
    magnitude, num_layers, mstd, increasing = parse_aa_config(config_str)
    resample_choices = _resample_choices(interpolation)
    photometric = _photometric_ops()
    T = frames.shape[0]

    def sample_ops():
        names = rng.choice(_RAND_TRANSFORMS, num_layers)
        levels = [
            np.clip(rng.normal(magnitude, mstd) if mstd > 0 else magnitude,
                    0, _MAX_LEVEL)
            for _ in names
        ]
        return list(zip(names, levels))

    out_frames = np.empty_like(frames)
    out_boxes = boxes.copy() if boxes is not None else None
    ops = sample_ops()
    for t in range(T):
        if different_per_frame and t > 0:
            ops = sample_ops()
        img = Image.fromarray(frames[t])
        fb = out_boxes[t] if out_boxes is not None else None
        for name, level in ops:
            v = _level_to_arg(name, level, increasing)
            # random sign for geometric ops (timm behaviour)
            if name in _AFFINE_OPS and rng.rand() > 0.5:
                v = -v
            if name in _AFFINE_OPS:
                rs = resample_choices[
                    rng.randint(len(resample_choices))
                    if len(resample_choices) > 1 else 0
                ]
                img, fb = _AFFINE[name](img, v, fb, resample=rs)
            else:
                img = photometric[name](img, v)
        out_frames[t] = np.asarray(img)
        if out_boxes is not None:
            w, h = img.size
            fb[..., [0, 2]] = np.clip(fb[..., [0, 2]], 0, w - 1)
            fb[..., [1, 3]] = np.clip(fb[..., [1, 3]], 0, h - 1)
            out_boxes[t] = fb
    return out_frames, out_boxes
