"""Spatial transforms on host numpy video [T, H, W, C] (a copy of
``focus_tpu/datasets/transform.py``; box co-transform variants carry boxes
through the same geometry). Resizes are OpenCV's INTER_LINEAR, through
cv2 where it imports; without cv2, uint8 frames take the same fixed-point
arithmetic in numpy and float frames raise.
"""

from __future__ import annotations

import functools
import math

import numpy as np


def _resize_frames(frames: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    dtype = frames.dtype
    if frames.dtype != np.uint8:
        # float frames: exact bilinear without a quantizing uint8 round
        # trip (matches the reference's float interpolate path)
        return _resize_frames_linear(
            np.ascontiguousarray(frames, np.float32), new_h, new_w
        ).astype(dtype)
    # uint8 frames (TPU.DEVICE_PREPROCESS path): cv2 INTER_LINEAR on
    # uint8 is the SAME no-antialias bilinear filter as the float path,
    # evaluated in fixed point with round-to-nearest — i.e. the float
    # result quantised to the byte grid (the labeled half-ULP deviation
    # documented at TPU.DEVICE_PREPROCESS). PIL's BILINEAR would
    # antialias and diverge from the reference's interpolate filter.
    return _resize_frames_linear(np.ascontiguousarray(frames), new_h, new_w)


def random_short_side_scale_jitter(
    frames, min_size, max_size, rng, inverse_uniform_sampling=False, boxes=None
):
    """(reference transform.py:29-80)"""
    if inverse_uniform_sampling:
        size = int(round(1.0 / rng.uniform(1.0 / max_size, 1.0 / min_size)))
    else:
        size = int(round(rng.uniform(min_size, max_size)))
    t, h, w, c = frames.shape
    if (w <= h and w == size) or (h <= w and h == size):
        return frames if boxes is None else (frames, boxes)
    if w < h:
        new_w, new_h = size, int(math.floor(h / w * size))
        scale = size / w
    else:
        new_w, new_h = int(math.floor(w / h * size)), size
        scale = size / h
    frames = _resize_frames(frames, new_h, new_w)
    if boxes is not None:
        return frames, boxes * scale
    return frames


def random_crop(frames, size, rng, boxes=None):
    """(reference transform.py:120-152)"""
    t, h, w, c = frames.shape
    y = rng.randint(0, h - size + 1) if h > size else 0
    x = rng.randint(0, w - size + 1) if w > size else 0
    out = frames[:, y : y + size, x : x + size]
    if boxes is not None:
        boxes = boxes.copy()
        boxes[..., [0, 2]] -= x
        boxes[..., [1, 3]] -= y
        return out, boxes
    return out


def _resize_frames_linear(frames: np.ndarray, new_h: int, new_w: int):
    """Bilinear resize without antialias — matches the reference's
    ``F.interpolate(mode='bilinear', align_corners=False)`` (cv2's
    INTER_LINEAR is the same filter; PIL's BILINEAR antialiases). Through
    cv2 where it imports; without it, uint8 frames take ``_resize_uint8``,
    cv2's fixed-point arithmetic in numpy (bit-equal, ~40x slower), and
    float frames raise ``ImportError``."""
    cv2 = _cv2()
    if cv2 is None and frames.dtype == np.uint8:
        return _resize_uint8(frames, new_h, new_w)
    if cv2 is None:
        raise ImportError("cv2 (opencv-python) resizes float frames")
    out = np.empty(
        (frames.shape[0], new_h, new_w, frames.shape[3]), frames.dtype
    )
    for t in range(frames.shape[0]):
        out[t] = cv2.resize(
            frames[t], (new_w, new_h), interpolation=cv2.INTER_LINEAR
        ).reshape(new_h, new_w, frames.shape[3])
    return out


@functools.lru_cache(maxsize=None)
def _cv2():
    """The cv2 module, or None where it does not import (looked up once)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


_COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_SCALE (11 fraction bits)


def _linear_taps(n_in: int, n_out: int, clamp: bool):
    """Source indices and fixed-point weights of one axis, as cv2 computes
    them: the source coordinate in float32, its floor and fraction, the
    weights rounded to 1/2048. Along x (``clamp``) a tap past either border
    takes the border pixel at full weight; along y only the row indices
    are clipped."""
    d = np.arange(n_out, dtype=np.float64)
    f = ((d + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        low, high = s < 0, s + 1 >= n_in
        f[low | high] = 0.0
        s[low] = 0
        s[high] = n_in - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE))
    w1 = np.rint(f * np.float32(_COEF_SCALE))
    return (np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1),
            w0.astype(np.int32), w1.astype(np.int32))


def _resize_uint8(frames: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """``cv2.resize(..., INTER_LINEAR)`` of uint8 [T, H, W, C] frames, bit
    for bit, without cv2: the horizontal pass sums pixel x weight in
    integers over the source rows that some output row reads, the vertical
    pass is cv2's vector form,
    ``((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2``."""
    t, h, w, c = frames.shape
    x0, x1, a0, a1 = _linear_taps(w, new_w, clamp=True)
    y0, y1, b0, b1 = _linear_taps(h, new_h, clamp=False)
    need = np.unique(np.concatenate([y0, y1]))
    flat = frames[:, need].reshape(t, len(need), w * c)
    lanes = np.arange(c)
    rows = np.take(flat, (x0[:, None] * c + lanes).ravel(), axis=2).astype(
        np.int32)
    rows *= np.repeat(a0, c)
    right = np.take(flat, (x1[:, None] * c + lanes).ravel(), axis=2).astype(
        np.int32)
    right *= np.repeat(a1, c)
    rows += right
    rows >>= 4
    out = np.take(rows, np.searchsorted(need, y0), axis=1)
    out *= b0[:, None]
    out >>= 16
    below = np.take(rows, np.searchsorted(need, y1), axis=1)
    below *= b1[:, None]
    below >>= 16
    out += below
    out += 2
    out >>= 2
    return out.astype(np.uint8).reshape(t, new_h, new_w, c)


def uniform_crop(frames, size, spatial_idx, boxes=None, scale_size=None):
    """Three-crop protocol (reference transform.py:212-283). When
    ``scale_size`` is given, the short side is bilinearly resized to it
    before cropping (reference :239-250)."""
    assert spatial_idx in (0, 1, 2)
    t, h, w, c = frames.shape
    if scale_size is not None:
        if w <= h:
            new_w, new_h = scale_size, int(h / w * scale_size)
        else:
            new_w, new_h = int(w / h * scale_size), scale_size
        if boxes is not None:
            boxes = boxes * (new_w / w)
        frames = _resize_frames_linear(frames, new_h, new_w)
        h, w = new_h, new_w
    y = int(math.ceil((h - size) / 2))
    x = int(math.ceil((w - size) / 2))
    if h > w:
        y = 0 if spatial_idx == 0 else (h - size if spatial_idx == 2 else y)
    else:
        x = 0 if spatial_idx == 0 else (w - size if spatial_idx == 2 else x)
    out = frames[:, y : y + size, x : x + size]
    if boxes is not None:
        boxes = boxes.copy()
        boxes[..., [0, 2]] -= x
        boxes[..., [1, 3]] -= y
        return out, boxes
    return out


def horizontal_flip(frames, prob, rng, boxes=None):
    """(reference transform.py:155-187)"""
    if rng.uniform() < prob:
        frames = frames[:, :, ::-1].copy()
        if boxes is not None:
            w = frames.shape[2]
            boxes = boxes.copy()
            x0 = boxes[..., 0].copy()
            boxes[..., 0] = w - boxes[..., 2] - 1
            boxes[..., 2] = w - x0 - 1
    if boxes is not None:
        return frames, boxes
    return frames


def clip_boxes_to_image(boxes, height, width):
    boxes = boxes.copy()
    boxes[..., [0, 2]] = np.clip(boxes[..., [0, 2]], 0, width - 1)
    boxes[..., [1, 3]] = np.clip(boxes[..., [1, 3]], 0, height - 1)
    return boxes


def _get_param_spatial_crop(scale, ratio, height, width, rng,
                            num_repeat=10, log_scale=True):
    """Sample an Inception-style crop box (reference transform.py:520-557),
    including the aspect-preserving central-crop fallback."""
    for _ in range(num_repeat):
        target_area = rng.uniform(*scale) * height * width
        if log_scale:
            log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
            aspect = math.exp(rng.uniform(*log_ratio))
        else:
            aspect = rng.uniform(*ratio)
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            i = rng.randint(0, height - h + 1)
            j = rng.randint(0, width - w + 1)
            return i, j, h, w
    # fallback: central crop clamped to the ratio range
    in_ratio = float(width) / float(height)
    if in_ratio < min(ratio):
        w = width
        h = int(round(w / min(ratio)))
    elif in_ratio > max(ratio):
        h = height
        w = int(round(h * max(ratio)))
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


def random_resized_crop(
    frames, target_height, target_width, rng,
    scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0), boxes=None,
):
    """Inception-style crop (reference transform.py:560-601)."""
    t, h, w, c = frames.shape
    y, x, ch, cw = _get_param_spatial_crop(scale, ratio, h, w, rng)
    cropped = frames[:, y : y + ch, x : x + cw]
    out = _resize_frames_linear(cropped, target_height, target_width)
    if boxes is not None:
        boxes = boxes.copy()
        boxes[..., [0, 2]] = (
            np.clip(boxes[..., [0, 2]] - x, 0, cw) * target_width / cw
        )
        boxes[..., [1, 3]] = (
            np.clip(boxes[..., [1, 3]] - y, 0, ch) * target_height / ch
        )
        return out, boxes
    return out


def random_resized_crop_with_shift(
    frames, target_height, target_width, rng,
    scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
):
    """Motion-shift crop (reference transform.py:603-649): sample two crop
    boxes for the first and last frame and linearly interpolate the box
    across time, so the crop pans/zooms through the clip."""
    t, h, w, c = frames.shape
    i, j, ch, cw = _get_param_spatial_crop(scale, ratio, h, w, rng)
    i_, j_, ch_, cw_ = _get_param_spatial_crop(scale, ratio, h, w, rng)
    i_s = np.linspace(i, i_, num=t).astype(int)
    j_s = np.linspace(j, j_, num=t).astype(int)
    h_s = np.linspace(ch, ch_, num=t).astype(int)
    w_s = np.linspace(cw, cw_, num=t).astype(int)
    out = np.empty((t, target_height, target_width, c), frames.dtype)
    for ind in range(t):
        out[ind] = _resize_frames_linear(
            frames[ind : ind + 1,
                   i_s[ind] : i_s[ind] + h_s[ind],
                   j_s[ind] : j_s[ind] + w_s[ind]],
            target_height, target_width,
        )[0]
    return out


# ------------------------------------------------------------------
# Photometric jitter (reference transform.py:298-476). Frames here are
# [T, H, W, C] RGB floats in [0, 1]; the reference works on [T, C, H, W]
# BGR tensors — the math below is channel-order-corrected.
# ------------------------------------------------------------------


def blend(frames1, frames2, alpha):
    """(reference transform.py:298-311)"""
    return frames1 * alpha + frames2 * (1.0 - alpha)


def grayscale(frames):
    """ITU-R 601 luma, broadcast back to 3 channels (reference
    transform.py:314-333; RGB channel order here)."""
    gray = (
        0.299 * frames[..., 0]
        + 0.587 * frames[..., 1]
        + 0.114 * frames[..., 2]
    )
    return np.repeat(gray[..., None], 3, axis=-1).astype(frames.dtype)


def brightness_jitter(var, frames, rng):
    """(reference transform.py:371-388)"""
    alpha = 1.0 + rng.uniform(-var, var)
    return blend(frames, np.zeros_like(frames), alpha)


def contrast_jitter(var, frames, rng):
    """(reference transform.py:391-409)"""
    alpha = 1.0 + rng.uniform(-var, var)
    gray = grayscale(frames)
    gray[:] = gray.mean(axis=(1, 2, 3), keepdims=True)
    return blend(frames, gray, alpha)


def saturation_jitter(var, frames, rng):
    """(reference transform.py:412-428)"""
    alpha = 1.0 + rng.uniform(-var, var)
    return blend(frames, grayscale(frames), alpha)


def color_jitter(frames, rng, img_brightness=0, img_contrast=0,
                 img_saturation=0):
    """Apply the enabled jitters in random order (reference
    transform.py:335-368)."""
    jitter = []
    if img_brightness != 0:
        jitter.append("brightness")
    if img_contrast != 0:
        jitter.append("contrast")
    if img_saturation != 0:
        jitter.append("saturation")
    if jitter:
        order = rng.permutation(np.arange(len(jitter)))
        for idx in range(len(jitter)):
            if jitter[order[idx]] == "brightness":
                frames = brightness_jitter(img_brightness, frames, rng)
            elif jitter[order[idx]] == "contrast":
                frames = contrast_jitter(img_contrast, frames, rng)
            elif jitter[order[idx]] == "saturation":
                frames = saturation_jitter(img_saturation, frames, rng)
    return frames


def lighting_jitter(frames, alphastd, eigval, eigvec, rng):
    """AlexNet-style PCA lighting noise (reference transform.py:431-476).
    eigval: [3], eigvec: [3, 3] rows in RGB order; frames RGB."""
    if alphastd == 0:
        return frames
    alpha = rng.normal(0, alphastd, size=(1, 3))
    eig_vec = np.asarray(eigvec)
    eig_val = np.reshape(np.asarray(eigval), (1, 3))
    rgb = np.sum(
        eig_vec * np.repeat(alpha, 3, axis=0) * np.repeat(eig_val, 3, axis=0),
        axis=1,
    )
    return (frames + rgb.reshape(1, 1, 1, 3)).astype(frames.dtype)


def color_normalization(frames, mean, stddev):
    """(reference transform.py:479-517); frames [T, H, W, C]."""
    mean = np.asarray(mean, frames.dtype).reshape(1, 1, 1, -1)
    stddev = np.asarray(stddev, frames.dtype).reshape(1, 1, 1, -1)
    return (frames - mean) / stddev
