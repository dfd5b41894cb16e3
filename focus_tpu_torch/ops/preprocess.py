"""Input normalisation on the device (counterpart of
``focus_tpu/ops/preprocess.py``).

A uint8 video ``[B, T, H, W, C]`` (raw pixels, 4x fewer bytes to copy to
the device than float32) is normalised where it lands,
``(x / 255 - mean) / std`` with ``cfg.DATA.MEAN`` / ``cfg.DATA.STD``; a
float video is taken as normalised already and passes through unchanged.
"""

import torch


def device_normalize(video, cfg):
    """Normalise a uint8 video (or each uint8 pathway of a tuple or list)
    on its device; float tensors are returned unchanged."""

    def norm(x):
        if x.dtype != torch.uint8:
            return x
        mean = torch.tensor(cfg.DATA.MEAN, dtype=torch.float32, device=x.device)
        inv_std = 1.0 / torch.tensor(cfg.DATA.STD, dtype=torch.float32,
                                     device=x.device)
        return (x.float() * (1.0 / 255.0) - mean) * inv_std

    if isinstance(video, (tuple, list)):
        return type(video)(norm(v) for v in video)
    return norm(video)
