"""Discrete VAE of STEVE (counterpart of ``focus_tpu/models/steve/dvae.py``;
reference ``slowfast/models/STEVE/dvae.py``).

The public modules keep the JAX package's channels-last layout
(``[B, H, W, C]`` in and out) and run NCHW inside. Encoder and decoder are
``nn.Sequential``s with the upstream slot numbers, so a reference
``state_dict`` loads with ``strict=True``.
"""

import torch.nn.functional as F
from torch import nn

from focus_tpu_torch.models.common import Conv2dBlock, conv, conv2d


def pixel_shuffle(x, r: int):
    """Channels-last depth-to-space with ``torch.nn.PixelShuffle``'s channel
    order: input channel c*r*r + i*r + j feeds output pixel offset (i, j) of
    channel c. x [B, H, W, C] -> [B, H*r, W*r, C/(r*r)]."""
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


class _ChannelsLastStack(nn.Sequential):
    """A conv stack that takes and returns [B, H, W, C]."""

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for m in self:
            x = conv(x, m) if isinstance(m, nn.Conv2d) else m(x)
        return x.permute(0, 2, 3, 1)


def DVAEEncoder(vocab_size, img_channels=3):
    """4x4/s4 stem + six 1x1 conv-relu blocks + 1x1 head to vocabulary
    logits (reference dvae.py:8-17)."""
    return _ChannelsLastStack(
        Conv2dBlock(img_channels, 64, 4, 4),
        *[Conv2dBlock(64, 64, 1) for _ in range(6)],
        conv2d(64, vocab_size, 1),
    )


def DVAEDecoder(vocab_size, img_channels):
    """Two PixelShuffle(2) upsampling stages back to pixels
    (reference dvae.py:19-32)."""
    return _ChannelsLastStack(
        Conv2dBlock(vocab_size, 64, 1),
        Conv2dBlock(64, 64, 3, 1, 1),
        Conv2dBlock(64, 64, 1),
        Conv2dBlock(64, 64, 1),
        Conv2dBlock(64, 64 * 4, 1),
        nn.PixelShuffle(2),
        Conv2dBlock(64, 64, 3, 1, 1),
        Conv2dBlock(64, 64, 1),
        Conv2dBlock(64, 64, 1),
        Conv2dBlock(64, 64 * 4, 1),
        nn.PixelShuffle(2),
        conv2d(64, img_channels, 1),
    )


class DVAE(nn.Module):
    def __init__(self, vocab_size, img_channels):
        super().__init__()
        self.encoder = DVAEEncoder(vocab_size, img_channels)
        self.decoder = DVAEDecoder(vocab_size, img_channels)

    def forward(self, x):
        return self.decoder(self.encoder(x))
