"""VGG-16 conv5 body (port of the JAX package's ``models/vgg16.py``).

13 3x3 convs in 5 stages with 2x2 max pools after stages 1-4; with
``dilation == 2`` pool4 has stride 1 and conv5_* are dilated by 2, giving
spatial scale 1/8 (the flagship). The convolutions go to cuDNN through
``F.conv2d`` (they were XLA, not Pallas, in the JAX package).

The public layout is the JAX package's NHWC: ``forward`` takes (N, H, W, 3)
and returns (N, h, w, 512). Inside, the body runs in ``channels_last``, so
the NCHW views at both ends are free permutes and ``feat[0]`` is already
the contiguous (h, w, C) map the RoI pooling kernel reads.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

# (name, in_ch, out_ch) per stage; pools after each of the first four
VGG16_STAGES = [
    [('conv1_1', 3, 64), ('conv1_2', 64, 64)],
    [('conv2_1', 64, 128), ('conv2_2', 128, 128)],
    [('conv3_1', 128, 256), ('conv3_2', 256, 256), ('conv3_3', 256, 256)],
    [('conv4_1', 256, 512), ('conv4_2', 512, 512), ('conv4_3', 512, 512)],
    [('conv5_1', 512, 512), ('conv5_2', 512, 512), ('conv5_3', 512, 512)],
]


class VGG16(nn.Module):
    """The conv5 body. Parameters are float32 masters; ``forward`` casts
    them to the input's dtype, as the JAX body does."""

    def __init__(self, dilation=2, device=None):
        super().__init__()
        self.dilation = dilation
        for stage in VGG16_STAGES:
            for name, cin, cout in stage:
                self.add_module(name, nn.Conv2d(cin, cout, 3, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator):
        """MSRA normal weights (std sqrt(2 / fan_in)), zero biases."""
        for stage in VGG16_STAGES:
            for name, cin, _ in stage:
                conv = getattr(self, name)
                conv.weight.normal_(0.0, math.sqrt(2.0 / (9 * cin)),
                                    generator=generator)
                conv.bias.zero_()

    def forward(self, image):
        """image: (N, H, W, 3) in the compute dtype. Returns
        ((N, h, w, 512) features, spatial_scale)."""
        dtype = image.dtype
        x = image.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        for si, stage in enumerate(VGG16_STAGES):
            d = self.dilation if (si == 4 and self.dilation == 2) else 1
            for name, _, _ in stage:
                conv = getattr(self, name)
                x = F.relu(F.conv2d(x, conv.weight.to(dtype),
                                    conv.bias.to(dtype), padding=d,
                                    dilation=d))
            if si < 4:
                stride = 1 if (si == 3 and self.dilation == 2) else 2
                x = F.max_pool2d(x, 2, stride)
        scale = 1.0 / 8.0 if self.dilation == 2 else 1.0 / 16.0
        return x.permute(0, 2, 3, 1), scale


def feature_shape(im_h, im_w, dilation=2):
    """Output spatial dims for an (im_h, im_w) input."""
    h, w = im_h, im_w
    for _ in range(3):  # pool1-3 stride 2
        h, w = h // 2, w // 2
    if dilation == 2:
        h, w = h - 1, w - 1  # pool4 kernel 2 stride 1
    else:
        h, w = h // 2, w // 2
    return h, w
