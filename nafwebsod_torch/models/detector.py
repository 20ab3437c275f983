"""Model assembly (port of the JAX package's ``models/detector.py``, the
flagship family: dilated VGG16-C5 body, RoIPoolF, the noise-aware 2fc head
and the WSDDN two-stream outputs).

``spec_from_cfg`` raises ``NotImplementedError`` for every other family;
those are later slices of the port.
"""

from dataclasses import dataclass

import torch
from torch import nn

from nafwebsod_torch.models import heads, vgg16
from nafwebsod_torch.utils.device import resolve_device

_BODY = 'VGG16.add_VGG16_conv5_body_origin'
_HEAD = 'webly_heads.add_VGG16_roi_2fc_noise_head'
_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


@dataclass(frozen=True)
class ModelSpec:
    """The config keys the flagship family's model reads."""
    num_classes: int = 21
    dilation: int = 2
    freeze_conv_body: bool = True
    roi_resolution: int = 7
    compute_dtype: str = 'float32'
    # fc6/fc7 width: 4096 in the reference; tests use a narrow tower
    hidden_dim: int = 4096

    @property
    def dtype(self):
        return _DTYPES[self.compute_dtype]


def spec_from_cfg(cfg):
    """The flagship family's spec from ``cfg``; anything else raises."""
    unported = [k for k, on in (
        ('MODEL.CONV_BODY ' + cfg.MODEL.CONV_BODY,
         cfg.MODEL.CONV_BODY != _BODY),
        ('FAST_RCNN.ROI_BOX_HEAD ' + cfg.FAST_RCNN.ROI_BOX_HEAD,
         cfg.FAST_RCNN.ROI_BOX_HEAD != _HEAD),
        ('FAST_RCNN.ROI_XFORM_METHOD ' + cfg.FAST_RCNN.ROI_XFORM_METHOD,
         cfg.FAST_RCNN.ROI_XFORM_METHOD != 'RoIPoolF'),
        ('MODEL.TYPE ' + cfg.MODEL.TYPE,
         cfg.MODEL.TYPE != 'generalized_wsl'),
        ('WEBLY.WEBLY_ON False', not cfg.WEBLY.WEBLY_ON),
        ('MODEL.FASTER_RCNN', cfg.MODEL.FASTER_RCNN),
        ('MODEL.MASK_ON', cfg.MODEL.MASK_ON),
        ('MODEL.KEYPOINTS_ON', cfg.MODEL.KEYPOINTS_ON),
        ('WSL.OICR', cfg.WSL.OICR), ('WSL.PCL', cfg.WSL.PCL),
        ('WSL.CMIL', cfg.WSL.CMIL), ('WSL.CPG', cfg.WSL.CPG),
        ('WSL.CSC', cfg.WSL.CSC), ('WSL.CENTER_LOSS', cfg.WSL.CENTER_LOSS),
        ('RETINANET.RETINANET_ON', cfg.RETINANET.RETINANET_ON)) if on]
    if unported:
        raise NotImplementedError('not ported yet: ' + ', '.join(unported))
    if cfg.TPU.COMPUTE_DTYPE not in _DTYPES:
        raise ValueError('TPU.COMPUTE_DTYPE must be float32 or bfloat16, '
                         'got {}'.format(cfg.TPU.COMPUTE_DTYPE))
    return ModelSpec(
        num_classes=cfg.MODEL.NUM_CLASSES,
        dilation=cfg.WSL.DILATION,
        freeze_conv_body=cfg.TRAIN.FREEZE_CONV_BODY,
        roi_resolution=cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
        compute_dtype=cfg.TPU.COMPUTE_DTYPE,
        hidden_dim=cfg.TPU.HEAD_HIDDEN_DIM)


class Detector(nn.Module):
    """Body + noise-aware head. Build with ``build_model``."""

    def __init__(self, spec, device):
        super().__init__()
        self.spec = spec
        self.body = vgg16.VGG16(spec.dilation, device=device)
        self.head = heads.NoiseHead(
            spec.num_classes,
            roi_feat_dim=512 * spec.roi_resolution ** 2,
            hidden=spec.hidden_dim, device=device)

    @property
    def device(self):
        return self.body.conv1_1.weight.device

    def body_forward(self, image):
        """image (1, H, W, 3) -> ((1, h, w, 512) features in the compute
        dtype, spatial scale)."""
        feat, scale = self.body(image.to(self.spec.dtype))
        if self.spec.freeze_conv_body:
            feat = feat.detach()
        return feat, scale

    @torch.no_grad()
    def forward_test(self, image, rois, obn_scores, valid_mask=None):
        """Per-image inference. image (1, H, W, 3); rois (R, 5) float32;
        obn_scores (R, 1). Returns {'scores': (R, num_classes) with the
        dummy background column first, 'rois_pred': (R, num_classes - 1)}.
        """
        spec = self.spec
        feat, scale = self.body_forward(image)
        roi_feat = heads.roi_transform(
            feat[0].contiguous(), rois, obn_scores, scale,
            spec.roi_resolution, spec.freeze_conv_body)
        fc7_clean, fc7_noisy = self.head.towers(roi_feat)
        out = self.head.webly_outputs(fc7_clean, fc7_noisy, valid_mask)
        return {'scores': heads.add_background_column(out['rois_pred']),
                'rois_pred': out['rois_pred']}


def build_model(spec, device=None, seed=0):
    """A Detector on ``device`` (the card unless ``device='cpu'``), with
    the JAX package's initialisation schemes drawn from a
    ``torch.Generator`` seeded with ``seed``: MSRA normal conv weights,
    Xavier-uniform fc weights, zero biases. (The draws differ from
    ``jax.random``; tests load bridged JAX weights instead.)"""
    device = resolve_device(device)
    model = Detector(spec, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model.body.reset_parameters(gen)
    model.head.reset_parameters(gen)
    return model.eval()
