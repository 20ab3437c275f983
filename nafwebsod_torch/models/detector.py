"""Model assembly (port of the JAX package's ``models/detector.py``): the
dilated VGG16-C5 body, RoIPoolF, the 2fc head with or without the noisy
tower, the WSDDN two-stream outputs and the training losses of three
branches -- webly (the flagship), CSC and plain CE.

``spec_from_cfg`` raises ``NotImplementedError`` for every other family;
those are later slices of the port.
"""

from dataclasses import dataclass

import torch
from torch import nn

from nafwebsod_torch.models import heads, vgg16
from nafwebsod_torch.ops import cpg as cpg_ops
from nafwebsod_torch.ops import losses as loss_ops
from nafwebsod_torch.ops.entropy import spatial_entropy_weights
from nafwebsod_torch.utils.device import resolve_device

_BODY = 'VGG16.add_VGG16_conv5_body_origin'
_HEADS = {'webly_heads.add_VGG16_roi_2fc_noise_head': 'vgg16_2fc_noise',
          'wsl_heads.add_VGG16_roi_2fc_head': 'vgg16_2fc'}
_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


@dataclass(frozen=True)
class ModelSpec:
    """The config keys the ported families' model reads (the names of the
    JAX package's ``ModelSpec``)."""
    num_classes: int = 21
    box_head: str = 'vgg16_2fc_noise'
    dilation: int = 2
    freeze_conv_body: bool = True
    freeze_at: int = 2
    roi_resolution: int = 7
    webly_on: bool = True
    webly_entropy: bool = True
    mean_loss: bool = True
    cpg: bool = False
    csc: bool = False
    cpg_tau: float = 0.7
    csc_fg_threshold: float = 0.1
    csc_max_iter: int = 35000
    # most ground-truth classes of one image that get a CPG backward pass
    max_gt_cpg: int = 4
    compute_dtype: str = 'float32'
    # fc6/fc7 width: 4096 in the reference; tests use a narrow tower
    hidden_dim: int = 4096

    @property
    def dtype(self):
        return _DTYPES[self.compute_dtype]

    @property
    def is_webly(self):
        return self.box_head.endswith('noise') or self.webly_on


def spec_from_cfg(cfg):
    """The spec of the flagship (noise-aware head, WEBLY.WEBLY_ON) or of the
    plain 2fc head with or without CPG / CSC; anything else raises."""
    head = _HEADS.get(cfg.FAST_RCNN.ROI_BOX_HEAD)
    noise = head == 'vgg16_2fc_noise'
    unported = [k for k, on in (
        ('MODEL.CONV_BODY ' + cfg.MODEL.CONV_BODY,
         cfg.MODEL.CONV_BODY != _BODY),
        ('FAST_RCNN.ROI_BOX_HEAD ' + cfg.FAST_RCNN.ROI_BOX_HEAD,
         head is None),
        ('FAST_RCNN.ROI_XFORM_METHOD ' + cfg.FAST_RCNN.ROI_XFORM_METHOD,
         cfg.FAST_RCNN.ROI_XFORM_METHOD != 'RoIPoolF'),
        ('MODEL.TYPE ' + cfg.MODEL.TYPE,
         cfg.MODEL.TYPE != 'generalized_wsl'),
        ('WEBLY.WEBLY_ON {} with {}'.format(cfg.WEBLY.WEBLY_ON,
                                            cfg.FAST_RCNN.ROI_BOX_HEAD),
         head is not None and cfg.WEBLY.WEBLY_ON != noise),
        ('WEBLY.MINING', cfg.WEBLY.MINING),
        ('MODEL.FASTER_RCNN', cfg.MODEL.FASTER_RCNN),
        ('MODEL.MASK_ON', cfg.MODEL.MASK_ON),
        ('MODEL.KEYPOINTS_ON', cfg.MODEL.KEYPOINTS_ON),
        ('WSL.OICR', cfg.WSL.OICR), ('WSL.PCL', cfg.WSL.PCL),
        ('WSL.CMIL', cfg.WSL.CMIL),
        ('WSL.CPG with the noise-aware head', cfg.WSL.CPG and noise),
        ('WSL.CSC with the noise-aware head', cfg.WSL.CSC and noise),
        ('WSL.CENTER_LOSS', cfg.WSL.CENTER_LOSS),
        ('WSL.MIN_ENTROPY_LOSS', cfg.WSL.MIN_ENTROPY_LOSS),
        ('RETINANET.RETINANET_ON', cfg.RETINANET.RETINANET_ON)) if on]
    if unported:
        raise NotImplementedError('not ported yet: ' + ', '.join(unported))
    if cfg.TPU.COMPUTE_DTYPE not in _DTYPES:
        raise ValueError('TPU.COMPUTE_DTYPE must be float32 or bfloat16, '
                         'got {}'.format(cfg.TPU.COMPUTE_DTYPE))
    return ModelSpec(
        num_classes=cfg.MODEL.NUM_CLASSES,
        box_head=head,
        dilation=cfg.WSL.DILATION,
        freeze_conv_body=cfg.TRAIN.FREEZE_CONV_BODY,
        freeze_at=cfg.TRAIN.FREEZE_AT,
        roi_resolution=cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
        webly_on=cfg.WEBLY.WEBLY_ON,
        webly_entropy=cfg.WEBLY.ENTROPY,
        mean_loss=cfg.WSL.MEAN_LOSS,
        cpg=cfg.WSL.CPG,
        csc=cfg.WSL.CSC,
        cpg_tau=cfg.WSL.CPG_TAU,
        csc_fg_threshold=cfg.WSL.CSC_FG_THRESHOLD,
        csc_max_iter=cfg.WSL.CSC_MAX_ITER,
        # 0 = every ground-truth class gets a map, as in the reference
        max_gt_cpg=(cfg.TPU.CPG_MAX_GT or cfg.MODEL.NUM_CLASSES - 1),
        compute_dtype=cfg.TPU.COMPUTE_DTYPE,
        hidden_dim=cfg.TPU.HEAD_HIDDEN_DIM)


class Detector(nn.Module):
    """Body + 2fc head. Build with ``build_model``."""

    def __init__(self, spec, device):
        super().__init__()
        self.spec = spec
        self.body = vgg16.VGG16(spec.dilation, device=device)
        self.head = heads.WslHead(
            spec.num_classes,
            roi_feat_dim=512 * spec.roi_resolution ** 2,
            hidden=spec.hidden_dim, device=device,
            noisy=spec.box_head == 'vgg16_2fc_noise')

    @property
    def device(self):
        return self.body.conv1_1.weight.device

    def body_forward(self, image, unfrozen=False):
        """image (1, H, W, 3) -> ((1, h, w, 512) features in the compute
        dtype, spatial scale). ``unfrozen`` lets the gradient reach the
        image whatever FREEZE_CONV_BODY and FREEZE_AT say (the CPG
        saliency needs it; which parameters are updated is the solver's
        business, see ``trainable_param_names``)."""
        frozen = self.spec.freeze_conv_body and not unfrozen
        with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
            feat, scale = self.body(image.to(self.spec.dtype),
                                    0 if unfrozen else self.spec.freeze_at)
        return feat, scale

    def _towers(self, image, rois, obn_scores, train=False, generator=None,
                unfrozen=False):
        spec = self.spec
        feat, scale = self.body_forward(image, unfrozen)
        roi_feat = heads.roi_transform(
            feat[0].contiguous(), rois, obn_scores, scale,
            spec.roi_resolution, spec.freeze_conv_body and not unfrozen)
        return self.head.towers(roi_feat, train, generator)

    def _outputs(self, fc7_clean, fc7_noisy, valid_mask):
        if fc7_noisy is not None:
            return self.head.webly_outputs(fc7_clean, fc7_noisy, valid_mask)
        return self.head.wsl_outputs(fc7_clean, valid_mask)

    @torch.no_grad()
    def forward_test(self, image, rois, obn_scores, valid_mask=None):
        """Per-image inference. image (1, H, W, 3); rois (R, 5) float32;
        obn_scores (R, 1). Returns {'scores': (R, num_classes) with the
        dummy background column first, 'rois_pred': (R, num_classes - 1)}.
        """
        out = self._outputs(*self._towers(image, rois, obn_scores),
                            valid_mask)
        return {'scores': heads.add_background_column(out['rois_pred']),
                'rois_pred': out['rois_pred']}

    def forward_train(self, batch, generator=None):
        """Per-image training forward and losses.

        batch: tensors on the model's device -- ``image`` (1, H, W, 3)
        mean-subtracted BGR, ``rois`` (R, 5), ``obn_scores`` (R, 1),
        ``labels_oh`` (1, C-1) image-level labels (possibly blended),
        ``valid_mask`` (R,) bool for padded RoIs, ``cur_iter`` a float
        scalar (it gates CSC). ``generator`` draws the dropout masks; None
        means no dropout. Returns (total loss, aux dict of losses and
        metrics)."""
        spec = self.spec
        image = batch['image']
        valid = batch.get('valid_mask')
        csc_active = (spec.csc and self.head.noisy is None and
                      float(batch.get('cur_iter', 0.0)) < spec.csc_max_iter)
        if csc_active:
            # One graph serves both gradients: the CPG saliency reads
            # d cls_prob / d image through the whole body, so the image is
            # a leaf that requires grad and nothing is detached here. The
            # body stays frozen all the same: the train step asks for the
            # gradient of the trainable parameters only.
            image = image.detach().requires_grad_(True)
        fc7_clean, fc7_noisy = self._towers(
            image, batch['rois'], batch['obn_scores'], True, generator,
            unfrozen=csc_active)
        out = self._outputs(fc7_clean, fc7_noisy, valid)
        return self.wsl_tail_losses(batch, out, image if csc_active else None)

    def forward_cpg_maps(self, batch, generator=None):
        """The CPG saliency maps of one training image, off the train
        step: (maps (max_gt, H, W), class_idx, keep) as ``cpg_maps``
        returns them. With a generator the forward runs with dropout, as
        the train step's does."""
        image = batch['image'].detach().requires_grad_(True)
        fc7, _ = self._towers(image, batch['rois'], batch['obn_scores'],
                              generator is not None, generator,
                              unfrozen=True)
        out = self.head.wsl_outputs(fc7, batch.get('valid_mask'))
        return cpg_ops.cpg_maps(
            heads.cls_pred(out['rois_pred']), image, batch['labels_oh'],
            tau=self.spec.cpg_tau, max_gt=self.spec.max_gt_cpg)

    def wsl_tail_losses(self, batch, out, image=None):
        """WSL losses downstream of the two-stream outputs. ``image`` is
        the leaf the CPG saliency differentiates to; None when CSC is off
        or past WSL.CSC_MAX_ITER (its weights are then 1)."""
        spec = self.spec
        rois = batch['rois']
        labels_oh = batch['labels_oh']
        valid = batch.get('valid_mask')
        cls_prob = heads.cls_pred(out['rois_pred'])
        aux, losses = {}, {}
        if spec.is_webly and 'rois_pred_noise' in out:
            cls_prob_noise = heads.cls_pred(out['rois_pred_noise'])
            if spec.webly_entropy:
                cw, cwn = spatial_entropy_weights(
                    out['rois_pred'], cls_prob, rois, labels_oh, valid)
            else:
                cw = torch.ones_like(labels_oh)
                cwn = torch.ones_like(labels_oh)
            losses['loss_cls'] = loss_ops.weighted_cross_entropy_with_logits(
                cls_prob, labels_oh, cw, spec.mean_loss)
            losses['loss_cls_noise'] = (
                loss_ops.weighted_cross_entropy_with_logits(
                    cls_prob_noise, labels_oh, cwn, spec.mean_loss))
            aux['accuracy_cls'] = loss_ops.multilabel_accuracy(
                cls_prob, labels_oh)
            aux['accuracy_cls_noise'] = loss_ops.multilabel_accuracy(
                cls_prob_noise, labels_oh)
            aux['class_weight_mean'] = cw.mean()
            aux['class_weight_noise_mean'] = cwn.mean()
        elif spec.csc:
            # CSC replaces the plain CE by a positive and a negative
            # constrained loss: CPG saliency -> per-RoI contrastive weights
            # -> polar split of rois_pred -> CE against the labels / zeros.
            # The weights are constants for the gradient.
            if image is not None:
                maps, idx, keep = cpg_ops.cpg_maps(
                    cls_prob, image, labels_oh, tau=spec.cpg_tau,
                    max_gt=spec.max_gt_cpg)
                w, _, _ = cpg_ops.csc_weights(
                    maps, idx, keep, rois, labels_oh, cls_prob.detach(),
                    fg_threshold=spec.csc_fg_threshold, context_scale=1.8,
                    valid_mask=valid)
            else:
                w = torch.ones_like(out['rois_pred'])
            pos = heads.cls_pred(
                cpg_ops.csc_constraint(out['rois_pred'], w, True))
            neg = heads.cls_pred(
                cpg_ops.csc_constraint(out['rois_pred'], w, False))
            losses['loss_cls_pos'] = loss_ops.cross_entropy_with_logits(
                pos, labels_oh, spec.mean_loss)
            losses['loss_cls_neg'] = loss_ops.cross_entropy_with_logits(
                neg, torch.zeros_like(labels_oh), spec.mean_loss)
            aux['accuracy_cls'] = loss_ops.multilabel_accuracy(pos, labels_oh)
        else:
            losses['loss_cls'] = loss_ops.cross_entropy_with_logits(
                cls_prob, labels_oh, spec.mean_loss)
            aux['accuracy_cls'] = loss_ops.multilabel_accuracy(
                cls_prob, labels_oh)
        total = sum(losses.values())
        aux.update(losses)
        return total, aux


def trainable_param_names(model):
    """State-dict keys of the parameters the solver may update: with
    FREEZE_CONV_BODY none of the body, otherwise the body's stages from
    FREEZE_AT on; the head always."""
    spec = model.spec
    stage_of = {'body.' + name: si
                for si, stage in enumerate(vgg16.VGG16_STAGES)
                for name, _, _ in stage}
    out = set()
    for key, _ in model.named_parameters():
        stage = stage_of.get(key.rsplit('.', 1)[0])
        if stage is None or not (spec.freeze_conv_body
                                 or stage < spec.freeze_at):
            out.add(key)
    return out


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
