"""Model assembly (port of the JAX package's ``models/detector.py``): the
dilated VGG16-C5 body, RoIPoolF or RoIAlign, the 2fc head with or without
the noisy tower, the three-stream context head (RoIPoolF plus two
RoILoopPool ring streams), the WSDDN two-stream outputs and the training
losses of three branches -- webly (the flagship), CSC and plain CE (the
plain 2fc head and the context head) -- and, with MODEL.MASK_ON, one of the
two weakly supervised mask heads: the fcn head over RoIAlign or the
image-level deeplab head.

``spec_from_cfg`` raises ``NotImplementedError`` for every other family;
those are later slices of the port.
"""

from dataclasses import dataclass

import torch
from torch import nn

from nafwebsod_torch.models import heads, seg_head, vgg16
from nafwebsod_torch.ops import cpg as cpg_ops
from nafwebsod_torch.ops import losses as loss_ops
from nafwebsod_torch.ops import roi_pool as roi_ops
from nafwebsod_torch.ops.entropy import spatial_entropy_weights
from nafwebsod_torch.utils.device import resolve_device

_BODY = 'VGG16.add_VGG16_conv5_body_origin'
_HEADS = {'webly_heads.add_VGG16_roi_2fc_noise_head': 'vgg16_2fc_noise',
          'wsl_heads.add_VGG16_roi_2fc_head': 'vgg16_2fc',
          'wsl_heads.add_VGG16_roi_context_2fc_head': 'vgg16_context_2fc'}
_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
# MRCNN.ROI_MASK_HEAD function names -> (mask_head, num_convs); '' is the
# default fcn head. The res5 (v0up, v0upshare) and GroupNorm heads are not
# ported.
_MASK_HEADS = {'': ('fcn', 2),
               'mask_rcnn_fcn_head': ('fcn', 2),
               'mask_rcnn_fcn_head_v1up': ('fcn', 2),
               'mask_rcnn_fcn_head_v1up4convs': ('fcn', 4),
               'deeplab_vgg16_head': ('deeplab', 2)}
# the sampling grid of the mask head's RoIAlign
_MASK_SAMPLING_RATIO = 2


@dataclass(frozen=True)
class ModelSpec:
    """The config keys the ported families' model reads (the names of the
    JAX package's ``ModelSpec``)."""
    num_classes: int = 21
    box_head: str = 'vgg16_2fc_noise'
    dilation: int = 2
    freeze_conv_body: bool = True
    freeze_at: int = 2
    roi_xform_method: str = 'RoIPoolF'
    roi_resolution: int = 7
    roi_sampling_ratio: int = 2
    # the context head's ring ratio (WSL.CONTEXT_RATIO)
    context_ratio: float = 1.8
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
    # the mask branch (MODEL.MASK_ON): 'fcn' (the conv tower over RoIAlign)
    # or 'deeplab' (the image-level ASPP head)
    mask_on: bool = False
    mask_head: str = 'fcn'
    mask_num_convs: int = 2
    mask_resolution: int = 14
    mask_dim_reduced: int = 256
    mask_dilation: int = 2
    mask_loss_weight: float = 1.0
    mask_cls_specific: bool = True

    @property
    def dtype(self):
        return _DTYPES[self.compute_dtype]

    @property
    def is_webly(self):
        return self.box_head.endswith('noise') or self.webly_on

    @property
    def is_context(self):
        return self.box_head == 'vgg16_context_2fc'

    @property
    def is_deeplab(self):
        return self.mask_on and self.mask_head == 'deeplab'


def spec_from_cfg(cfg):
    """The spec of the flagship (noise-aware head, WEBLY.WEBLY_ON), of the
    plain 2fc head with or without CPG / CSC, or of the context head, each
    with or without a WSL mask head (fcn or deeplab); anything else
    raises."""
    head = _HEADS.get(cfg.FAST_RCNN.ROI_BOX_HEAD)
    noise = head == 'vgg16_2fc_noise'
    context = head == 'vgg16_context_2fc'
    align = cfg.FAST_RCNN.ROI_XFORM_METHOD == 'RoIAlign'
    mask_name = (cfg.MRCNN.ROI_MASK_HEAD.rsplit('.', 1)[-1]
                 if cfg.MODEL.MASK_ON else '')
    mask_head, mask_num_convs = _MASK_HEADS.get(mask_name, (None, 0))
    deeplab = mask_head == 'deeplab'
    unported = [k for k, on in (
        ('MODEL.CONV_BODY ' + cfg.MODEL.CONV_BODY,
         cfg.MODEL.CONV_BODY != _BODY),
        ('FAST_RCNN.ROI_BOX_HEAD ' + cfg.FAST_RCNN.ROI_BOX_HEAD,
         head is None),
        ('FAST_RCNN.ROI_XFORM_METHOD ' + cfg.FAST_RCNN.ROI_XFORM_METHOD,
         cfg.FAST_RCNN.ROI_XFORM_METHOD not in ('RoIPoolF', 'RoIAlign')),
        # RoIAlign has no gradient yet (queue 2, K4 backward), and the JAX
        # package's context head pools with RoIPoolF whatever the method
        ('RoIAlign with an unfrozen body (TRAIN.FREEZE_CONV_BODY False, '
         'WSL.CPG, WSL.CSC, the deeplab head)',
         align and (not cfg.TRAIN.FREEZE_CONV_BODY or cfg.WSL.CPG
                    or cfg.WSL.CSC or deeplab)),
        ('RoIAlign with FAST_RCNN.ROI_XFORM_SAMPLING_RATIO <= 0',
         align and cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO <= 0),
        ('RoIAlign with the context head', align and context),
        ('MODEL.TYPE ' + cfg.MODEL.TYPE,
         cfg.MODEL.TYPE != 'generalized_wsl'),
        ('WEBLY.WEBLY_ON {} with {}'.format(cfg.WEBLY.WEBLY_ON,
                                            cfg.FAST_RCNN.ROI_BOX_HEAD),
         head is not None and cfg.WEBLY.WEBLY_ON != noise),
        ('WEBLY.MINING', cfg.WEBLY.MINING),
        ('MODEL.FASTER_RCNN', cfg.MODEL.FASTER_RCNN),
        ('MRCNN.ROI_MASK_HEAD ' + cfg.MRCNN.ROI_MASK_HEAD,
         mask_head is None),
        ('the fcn mask head with an unfrozen body (K4 backward)',
         mask_head == 'fcn' and cfg.MODEL.MASK_ON
         and not cfg.TRAIN.FREEZE_CONV_BODY),
        # the JAX package's CPGSW branch takes the mean of a (B, C) array
        # over axes 2 and 3 and cannot run either
        ('WSL.CPG_MAX_ITER > 0 (the CPGSW switch) with the deeplab head',
         deeplab and cfg.WSL.CPG_MAX_ITER > 0),
        ('MODEL.KEYPOINTS_ON', cfg.MODEL.KEYPOINTS_ON),
        ('WSL.OICR', cfg.WSL.OICR), ('WSL.PCL', cfg.WSL.PCL),
        ('WSL.CMIL', cfg.WSL.CMIL),
        ('WSL.CPG with the noise-aware head', cfg.WSL.CPG and noise),
        ('WSL.CSC with the noise-aware head', cfg.WSL.CSC and noise),
        ('WSL.CPG with the context head', cfg.WSL.CPG and context),
        ('the deeplab head with the noise-aware or the context head',
         deeplab and (noise or context)),
        ('WSL.CSC with the context head', cfg.WSL.CSC and context),
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
        roi_xform_method=cfg.FAST_RCNN.ROI_XFORM_METHOD,
        roi_resolution=cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
        roi_sampling_ratio=cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO,
        context_ratio=cfg.WSL.CONTEXT_RATIO,
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
        hidden_dim=cfg.TPU.HEAD_HIDDEN_DIM,
        # the MRCNN keys are read only with MODEL.MASK_ON
        **(dict(mask_on=True,
                mask_head=mask_head,
                mask_num_convs=mask_num_convs,
                mask_resolution=cfg.MRCNN.ROI_XFORM_RESOLUTION,
                mask_dim_reduced=cfg.MRCNN.DIM_REDUCED,
                mask_dilation=cfg.MRCNN.DILATION,
                mask_loss_weight=cfg.MRCNN.WEIGHT_LOSS_MASK,
                mask_cls_specific=cfg.MRCNN.CLS_SPECIFIC_MASK)
           if cfg.MODEL.MASK_ON else {}))


class Detector(nn.Module):
    """Body + 2fc head (+ mask head). Build with ``build_model``."""

    def __init__(self, spec, device):
        super().__init__()
        self.spec = spec
        self.body = vgg16.VGG16(spec.dilation, device=device)
        self.head = heads.WslHead(
            spec.num_classes,
            roi_feat_dim=512 * spec.roi_resolution ** 2,
            hidden=spec.hidden_dim, device=device,
            noisy=spec.box_head == 'vgg16_2fc_noise',
            context=spec.is_context)
        if spec.is_deeplab:
            self.mask_head = seg_head.DeeplabHead(spec.num_classes,
                                                  device=device)
        elif spec.mask_on:
            if spec.mask_head != 'fcn':
                raise NotImplementedError(
                    'mask head {} is not ported yet'.format(spec.mask_head))
            self.mask_head = seg_head.MaskFcnHead(
                spec.num_classes, dim_inner=spec.mask_dim_reduced,
                num_convs=spec.mask_num_convs, dilation=spec.mask_dilation,
                device=device)

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
                unfrozen=False, im_hw=None):
        """(fc7 of the clean tower, fc7 of the noisy tower or None, the
        body's features). For the context head the first is the tuple of
        the three streams' fc7. ``im_hw``: the true (h, w) of the image
        inside a padded canvas; the context head clips its rings there,
        not at the canvas edge, and the other heads ignore it."""
        spec = self.spec
        feat, scale = self.body_forward(image, unfrozen)
        if spec.is_context:
            im_h, im_w = image.shape[1:3] if im_hw is None else im_hw
            flats = heads.context_pooled_feats(
                feat[0].contiguous(), rois, obn_scores, scale, im_h, im_w,
                spec.context_ratio, spec.roi_resolution,
                spec.freeze_conv_body and not unfrozen)
            return (self.head.context_towers(flats, train, generator), None,
                    feat)
        roi_feat = heads.roi_transform(
            feat[0].contiguous(), rois, obn_scores, scale,
            spec.roi_resolution, spec.freeze_conv_body and not unfrozen,
            spec.roi_xform_method, spec.roi_sampling_ratio)
        return self.head.towers(roi_feat, train, generator) + (feat,)

    def _outputs(self, fc7_clean, fc7_noisy, valid_mask):
        if self.spec.is_context:
            return self.head.wsl_context_outputs(fc7_clean, valid_mask)
        if fc7_noisy is not None:
            return self.head.webly_outputs(fc7_clean, fc7_noisy, valid_mask)
        return self.head.wsl_outputs(fc7_clean, valid_mask)

    @torch.no_grad()
    def forward_test(self, image, rois, obn_scores, valid_mask=None,
                     im_hw=None):
        """Per-image inference. image (1, H, W, 3); rois (R, 5) float32;
        obn_scores (R, 1); ``im_hw`` as in ``_towers``. Returns {'scores':
        (R, num_classes) with the dummy background column first,
        'rois_pred': (R, num_classes - 1)}."""
        out = self._outputs(
            *self._towers(image, rois, obn_scores, im_hw=im_hw)[:2],
            valid_mask)
        return {'scores': heads.add_background_column(out['rois_pred']),
                'rois_pred': out['rois_pred']}

    def _mask_pooled(self, feat, rois):
        """The fcn mask head's pooled RoI features: single-scale RoIAlign
        of the (1, H, W, C) map, float32 out whatever the map's type."""
        res = self.spec.mask_resolution
        return roi_ops.roi_align(
            feat[0].contiguous(), rois, res, res,
            vgg16.spatial_scale(self.spec.dilation), _MASK_SAMPLING_RATIO,
            out_dtype=torch.float32)

    @torch.no_grad()
    def forward_masks(self, image, rois):
        """Soft masks of the fcn head for the given (final-detection) rois
        (R, 5) in blob coordinates: (R, M, M, num_classes), channel 0 a
        copy of the first class's."""
        feat, _ = self.body_forward(image)
        return seg_head.mask_probs_test(
            self.mask_head(self._mask_pooled(feat, rois)))

    @torch.no_grad()
    def forward_deeplab_masks(self, image):
        """Test-time deeplab masks: one image-level (1, h, w, num_classes)
        float32 grid at the head's resolution, channel 0 the background
        (1 - max), channel j class j's sigmoid."""
        feat, _ = self.body_forward(image)
        return seg_head.bgfg_grid(self.mask_head(feat))

    def forward_train(self, batch, generator=None):
        """Per-image training forward and losses.

        batch: tensors on the model's device -- ``image`` (1, H, W, 3)
        mean-subtracted BGR, ``rois`` (R, 5), ``obn_scores`` (R, 1),
        ``labels_oh`` (1, C-1) image-level labels (possibly blended),
        ``valid_mask`` (R,) bool for padded RoIs, ``cur_iter`` a float
        scalar (it gates CSC), optionally ``im_hw`` (2,), the image's true
        extent on its canvas (the context head). ``generator`` draws the
        dropout masks; None means no dropout. Returns (total loss, aux dict
        of losses and metrics)."""
        spec = self.spec
        image = batch['image']
        valid = batch.get('valid_mask')
        csc_active = (spec.csc and self.head.noisy is None and
                      float(batch.get('cur_iter', 0.0)) < spec.csc_max_iter)
        cpg_active = csc_active or spec.is_deeplab
        if cpg_active:
            # One graph serves both gradients: the CPG saliency reads
            # d cls_prob / d image through the whole body, so the image is
            # a leaf that requires grad and nothing is detached here. The
            # body stays frozen all the same: the train step asks for the
            # gradient of the trainable parameters only.
            image = image.detach().requires_grad_(True)
        fc7_clean, fc7_noisy, feat = self._towers(
            image, batch['rois'], batch['obn_scores'], True, generator,
            unfrozen=cpg_active, im_hw=batch.get('im_hw'))
        out = self._outputs(fc7_clean, fc7_noisy, valid)
        return self.wsl_tail_losses(
            batch, out, image if cpg_active else None, csc_active, feat,
            generator)

    def forward_cpg_maps(self, batch, generator=None):
        """The CPG saliency maps of one training image, off the train
        step: (maps (max_gt, H, W), class_idx, keep) as ``cpg_maps``
        returns them. With a generator the forward runs with dropout, as
        the train step's does."""
        image = batch['image'].detach().requires_grad_(True)
        fc7, _, _ = self._towers(image, batch['rois'], batch['obn_scores'],
                                 generator is not None, generator,
                                 unfrozen=True)
        out = self.head.wsl_outputs(fc7, batch.get('valid_mask'))
        return cpg_ops.cpg_maps(
            heads.cls_pred(out['rois_pred']), image, batch['labels_oh'],
            tau=self.spec.cpg_tau, max_gt=self.spec.max_gt_cpg)

    def wsl_tail_losses(self, batch, out, image=None, csc_active=False,
                        feat=None, generator=None):
        """WSL losses downstream of the two-stream outputs. ``image`` is
        the leaf the CPG saliency differentiates to (None when no branch
        needs a saliency map); ``csc_active`` is false when CSC is off or
        past WSL.CSC_MAX_ITER (its weights are then 1). The mask branches
        read the body's features ``feat`` (1, H, W, C); ``generator`` draws
        the deeplab head's dropout masks."""
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
            if csc_active:
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

        if spec.mask_on and spec.freeze_conv_body:
            feat = feat.detach()
        if spec.is_deeplab:
            # the ASPP head on the conv features; pixel pseudo labels from
            # the CPG saliency of (at most max_gt_cpg of) the image's
            # classes, scattered into a (1, C-1, H, W) tensor of constants
            maps, idx, keep = cpg_ops.cpg_maps(
                cls_prob, image, labels_oh, tau=spec.cpg_tau,
                max_gt=spec.max_gt_cpg)
            cpg_full = maps.new_zeros((1, spec.num_classes - 1)
                                      + tuple(maps.shape[1:]))
            for k, ci in enumerate(idx):
                if ci >= 0:
                    cpg_full[0, ci] = maps[k]
            mask_fc8 = self.mask_head(feat, spec.freeze_conv_body, True,
                                      generator)
            losses.update(seg_head.deeplab_losses(
                mask_fc8, cpg_full, labels_oh, cls_prob.detach(),
                image.detach(), tau=spec.cpg_tau))
        elif spec.mask_on:
            mask_logits = self.mask_head(self._mask_pooled(feat, rois))
            losses['mask_loss_cls'] = (
                spec.mask_loss_weight * seg_head.mask_losses(
                    mask_logits, out['rois_pred'].detach(), rois, labels_oh,
                    valid))
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
    if spec.mask_on:
        model.mask_head.reset_parameters(gen)
    return model.eval()
