"""Global configuration for the PyTorch port (copy of the JAX package's
``core/config.py``: the same defaults, keys and merge logic, so the repo's
YAML configs load unchanged).

PyYAML is imported lazily, inside the functions that read or write YAML:
the GPU machine has no PyYAML, so the card-side path builds ``cfg`` in code
(``merge_cfg_from_cfg(FLAGSHIP)``). Port-only keys live here, never in the
JAX config. The JAX package's original description follows.


Capability parity with the reference's ``detectron/core/config.py`` (global
``cfg`` AttrDict, defaults, YAML merge ``merge_cfg_from_file``, CLI override
``merge_cfg_from_list``, type coercion, immutability, ``assert_and_infer_cfg``;
reference lines 60-1396).  The key names and defaults below
mirror the reference so its YAML configs (e.g.
``configs/flickr_voc/na_wsddn_V-16-C5_1x.yaml``) load unchanged; the
implementation is new and TPU-oriented (NUM_GPUS is interpreted as the number
of JAX devices in the mesh).
"""

import copy
import os
from ast import literal_eval

import numpy as np

from nafwebsod_torch.utils.collections import AttrDict

_DEFAULTS = {

    # ---------------------------------------------------------------------------- #
    # Training options
    # ---------------------------------------------------------------------------- #
    'TRAIN': {
        'WEIGHTS': '',
        'DATASETS': (),
        'SCALES': (600,),
        'MAX_SIZE': 1000,
        'IMS_PER_BATCH': 2,
        'BATCH_SIZE_PER_IM': 64,
        'FG_FRACTION': 0.25,
        'FG_THRESH': 0.5,
        'BG_THRESH_HI': 0.5,
        'BG_THRESH_LO': 0.0,
        'USE_FLIPPED': True,
        'BBOX_THRESH': 0.5,
        'SNAPSHOT_ITERS': 80000,
        'PROPOSAL_FILES': (),
        'ASPECT_GROUPING': True,
        'CROWD_FILTER_THRESH': 0.7,
        'GT_MIN_AREA': -1,
        'FREEZE_CONV_BODY': False,
        'AUTO_RESUME': True,
        'COPY_WEIGHTS': False,
        'FREEZE_AT': 2,

        # RPN training options (reference config.py:146-177)
        'RPN_POSITIVE_OVERLAP': 0.7,
        'RPN_NEGATIVE_OVERLAP': 0.3,
        'RPN_FG_FRACTION': 0.5,
        'RPN_BATCH_SIZE_PER_IM': 256,
        'RPN_NMS_THRESH': 0.7,
        'RPN_PRE_NMS_TOP_N': 12000,
        'RPN_POST_NMS_TOP_N': 2000,
        'RPN_STRADDLE_THRESH': 0,
        'RPN_MIN_SIZE': 0,
        'GENERATE_PROPOSALS_ON_GPU': False,
    },

    # ---------------------------------------------------------------------------- #
    # Data loader options
    # ---------------------------------------------------------------------------- #
    'DATA_LOADER': {
        'NUM_THREADS': 4,
        'MINIBATCH_QUEUE_SIZE': 64,
        'BLOBS_QUEUE_CAPACITY': 8,
    },

    # ---------------------------------------------------------------------------- #
    # Inference options
    # ---------------------------------------------------------------------------- #
    'TEST': {
        'WEIGHTS': '',
        'DATASETS': (),
        'SCALE': 600,
        'MAX_SIZE': 1000,
        'NMS': 0.3,
        'BBOX_REG': True,
        'PROPOSAL_FILES': (),
        'PROPOSAL_LIMIT': 2000,
        'DETECTIONS_PER_IM': 100,
        'SCORE_THRESH': 0.05,
        'COMPETITION_MODE': True,
        'FORCE_JSON_DATASET_EVAL': False,
        'PRECOMPUTED_PROPOSALS': True,

        # RPN test options (reference config.py:254-267)
        'RPN_NMS_THRESH': 0.7,
        'RPN_PRE_NMS_TOP_N': 12000,
        'RPN_POST_NMS_TOP_N': 2000,
        'RPN_MIN_SIZE': 0,

        # Test-time augmentation for bounding boxes
        'BBOX_AUG': {
            'ENABLED': False,
            'SCORE_HEUR': 'UNION',  # 'ID' | 'AVG' | 'UNION'
            'COORD_HEUR': 'UNION',  # 'ID' | 'AVG' | 'UNION'
            'H_FLIP': False,
            'SCALES': (),
            'MAX_SIZE': 4000,
            'SCALE_H_FLIP': False,
            'SCALE_SIZE_DEP': False,
            'AREA_TH_LO': 50 ** 2,
            'AREA_TH_HI': 180 ** 2,
            'ASPECT_RATIOS': (),
            'ASPECT_RATIO_H_FLIP': False,
        },

        # Test-time augmentation for masks / keypoints (reference
        # config.py:341-403; sweeps run in engine/test.py im_detect_mask_aug /
        # im_detect_keypoints_aug with SOFT_AVG/SOFT_MAX/LOGIT_AVG and
        # HM_AVG/HM_MAX combination heuristics)
        'MASK_AUG': {
            'ENABLED': False,
            'HEUR': 'SOFT_AVG',
            'H_FLIP': False,
            'SCALES': (),
            'MAX_SIZE': 4000,
            'SCALE_H_FLIP': False,
            'SCALE_SIZE_DEP': False,
            'AREA_TH': 180 ** 2,
            'ASPECT_RATIOS': (),
            'ASPECT_RATIO_H_FLIP': False,
        },

        'KPS_AUG': {
            'ENABLED': False,
            'HEUR': 'HM_AVG',
            'H_FLIP': False,
            'SCALES': (),
            'MAX_SIZE': 4000,
            'SCALE_H_FLIP': False,
            'SCALE_SIZE_DEP': False,
            'AREA_TH': 180 ** 2,
            'ASPECT_RATIOS': (),
            'ASPECT_RATIO_H_FLIP': False,
        },

        # kept for YAML compat (Caffe2-runtime specific; proposals are always
        # generated on-device here)
        'GENERATE_PROPOSALS_ON_GPU': False,

        # Soft NMS
        'SOFT_NMS': {
            'ENABLED': False,
            'METHOD': 'linear',  # 'linear' | 'gaussian'
            'SIGMA': 0.5,
        },

        # Box voting
        'BBOX_VOTE': {
            'ENABLED': False,
            'VOTE_TH': 0.8,
            'SCORING_METHOD': 'ID',
            'SCORING_METHOD_BETA': 1.0,
        },
    },

    # ---------------------------------------------------------------------------- #
    # Model options
    # ---------------------------------------------------------------------------- #
    'MODEL': {
        'TYPE': '',
        'CONV_BODY': '',
        'NUM_CLASSES': -1,
        'CLS_AGNOSTIC_BBOX_REG': False,
        'BBOX_REG_WEIGHTS': (10., 10., 5., 5.),
        'FASTER_RCNN': False,
        'MASK_ON': False,
        'KEYPOINTS_ON': False,
        'RPN_ONLY': False,
        'EXECUTION_TYPE': 'dag',
    },

    # ---------------------------------------------------------------------------- #
    # Solver options
    # ---------------------------------------------------------------------------- #
    'SOLVER': {
        'BASE_LR': 0.001,
        'LR_POLICY': 'step',
        'GAMMA': 0.1,
        'STEP_SIZE': 30000,
        'STEPS': [],
        'LRS': [],
        'MAX_ITER': 40000,
        'MOMENTUM': 0.9,
        'WEIGHT_DECAY': 0.0005,
        'WEIGHT_DECAY_GN': 0.0,
        'WARM_UP_ITERS': 500,
        'WARM_UP_FACTOR': 1.0 / 3.0,
        'WARM_UP_METHOD': 'linear',
        'SCALE_MOMENTUM': True,
        'SCALE_MOMENTUM_THRESHOLD': 1.1,
        'LOG_LR_CHANGE_THRESHOLD': 1.1,
    },

    # ---------------------------------------------------------------------------- #
    # Fast R-CNN / RoI box head options
    # ---------------------------------------------------------------------------- #
    'FAST_RCNN': {
        'ROI_BOX_HEAD': '',
        'MLP_HEAD_DIM': 1024,
        'CONV_HEAD_DIM': 256,
        'NUM_STACKED_CONVS': 4,
        'ROI_XFORM_METHOD': 'RoIPoolF',
        'ROI_XFORM_SAMPLING_RATIO': 0,
        'ROI_XFORM_RESOLUTION': 14,
    },

    # ---------------------------------------------------------------------------- #
    # WSL (weakly-supervised learning) options — the capability switchboard
    # (reference config.py:910-987)
    # ---------------------------------------------------------------------------- #
    'WSL': {
        'WSL_ON': False,
        'ITER_SIZE': 1,
        'DEBUG': False,
        'SAMPLE': False,
        'SAMPLE_ITER': 1280,
        'CPG': False,
        'CPG_PRE_BLOB': 'cls_prob',
        'CPG_DATA_BLOB': 'data',
        'CPG_TAU': 0.7,
        'CPG_MAX_ITER': 0,
        'CSC_MAX_ITER': 35000,
        'CSC': False,
        'CSC_FG_THRESHOLD': 0.1,
        'CSC_MASS_THRESHOLD': 0.2,
        'CSC_DENSITY_THRESHOLD': 0.0,
        'CENTER_LOSS': False,
        'CENTER_LOSS_NUMBER': 5,
        'CENTER_LOSS_TOP_K': 10,
        'CONTEXT': False,
        'CONTEXT_RATIO': 1.8,
        'OICR': False,
        'PCL': False,
        # Run the PCL pseudo-labeling on device (lax.while_loop clique extraction
        # + masked KMeans) instead of the reference-faithful host callback; saves
        # refine_k host round-trips per step. Documented deviations: KMeans center
        # init and top-5 tie-breaking (ops/refine.py:pcl_targets_device).
        'PCL_DEVICE': False,
        'CMIL': False,
        'SIZE_EPOCH': 5000,
        'MLP_HEAD_DIM': [],
        'DEEP_MEM': False,
        'MEAN_LOSS': False,
        'USE_DISTORTION': True,
        'SATURATION': 1.5,
        'EXPOSURE': 1.5,
        'USE_CROP': True,
        'CROP': 0.9,
        'DILATION': 1,
        'MASK_SOFTMAX': False,
        'MIN_ENTROPY_LOSS': False,
        'PTH_IMG': False,
    },

    # Pseudo ground-truth self-training
    'USE_PSEUDO': False,
    'PSEUDO_PATH': (),

    # ---------------------------------------------------------------------------- #
    # WEBLY (noise-aware web supervision) options (reference config.py:990-1001)
    # ---------------------------------------------------------------------------- #
    'WEBLY': {
        'WEBLY_ON': False,
        'ENTROPY': False,
        'MINING': False,
        'BAGGING_MIXUP': False,
        'BAGGING_MIXUP_ALPHA': 1.5,
    },

    # ---------------------------------------------------------------------------- #
    # Mask head options (weakly-supervised seg branch; reference config.py:747-792)
    # ---------------------------------------------------------------------------- #
    'MRCNN': {
        # '' (the reference default) resolves to the same fcn/2-conv fields
        # as the explicit wsl_seg_heads.mask_rcnn_fcn_head name
        # (models/detector.py _mask_head_fields)
        'ROI_MASK_HEAD': '',
        'RESOLUTION': 14,
        'ROI_XFORM_METHOD': 'RoIAlign',
        'ROI_XFORM_RESOLUTION': 7,
        'ROI_XFORM_SAMPLING_RATIO': 0,
        'DIM_REDUCED': 256,
        'DILATION': 2,
        'UPSAMPLE_RATIO': 1,
        'USE_FC_OUTPUT': False,
        'CONV_INIT': 'GaussianFill',
        'CLS_SPECIFIC_MASK': True,
        'WEIGHT_LOSS_MASK': 1.0,
        'THRESH_BINARIZE': 0.5,
    },

    # ---------------------------------------------------------------------------- #
    # RPN options (reference config.py:683-693)
    # ---------------------------------------------------------------------------- #
    'RPN': {
        'RPN_ON': False,
        'SIZES': (64, 128, 256, 512),
        'STRIDE': 16,
        'ASPECT_RATIOS': (0.5, 1, 2),
    },

    # ---------------------------------------------------------------------------- #
    # FPN options (reference config.py:702-743)
    # ---------------------------------------------------------------------------- #
    'FPN': {
        'FPN_ON': False,
        'DIM': 256,
        'ZERO_INIT_LATERAL': False,
        'COARSEST_STRIDE': 32,
        'MULTILEVEL_ROIS': False,
        'ROI_CANONICAL_SCALE': 224,
        'ROI_CANONICAL_LEVEL': 4,
        'ROI_MAX_LEVEL': 5,
        'ROI_MIN_LEVEL': 2,
        'MULTILEVEL_RPN': False,
        'RPN_MAX_LEVEL': 6,
        'RPN_MIN_LEVEL': 2,
        'RPN_ASPECT_RATIOS': (0.5, 1, 2),
        'RPN_ANCHOR_START_SIZE': 32,
        'EXTRA_CONV_LEVELS': False,
        'USE_GN': False,
    },

    # ---------------------------------------------------------------------------- #
    # RetinaNet options (reference config.py:500-556)
    # ---------------------------------------------------------------------------- #
    'RETINANET': {
        'RETINANET_ON': False,
        'ASPECT_RATIOS': (0.5, 1.0, 2.0),
        'SCALES_PER_OCTAVE': 3,
        'ANCHOR_SCALE': 4,
        'NUM_CONVS': 4,
        'BBOX_REG_WEIGHT': 1.0,
        'BBOX_REG_BETA': 0.11,
        'PRE_NMS_TOP_N': 1000,
        'POSITIVE_OVERLAP': 0.5,
        'NEGATIVE_OVERLAP': 0.4,
        'LOSS_ALPHA': 0.25,
        'LOSS_GAMMA': 2.0,
        'PRIOR_PROB': 0.01,
        'SHARE_CLS_BBOX_TOWER': False,
        'CLASS_SPECIFIC_BBOX': False,
        'SOFTMAX': False,
        'INFERENCE_TH': 0.05,
    },

    # ---------------------------------------------------------------------------- #
    # Keypoint R-CNN options (reference config.py:803-870)
    # ---------------------------------------------------------------------------- #
    'KRCNN': {
        'ROI_KEYPOINTS_HEAD': '',
        'HEATMAP_SIZE': -1,
        'UP_SCALE': -1,
        'USE_DECONV': False,
        'DECONV_DIM': 256,
        'USE_DECONV_OUTPUT': False,
        'DILATION': 1,
        'DECONV_KERNEL': 4,
        'NUM_KEYPOINTS': -1,
        'NUM_STACKED_CONVS': 8,
        'CONV_HEAD_DIM': 256,
        'CONV_HEAD_KERNEL': 3,
        'CONV_INIT': 'GaussianFill',
        'NMS_OKS': False,
        'KEYPOINT_CONFIDENCE': 'bbox',
        'ROI_XFORM_METHOD': 'RoIAlign',
        'ROI_XFORM_RESOLUTION': 7,
        'ROI_XFORM_SAMPLING_RATIO': 0,
        'MIN_KEYPOINT_COUNT_FOR_VALID_MINIBATCH': 20,
        'INFERENCE_MIN_SIZE': 0,
        'LOSS_WEIGHT': 1.0,
        'NORMALIZE_BY_VISIBLE_KEYPOINTS': True,
    },

    # ---------------------------------------------------------------------------- #
    # R-FCN / ResNet options (reference config.py:879-905)
    # ---------------------------------------------------------------------------- #
    'RFCN': {
        'PS_GRID_SIZE': 3,
    },

    'RESNETS': {
        'NUM_GROUPS': 1,
        'WIDTH_PER_GROUP': 64,
        'STRIDE_1X1': True,
        'TRANS_FUNC': 'bottleneck_transformation',
        'STEM_FUNC': 'basic_bn_stem',
        'SHORTCUT_FUNC': 'basic_bn_shortcut',
        'RES5_DILATION': 1,
    },

    # ---------------------------------------------------------------------------- #
    # GroupNorm options
    # ---------------------------------------------------------------------------- #
    'GROUP_NORM': {
        'DIM_PER_GP': -1,
        'NUM_GROUPS': 32,
        'EPSILON': 1e-5,
    },

    # ---------------------------------------------------------------------------- #
    # Misc options
    # ---------------------------------------------------------------------------- #
    # Number of devices in the data-parallel mesh (the reference's NUM_GPUS;
    # here: number of TPU chips used by pjit/shard_map)
    'NUM_GPUS': 1,
    'USE_NCCL': False,  # kept for YAML compat; collectives are XLA-native here
    'DEDUP_BOXES': 1. / 16.,
    'BBOX_XFORM_CLIP': float(np.log(1000. / 16.)),
    'PIXEL_MEANS': np.array([[[102.9801, 115.9465, 122.7717]]]),
    'PIXEL_STDS': np.array([[[1.0, 1.0, 1.0]]]),
    'RNG_SEED': 3,
    'EPS': 1e-14,
    'ROOT_DIR': os.getcwd(),
    'OUTPUT_DIR': '/tmp',
    'MATLAB': 'matlab',
    'MEMONGER': False,
    'MEMONGER_SHARE_ACTIVATIONS': False,
    'VIS': False,
    'VIS_TH': 0.9,
    'EXPECTED_RESULTS': [],
    'EXPECTED_RESULTS_RTOL': 0.1,
    'EXPECTED_RESULTS_ATOL': 0.005,
    'EXPECTED_RESULTS_SIGMA_TOL': 4,
    'EXPECTED_RESULTS_EMAIL': '',
    'DOWNLOAD_CACHE': '/tmp/detectron-download-cache',

    # Cluster-environment flag (reference config.py:1098-1101; YAML compat)
    'CLUSTER': {
        'ON_CLUSTER': False,
    },

    # TPU-specific knobs (new; no reference equivalent)
    'TPU': {
        # Compute dtype for conv body / FC matmuls ('bfloat16' or 'float32').
        'COMPUTE_DTYPE': 'float32',
        # Pad RoI count to this multiple for static XLA shapes.
        'ROI_PAD_MULTIPLE': 256,
        # Max gt classes per image given CPG/CSC backward passes (static scan
        # capacity; each active class costs one conv backward). 0 = reference-
        # faithful: NUM_CLASSES-1, i.e. every gt class gets a saliency map like
        # the reference's dynamic loop (cpg_op.cu:149-213). The shipped TPU
        # CPG/CSC configs set 4 explicitly — it covers the observed per-image
        # label cardinality of the WSOD datasets and bounds compile-time scan
        # capacity; inactive capacity costs nothing at run time either way.
        'CPG_MAX_GT': 0,
        # Bucketed image sizes are rounded up to this multiple to bound recompiles.
        'SIZE_BUCKET_MULTIPLE': 64,
        # Use the Pallas fused RoI pooling kernel when on TPU.
        'USE_PALLAS': True,
        # Run the clean+noisy fc towers as one width-doubled GEMM pair (identical
        # math, fewer MXU launches; see ROADMAP perf lever 1).
        'FUSED_NOISE_TOWER': False,
        # Batch only the fc7 GEMMs across the clean/noisy towers (one (2, H, H)
        # batched matmul instead of two (H, H) ones; fc6 stays per-tower so the
        # HBM-heavy weight concat that sank FUSED_NOISE_TOWER is avoided).
        # MEASURED SLOWER on v5e (48.8 vs 53.2 img/s): the per-step weight
        # stack/cast still outweighs the launch savings — documented negative
        # result, keep off (models/heads.py vgg16_roi_2fc_noise_head).
        'FUSED_FC7': False,
        # Carry the dual noise-aware fc towers PRE-STACKED in the in-memory
        # param pytree (fc6s_w (roi_dim, 2H) + fc7s_w (2, H, H)): the fused
        # GEMM pair with ZERO per-step weight concat — the traffic that sank
        # FUSED_NOISE_TOWER/FUSED_FC7. The on-disk checkpoint schema is
        # unchanged (split at save / joined at load, engine/train.py).
        # Training-path only; requires the vgg16_2fc_noise head and the plain
        # DP train step (the name-driven TP/pipeline splits reject it).
        'STACKED_TOWERS': False,
        # Store SGD momentum buffers in bfloat16 (update math stays fp32;
        # each store rounds once). The Caffe-momentum update is HBM-bound
        # (~5 ms/step at flagship shapes, BASELINE.md roofline); halving the
        # momentum read+write traffic recovers ~1 ms/step. OPT-IN numerics
        # deviation from the reference's fp32 buffers (documented in
        # PARITY.md); on-disk checkpoints carry fp32 momentum either way.
        # Plain DP train step only (the ZeRO flat-momentum shard keeps f32).
        'BF16_MOMENTUM': False,
        # Rematerialize the conv body during backward (jax.checkpoint): trade
        # recompute FLOPs for activation HBM — lets an UNFROZEN body train at
        # larger image sizes / batch. No effect on frozen-body configs (their
        # activations are already dead after the pool).
        'REMAT_BODY': False,
        # Carry pre-cast bf16 shadow copies of the big compute-path weights in the
        # optimizer state (parallel/train_step.init_shadow): the forward reads the
        # shadow directly instead of converting the fp32 master weights every step.
        # Numerically identical to the plain path (exact-parity tests in
        # tests/test_shadow.py). MEASURED SLOWER on v5e (52.2 vs 54.8 img/s):
        # XLA already hides the fp32->bf16 convert in the GEMM/conv operand load,
        # so the only real cost moved was the post-update re-cast of the trainable
        # fc towers (~705 MB/step of unfused HBM traffic) — documented negative
        # result, keep off. -1 = auto (currently off pending a frozen-leaves-only
        # variant), 0 = off, 1 = force on.
        'SHADOW_BF16': -1,
        # ZeRO-1 (parallel/zero.py): keep the data-parallel step but shard the
        # SGD momentum over the mesh — psum_scatter gradients, per-slice Caffe
        # momentum update, all_gather of the updated params. Optimizer memory
        # per chip drops n-fold; numerics identical to the replicated solver.
        # Checkpoints keep the reference per-param momentum schema.
        'ZERO_OPT': False,
        # fc6/fc7 width (4096 in the reference; narrow for CPU tests only).
        'HEAD_HIDDEN_DIM': 4096,
        # When set, capture a jax.profiler trace of iterations [10, 15) into this
        # directory (the TPU-native analogue of the reference's per-phase Timers).
        'PROFILE_DIR': '',
        # Train-loop steps fused into one device call via lax.scan (1 = one call
        # per step). Per-call dispatch costs real wall-clock (dominant on
        # remote-attached TPUs); K chained steps amortize it Kx at the cost of
        # snapshot/log granularity rounding to K and the window sharing one padded
        # image size.
        'STEPS_PER_CALL': 1,
        # Host/device overlap: number of training windows assembled (loader
        # drain + stack + rng split) and uploaded ahead of the window the
        # device is executing, on a background thread. The produced stream
        # is BIT-IDENTICAL to the inline path (same loader order, same rng
        # chain); only wall-clock scheduling changes — wall/iter approaches
        # max(host, device) instead of their sum (reference analogue: the
        # BlobsQueue prefill pipeline, roi_data/loader_wsl.py:215-258).
        # 0 = assemble inline (old behavior). Single-host only; multi-host
        # runs keep the canvas-agreement collective on the main thread.
        'HOST_PREFETCH': 1,
        # Static ground-truth box capacity per image for the in-graph Faster R-CNN
        # target machinery (padded with a validity mask; no reference equivalent —
        # the Caffe2 python ops used dynamic shapes on host).
        'MAX_GT_BOXES': 64,
        # Shard the RoI axis over the mesh instead of data-parallel images: one
        # image per step, proposals split across devices, psum/all_gather
        # collectives for the RoI softmax / image score / entropy weights
        # (parallel/roi_shard.py — the scale-out for the R x 25088 tower axis
        # when RoI activations exceed per-chip HBM). Plain WSDDN/webly heads only.
        'ROI_SHARDING': False,
        # Tensor (hidden-dim) parallelism for the fc towers: the Megatron-style
        # column-parallel fc6 / row-parallel fc7 split over a 2-D
        # ('data', 'model') mesh (parallel/tensor_shard.py). Value = model-axis
        # size m (0 = off); the remaining devices//m mesh rows stay data-parallel
        # (one image each). Shrinks the dominant 25088 x hidden tower weights and
        # their optimizer state m-fold per chip with ONE psum per tower per
        # direction. Plain WSDDN/webly 2fc heads only.
        'TENSOR_SHARDING': 0,
        # 2-stage pipeline parallelism (parallel/pipeline.py): conv body on stage
        # 0, fc towers + heads + backward on stage 1, microbatches flowing through
        # a lax.scan schedule with one ppermute hop per tick. Requires
        # TRAIN.FREEZE_CONV_BODY (the flagship setting — makes the pipe
        # one-directional). Plain WSDDN/webly 2fc heads only.
        'PIPELINE_PARALLEL': False,
        # Microbatches (images) per pipeline step; the fill/drain bubble is
        # 1/(B+1) of the step, so more microbatches amortize it better.
        'PIPELINE_MICROBATCHES': 4,
        # Images per device call at eval time (plain protocol only: precomputed
        # proposals, no TTA/soft-NMS/voting/mask/keypoints/vis). A scan-of-B
        # fused forward+NMS program amortizes the per-call dispatch round-trip
        # Bx — dominant on remote-attached TPUs (~170 ms/call on the dev rig).
        # -1 = auto: 16 when the default backend is TPU (the measured sweet spot
        # of the double-buffered dispatch sweep — batch 32 regresses because the
        # chunk's host prep stops hiding under device compute; BASELINE.md), 1
        # elsewhere. Explicit values are honored as given.
        'INFER_BATCH': -1,
        # Shard each eval chunk's images over this many mesh devices inside ONE
        # program (engine/test.py _fused_detect_scan_mesh): the in-process,
        # ICI-native counterpart of --multi-gpu-testing's process-per-range
        # sharding (one weight replica per chip, no pickle merge). 0/1 = off;
        # chunks whose size does not divide evenly fall back to single-device.
        'INFER_MESH': 0,
        # Chunks kept in flight before harvesting in the batched eval loop.
        # 1 = classic double-buffer (dispatch i+1, then harvest i); 2 keeps a
        # second dispatched chunk queued so the host's harvest/assemble work for
        # chunk i also overlaps device compute (measured 55.4 -> 40.9 ms/image
        # on the dev rig, BASELINE.md). Results are order-identical at any depth
        # (FIFO harvest into per-image slots).
        'INFER_PIPELINE_DEPTH': 2,
        # Resize + normalize images INSIDE the jitted program (ops/image.py):
        # the host ships raw uint8 pixels (4x smaller than the f32 resized blob)
        # and skips cv2.resize. -1 = auto (on when the default backend is TPU),
        # 0 = force host prep, 1 = force device prep. Deviation from the
        # reference host pipeline is ~2e-3 pixel units (PARITY.md).
        'DEVICE_IMAGE_PREP': -1,
        # PRNG impl for the per-step dropout-mask stream. 'rbg' rides the XLA
        # RngBitGenerator fast path (measured ~3 ms/step cheaper than
        # 'threefry2x32' on v5e at flagship shapes — 33M mask draws/step); the
        # mask stream is arbitrary randomness, so this has no parity impact (the
        # reference uses Caffe2's RNG). Param INIT always stays on threefry.
        'RNG_IMPL': 'rbg',
    },
}


def _to_attr_dict(d):
    if isinstance(d, dict):
        return AttrDict({k: _to_attr_dict(v) for k, v in d.items()})
    return d


__C = _to_attr_dict(copy.deepcopy(_DEFAULTS))
cfg = __C

# Deprecated/renamed keys from the reference's registry that we silently accept
# in YAML files (reference config.py:1109-1175).
_DEPRECATED_KEYS = {
    'FINAL_MSG', 'MODEL.DILATION', 'ROOT_GPU_ID', 'RPN.ON', 'TRAIN.BBOX_NORMALIZE_TARGETS',
    'TRAIN.BBOX_NORMALIZE_TARGETS_PRECOMPUTED', 'TRAIN.BBOX_NORMALIZE_MEANS',
    'TRAIN.BBOX_NORMALIZE_STDS', 'TRAIN.DROPOUT', 'USE_GPU_NMS', 'TEST.NUM_TEST_IMAGES',
}

_RENAMED_KEYS = {
    'EXAMPLE.RENAMED.KEY': 'EXAMPLE.KEY',
    'PIXEL_MEAN': 'PIXEL_MEANS',
    # the reference's full rename registry (config.py:1130-1164) — a value
    # may be (new_key, extra_migration_hint)
    'MODEL.PS_GRID_SIZE': 'RFCN.PS_GRID_SIZE',
    'MODEL.ROI_HEAD': 'FAST_RCNN.ROI_BOX_HEAD',
    'MRCNN.MASK_HEAD_NAME': 'MRCNN.ROI_MASK_HEAD',
    'TRAIN.DATASET': (
        'TRAIN.DATASETS',
        "Also convert the value to a tuple, e.g. 'coco_2014_train' -> "
        "('coco_2014_train',); ':'-separated lists become tuple elements"),
    'TRAIN.PROPOSAL_FILE': (
        'TRAIN.PROPOSAL_FILES',
        "Also convert the value to a tuple of paths"),
    'TEST.SCALES': (
        'TEST.SCALE',
        "Also convert the value from a tuple, e.g. (600,), to an int"),
    'TEST.DATASET': (
        'TEST.DATASETS',
        "Also convert the value to a tuple, e.g. ('coco_2014_minival',)"),
    'TEST.PROPOSAL_FILE': (
        'TEST.PROPOSAL_FILES',
        "Also convert the value to a tuple of paths"),
}

# Keys the TPU rebuild accepts but ignores (none currently; the model-family
# subtrees RPN/FPN/RETINANET/KRCNN/RESNETS/RFCN are real keys now).
_IGNORED_SUBTREES = ()


def merge_cfg_from_file(cfg_filename):
    """Load a YAML config file and merge it into the global config."""
    import yaml
    with open(cfg_filename, 'r') as f:
        yaml_cfg = AttrDict(_to_attr_dict(yaml.safe_load(f)))
    _merge_a_into_b(yaml_cfg, __C)


def merge_cfg_from_cfg(cfg_other):
    """Merge another config (AttrDict or plain dict) into the global config."""
    _merge_a_into_b(AttrDict(_to_attr_dict(cfg_other)), __C)


def merge_cfg_from_list(cfg_list):
    """Merge config keys/values in a list (e.g. from CLI) into the config.

    The list must have even length: [key1, value1, key2, value2, ...].
    """
    assert len(cfg_list) % 2 == 0, 'Specify values or keys for args'
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        if _key_is_deprecated(full_key):
            continue
        if _key_is_renamed(full_key):
            _raise_key_rename_error(full_key)
        key_list = full_key.split('.')
        d = __C
        for subkey in key_list[:-1]:
            assert subkey in d, 'Non-existent key: {}'.format(full_key)
            d = d[subkey]
        subkey = key_list[-1]
        assert subkey in d, 'Non-existent key: {}'.format(full_key)
        value = _decode_cfg_value(v)
        value = _check_and_coerce_cfg_value_type(value, d[subkey], subkey, full_key)
        d[subkey] = value


def assert_and_infer_cfg(make_immutable=True):
    """Validate config invariants and freeze the config."""
    if (__C.MODEL.RPN_ONLY or __C.MODEL.FASTER_RCNN or
            __C.MODEL.TYPE == 'retinanet'):
        __C.TEST.PRECOMPUTED_PROPOSALS = False
    if make_immutable:
        __C.immutable(True)


def reset_cfg():
    """Restore the global config to its default state (test helper)."""
    global _DEFAULT_CFG
    __C.immutable(False)
    for k in list(__C.keys()):
        del __C[k]
    for k, v in copy.deepcopy(_DEFAULT_CFG).items():
        __C[k] = v
    __C.immutable(False)


def dump_cfg():
    """Serialize the current config to a YAML string (for checkpoints)."""
    import yaml
    return yaml.dump(_to_plain_dict(__C))


def dump_cfg_or_none():
    """The cfg as YAML for a checkpoint or a detections file, or None where
    PyYAML is not installed (their ``cfg`` entry is optional)."""
    try:
        return dump_cfg()
    except ImportError:
        return None


def get_output_dir(datasets, training=True):
    """<OUTPUT_DIR>/<train|test>/<dataset>/<MODEL.TYPE>, created."""
    dataset_name = (':'.join(datasets) if isinstance(datasets, (tuple, list))
                    else datasets)
    outdir = os.path.join(__C.OUTPUT_DIR, 'train' if training else 'test',
                          dataset_name, __C.MODEL.TYPE)
    os.makedirs(outdir, exist_ok=True)
    return outdir


# ---------------------------------------------------------------------------- #
# Internals
# ---------------------------------------------------------------------------- #

def _to_plain_dict(d):
    if isinstance(d, dict):
        return {k: _to_plain_dict(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [_to_plain_dict(x) for x in d]
    if isinstance(d, np.ndarray):
        return d.tolist()
    if isinstance(d, (np.floating, np.integer)):
        return d.item()
    return d


def _merge_a_into_b(a, b, stack=None):
    """Merge config ``a`` into ``b`` with an explicit worklist (no recursion).

    Behavior parity with the reference merge (``detectron/core/config.py``
    ``_merge_a_into_b``): unknown keys raise unless deprecated (skipped) or
    renamed (explanatory error); values are decoded then type-coerced against
    the default already in ``b``. Top-level subtrees in ``_IGNORED_SUBTREES``
    (reference key groups this rebuild intentionally drops) are skipped.
    """
    if not (isinstance(a, AttrDict) and isinstance(b, AttrDict)):
        raise TypeError(
            f'merge expects AttrDicts, got {type(a).__name__}/{type(b).__name__}')
    worklist = [('.'.join(stack) if stack else '', a, b)]
    while worklist:
        prefix, src, dst = worklist.pop()
        for key, raw in src.items():
            dotted = f'{prefix}.{key}' if prefix else key
            if key not in dst:
                if _key_is_deprecated(dotted):
                    continue
                if _key_is_renamed(dotted):
                    _raise_key_rename_error(dotted)
                if not prefix and key in _IGNORED_SUBTREES:
                    continue
                raise KeyError(f'Non-existent config key: {dotted}')
            value = _check_and_coerce_cfg_value_type(
                _decode_cfg_value(copy.deepcopy(raw)), dst[key], key, dotted)
            if isinstance(value, AttrDict):
                worklist.append((dotted, value, dst[key]))
            else:
                dst[key] = value


def _key_is_deprecated(full_key):
    return full_key in _DEPRECATED_KEYS


def _key_is_renamed(full_key):
    return full_key in _RENAMED_KEYS


def _raise_key_rename_error(full_key):
    new_key = _RENAMED_KEYS[full_key]
    hint = ''
    if isinstance(new_key, tuple):
        new_key, extra = new_key
        hint = ' Note: ' + extra + '.'
    raise KeyError(
        f'Key {full_key} was renamed to {new_key}; '
        f'please update your config.{hint}')


def _decode_cfg_value(v):
    """Decode a raw config value (from YAML or the CLI) into a Python object.

    Plain dicts become AttrDicts; strings are parsed as Python literals when
    they are one ("[1, 2]", "0.5", "True"), and pass through otherwise (bare
    words and paths raise inside ``literal_eval`` and stay strings).
    """
    if isinstance(v, AttrDict):
        return v
    if isinstance(v, dict):
        return _to_attr_dict(v)
    if isinstance(v, str):
        try:
            return literal_eval(v)
        except (ValueError, SyntaxError):
            pass
    return v


# (predicate(new, old) -> bool, convert(new, old) -> coerced) rule table for
# the YAML-ambiguity coercions the reference merge allows; first hit wins.
_COERCION_RULES = (
    (lambda n, o: isinstance(o, np.ndarray),
     lambda n, o: np.array(n, dtype=o.dtype)),
    (lambda n, o: isinstance(o, str),
     lambda n, o: str(n)),
    (lambda n, o: isinstance(n, tuple) and isinstance(o, list),
     lambda n, o: list(n)),
    (lambda n, o: isinstance(n, list) and isinstance(o, tuple),
     lambda n, o: tuple(n)),
    (lambda n, o: isinstance(o, float) and isinstance(n, int),
     lambda n, o: float(n)),
    (lambda n, o: isinstance(n, AttrDict) and isinstance(o, AttrDict),
     lambda n, o: n),
)


def _check_and_coerce_cfg_value_type(new, old, key, full_key):
    """Return ``new`` coerced to ``old``'s type when a rule allows it."""
    if type(new) is type(old):
        return new
    for matches, convert in _COERCION_RULES:
        if matches(new, old):
            return convert(new, old)
    raise ValueError(
        f'Type mismatch ({type(old)} vs. {type(new)}) with values '
        f'({old} vs. {new}) for config key: {full_key}')


# The values of configs/flickr_voc/na_wsddn_V-16-C5_1x.yaml (the paper's
# flagship), for merge_cfg_from_cfg where PyYAML is absent. A test holds this
# dict equal to the YAML file's merge.
FLAGSHIP = {
    'MODEL': {'TYPE': 'generalized_wsl',
              'CONV_BODY': 'VGG16.add_VGG16_conv5_body_origin',
              'NUM_CLASSES': 21},
    'NUM_GPUS': 8,
    'RNG_SEED': 11,
    'DEDUP_BOXES': 0.125,
    'PIXEL_MEANS': [[[103.939, 116.779, 123.68]]],
    'OUTPUT_DIR': 'outputs',
    'SOLVER': {'LR_POLICY': 'steps_with_decay', 'BASE_LR': 0.001,
               'GAMMA': 0.1, 'STEPS': [0, 150000], 'MAX_ITER': 200000,
               'MOMENTUM': 0.9, 'WEIGHT_DECAY': 0.0005, 'WARM_UP_ITERS': 0},
    'FAST_RCNN': {'ROI_BOX_HEAD': 'webly_heads.add_VGG16_roi_2fc_noise_head',
                  'ROI_XFORM_METHOD': 'RoIPoolF',
                  'ROI_XFORM_RESOLUTION': 7,
                  'ROI_XFORM_SAMPLING_RATIO': 2},
    'TRAIN': {'WEIGHTS': 'models/VGG/VGG_ILSVRC_16_layers_v1.pkl',
              'DATASETS': ('flickr_voc',),
              'PROPOSAL_FILES': ('datasets/data/flickr_voc/mcg.pkl',),
              'SCALES': (480, 576, 688, 864, 1200), 'MAX_SIZE': 2000,
              'IMS_PER_BATCH': 1, 'BATCH_SIZE_PER_IM': 2048,
              'FREEZE_CONV_BODY': True, 'CROWD_FILTER_THRESH': 0.0,
              'SNAPSHOT_ITERS': 10000},
    'TEST': {'DATASETS': ('voc_2007_test',),
             'PROPOSAL_FILES': (
                 'datasets/data/proposals/mcg_voc_2007_test.pkl',),
             'PROPOSAL_LIMIT': 9999, 'SCALE': 688, 'MAX_SIZE': 4000,
             'NMS': 0.5, 'BBOX_REG': False, 'SCORE_THRESH': 0.000000001,
             'DETECTIONS_PER_IM': 100,
             'BBOX_AUG': {'ENABLED': False, 'SCORE_HEUR': 'AVG',
                          'COORD_HEUR': 'ID', 'H_FLIP': True,
                          'SCALES': (480, 576, 864, 1200),
                          'MAX_SIZE': 4000, 'SCALE_H_FLIP': True}},
    'WSL': {'WSL_ON': True, 'ITER_SIZE': 1, 'SAMPLE': True,
            'SAMPLE_ITER': 1280, 'DILATION': 2, 'MEAN_LOSS': True},
    'WEBLY': {'WEBLY_ON': True, 'ENTROPY': True, 'BAGGING_MIXUP': True,
              'BAGGING_MIXUP_ALPHA': 1.5},
    'TPU': {'COMPUTE_DTYPE': 'bfloat16'},
}

# The values of configs/wsod_families/csc_V-16-C5.yaml (CPG saliency + CSC
# on the plain 2fc head, the flagship's data and solver recipe). A test
# holds this dict equal to the YAML file's merge.
CSC = {
    **{k: v for k, v in FLAGSHIP.items() if k not in ('WEBLY', 'TEST')},
    'FAST_RCNN': dict(FLAGSHIP['FAST_RCNN'],
                      ROI_BOX_HEAD='wsl_heads.add_VGG16_roi_2fc_head'),
    'TEST': {k: v for k, v in FLAGSHIP['TEST'].items() if k != 'BBOX_AUG'},
    'WSL': dict(FLAGSHIP['WSL'], CPG=True, CSC=True, CPG_TAU=0.7,
                CSC_FG_THRESHOLD=0.1, CSC_MAX_ITER=35000),
    'WEBLY': {'WEBLY_ON': False},
    'TPU': {'CPG_MAX_GT': 4, 'COMPUTE_DTYPE': 'bfloat16'},
}

# The values of configs/wsod_families/context_V-16-C5.yaml (the context
# head: the proposal plus its frame and context rings, the flagship's data
# and solver recipe). A test holds this dict equal to the YAML file's merge.
CONTEXT = dict(
    CSC,
    FAST_RCNN=dict(FLAGSHIP['FAST_RCNN'],
                   ROI_BOX_HEAD='wsl_heads.add_VGG16_roi_context_2fc_head'),
    WSL=dict(FLAGSHIP['WSL'], CONTEXT=True, CONTEXT_RATIO=1.8),
    TPU=FLAGSHIP['TPU'])

# The values of configs/wsod_families/seg_V-16-C5.yaml (the plain 2fc head
# with the image-level deeplab mask head: ASPP logits, CPG pseudo labels,
# dense CRF; the flagship's data and solver recipe). A test holds this dict
# equal to the YAML file's merge.
SEG = dict(
    CSC,
    MODEL=dict(FLAGSHIP['MODEL'], MASK_ON=True),
    MRCNN={'ROI_MASK_HEAD': 'wsl_seg_heads.deeplab_vgg16_head',
           'RESOLUTION': 28},
    WSL=dict(FLAGSHIP['WSL'], CPG=True, CPG_TAU=0.7))

# SEG with the family's other mask head, the fcn tower over RoIAlign, in
# Detectron's published geometry (14x14 RoIAlign, 28x28 masks). No YAML
# file: the JAX package takes the same cfg.
SEG_FCN = dict(
    SEG,
    MRCNN={'ROI_MASK_HEAD': 'wsl_seg_heads.mask_rcnn_fcn_head',
           'ROI_XFORM_RESOLUTION': 14, 'RESOLUTION': 28})


# Snapshot defaults for reset_cfg(); keep at module end.
_DEFAULT_CFG = copy.deepcopy({k: v for k, v in __C.items()})
