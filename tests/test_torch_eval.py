"""The port's VOC inference tail (catalog, COCO-json dataset -> roidb, VOC
AP / CorLoc, ``evaluate_all``, ``run_inference`` and the test CLI) against
the JAX package's on the synthetic dataset of tests/fixtures.py.

Everything here is numpy on the host: the same files in, the same numbers
out, compared exactly (``assert_array_equal`` / ``==``).
"""

import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import fixtures
from nafwebsod_tpu.core import config as jax_config
from nafwebsod_tpu.data import catalog as jax_catalog
from nafwebsod_tpu.data import roidb as jax_roidb
from nafwebsod_tpu.data import task_evaluation as jax_task_evaluation
from nafwebsod_tpu.data import voc_eval as jax_voc_eval
from nafwebsod_tpu.data.json_dataset import JsonDataset as JaxJsonDataset
from nafwebsod_torch.core import config as port_config
from nafwebsod_torch.data import (catalog, minibatch, roidb as roidb_lib,
                                  task_evaluation, voc_dataset_evaluator,
                                  voc_eval)
from nafwebsod_torch.data.json_dataset import JsonDataset
from nafwebsod_torch.engine import test_engine
from nafwebsod_torch.engine import train as train_engine
from nafwebsod_torch.ops import boxes as box_utils
from nafwebsod_torch.utils import checkpoint
from nafwebsod_torch.utils.io import load_object, save_object

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLUMNS = ('boxes', 'obn_scores', 'gt_classes', 'seg_areas', 'gt_overlaps',
           'is_crowd', 'box_to_gt_ind_map', 'max_classes', 'max_overlaps')


@pytest.fixture(autouse=True)
def _fresh_cfgs():
    jax_config.reset_cfg()
    port_config.reset_cfg()
    yield
    jax_config.reset_cfg()
    port_config.reset_cfg()


def _edit_json(path, edit):
    with open(path) as f:
        ann = json.load(f)
    edit(ann)
    with open(path, 'w') as f:
        json.dump(ann, f)


def _write_devkit(root, ann_file):
    """A VOC2007 devkit for the dataset's json: 1-based XML boxes and the
    image-set file, in image-id order."""
    with open(ann_file) as f:
        ann = json.load(f)
    names = {c['id']: c['name'] for c in ann['categories']}
    specs = []
    for im in sorted(ann['images'], key=lambda im: im['id']):
        objs = []
        for a in ann['annotations']:
            if a['image_id'] != im['id'] or a.get('iscrowd', 0):
                continue
            x, y, w, h = a['bbox']
            objs.append((names[a['category_id']], x + 1, y + 1, x + w, y + h,
                         int(a.get('diffcult', 0))))
        specs.append((os.path.splitext(im['file_name'])[0], objs))
    voc_root = os.path.join(root, 'devkit', 'VOC2007')
    _, setfile = fixtures.make_voc_annotations(voc_root, specs)
    main = os.path.join(voc_root, 'ImageSets', 'Main')
    os.makedirs(main)
    shutil.move(setfile, os.path.join(main, 'test.txt'))
    return os.path.join(root, 'devkit')


def _dataset(tmp_path, name, n_images=4, devkit=True, edit=None):
    """The fixture dataset under ``name`` in both packages' catalogs."""
    root = str(tmp_path / name)
    info = fixtures.make_coco_dataset(root, n_images=n_images)
    if edit is not None:
        _edit_json(info['ann_file'], edit)
    info['devkit'] = _write_devkit(root, info['ann_file']) if devkit else None
    for cat in (catalog, jax_catalog):
        cat.register_dataset(name, info['image_dir'], info['ann_file'],
                             info['devkit'])
    return info


def _assert_same_roidb(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # the port's entries have no mask column and nothing else missing
        assert set(w) - set(g) == {'segms'} and set(g) <= set(w)
        for k in g:
            if isinstance(g[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k
        assert set(COLUMNS) <= set(g)


def _add_crowd_and_hard_objects(ann):
    im0, im1 = ann['images'][0], ann['images'][1]
    ann['annotations'].append({
        'id': 900, 'image_id': im0['id'], 'category_id': 2,
        'bbox': [2, 2, im0['width'] // 2, im0['height'] // 2],
        'area': 500, 'iscrowd': 1})
    # every object of image 1 difficult and truncated: it keeps no gt
    for a in ann['annotations']:
        if a['image_id'] == im1['id']:
            a['diffcult'], a['truncated'] = 1, 1
    # a box that is degenerate after clipping, and an ignored one
    ann['annotations'].append({
        'id': 901, 'image_id': im0['id'], 'category_id': 1,
        'bbox': [im0['width'] + 5, 4, 10, 10], 'area': 100, 'iscrowd': 0})
    ann['annotations'].append({
        'id': 902, 'image_id': im0['id'], 'category_id': 3,
        'bbox': [4, 4, 10, 10], 'area': 100, 'iscrowd': 0, 'ignore': 1})


@pytest.mark.parametrize('name', ['synth_voc_test', 'synth_webly_train'])
@pytest.mark.parametrize('kind', ['gt_only', 'proposals', 'limit_and_crowd'])
def test_roidb_equals_the_jax_packages(tmp_path, name, kind):
    info = _dataset(tmp_path, name, devkit=False,
                    edit=_add_crowd_and_hard_objects)
    kw = {'gt_only': dict(gt=True),
          'proposals': dict(gt=True, proposal_file=info['prop_file']),
          'limit_and_crowd': dict(gt=True, proposal_file=info['prop_file'],
                                  proposal_limit=10, min_proposal_size=25,
                                  crowd_filter_thresh=0.3)}[kind]
    got = JsonDataset(name).get_roidb(**kw)
    want = JaxJsonDataset(name).get_roidb(**kw)
    _assert_same_roidb(got, want)
    # the train-time filter drops the image without gt; a test set keeps it
    assert len(got) == (4 if 'test' in name else 3)
    if kind == 'limit_and_crowd':
        assert any((e['gt_overlaps'] == -1).all(axis=1)[
            e['gt_classes'] == 0].any() for e in got)
        assert all((e['gt_classes'] == 0).sum() <= 10 for e in got)


def test_roidb_without_gt_and_the_unported_columns(tmp_path):
    info = _dataset(tmp_path, 'synth_voc_test', devkit=False)
    got = JsonDataset('synth_voc_test').get_roidb(
        proposal_file=info['prop_file'])
    want = JaxJsonDataset('synth_voc_test').get_roidb(
        proposal_file=info['prop_file'])
    _assert_same_roidb(got, want)
    assert all(os.path.isfile(e['image']) for e in got)
    with pytest.raises(AssertionError):
        JsonDataset('synth_voc_test').get_roidb(crowd_filter_thresh=0.5)
    for key in ('MASK_ON', 'KEYPOINTS_ON'):
        port_config.cfg.MODEL[key] = True
        with pytest.raises(NotImplementedError, match=key):
            JsonDataset('synth_voc_test').get_roidb(gt=True)
        port_config.cfg.MODEL[key] = False
    port_config.cfg.USE_PSEUDO = True
    with pytest.raises(NotImplementedError, match='USE_PSEUDO'):
        JsonDataset('synth_voc_test').get_roidb(gt=True)
    with pytest.raises(KeyError):
        JsonDataset('no_such_dataset')


def test_repeated_proposals_are_dropped_before_the_size_filter(tmp_path):
    """A proposal file whose last box repeats an earlier one: the port
    drops the repeat, then the small boxes, as the JAX package does on the
    same file without the repeat. The JAX package computes both filters'
    indices on the unfiltered boxes and fails on the repeat (a fault of
    the reference, ROADMAP queue 3)."""
    info = _dataset(tmp_path, 'synth_voc_test', devkit=False)
    props = load_object(info['prop_file'])
    clean = str(tmp_path / 'clean.pkl')
    save_object(props, clean)
    props['boxes'][0] = np.vstack([props['boxes'][0], props['boxes'][0][:1]])
    props['scores'][0] = np.vstack([props['scores'][0],
                                    props['scores'][0][:1]])
    repeated = str(tmp_path / 'repeated.pkl')
    save_object(props, repeated)
    kw = dict(gt=True, min_proposal_size=25)
    got = JsonDataset('synth_voc_test').get_roidb(proposal_file=repeated,
                                                  **kw)
    want = JaxJsonDataset('synth_voc_test').get_roidb(proposal_file=clean,
                                                      **kw)
    _assert_same_roidb(got, want)
    with pytest.raises(IndexError):
        JaxJsonDataset('synth_voc_test').get_roidb(proposal_file=repeated,
                                                   **kw)


@pytest.mark.parametrize('flipped', [False, True])
def test_training_roidb_equals_the_jax_packages(tmp_path, flipped):
    info = _dataset(tmp_path, 'synth_webly_train', devkit=False,
                    edit=_add_crowd_and_hard_objects)
    for c in (jax_config.cfg, port_config.cfg):
        c.TRAIN.USE_FLIPPED = flipped
        c.TRAIN.CROWD_FILTER_THRESH = 0.0
    got = roidb_lib.combined_roidb_for_training(
        ('synth_webly_train',), (info['prop_file'],))
    want = jax_roidb.combined_roidb_for_training(
        ('synth_webly_train',), (info['prop_file'],))
    _assert_same_roidb(got, want)
    assert len(got) == (6 if flipped else 3)
    assert [e['flipped'] for e in got] == [False] * 3 + [True] * 3 * flipped
    with pytest.raises(ValueError):
        roidb_lib.combined_roidb_for_training(('a', 'b'), ('p',))


def test_catalog_is_the_jax_packages(monkeypatch, tmp_path):
    monkeypatch.setenv('WEBSOD_DATA_DIR', str(tmp_path))
    for name in ('voc_2007_test', 'voc_2007_trainval', 'voc_2012_val',
                 'flickr_voc', 'flickr_clean', 'coco_2014_minival',
                 'coco_2017_test-dev', 'cityscapes_fine_instanceonly_seg_val'):
        assert catalog.get_im_dir(name) == jax_catalog.get_im_dir(name)
        assert catalog.get_ann_fn(name) == jax_catalog.get_ann_fn(name)
        assert catalog.get_im_prefix(name) == jax_catalog.get_im_prefix(name)
    assert (catalog.get_devkit_dir('voc_2007_test')
            == jax_catalog.get_devkit_dir('voc_2007_test')
            == str(tmp_path / 'VOC2007' / 'VOCdevkit2007'))
    monkeypatch.delenv('WEBSOD_DATA_DIR')
    assert catalog.get_data_dir() == os.path.join(REPO, 'datasets', 'data')


def test_numpy_boxes_equal_the_jax_packages():
    from nafwebsod_tpu.ops import boxes as jax_boxes
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 80, (40, 2))
    b = np.hstack([xy, xy + rng.uniform(0, 40, (40, 2))]).astype(np.float32)
    b[5] = b[4]
    np.testing.assert_array_equal(box_utils.bbox_overlaps(b, b[:7]),
                                  jax_boxes.bbox_overlaps(b, b[:7]))
    np.testing.assert_array_equal(box_utils.unique_boxes(b),
                                  jax_boxes.unique_boxes(b))
    np.testing.assert_array_equal(box_utils.filter_small_boxes(b, 20),
                                  jax_boxes.filter_small_boxes(b, 20))
    assert (box_utils.xywh_to_xyxy([3, 4, 10, 0.5])
            == jax_boxes.xywh_to_xyxy([3, 4, 10, 0.5]))
    assert (box_utils.clip_xyxy_to_image(-3, 4, 200, 90, 60, 100)
            == jax_boxes.clip_xyxy_to_image(-3, 4, 200, 90, 60, 100))


# --------------------------------------------------------------------------- #
# VOC AP / CorLoc
# --------------------------------------------------------------------------- #

def _noisy_detections(roidb, num_classes, seed=0):
    """all_boxes[class][image]: the gt boxes jittered (some past IoU 0.5),
    plus false positives, plus an image without detections."""
    rng = np.random.RandomState(seed)
    all_boxes = [[[] for _ in roidb] for _ in range(num_classes)]
    for i, e in enumerate(roidb):
        if i == len(roidb) - 1:
            continue
        for cls in range(1, num_classes):
            gt = e['boxes'][e['gt_classes'] == cls]
            dets = [np.hstack([g + rng.uniform(-9, 9, 4), rng.rand()])
                    for g in gt for _ in range(2)]
            for _ in range(3):
                x, y = rng.uniform(0, 60, 2)
                dets.append([x, y, x + 25, y + 20, rng.rand()])
            all_boxes[cls][i] = np.asarray(dets, np.float32)
    return all_boxes


def _add_objects(ann):
    """A second object in image 1 and a difficult one in image 2, so that
    AP sees duplicates and CorLoc sees a skipped image."""
    ann['annotations'].append({
        'id': 800, 'image_id': 1, 'category_id': 1,
        'bbox': [70, 50, 30, 25], 'area': 750, 'iscrowd': 0})
    for a in ann['annotations']:
        if a['image_id'] == 2:
            a['diffcult'] = 1


@pytest.mark.parametrize('use_07_metric', [True, False])
def test_voc_eval_ap_and_corloc_equal_the_jax_packages(tmp_path,
                                                       use_07_metric):
    info = _dataset(tmp_path, 'synth_voc_test', n_images=6,
                    edit=_add_objects)
    ds = JsonDataset('synth_voc_test')
    roidb = ds.get_roidb(gt=True)
    all_boxes = _noisy_detections(roidb, ds.num_classes)
    voc_dataset_evaluator._write_voc_results_files(ds, all_boxes, '_t')
    vinfo = voc_dataset_evaluator.voc_info(ds)
    det = os.path.join(info['devkit'], 'results', 'VOC2007', 'Main',
                       'comp4_t_det_test_{:s}.txt')
    seen = []
    for cls in ds.classes[1:]:
        args = (det, vinfo['anno_path'], vinfo['image_set_path'], cls)
        rec, prec, ap = voc_eval.voc_eval(
            *args, str(tmp_path / 'cache_a'), use_07_metric=use_07_metric)
        wrec, wprec, wap = jax_voc_eval.voc_eval(
            *args, str(tmp_path / 'cache_b'), use_07_metric=use_07_metric)
        np.testing.assert_array_equal(rec, wrec)
        np.testing.assert_array_equal(prec, wprec)
        assert ap == wap and 0.0 <= ap <= 1.0
        got = voc_eval.voc_eval_corloc(*args, str(tmp_path / 'cache_a'))
        assert got == jax_voc_eval.voc_eval_corloc(
            *args, str(tmp_path / 'cache_b'))
        seen.append((ap, got[0]))
    assert any(0 < ap < 1 for ap, _ in seen)
    assert any(c > 0 for _, c in seen)
    # a class without a detections file
    assert voc_eval.voc_eval(det, vinfo['anno_path'],
                             vinfo['image_set_path'], 'nothing',
                             str(tmp_path / 'cache_a'))[2] == 0.0


def test_voc_ap_equals_the_jax_packages():
    rng = np.random.RandomState(3)
    for n in (0, 1, 7, 40):
        rec = np.sort(rng.rand(n))
        prec = rng.rand(n)
        for use_07 in (True, False):
            assert (voc_eval.voc_ap(rec, prec, use_07)
                    == jax_voc_eval.voc_ap(rec, prec, use_07))


def test_evaluate_all_equals_the_jax_packages(tmp_path):
    _dataset(tmp_path, 'synth_voc_test', n_images=6, edit=_add_objects)
    ds = JsonDataset('synth_voc_test')
    roidb = ds.get_roidb(gt=True)
    all_boxes = _noisy_detections(roidb, ds.num_classes)
    ids = [e['id'] for e in roidb]
    got = task_evaluation.evaluate_all(
        ds, all_boxes, None, None, str(tmp_path / 'out_a'), image_ids=ids)
    want = jax_task_evaluation.evaluate_all(
        JaxJsonDataset('synth_voc_test'), all_boxes, None, None,
        str(tmp_path / 'out_b'), image_ids=ids)
    assert got == want
    res = got['synth_voc_test']
    assert set(res) == {'ap', 'mAP', 'corloc', 'mean_corloc'}
    assert 0 < res['mAP'] < 1 and 0 < res['mean_corloc'] <= 1
    assert set(res['ap']) == set(fixtures.CLASSES)
    # the per-class files of the reference layout, and no result files left
    # in the devkit
    assert os.path.isfile(str(tmp_path / 'out_a' / 'bird_pr.pkl'))
    assert os.path.isfile(str(tmp_path / 'out_a' / 'bird_corloc.pkl'))
    assert os.listdir(os.path.join(
        catalog.get_devkit_dir('synth_voc_test'), 'results', 'VOC2007',
        'Main')) == []
    # perfect detections
    perfect = [[[] for _ in roidb] for _ in range(ds.num_classes)]
    for i, e in enumerate(roidb):
        for cls in range(1, ds.num_classes):
            gt = e['boxes'][e['gt_classes'] == cls]
            if len(gt):
                perfect[cls][i] = np.hstack(
                    [gt, np.ones((len(gt), 1))]).astype(np.float32)
    res = task_evaluation.evaluate_all(
        ds, perfect, None, None, str(tmp_path / 'out_c'),
        image_ids=ids)['synth_voc_test']
    assert res['mAP'] == 1.0 and res['mean_corloc'] == 1.0


def test_detections_that_do_not_line_up_with_the_image_set_raise(tmp_path):
    """The devkit evaluator reads all_boxes by position against the
    image-set file (the trap of tests/test_eval_alignment.py): the port
    checks the detection-time ids against it."""
    _dataset(tmp_path, 'synth_voc_test')
    ds = JsonDataset('synth_voc_test')
    roidb = ds.get_roidb(gt=True)
    all_boxes = _noisy_detections(roidb, ds.num_classes)
    ids = [e['id'] for e in roidb]
    for bad in (ids[1:] + ids[:1], ids[:-1]):
        with pytest.raises(ValueError, match='line up'):
            task_evaluation.evaluate_all(ds, all_boxes, None, None,
                                         str(tmp_path / 'out'),
                                         image_ids=bad)


def test_unported_evaluators_raise(tmp_path):
    """Without a devkit (or with TEST.FORCE_JSON_DATASET_EVAL) the boxes go
    to the COCO-protocol evaluator; masks and keypoints still raise."""
    _dataset(tmp_path, 'synth_coco_test', devkit=False)
    ds = JsonDataset('synth_coco_test')
    empty = test_engine.empty_results(ds.num_classes, 4)
    res = task_evaluation.evaluate_all(ds, empty, None, None, str(tmp_path))
    # the fixture's objects are all medium-sized
    assert res == {'synth_coco_test': {'AP': 0.0, 'AP50': 0.0, 'AP75': 0.0,
                                       'APm': 0.0}}
    _dataset(tmp_path, 'synth_voc_test')
    ds = JsonDataset('synth_voc_test')
    port_config.cfg.TEST.FORCE_JSON_DATASET_EVAL = True
    assert 'AP' in task_evaluation.evaluate_all(
        ds, empty, None, None, str(tmp_path))['synth_voc_test']
    port_config.cfg.TEST.FORCE_JSON_DATASET_EVAL = False
    with pytest.raises(NotImplementedError, match='mask'):
        task_evaluation.evaluate_all(ds, empty, empty, None, str(tmp_path))
    with pytest.raises(NotImplementedError, match='keypoint'):
        task_evaluation.evaluate_all(ds, empty, None, empty, str(tmp_path))


@pytest.mark.parametrize('edit', [None, _add_crowd_and_hard_objects])
def test_coco_box_metrics_equal_the_jax_evaluators(tmp_path, edit):
    """The COCO protocol on detections that hit, duplicate and miss the
    fixture's objects, with crowd, ignored and difficult objects in the
    second case: the same numbers as the JAX package's evaluator."""
    _dataset(tmp_path, 'synth_coco_test', n_images=6, devkit=False,
             edit=edit)
    ds = JsonDataset('synth_coco_test')
    roidb = ds.get_roidb(gt=True)
    all_boxes = _noisy_detections(roidb, ds.num_classes)
    ids = [e['id'] for e in roidb]
    got = task_evaluation.evaluate_all(ds, all_boxes, None, None,
                                       str(tmp_path / 'out'), image_ids=ids)
    want = jax_task_evaluation.evaluate_all(
        JaxJsonDataset('synth_coco_test'), all_boxes, None, None,
        str(tmp_path / 'jax_out'), image_ids=ids)
    assert got == want
    res = got['synth_coco_test']
    assert {'AP', 'AP50', 'AP75'} <= set(res)
    assert 0 < res['AP'] < res['AP50'] <= 1


def test_check_expected_results(tmp_path):
    results = {'synth_voc_test': {'mAP': 0.5, 'mean_corloc': 0.25}}
    assert task_evaluation.check_expected_results(results)
    for expected, ok in (
            ([['synth_voc_test', 'box', 'mAP', 0.52]], True),
            ([['synth_voc_test', 'box', 'mAP', 0.7]], False),
            ([['synth_voc_test', 'box', 'AP50', 0.5]], False),
            ([['other', 'box', 'mAP', 0.5]], False)):
        for c, mod in ((port_config.cfg, task_evaluation),
                       (jax_config.cfg, jax_task_evaluation)):
            c.EXPECTED_RESULTS = expected
            assert mod.check_expected_results(results) is ok


# --------------------------------------------------------------------------- #
# run_inference and the CLI
# --------------------------------------------------------------------------- #

def _tiny_context_cfg(info, output_dir, name='synth_voc_test'):
    c = port_config.cfg
    port_config.merge_cfg_from_cfg(port_config.CONTEXT)
    c.MODEL.NUM_CLASSES = len(fixtures.CLASSES) + 1
    c.TPU.HEAD_HIDDEN_DIM = 8
    c.TPU.COMPUTE_DTYPE = 'float32'
    c.TPU.SIZE_BUCKET_MULTIPLE = 32
    c.TEST.DATASETS = (name,)
    c.TEST.PROPOSAL_FILES = (info['prop_file'],)
    c.TEST.SCALE = 64
    c.TEST.MAX_SIZE = 120
    c.OUTPUT_DIR = output_dir
    return c


def test_run_inference_end_to_end_on_the_cpu(tmp_path):
    info = _dataset(tmp_path, 'synth_voc_test')
    _tiny_context_cfg(info, str(tmp_path / 'out'))
    results = test_engine.run_inference(device='cpu',
                                        check_expected_results=True)
    res = results['synth_voc_test']
    assert np.isfinite(res['mAP']) and 0 <= res['mAP'] <= 1
    assert np.isfinite(res['mean_corloc']) and 0 <= res['mean_corloc'] <= 1
    out_dir = port_config.get_output_dir(('synth_voc_test',), training=False)
    jax_config.cfg.OUTPUT_DIR = str(tmp_path / 'out')
    jax_config.cfg.MODEL.TYPE = port_config.cfg.MODEL.TYPE
    assert out_dir == jax_config.get_output_dir(('synth_voc_test',),
                                                training=False)
    saved = load_object(os.path.join(out_dir, 'detections.pkl'))
    ds = JsonDataset('synth_voc_test')
    assert saved['image_ids'] == sorted(ds.COCO.getImgIds()) == [1, 2, 3, 4]
    n = 0
    for cls in range(1, 4):
        for dets in saved['all_boxes'][cls]:
            assert dets.shape[1] == 5 and np.isfinite(dets).all()
            n += len(dets)
    assert 0 < n <= 4 * port_config.cfg.TEST.DETECTIONS_PER_IM
    # the JAX package's evaluator gives the same numbers for these
    # detections
    want = jax_task_evaluation.evaluate_all(
        JaxJsonDataset('synth_voc_test'), saved['all_boxes'], None, None,
        str(tmp_path / 'jax_eval'), image_ids=saved['image_ids'])
    assert want == results
    # pixels handed over in place of the files: the same detections
    model = test_engine.initialize_model_from_cfg(device='cpu')
    import cv2
    images = {i: cv2.imread(os.path.join(
        info['image_dir'], ds.COCO.imgs[i]['file_name'])) for i in (1, 2, 3)}
    again = test_engine.run_inference(model=model, images=images)
    assert again == results
    for unported in (dict(ind_range=(0, 2)), dict(multi_gpu_testing=True)):
        with pytest.raises(NotImplementedError):
            test_engine.run_inference(device='cpu', **unported)
    with pytest.raises(NotImplementedError):
        test_engine.get_roidb_and_dataset('synth_voc_test',
                                          info['prop_file'], (0, 2))


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        'test_net_torch', os.path.join(REPO, 'tools', 'test_net_torch.py'))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_the_cli_runs_on_the_tiny_fixture(tmp_path, monkeypatch):
    """tools/test_net_torch.py --cfg ... --device cpu TEST.WEIGHTS ... over
    a voc_2007_test laid out under WEBSOD_DATA_DIR as the catalog names
    it."""
    pytest.importorskip('yaml')
    info = _dataset(tmp_path, 'staging')
    data = tmp_path / 'data' / 'VOC2007'
    os.makedirs(str(data / 'annotations'))
    shutil.move(info['image_dir'], str(data / 'JPEGImages'))
    shutil.move(info['ann_file'],
                str(data / 'annotations' / 'voc_2007_test.json'))
    shutil.move(info['devkit'], str(data / 'VOCdevkit2007'))
    monkeypatch.setenv('WEBSOD_DATA_DIR', str(tmp_path / 'data'))

    c = _tiny_context_cfg(info, str(tmp_path / 'out'), 'voc_2007_test')
    model = test_engine.initialize_model_from_cfg(device='cpu')
    weights = str(tmp_path / 'weights.pkl')
    checkpoint.save_weights_file(weights, model)
    want = test_engine.run_inference(model=model)
    cfg_file = str(tmp_path / 'cfg.yaml')
    with open(cfg_file, 'w') as f:
        f.write(port_config.dump_cfg())
    port_config.reset_cfg()

    tool = _load_tool()
    got = tool.main(['--cfg', cfg_file, '--device', 'cpu',
                     'TEST.WEIGHTS', weights, 'RNG_SEED', '5',
                     'OUTPUT_DIR', str(tmp_path / 'cli_out')])
    assert got == want and 'mAP' in got['voc_2007_test']
    assert os.path.isfile(str(tmp_path / 'cli_out' / 'test' / 'voc_2007_test'
                              / 'generalized_wsl' / 'detections.pkl'))
    port_config.reset_cfg()
    with pytest.raises(NotImplementedError):
        tool.main(['--cfg', cfg_file, '--device', 'cpu', '--range', '0', '2',
                   'TEST.WEIGHTS', weights])
    port_config.reset_cfg()
    with pytest.raises(AssertionError, match='TEST.WEIGHTS'):
        tool.main(['--cfg', cfg_file, '--device', 'cpu'])
    del c


def test_read_image(tmp_path, monkeypatch):
    info = _dataset(tmp_path, 'synth_voc_test', devkit=False)
    path = os.path.join(info['image_dir'], 'im_0000.png')
    im = minibatch.read_image(path)
    assert im.dtype == np.uint8 and im.shape == (90, 120, 3)
    assert minibatch.read_image(im) is im
    np.testing.assert_array_equal(minibatch.read_image(tmp_path.__class__(
        path)), im)
    with pytest.raises(FileNotFoundError):
        minibatch.read_image(str(tmp_path / 'missing.png'))
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match='OpenCV'):
        minibatch.read_image(path)
    assert minibatch.read_image(im) is im


def test_context_training_from_a_dataset_roidb(tmp_path):
    """dataset -> combined_roidb_for_training (image paths, flipped copies)
    -> train_model on the context family, from the files to the steps."""
    info = _dataset(tmp_path, 'synth_webly_train', devkit=False)
    c = _tiny_context_cfg(info, str(tmp_path / 'out'))
    c.TRAIN.DATASETS = ('synth_webly_train',)
    c.TRAIN.PROPOSAL_FILES = (info['prop_file'],)
    c.TRAIN.WEIGHTS = ''
    c.TRAIN.SCALES = (64,)
    c.TRAIN.MAX_SIZE = 120
    c.TRAIN.BATCH_SIZE_PER_IM = 12
    c.TPU.ROI_PAD_MULTIPLE = 16
    c.SOLVER.BASE_LR = 1e-5
    c.WSL.USE_DISTORTION = False
    # one loader thread: a fixed stream (with more, the order of the
    # minibatches varies, and the random head saturates on some: loss 0)
    c.DATA_LOADER.NUM_THREADS = 1
    roidb = roidb_lib.combined_roidb_for_training(
        ('synth_webly_train',), (info['prop_file'],))
    assert len(roidb) == 8 and isinstance(roidb[0]['image'], str)
    checkpoints, records = train_engine.train_model(max_iters=2,
                                                    device='cpu')
    assert [r['iter'] for r in records] == [0, 1]
    assert all(np.isfinite(r['loss']) and r['loss'] > 0 for r in records)
    blobs, _ = checkpoint.load_weights_pkl(checkpoints['final'])
    assert 'fc8d_frame_w' in blobs
