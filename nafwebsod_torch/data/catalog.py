"""Dataset catalog: name -> {image dir, annotation json, devkit dir} (the
port's own copy of the JAX package's ``data/catalog.py``, the same names
and layout, so one data directory serves both packages).

Capability parity with ``detectron/datasets/dataset_catalog.py`` including the
webly datasets (flickr_voc / flickr_clean / flickr_coco, ref :237-260) and the
VOC/COCO entries. The data root defaults to ``<repo>/datasets/data`` and can
be overridden with the WEBSOD_DATA_DIR environment variable.
"""

import os

_IM_DIR = 'image_directory'
_ANN_FN = 'annotation_file'
_DEVKIT_DIR = 'devkit_directory'
_IM_PREFIX = 'image_prefix'


def get_data_dir():
    return os.environ.get(
        'WEBSOD_DATA_DIR',
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), 'datasets', 'data'))


def _catalog():
    d = get_data_dir()
    cat = {}
    # VOC splits, incl. the webly-noise-distorted jsons the reference pairs
    # with them (ref dataset_catalog.py voc_2007_{train,val}_noisy; produced
    # by tools/distort_voc_json.py)
    voc_splits = {'2007': ('train', 'val', 'trainval', 'test',
                           'train_noisy', 'val_noisy'),
                  '2012': ('train', 'val', 'trainval', 'test')}
    for year, splits in voc_splits.items():
        for split in splits:
            cat['voc_{}_{}'.format(year, split)] = {
                _IM_DIR: os.path.join(d, 'VOC' + year, 'JPEGImages'),
                _ANN_FN: os.path.join(
                    d, 'VOC' + year, 'annotations',
                    'voc_{}_{}.json'.format(year, split)),
                _DEVKIT_DIR: os.path.join(d, 'VOC' + year, 'VOCdevkit' + year),
            }
    # webly (Flickr) training sets with VOC / COCO label spaces
    for name, img_dir in (
        ('flickr_voc', 'flickr_voc'),
        ('flickr_clean', 'flickr_clean'),
        ('flickr_coco', 'flickr_coco'),
    ):
        cat[name] = {
            _IM_DIR: os.path.join(d, img_dir, 'images'),
            _ANN_FN: os.path.join(d, img_dir, 'annotations.json'),
            _DEVKIT_DIR: os.path.join(d, img_dir, 'devkit'),
        }
    # cityscapes (COCO-converted jsons, ref dataset_catalog.py cityscapes
    # entries; produced by tools/convert_cityscapes_to_coco.py upstream)
    for split in ('train', 'val', 'test'):
        cat['cityscapes_fine_instanceonly_seg_' + split] = {
            _IM_DIR: os.path.join(d, 'cityscapes', 'images'),
            _ANN_FN: os.path.join(
                d, 'cityscapes', 'annotations',
                'instancesonly_filtered_gtFine_{}.json'.format(split)),
        }
    for split in ('train2014', 'val2014', 'minival2014', 'valminusminival2014'):
        cat['coco_2014_' + split.replace('2014', '')] = {
            _IM_DIR: os.path.join(d, 'coco', split.replace('minival', 'val')
                                  .replace('valminusval', 'val')),
            _ANN_FN: os.path.join(d, 'coco', 'annotations',
                                  'instances_{}.json'.format(split)),
        }
    # keypoint task views of the same 2014 images (person_keypoints jsons,
    # ref dataset_catalog.py:129-152)
    for split in ('train', 'val', 'minival', 'valminusminival'):
        cat['keypoints_coco_2014_' + split] = {
            _IM_DIR: os.path.join(
                d, 'coco', ('train' if split == 'train' else 'val') + '2014'),
            _ANN_FN: os.path.join(
                d, 'coco', 'annotations',
                'person_keypoints_{}2014.json'.format(split)),
        }
    # image-info-only test sets; 2017 test reuses the 2015 test images with
    # a COCO_test2015_ filename prefix (ref dataset_catalog.py:89-116)
    test_sets = {
        'coco_2015_test': ('image_info_test2015.json', ''),
        'coco_2015_test-dev': ('image_info_test-dev2015.json', ''),
        'coco_2017_test': ('image_info_test2017.json', 'COCO_test2015_'),
        'coco_2017_test-dev': ('image_info_test-dev2017.json',
                               'COCO_test2015_'),
        'keypoints_coco_2015_test': ('image_info_test2015.json', ''),
        'keypoints_coco_2015_test-dev': ('image_info_test-dev2015.json', ''),
    }
    for name, (ann, prefix) in test_sets.items():
        cat[name] = {
            _IM_DIR: os.path.join(d, 'coco', 'test2015'),
            _ANN_FN: os.path.join(d, 'coco', 'annotations', ann),
            _IM_PREFIX: prefix,
        }
    # COCO-stuff jsons over the 2014 images (ref dataset_catalog.py:117-128)
    for split in ('train', 'val'):
        cat['coco_stuff_' + split] = {
            _IM_DIR: os.path.join(d, 'coco', split + '2014'),
            _ANN_FN: os.path.join(d, 'coco', 'annotations',
                                  'coco_stuff_{}.json'.format(split)),
        }
    return cat


# Registry for tests / user datasets registered at runtime
_EXTRA = {}


def register_dataset(name, image_directory, annotation_file,
                     devkit_directory=None):
    _EXTRA[name] = {
        _IM_DIR: image_directory,
        _ANN_FN: annotation_file,
        _DEVKIT_DIR: devkit_directory,
    }


def _lookup(name):
    if name in _EXTRA:
        return _EXTRA[name]
    cat = _catalog()
    if name not in cat:
        raise KeyError('Unknown dataset name: {}'.format(name))
    return cat[name]


def get_im_dir(name):
    return _lookup(name)[_IM_DIR]


def get_ann_fn(name):
    return _lookup(name)[_ANN_FN]


def get_devkit_dir(name):
    return _lookup(name)[_DEVKIT_DIR]


def get_im_prefix(name):
    """Filename prefix prepended to every file_name of the dataset (the
    coco_2017_test sets reuse 2015 test images; ref dataset_catalog.py:295)."""
    return _lookup(name).get(_IM_PREFIX, '')
