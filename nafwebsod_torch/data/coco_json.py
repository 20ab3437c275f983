"""Minimal COCO-json index, no pycocotools (the port's own copy of the JAX
package's ``data/coco_json.py``).

Implements the subset of the COCO API the dataset layer needs
(``getImgIds / loadImgs / getAnnIds / loadAnns / getCatIds / loadCats``) from
a plain json parse. The reference uses pycocotools.COCO for this
(``detectron/datasets/json_dataset_wsl.py:60-75``).
"""

import json
from collections import defaultdict


class COCOJson:
    def __init__(self, annotation_file):
        with open(annotation_file, 'r') as f:
            self.dataset = json.load(f)
        self.imgs = {img['id']: img for img in self.dataset.get('images', [])}
        self.anns = {ann['id']: ann for ann in self.dataset.get('annotations', [])}
        self.cats = {c['id']: c for c in self.dataset.get('categories', [])}
        self.img_to_anns = defaultdict(list)
        for ann in self.dataset.get('annotations', []):
            self.img_to_anns[ann['image_id']].append(ann)

    def getImgIds(self):
        return list(self.imgs.keys())

    def loadImgs(self, ids):
        if isinstance(ids, int):
            ids = [ids]
        return [dict(self.imgs[i]) for i in ids]

    def getAnnIds(self, imgIds=None, iscrowd=None):
        if imgIds is None:
            anns = list(self.anns.values())
        else:
            if isinstance(imgIds, int):
                imgIds = [imgIds]
            anns = [a for i in imgIds for a in self.img_to_anns[i]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get('iscrowd', 0) == iscrowd]
        return [a['id'] for a in anns]

    def loadAnns(self, ids):
        if isinstance(ids, int):
            ids = [ids]
        return [dict(self.anns[i]) for i in ids]

    def getCatIds(self):
        return sorted(self.cats.keys())

    def loadCats(self, ids):
        if isinstance(ids, int):
            ids = [ids]
        return [dict(self.cats[i]) for i in ids]
