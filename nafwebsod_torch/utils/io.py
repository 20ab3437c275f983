"""Pickle / file IO helpers (reference: ``detectron/utils/io.py``).

Keeps the reference's public pickle-based artifact formats (checkpoints,
``detections.pkl``, proposal files) readable and writable.
"""

import os
import pickle


def save_object(obj, file_name):
    """Serialize a Python object with pickle (protocol 2 for compat)."""
    file_name = os.path.abspath(file_name)
    os.makedirs(os.path.dirname(file_name), exist_ok=True)
    with open(file_name, 'wb') as f:
        pickle.dump(obj, f, protocol=2)


def load_object(file_name):
    with open(file_name, 'rb') as f:
        return pickle.load(f, encoding='latin1')
