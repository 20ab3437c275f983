"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for sm_90a into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to ``build/torch_kernels/``
at the root of the checkout, named by a hash of the source and the flags:
the first use after a change builds, later uses load. ``build`` starts one
``nvcc`` per missing library, all at once, and waits for them together.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, 'build', 'torch_kernels')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LOCK = threading.Lock()
_LOADED = {}


def nvcc_path():
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    the one on PATH."""
    for home in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if home and os.path.isfile(os.path.join(home, 'bin', 'nvcc')):
            return os.path.join(home, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                           'toolkit (set CUDA_HOME)')
    return found


def library_path(name):
    src = os.path.join(CSRC, name + '.cu')
    with open(src, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, 'lib{}_{}.so'.format(
        name, digest.hexdigest()[:16]))


def build(names):
    """Compile every library in ``names`` that is not built yet, with one
    nvcc process each, all started together. Returns {name: ptxas report}
    for the libraries built by this call; raises on a failed build."""
    todo = [n for n in names if not os.path.isfile(library_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = '{}.{}.tmp'.format(library_path(name), os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, os.path.join(CSRC, name + '.cu')]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append('{}:\n{}'.format(name, output))
            continue
        os.replace(tmp, library_path(name))
        reports[name] = output
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return reports


def load(name):
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _LOADED[name] = lib
        return lib
