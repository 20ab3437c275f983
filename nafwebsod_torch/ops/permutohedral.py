"""Permutohedral-lattice Gaussian filtering (Adams, Baek, Davis, 2010), a
port of the JAX package's ``ops/permutohedral.py``: embed each feature
vector into the hyperplane H_d, splat it onto the vertices of its lattice
simplex with barycentric weights, blur with [1/2, 1, 1/2] along each of the
d + 1 lattice directions, and slice back. It is the bilateral filter inside
the dense CRF's message passing.

The lattice and the blur are the JAX package's. What differs is how the
occupied lattice points are found: the integer keys are packed into one
int64 each (mixed radix, first coordinate most significant, so the order is
the lexicographic one), ``torch.unique`` dedups them, ``torch.searchsorted``
finds the blur neighbours and ``index_add_`` splats, in place of the
sort-and-boundary-flags dedup at a static capacity, the hand-written
binary search and the segment sum. The lattice holds only the occupied
points: its size depends on the data. Filtering runs in float32.
"""

import numpy as np
import torch
import torch.nn.functional as F


def _pack_keys(keys, lo, radix):
    """(.., d) int64 keys -> int64 codes, lexicographic order kept."""
    code = torch.zeros(keys.shape[:-1], dtype=torch.int64, device=keys.device)
    for c in range(keys.shape[-1]):
        code = code * radix[c] + (keys[..., c] - lo[c])
    return code


def build_lattice(features):
    """The lattice of one feature set. features: (N, d) float32, scaled so
    that the target Gaussian has unit standard deviation per dimension.
    Returns a dict for ``apply``: ``entry_uid`` (N * (d + 1),) lattice point
    of each splat entry, ``bary`` (N, d + 1), ``n1`` / ``n2`` (d + 1, M)
    blur neighbours with M (the number of lattice points) for "absent"."""
    features = features.float()
    n, d = features.shape
    dev = features.device

    # elevate onto H_d (E^T f with the paper's scaling)
    i = np.arange(d)
    scale = torch.tensor((np.sqrt(2.0 / 3.0) * (d + 1) /
                          np.sqrt((i + 1.0) * (i + 2.0))).astype(np.float32),
                         device=dev)
    cf = features * scale                                        # (N, d)
    suffix = torch.flip(torch.cumsum(torch.flip(cf, [1]), dim=1), [1])
    zeros = features.new_zeros((n, 1))
    sfull = torch.cat([suffix, zeros], dim=1)
    shifted = torch.cat([zeros, cf], dim=1)
    elevated = sfull - torch.arange(d + 1, dtype=torch.float32,
                                    device=dev) * shifted

    # nearest remainder-0 lattice point and the simplex rank
    rem0 = torch.round(elevated / (d + 1)) * (d + 1)         # (N, d+1)
    diff = elevated - rem0
    lt = diff[:, :, None] < diff[:, None, :]
    eq = diff[:, :, None] == diff[:, None, :]
    tril = torch.tril(torch.ones((d + 1, d + 1), dtype=torch.bool,
                                 device=dev), diagonal=-1)       # j < i
    rank = lt.sum(-1) + (eq & tril[None]).sum(-1)
    sumv = torch.round(rem0.sum(dim=-1) / (d + 1)).long()
    rank = rank + sumv[:, None]
    low = rank < 0
    high = rank > d
    rank = rank + (d + 1) * low.long() - (d + 1) * high.long()
    rem0 = rem0 + (d + 1) * low.float() - (d + 1) * high.float()

    # barycentric coordinates inside the simplex
    v = (elevated - rem0) / (d + 1)                              # (N, d+1)
    oh1 = F.one_hot(d - rank, d + 2).float()
    oh2 = F.one_hot(d + 1 - rank, d + 2).float()
    b = torch.einsum('ni,nik->nk', v, oh1 - oh2)                # (N, d+2)
    b[:, 0] += 1.0 + b[:, d + 1]
    bary = b[:, :d + 1]

    # integer keys of the d + 1 simplex vertices (their first d coordinates)
    rem0i = torch.round(rem0[:, :d]).long()
    keys = []
    for k in range(d + 1):
        # canonical simplex: coordinate i gets +k, or k - (d + 1) for the
        # coordinates of rank > d - k
        add = torch.where(rank[:, :d] < d + 1 - k, k, k - (d + 1))
        keys.append(rem0i + add)
    keys = torch.stack(keys, dim=1).reshape(n * (d + 1), d)

    # dedup: one int64 per key, wide enough for the blur's offsets of +-d
    lo = (keys.amin(dim=0) - d).tolist()
    radix = [int(hi) - l + d + 1 for hi, l in zip(keys.amax(dim=0).tolist(),
                                                  lo)]
    if np.prod([float(r) for r in radix]) >= 2.0 ** 62:
        raise ValueError('permutohedral keys span {} values per dimension: '
                         'too many for one int64'.format(radix))
    codes, entry_uid = torch.unique(_pack_keys(keys, lo, radix),
                                    return_inverse=True)
    m = codes.shape[0]
    unique_keys = torch.empty((m, d), dtype=torch.int64, device=dev)
    unique_keys[entry_uid] = keys

    def find(queries):
        q = _pack_keys(queries, lo, radix)
        idx = torch.searchsorted(codes, q).clamp(max=m - 1)
        return torch.where(codes[idx] == q, idx, m)

    n1, n2 = [], []
    for j in range(d + 1):
        off = torch.ones((d,), dtype=torch.int64, device=dev)
        if j < d:
            off[j] = -d
        n1.append(find(unique_keys + off))
        n2.append(find(unique_keys - off))
    return {'entry_uid': entry_uid, 'bary': bary,
            'n1': torch.stack(n1), 'n2': torch.stack(n2),
            'n': n, 'd': d, 'm': m}


def apply(lattice, values):
    """Filter ``values`` (N, V) float32 through a built lattice -> (N, V):
    out_i = sum_j exp(-|f_i - f_j|^2 / 2) * v_j up to a constant factor
    (``gaussian_filter`` normalises it away). The splat's sums are
    ``index_add_``: on a card their order changes from run to run."""
    n, d, m = lattice['n'], lattice['d'], lattice['m']
    vdim = values.shape[1]
    bary = lattice['bary']
    w = (values[:, None, :] * bary[:, :, None]).reshape(n * (d + 1), vdim)
    lat = values.new_zeros((m, vdim)).index_add_(0, lattice['entry_uid'], w)
    zero = values.new_zeros((1, vdim))
    for j in range(d + 1):
        padded = torch.cat([lat, zero], dim=0)
        lat = lat + 0.5 * (padded[lattice['n1'][j]] + padded[lattice['n2'][j]])
    vert = lat[lattice['entry_uid']].reshape(n, d + 1, vdim)
    alpha = 1.0 / (1.0 + 2.0 ** (-float(d)))
    return (bary[:, :, None] * vert).sum(dim=1) * alpha


def gaussian_filter(values, features, lattice=None):
    """Symmetrically normalised Gaussian filter (the dense CRF's
    convention): D^-1/2 K D^-1/2 v with D = diag(K 1). Returns (filtered
    values, lattice); pass the lattice back in to reuse it."""
    if lattice is None:
        lattice = build_lattice(features)
    ones = apply(lattice, values.new_ones((lattice['n'], 1)))
    norm = torch.rsqrt(ones.clamp(min=1e-20))
    return norm * apply(lattice, values * norm), lattice
