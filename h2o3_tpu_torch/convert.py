"""Carry a trained tree model across from its numpy arrays.

A tree model's "weights" are its forest: per tree the heap arrays `feat`,
`bin`, `thr`, `is_split` and `value` (plus the node covers), the initial
margin `f0`, the bin edges, the heap depth and the mode (``"gbm"`` sums
the trees through the link; ``"drf"`` averages them). `forest_from_numpy`
builds the port's model from them, so a GBM or DRF model trained by the JAX
package (whose arrays the caller reads out as numpy) scores in the port.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from . import device as devlib
from .frame.binning import BinnedMatrix
from .models import tree as treelib
from .models.shared_tree import SharedTreeModel


def forest_from_numpy(*, feat, bin, thr, is_split, value, covers, f0: float,
                      edges: Sequence[np.ndarray], max_depth: int,
                      x: Sequence[str], y: str, nbins: int,
                      domain: Optional[List[str]] = None,
                      problem: str = "binomial",
                      distribution: str = "bernoulli",
                      mode: str = "gbm",
                      device=None) -> SharedTreeModel:
    """Port model from (ntrees, T) heap arrays. `edges` are the per-feature
    bin edges of the training `BinnedMatrix`; `domain` the response levels
    of a binomial model; `mode` the reference model's `mode`."""
    if mode not in ("gbm", "drf"):
        raise ValueError(f"mode must be 'gbm' or 'drf', got {mode!r}")
    dev = devlib.resolve(device)
    T = treelib.heap_size(max_depth)
    arrays = dict(feat=(feat, torch.int32), bin=(bin, torch.int32),
                  thr=(thr, torch.float32), is_split=(is_split, torch.bool),
                  value=(value, torch.float32))
    fields = {}
    for name, (a, dt) in arrays.items():
        a = np.asarray(a)
        if a.ndim != 2 or a.shape[1] != T:
            raise ValueError(f"{name}: expected (ntrees, {T}) for max_depth "
                             f"{max_depth}, got {a.shape}")
        fields[name] = torch.as_tensor(a).to(dt).to(dev)
    forest = treelib.Tree(**fields)
    F = len(x)
    bm = BinnedMatrix(codes=None, edges=[np.asarray(e, np.float64) for e in edges],
                      nbins=int(nbins), names=list(x),
                      is_categorical=np.zeros(F, bool), domains=[None] * F)
    cov = (torch.as_tensor(np.asarray(covers, np.float32)).to(dev)
           if covers is not None else None)
    return SharedTreeModel(None, x, y, bm, problem, 2 if problem == "binomial" else 1,
                           domain, distribution, float(f0), forest, cov,
                           int(max_depth), dev, mode=mode)
