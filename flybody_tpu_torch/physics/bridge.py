"""State carried across: the port's Model and Data from plain numpy.

``model_from_numpy`` and ``data_from_numpy`` take dicts of numpy arrays
keyed by the JAX package's field names (``Model`` / ``Data`` of
``flybody_tpu/physics/types.py``; nested ``opt`` and ``contact`` as dicts)
and build the port's types, so both packages can compute from the
identical state. The tree schedule is rebuilt from ``dof_parentid``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flybody_tpu_torch.ops import tree_ldl as TL
from flybody_tpu_torch.physics import types as T


_OPT_TENSORS = ("timestep", "gravity", "density", "viscosity", "wind",
                "impratio", "tolerance")


def _tensor(x, device, dtype):
    x = np.asarray(x)
    if x.dtype.kind in "iub":
        return torch.as_tensor(x.astype(np.int32) if x.dtype.kind != "b"
                               else x, device=device)
    return torch.as_tensor(x.astype(np.float64), device=device).to(dtype)


def to_numpy(obj) -> dict:
    """{field: value} of a Model/Data-like dataclass from either package:
    nested dataclasses become dicts, array leaves numpy arrays, static
    values stay as they are. The tree schedule (``tree``) is skipped."""
    out = {}
    for f in dataclasses.fields(obj):
        if f.name == "tree" or not f.init:
            continue
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = to_numpy(v)
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        elif hasattr(v, "__array__") and not isinstance(v, np.ndarray):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


def model_from_numpy(mapping: dict, device="cpu",
                     dtype=torch.float64) -> T.Model:
    """Model from {field: value}: static fields as numpy/ints/tuples,
    numeric fields as arrays, ``opt`` as a dict of Option fields."""
    opt = T.Option(**{
        k: _tensor(v, device, dtype) if k in _OPT_TENSORS else v
        for k, v in mapping["opt"].items()})
    kw = {}
    for name in T.MODEL_STATIC:
        if name == "tree":
            continue
        v = mapping[name]
        kw[name] = np.asarray(v) if isinstance(v, np.ndarray) else v
    kw["body_tree"] = tuple(np.asarray(x) for x in mapping["body_tree"])
    kw["tree"] = TL.build_tree_meta(np.asarray(mapping["dof_parentid"]))
    for name in T.MODEL_TENSORS:
        kw[name] = _tensor(mapping[name], device, dtype)
    return T.Model(opt=opt, **kw)


def data_from_numpy(mapping: dict, model: T.Model) -> T.Data:
    """Data from {field: array}, ``contact`` as a dict of Contact fields;
    floating arrays take the model's dtype, integer arrays become int32."""
    dev, dtype = model.device, model.dtype
    con = T.Contact(**{f.name: _tensor(mapping["contact"][f.name], dev,
                                       dtype)
                       for f in dataclasses.fields(T.Contact)})
    kw = {f.name: _tensor(mapping[f.name], dev, dtype)
          for f in dataclasses.fields(T.Data) if f.name != "contact"}
    return T.Data(contact=con, **kw)
