"""Checkpoint and resume of inference state (counterpart of
``rxinfer_tpu/utils/checkpoint.py``): a posterior dict, a streaming
engine's autoupdated arguments or its carried state, or any nest of dicts,
lists and tuples of tensors and the port's distributions, saved to disk and
restored onto a device.

``backend="pickle"`` (the default) pickles the structure with every tensor
as a host numpy array, so a checkpoint taken on the card loads on the CPU
and back.  ``backend="orbax"`` keeps the JAX package's name for its
directory form: here ``torch.distributed.checkpoint`` in one process, a
directory holding the tensors and a description of the structure.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import warnings
from typing import Any

import numpy as np
import torch

_STRUCTURE = "structure.pkl"


@dataclasses.dataclass
class _Leaf:
    """A tensor on the host: its values (pickle backend) or its index in
    the directory's flat list (None values), with its shape and dtype."""

    values: Any
    dtype: str
    shape: tuple = ()
    index: int = -1


@dataclasses.dataclass
class _Marginal:
    """An annotated posterior (``postprocess.Marginal``), packed."""

    dist: Any
    annotations: dict


@dataclasses.dataclass
class _Obj:
    """A dataclass (the port's distributions): its type and packed
    fields."""

    cls: type
    fields: dict


def _pack(obj, leaf):
    """``obj`` with every tensor replaced by ``leaf(tensor)``."""
    from ..postprocess import Marginal

    if isinstance(obj, torch.Tensor):
        return leaf(obj.detach())
    if isinstance(obj, dict):
        return {k: _pack(v, leaf) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v, leaf) for v in obj)
    if isinstance(obj, Marginal):
        return _Marginal(_pack(obj.dist, leaf), _pack(obj.annotations, leaf))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _Obj(type(obj), {f.name: _pack(getattr(obj, f.name), leaf)
                                for f in dataclasses.fields(obj)})
    return obj


def _unpack(obj, tensor):
    """The inverse of ``_pack``: every ``_Leaf`` becomes ``tensor(leaf)``."""
    from ..postprocess import Marginal

    if isinstance(obj, _Leaf):
        return tensor(obj)
    if isinstance(obj, _Obj):
        return obj.cls(**{k: _unpack(v, tensor)
                          for k, v in obj.fields.items()})
    if isinstance(obj, dict):
        return {k: _unpack(v, tensor) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, tensor) for v in obj)
    if isinstance(obj, _Marginal):
        return Marginal(_unpack(obj.dist, tensor),
                        _unpack(obj.annotations, tensor))
    return obj


def _host_leaf(t: torch.Tensor) -> _Leaf:
    dtype = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:   # numpy has no bfloat16: widen exactly
        t = t.float()
    return _Leaf(t.cpu().numpy(), dtype, tuple(t.shape))


def _to_device(device):
    def tensor(leaf: _Leaf) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(leaf.values))
        return t.to(device=device, dtype=getattr(torch, leaf.dtype))
    return tensor


def save_checkpoint(path: str, state: Any, backend: str = "pickle") -> None:
    """Save ``state`` (dicts, lists, tuples of tensors and distributions).
    ``backend="pickle"``: one file.  ``backend="orbax"``: a directory
    written by ``torch.distributed.checkpoint`` in this one process (the
    name is the JAX package's, whose directory form is orbax's)."""
    if backend == "pickle":
        with open(path, "wb") as f:
            pickle.dump(_pack(state, _host_leaf), f)
        return
    if backend != "orbax":
        raise ValueError(f"unknown checkpoint backend {backend!r}; choose "
                         "'pickle' or 'orbax' (a directory)")
    import torch.distributed.checkpoint as dcp

    leaves: list = []

    def index_leaf(t: torch.Tensor) -> _Leaf:
        leaves.append(t.cpu().contiguous())
        return _Leaf(None, str(t.dtype).removeprefix("torch."),
                     tuple(t.shape), len(leaves) - 1)

    structure = _pack(state, index_leaf)
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    with warnings.catch_warnings():
        # one process: torch.distributed need not be initialized
        warnings.simplefilter("ignore", UserWarning)
        dcp.save({str(i): t for i, t in enumerate(leaves)},
                 checkpoint_id=path)
    with open(os.path.join(path, _STRUCTURE), "wb") as f:
        pickle.dump(structure, f)


def load_checkpoint(path: str, like: Any = None, device: Any = None) -> Any:
    """Load a checkpoint of ``save_checkpoint`` with every tensor on
    ``device`` (None: the CPU).  A directory is the ``"orbax"`` backend's;
    ``like`` (a state of the same structure) then gives the structure, as
    the JAX package's orbax restore takes it, else the structure saved
    beside the tensors is used."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if not os.path.isdir(path):
        with open(path, "rb") as f:
            packed = pickle.load(f)
        return _unpack(packed, _to_device(device))
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    if like is not None:
        templates: list = []

        def template_leaf(t: torch.Tensor) -> _Leaf:
            templates.append(t)
            return _Leaf(None, str(t.dtype).removeprefix("torch."),
                         tuple(t.shape), len(templates) - 1)

        structure = _pack(like, template_leaf)
    else:
        with open(os.path.join(path, _STRUCTURE), "rb") as f:
            structure = pickle.load(f)
    targets: dict = {}

    def target(leaf: _Leaf) -> torch.Tensor:
        targets[str(leaf.index)] = torch.empty(
            leaf.shape, dtype=getattr(torch, leaf.dtype))
        return targets[str(leaf.index)]

    _unpack(structure, target)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        dcp.load(targets, checkpoint_id=path)
    return _unpack(structure, lambda leaf: targets[str(leaf.index)].to(
        device))
