"""Checkpoint = a directory of files (reference: ray
python/ray/train/_checkpoint.py:56 — Checkpoint as a pyarrow-fs directory).

The port's counterpart of `ray_tpu/train/checkpoint.py`: the `Checkpoint`
class is its copy (that part imports no JAX). `from_arrays` / `to_arrays`
store a tree of tensors and arrays, which JAX writes as an .npz of leaves
beside a pickled JAX treedef; a treedef is JAX's own type, so the port
writes its own format:

  * `arrays.npz`: the leaves, leaf i under the name "i". A bf16 tensor is
    stored as its uint16 bits (numpy has no bf16) and restored bit for bit;
    a DTensor is stored whole (`full_tensor`, a collective every rank of
    its mesh takes part in), as JAX's `device_get` fetches a sharded array
    whole.
  * `tree.json`: the structure: nested dicts, lists and tuples, None and
    Python scalars, and the port's `TrainState` and `AdamWState`, so that a
    whole train state round-trips; per leaf, whether it was a tensor (and
    its dtype) or a numpy array.

`to_arrays` gives the tree back with host tensors (numpy leaves as numpy),
every dtype as it was saved, and `place_like` puts such a tree back on a
mesh's placements, as JAX's `device_put` against a tree of shardings does.
In a gang, every rank takes part in fetching a sharded tree whole
(`host_tree`), and one of them writes it.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
import uuid
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ray_tpu_torch.train.optim import AdamWState
from ray_tpu_torch.train.step import TrainState

FORMAT = "ray_tpu_torch.tree/1"
_DATACLASSES = {"TrainState": TrainState, "AdamWState": AdamWState}


class Checkpoint:
    """A reference to a directory tree containing checkpoint data."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"

    def __eq__(self, other):
        return isinstance(other, Checkpoint) and other.path == self.path

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @contextmanager
    def as_directory(self) -> Iterator[str]:
        yield self.path

    def to_directory(self, path: Optional[str] = None) -> str:
        dest = path or os.path.join(
            tempfile.gettempdir(), f"ckpt_{uuid.uuid4().hex[:8]}"
        )
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    # -- convenience payloads ------------------------------------------------

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="ckpt_dict_")
        with open(os.path.join(d, "data.pkl"), "wb") as f:
            pickle.dump(data, f)
        return cls(d)

    def to_dict(self) -> Dict[str, Any]:
        with open(os.path.join(self.path, "data.pkl"), "rb") as f:
            return pickle.load(f)

    def update_metadata(self, metadata: Dict[str, Any]) -> None:
        meta = self.get_metadata()
        meta.update(metadata)
        with open(os.path.join(self.path, ".metadata.json"), "w") as f:
            json.dump(meta, f)

    def get_metadata(self) -> Dict[str, Any]:
        p = os.path.join(self.path, ".metadata.json")
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    # -- tree payloads -------------------------------------------------------

    @classmethod
    def from_arrays(cls, tree: Any, path: Optional[str] = None
                    ) -> "Checkpoint":
        """Save a tree of tensors and arrays (device tensors are fetched to
        the host; a DTensor whole)."""
        d = path or tempfile.mkdtemp(prefix="ckpt_arrays_")
        os.makedirs(d, exist_ok=True)
        leaves: List[np.ndarray] = []
        structure = _encode(tree, leaves)
        np.savez(os.path.join(d, "arrays.npz"),
                 **{str(i): x for i, x in enumerate(leaves)})
        with open(os.path.join(d, "tree.json"), "w") as f:
            json.dump({"format": FORMAT, "tree": structure}, f)
        return cls(d)

    def to_arrays(self) -> Any:
        with open(os.path.join(self.path, "tree.json")) as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT:
            raise ValueError(f"{self.path} holds a tree in format "
                             f"{meta.get('format')!r}, not {FORMAT!r}")
        with np.load(os.path.join(self.path, "arrays.npz")) as z:
            leaves = [z[str(i)] for i in range(len(z.files))]
        return _decode(meta["tree"], leaves)


def _host_tensor(x: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().to("cpu")


def _encode(node, leaves: List[np.ndarray]):
    """node -> its JSON structure; its leaves appended to `leaves`."""
    if isinstance(node, dict):
        for k in node:
            if not isinstance(k, str):
                raise TypeError(f"a key {k!r}: the tree's dict keys must be "
                                "strings")
        return {"dict": [[k, _encode(v, leaves)] for k, v in node.items()]}
    if isinstance(node, (list, tuple)):
        return {type(node).__name__: [_encode(v, leaves) for v in node]}
    for name, cls in _DATACLASSES.items():
        if type(node) is cls:
            return {name: {f: _encode(getattr(node, f), leaves)
                           for f in cls.__dataclass_fields__}}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    if isinstance(node, torch.Tensor):
        t = _host_tensor(node)
        dtype = str(t.dtype)
        arr = (t.view(torch.int16).numpy().view(np.uint16)
               if t.dtype == torch.bfloat16 else t.numpy())
        leaves.append(arr)
        return {"tensor": len(leaves) - 1, "dtype": dtype}
    if isinstance(node, (np.ndarray, np.generic)):
        leaves.append(np.asarray(node))
        return {"numpy": len(leaves) - 1}
    raise TypeError(f"a leaf of type {type(node).__name__} is neither a "
                    "tensor nor a numpy array")


def _decode(node, leaves: List[np.ndarray]):
    if "tensor" in node:
        arr = leaves[node["tensor"]]
        if node["dtype"] == "torch.bfloat16":
            return torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        t = torch.from_numpy(arr.copy())
        if str(t.dtype) != node["dtype"]:
            raise ValueError(f"leaf {node['tensor']} is {t.dtype}; saved as "
                             f"{node['dtype']}")
        return t
    (kind, body), = node.items()
    if kind == "dict":
        return {k: _decode(v, leaves) for k, v in body}
    if kind in ("list", "tuple"):
        items = [_decode(v, leaves) for v in body]
        return items if kind == "list" else tuple(items)
    if kind in _DATACLASSES:
        return _DATACLASSES[kind](**{f: _decode(v, leaves)
                                     for f, v in body.items()})
    if kind == "value":
        return body
    if kind == "numpy":
        return leaves[body]
    raise ValueError(f"unknown node {kind!r} in the tree")


def _map_tree(fn, tree, like):
    """fn(leaf of tree, leaf of like) over two trees of one structure."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, like[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(like):
            raise ValueError(f"a sequence of {len(tree)} against one of "
                             f"{len(like)}")
        return type(tree)(_map_tree(fn, a, b) for a, b in zip(tree, like))
    if type(tree) in _DATACLASSES.values():
        return type(tree)(**{f: _map_tree(fn, getattr(tree, f),
                                          getattr(like, f))
                             for f in tree.__dataclass_fields__})
    return fn(tree, like)


def host_tree(tree: Any) -> Any:
    """The tree with every tensor fetched to the host, a DTensor whole (a
    collective that every rank of its mesh takes part in, leaf by leaf in
    the order `from_arrays` walks them). In a gang every rank calls this and
    one writes `Checkpoint.from_arrays` of the result, which then fetches
    nothing."""
    return _map_tree(lambda x, _: _host_tensor(x)
                     if isinstance(x, torch.Tensor) else x, tree, tree)


def _place(x, like):
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.sharding import local_slices

    if not isinstance(x, torch.Tensor) or not isinstance(like, torch.Tensor):
        return x
    if tuple(x.shape) != tuple(like.shape):
        raise ValueError(f"a saved leaf of shape {tuple(x.shape)} against "
                         f"one of {tuple(like.shape)}")
    if not isinstance(like, DTensor):
        return x.to(like.device)
    mesh, placements = like.device_mesh, like.placements
    block = x[local_slices(x.shape, placements, mesh)].contiguous()
    return DTensor.from_local(block.to(like.to_local().device), mesh,
                              placements, run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def place_like(tree: Any, like: Any) -> Any:
    """A host tree (`Checkpoint.to_arrays`'s) placed as the tensors of
    `like` (a state of the same structure, e.g. a freshly initialised one
    on the mesh) are: where `like` has a DTensor, each rank copies only its
    block, on the mesh and placements of that DTensor, to its device (the
    counterpart of JAX's `device_put` against a tree of shardings); where
    it has a tensor, to that tensor's device. Dtypes and values are the
    saved ones, bit for bit; leaves that are not tensors come from
    `tree`."""
    return _map_tree(_place, tree, like)
