"""Episode JSON I/O (reference: ray rllib/offline/json_writer.py,
json_reader.py:221 — SampleBatch-rows-as-JSON-lines; here each line is one
episode batch, the natural unit for MC-return computation in MARWIL).

Line schema: {"obs": [[...]], "next_obs": [[...]], "actions": [...],
"rewards": [...], "terminateds": [...], "truncateds": [...],
optional "action_logp": [...]} — arrays as nested lists.

The port's copy of `ray_tpu/rllib/offline/io.py` (which imports no JAX; the
port imports nothing of `ray_tpu`).
"""

from __future__ import annotations

import glob as _glob
import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

_ARRAY_KEYS = ("obs", "next_obs", "actions", "rewards", "terminateds",
               "truncateds", "action_logp")


def _expand(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(_glob.glob(os.path.join(p, "*.json"))))
        elif any(c in p for c in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no offline data matched {paths}")
    return out


class JsonWriter:
    """Append episode batches to a JSON-lines file."""

    def __init__(self, path: str, max_file_size: int = 64 * 1024 * 1024):
        os.makedirs(path, exist_ok=True)
        self._dir = path
        self._max = max_file_size
        self._index = 0
        self._fp = None
        self._open_next()

    def _open_next(self):
        if self._fp:
            self._fp.close()
        name = os.path.join(self._dir, f"episodes-{self._index:05d}.json")
        self._index += 1
        self._fp = open(name, "w")

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        row = {}
        for k, v in batch.items():
            if k in _ARRAY_KEYS or isinstance(v, np.ndarray):
                row[k] = np.asarray(v).tolist()
            else:
                row[k] = v
        self._fp.write(json.dumps(row) + "\n")
        self._fp.flush()
        if self._fp.tell() > self._max:
            self._open_next()

    def write_episode(self, episode) -> None:
        self.write(episode.to_batch())

    def close(self):
        if self._fp:
            self._fp.close()
            self._fp = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _decode(row: dict) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in row.items():
        if isinstance(v, list):
            arr = np.asarray(v)
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            out[k] = arr
        else:
            out[k] = v
    return out


class JsonReader:
    """Iterate episode batches from JSON-lines files; next() cycles."""

    def __init__(self, paths):
        self._files = _expand(paths)
        self._iter: Optional[Iterator] = None

    def read_all(self) -> List[Dict[str, np.ndarray]]:
        out = []
        for f in self._files:
            with open(f) as fp:
                for line in fp:
                    line = line.strip()
                    if line:
                        out.append(_decode(json.loads(line)))
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for f in self._files:
            with open(f) as fp:
                for line in fp:
                    line = line.strip()
                    if line:
                        yield _decode(json.loads(line))

    def next(self) -> Dict[str, np.ndarray]:
        if self._iter is None:
            self._iter = iter(self)
        try:
            return next(self._iter)
        except StopIteration:
            self._iter = iter(self)
            return next(self._iter)


def load_episode_batches(input_) -> List[Dict[str, np.ndarray]]:
    """config.input_ (paths / dirs / list of either, or a list of
    already-decoded episode batch dicts) → list of episode batches."""
    if isinstance(input_, list) and input_ and isinstance(input_[0], dict):
        return [
            {k: np.asarray(v) for k, v in b.items()} for b in input_]
    return JsonReader(input_).read_all()
