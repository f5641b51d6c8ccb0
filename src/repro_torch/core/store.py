"""ArtifactStore — the EFS analogue: shared model/dataset/result storage.

Content lives in memory (optionally spilled to disk); every read/write is
metered so the latency/cost models can charge realistic store traffic
(model cold-load dominates a short function's runtime — exactly the
paper's motivation for putting the model on EFS rather than in the
deployment package).

Result commits are idempotent per key — the orchestrator's exactly-once
merge builds on this.
"""
from __future__ import annotations

import os
import pickle
import threading
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.tree import tree_map


class ArtifactStore:
    def __init__(self, root: Optional[str] = None,
                 read_bandwidth_mbps: float = 300.0,
                 write_bandwidth_mbps: float = 100.0):
        self._mem: Dict[str, bytes] = {}
        self._root = root
        self._lock = threading.Lock()
        self.read_bandwidth_mbps = read_bandwidth_mbps
        self.write_bandwidth_mbps = write_bandwidth_mbps
        self.bytes_read = 0
        self.bytes_written = 0
        self.n_reads = 0
        self.n_writes = 0
        if root:
            os.makedirs(root, exist_ok=True)

    # -- raw bytes -------------------------------------------------------
    def put(self, key: str, blob: bytes, *, overwrite: bool = True) -> bool:
        with self._lock:
            if not overwrite and key in self._mem:
                return False  # idempotent commit: first writer wins
            self._mem[key] = blob
            self.bytes_written += len(blob)
            self.n_writes += 1
            if self._root:
                path = os.path.join(self._root, key.replace("/", "__"))
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, path)
            return True

    def get(self, key: str) -> bytes:
        with self._lock:
            if key in self._mem:
                blob = self._mem[key]
            elif self._root:
                path = os.path.join(self._root, key.replace("/", "__"))
                with open(path, "rb") as f:
                    blob = f.read()
                self._mem[key] = blob
            else:
                raise KeyError(key)
            self.bytes_read += len(blob)
            self.n_reads += 1
            return blob

    def exists(self, key: str) -> bool:
        with self._lock:
            if key in self._mem:
                return True
        if self._root:
            return os.path.exists(
                os.path.join(self._root, key.replace("/", "__")))
        return False

    def size(self, key: str) -> int:
        return len(self.get(key))

    # -- tensor trees ------------------------------------------------------
    # A tree is nested dicts/tuples/lists of tensors. Leaves are stored as
    # raw bytes + (dtype, shape); bfloat16, which numpy lacks, travels as
    # the bytes of its int16 view, so no extra dtype package is needed.
    def put_tree(self, key: str, tree: Any, *, overwrite: bool = True) -> bool:
        blob = pickle.dumps(tree_map(_encode_leaf, tree))
        return self.put(key, blob, overwrite=overwrite)

    def get_tree(self, key: str) -> Any:
        """The stored tree, as CPU tensors of the stored dtypes."""
        return tree_map(_decode_leaf, pickle.loads(self.get(key)))

    # -- timing model ------------------------------------------------------
    def read_time_s(self, n_bytes: int) -> float:
        return n_bytes / (self.read_bandwidth_mbps * 1e6)

    def write_time_s(self, n_bytes: int) -> float:
        return n_bytes / (self.write_bandwidth_mbps * 1e6)


class _Leaf(NamedTuple):
    dtype: str    # torch dtype name, e.g. "bfloat16"
    shape: tuple
    data: bytes


def _encode_leaf(x) -> _Leaf:
    t = torch.as_tensor(x).detach().cpu().contiguous()
    dtype = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return _Leaf(dtype, tuple(t.shape), t.numpy().tobytes())


def _decode_leaf(rec: _Leaf) -> torch.Tensor:
    dtype = getattr(torch, rec.dtype)
    raw = torch.int16 if dtype == torch.bfloat16 else dtype
    np_dtype = torch.empty((), dtype=raw).numpy().dtype
    arr = np.frombuffer(rec.data, dtype=np_dtype).reshape(rec.shape).copy()
    return torch.from_numpy(arr).view(dtype)
