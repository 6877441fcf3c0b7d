"""Datasets materialized as ArrayRecord shards of ndarray dicts
(counterpart of ``minddet_tpu/data/records.py``: ``encode_example``,
``decode_example``, ``write_records`` and ``RecordDataset``).

A record is a dict of numpy arrays (and raw ``bytes`` fields) in the npz
container, so shards written by either package read in the other.
``array_record`` is imported by the calls that open a shard
(``write_records``, ``RecordDataset``), and raises there where it is not
installed; encoding and decoding need numpy only.
"""

from __future__ import annotations

import glob
import io
import os
from typing import Any, Dict, Iterable, List

import numpy as np

_BYTES = "__bytes__"  # marks a field that was ``bytes``
WRITER_OPTIONS = "group_size:1"  # one record per chunk: random access


def encode_example(example: Dict[str, Any]) -> bytes:
    """dict of ndarrays / bytes / scalars -> npz bytes."""
    norm = {}
    for k, v in example.items():
        if isinstance(v, bytes):
            norm[k] = np.frombuffer(v, dtype=np.uint8)
            norm[f"{_BYTES}{k}"] = np.asarray(True)
        else:
            norm[k] = np.asarray(v)
    buf = io.BytesIO()
    np.savez(buf, **norm)
    return buf.getvalue()


def decode_example(blob: bytes) -> Dict[str, Any]:
    """npz bytes -> the dict ``encode_example`` was given (scalars as 0-d
    arrays)."""
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        byte_keys = {k[len(_BYTES):] for k in z.files if k.startswith(_BYTES)}
        return {k: z[k].tobytes() if k in byte_keys else z[k]
                for k in z.files if not k.startswith(_BYTES)}


def write_records(path_prefix: str, examples: Iterable[Dict[str, Any]],
                  shard_size: int = 4096) -> List[str]:
    """Write examples to ``{prefix}-{i:05d}.arrayrecord`` shards of at most
    ``shard_size`` records; returns the shards' paths."""
    from array_record.python.array_record_module import ArrayRecordWriter

    os.makedirs(os.path.dirname(os.path.abspath(path_prefix)) or ".",
                exist_ok=True)
    paths: List[str] = []
    writer = None
    for count, ex in enumerate(examples):
        if count % shard_size == 0:
            if writer is not None:
                writer.close()
            path = f"{path_prefix}-{len(paths):05d}.arrayrecord"
            writer = ArrayRecordWriter(path, WRITER_OPTIONS)
            paths.append(path)
        writer.write(encode_example(ex))
    if writer is not None:
        writer.close()
    return paths


class RecordDataset:
    """Random-access view over a set of ArrayRecord shards (a glob pattern
    or a list of paths, read in sorted or given order)."""

    def __init__(self, pattern_or_paths):
        from array_record.python.array_record_module import \
            ArrayRecordReader

        if isinstance(pattern_or_paths, str):
            paths = sorted(glob.glob(pattern_or_paths))
        else:
            paths = list(pattern_or_paths)
        if not paths:
            raise FileNotFoundError(
                f"no record shards match {pattern_or_paths}")
        self._readers = [ArrayRecordReader(p) for p in paths]
        self._offsets = np.cumsum(
            [0] + [r.num_records() for r in self._readers])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        if idx < 0:
            idx += len(self)
        shard = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        (blob,) = self._readers[shard].read([idx - int(self._offsets[shard])])
        return decode_example(blob)
