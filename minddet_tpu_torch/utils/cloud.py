"""Storage paths, local or remote (counterpart of
``minddet_tpu/utils/cloud.py``): ``is_remote``, ``open_path``,
``download``, ``listdir``, ``sync_dir`` and ``upload_dir``. Local paths are
plain file I/O; gs://, s3:// and obs:// go through fsspec, imported inside
the call, which raises where it is not installed. The train CLI's
``--data-url`` and ``--train-url`` use it.
"""

from __future__ import annotations

import os
import shutil
from typing import List

_SCHEMES = ("gs://", "s3://", "obs://")


def is_remote(path: str) -> bool:
    return any(path.startswith(s) for s in _SCHEMES)


def _fsspec(path: str):
    """The fsspec module, or ImportError naming ``path``."""
    try:
        import fsspec
    except ImportError as e:
        raise ImportError(
            f"remote path {path!r} needs fsspec (+gcsfs/s3fs) — not "
            "available in this environment; stage data locally instead"
        ) from e
    return fsspec


def open_path(path: str, mode: str = "rb"):
    """open() that transparently handles gs:// s3:// obs:// paths."""
    if not is_remote(path):
        return open(path, mode)
    return _fsspec(path).open(path, mode).open()


def download(src: str, dst: str) -> str:
    """Copy a (possibly remote) file to a local destination path."""
    os.makedirs(os.path.dirname(os.path.abspath(dst)) or ".", exist_ok=True)
    if not is_remote(src):
        shutil.copyfile(src, dst)
        return dst
    with open_path(src, "rb") as f, open(dst, "wb") as g:
        shutil.copyfileobj(f, g)
    return dst


def listdir(path: str) -> List[str]:
    if not is_remote(path):
        return sorted(os.listdir(path))
    fs, _, paths = _fsspec(path).get_fs_token_paths(path)
    return sorted(fs.ls(paths[0]))


def sync_dir(src: str, dst: str) -> str:
    """Mirror a (possibly remote) directory into a local one; returns dst.

    The download half of the reference's ModelArts cloud-train workflow
    (``centerpoint/tools_ms/train_cloud.py:250`` stages data_url locally
    with moxing/OBS before training).
    """
    os.makedirs(dst, exist_ok=True)
    if not is_remote(src):
        for name in sorted(os.listdir(src)):
            s = os.path.join(src, name)
            d = os.path.join(dst, name)
            if os.path.isdir(s):
                sync_dir(s, d)
            else:
                shutil.copyfile(s, d)
        return dst
    fs, _, paths = _fsspec(src).get_fs_token_paths(src)
    fs.get(paths[0], dst + os.sep, recursive=True)
    return dst


def upload_dir(src: str, dst: str, exclude: tuple = ("data",)) -> str:
    """Mirror a local directory to a (possibly remote) destination.

    The upload half of cloud-train: results/checkpoints in the workdir go
    back to train_url when the job ends. ``exclude`` skips top-level entries
    (by default the staged input-data mirror, which must not round-trip).
    """
    if not is_remote(dst):
        os.makedirs(dst, exist_ok=True)
        for name in sorted(os.listdir(src)):
            if name in exclude:
                continue
            s_ = os.path.join(src, name)
            d_ = os.path.join(dst, name)
            if os.path.isdir(s_):
                sync_dir(s_, d_)
            else:
                shutil.copyfile(s_, d_)
        return dst
    fs, _, paths = _fsspec(dst).get_fs_token_paths(dst)
    for name in sorted(os.listdir(src)):
        if name in exclude:
            continue
        fs.put(os.path.join(src, name), paths[0] + "/" + name,
               recursive=True)
    return dst
