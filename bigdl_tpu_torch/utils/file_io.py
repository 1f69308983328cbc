"""Checkpoint file IO (counterpart of ``bigdl_tpu/utils/file_io.py``).

Objects are pulled to host numpy and written in the reference's
self-describing envelope: the ``BIGDL_TPU_V1`` magic, then a pickle. URI
schemes dispatch to registered handlers:

- local paths and ``file://``: direct filesystem IO;
- ``gs://``: Google Cloud Storage through ``google.cloud.storage`` (an
  explicit error when the client or its credentials are absent);
- ``hdfs://``: the reference's own remote scheme, through fsspec's Hadoop
  filesystem (an explicit error without a Hadoop client);
- ``mem://``: an in-process store, the tested implementation of the
  handler protocol;
- anything else: ``register_scheme`` your own.

Tensors. In a tree of dicts, lists and tuples (a training snapshot's
``{"params", "buffers"}`` or ``{"optim", "driver"}``) every ``torch.Tensor``
becomes a host numpy array, bf16 widened to f32 (exact), so the file is
the reference's format and loads on a box without a card; ``load`` gives
numpy back. Any other object, a whole ``Module`` for instance, is pickled
with each tensor inside it stored as host numpy with its dtype (bf16 as
its raw bits) and rebuilt by ``load`` on ``device`` (default ``"cuda"``),
so an int8 twin's quantized weights and scales, a bf16 twin's dtypes and
BN's running statistics come back as they were. A module's dropout
generators are not saved: a loaded ``Dropout`` draws from its seed again.
"""

from __future__ import annotations

import functools
import io
import itertools
import os
import pickle
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

_MAGIC = b"BIGDL_TPU_V1"


class SchemeHandler:
    """IO surface a remote scheme provides. ``opener(path, mode) -> file`` is
    mandatory; ``lister(path) -> [name]`` and ``mtime(path) -> float`` make
    snapshot discovery (``resilience/coordinator.py``) work on the scheme;
    ``exists(path) -> bool`` guards ``save(overwrite=False)``."""

    def __init__(self, opener: Callable[[str, str], Any],
                 lister: Optional[Callable[[str], List[str]]] = None,
                 mtime: Optional[Callable[[str], float]] = None,
                 exists: Optional[Callable[[str], bool]] = None):
        self.opener = opener
        self.lister = lister
        self.mtime = mtime
        self.exists = exists


_SCHEME_HANDLERS: Dict[str, SchemeHandler] = {}


def register_scheme(scheme: str, opener: Callable[[str, str], Any],
                    lister=None, mtime=None, exists=None) -> None:
    """Register an ``opener(path, mode) -> file`` (plus optional ``lister``,
    ``mtime`` and ``exists``) for a URI scheme."""
    _SCHEME_HANDLERS[scheme] = SchemeHandler(opener, lister, mtime, exists)


def _split(path: str) -> Tuple[Optional[str], str]:
    if "://" in path:
        scheme, rest = path.split("://", 1)
        if scheme == "file":
            return None, rest
        return scheme, rest
    return None, path


def _handler(scheme: str) -> SchemeHandler:
    h = _SCHEME_HANDLERS.get(scheme)
    if h is None:
        raise ValueError(f"no handler registered for scheme {scheme!r}; "
                         f"use file_io.register_scheme")
    return h


def _open(path: str, mode: str):
    scheme, rest = _split(path)
    if scheme is not None:
        return _handler(scheme).opener(rest, mode)
    if "w" in mode:
        parent = os.path.dirname(os.path.abspath(rest))
        os.makedirs(parent, exist_ok=True)
    return open(rest, mode)


def exists(path: str) -> bool:
    scheme, rest = _split(path)
    if scheme is None:
        return os.path.exists(rest)
    h = _handler(scheme)
    if h.exists is None:
        raise NotImplementedError(
            f"scheme {scheme!r} has no exists hook; "
            f"register_scheme(..., exists=...) to enable existence checks")
    return h.exists(rest)


def listdir(path: str) -> List[str]:
    """Names under a directory or prefix, for snapshot discovery."""
    scheme, rest = _split(path)
    if scheme is None:
        return os.listdir(rest)
    h = _handler(scheme)
    if h.lister is None:
        raise NotImplementedError(
            f"scheme {scheme!r} has no lister; checkpoint discovery "
            f"needs one (register_scheme(..., lister=...))")
    return h.lister(rest)


def getmtime(path: str) -> float:
    scheme, rest = _split(path)
    if scheme is None:
        return os.path.getmtime(rest)
    h = _handler(scheme)
    if h.mtime is None:
        return 0.0
    return h.mtime(rest)


def join(base: str, *names: str) -> str:
    """URI-safe path join."""
    return "/".join([base.rstrip("/")] + [n.strip("/") for n in names])


# ------------------------------------------------------------- host values
def to_host(obj: Any) -> Any:
    """Every tensor of a tree of plain dicts, lists and tuples as host
    numpy, bf16 (no numpy dtype) widened to f32, which a copy back into a
    bf16 tensor undoes exactly. A card's tensors are copied without
    blocking and waited for once, not one synchronizing copy apiece."""
    copies: List[torch.Tensor] = []
    from_card = []

    def start(x):
        if torch.is_tensor(x):
            x = x.detach()
            if x.dtype == torch.bfloat16:
                x = x.float()
            from_card.append(x.is_cuda)
            copies.append(x.to("cpu", non_blocking=True))
            return len(copies) - 1
        if type(x) is dict:
            return {k: start(v) for k, v in x.items()}
        if type(x) in (list, tuple):
            return type(x)(start(v) for v in x)
        return x

    tree = start(obj)
    if any(from_card):
        torch.cuda.synchronize()
    arrays = [t.numpy() for t in copies]

    def finish(x, src):
        if torch.is_tensor(src):
            return arrays[x]
        if type(src) is dict:
            return {k: finish(x[k], v) for k, v in src.items()}
        if type(src) in (list, tuple):
            return type(src)(finish(a, b) for a, b in zip(x, src))
        return x

    return finish(tree, obj)


def _tensor_from_host(array: np.ndarray, dtype: str, parameter: bool,
                      requires_grad: bool,
                      device: torch.device = torch.device("cpu")
                      ) -> torch.Tensor:
    """Unpickling half of ``_Pickler.reducer_override``."""
    t = torch.from_numpy(np.array(array))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    t = t.to(device)
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t


def _no_generator():
    return None


class _Pickler(pickle.Pickler):
    """Stores each tensor of a pickled object as host numpy with its dtype,
    and each ``torch.Generator`` as None."""

    def reducer_override(self, obj):
        if torch.is_tensor(obj):
            t = obj.detach()
            dtype = str(t.dtype).replace("torch.", "")
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            return _tensor_from_host, (
                t.cpu().numpy(), dtype, isinstance(obj, torch.nn.Parameter),
                bool(obj.requires_grad))
        if isinstance(obj, torch.Generator):
            return _no_generator, ()
        return NotImplemented


def _payload(obj: Any) -> bytes:
    buf = io.BytesIO()
    buf.write(_MAGIC)
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(to_host(obj))
    return buf.getvalue()


def save(obj: Any, path: str, overwrite: bool = True) -> Dict[str, int]:
    """Serialize a tree or an object (reference ``File.save``); returns the
    file's ``{"bytes", "crc32"}``, which the resume marker records.

    The payload is fully serialized BEFORE the destination opens: remote
    handlers commit on close, so streaming the pickle directly could
    replace a good checkpoint with a truncated one if serialization failed
    midway."""
    if not overwrite and exists(path):
        raise FileExistsError(path)
    payload = _payload(obj)
    with _open(path, "wb") as f:
        f.write(payload)
    return {"bytes": len(payload), "crc32": zlib.crc32(payload)}


class _Unpickler(pickle.Unpickler):
    """Rebuilds a pickled object's tensors on ``device``, resolved at the
    first tensor (a host tree never touches a device)."""

    def __init__(self, f, device: DeviceLike):
        super().__init__(f)
        self._device = device
        self._resolved: Optional[torch.device] = None

    def find_class(self, module, name):
        if module == __name__ and name == "_tensor_from_host":
            return self._rebuild
        return super().find_class(module, name)

    def _rebuild(self, array, dtype, parameter, requires_grad):
        if self._resolved is None:
            self._resolved = resolve_device(self._device)
        return _tensor_from_host(array, dtype, parameter, requires_grad,
                                 self._resolved)


def load(path: str, device: DeviceLike = "cuda") -> Any:
    """Deserialize (reference ``File.load``). A tree comes back as host
    numpy; the tensors of any other object (a saved module) are rebuilt on
    ``device``, which raises without a card unless it is ``"cpu"``."""
    with _open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path} is not a bigdl_tpu checkpoint")
        return _Unpickler(f, device).load()


# ----------------------------------------------------------- mem:// handler
_MEM_STORE: Dict[str, bytes] = {}
_MEM_CLOCK = itertools.count(1)
_MEM_MTIME: Dict[str, float] = {}


class _WriteBack(io.BytesIO):
    def __init__(self, key: str):
        super().__init__()
        self._key = key

    def close(self):
        _MEM_STORE[self._key] = self.getvalue()
        _MEM_MTIME[self._key] = float(next(_MEM_CLOCK))
        super().close()


def _mem_opener(path: str, mode: str):
    if "w" in mode:
        return _WriteBack(path)
    if path not in _MEM_STORE:
        raise FileNotFoundError(f"mem://{path}")
    return io.BytesIO(_MEM_STORE[path])


def _mem_lister(path: str) -> List[str]:
    prefix = path.rstrip("/") + "/" if path.strip("/") else ""
    return sorted({k[len(prefix):].split("/", 1)[0]
                   for k in _MEM_STORE if k.startswith(prefix)})


register_scheme("mem", _mem_opener, lister=_mem_lister,
                mtime=lambda p: _MEM_MTIME.get(p, 0.0),
                exists=lambda p: p in _MEM_STORE)


def clear_mem_store() -> None:
    """Drop everything saved under ``mem://`` (test isolation)."""
    _MEM_STORE.clear()
    _MEM_MTIME.clear()


# ------------------------------------------------------------ gs:// handler
@functools.lru_cache(maxsize=1)
def _gcs_client():
    try:
        from google.cloud import storage  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "gs:// checkpoint IO needs the google-cloud-storage client, "
            "which is not installed in this environment; install it, or "
            "file_io.register_scheme('gs', ...) an opener backed by your "
            "own client") from e
    try:
        return storage.Client()
    except Exception as e:  # DefaultCredentialsError and friends
        raise RuntimeError(
            "gs:// checkpoint IO could not authenticate to Google Cloud "
            "Storage (set GOOGLE_APPLICATION_CREDENTIALS or run on a "
            f"machine with application-default credentials): {e}") from e


def _gcs_blob(path: str):
    bucket_name, _, blob_path = path.partition("/")
    return _gcs_client().bucket(bucket_name).blob(blob_path)


class _GcsUpload(io.BytesIO):
    def __init__(self, blob):
        super().__init__()
        self._blob = blob

    def close(self):
        self._blob.upload_from_string(self.getvalue())
        super().close()


def _gcs_opener(path: str, mode: str):
    blob = _gcs_blob(path)
    if "w" in mode:
        return _GcsUpload(blob)
    return io.BytesIO(blob.download_as_bytes())


def _gcs_lister(path: str) -> List[str]:
    bucket_name, _, prefix = path.partition("/")
    prefix = prefix.rstrip("/") + "/" if prefix.strip("/") else ""
    blobs = _gcs_client().list_blobs(bucket_name, prefix=prefix,
                                     delimiter="/")
    return sorted(b.name[len(prefix):] for b in blobs)


def _gcs_mtime(path: str) -> float:
    blob = _gcs_blob(path)
    blob.reload()
    return blob.updated.timestamp() if blob.updated else 0.0


register_scheme("gs", _gcs_opener, lister=_gcs_lister, mtime=_gcs_mtime,
                exists=lambda p: _gcs_blob(p).exists())


# ---------------------------------------------------------- hdfs:// handler
def _hdfs_fs_path(path: str):
    try:
        import fsspec
        return fsspec.core.url_to_fs("hdfs://" + path)
    except Exception as e:
        raise RuntimeError(
            "hdfs:// checkpoint IO needs a working Hadoop client "
            "(fsspec -> pyarrow HadoopFileSystem, which loads libhdfs and "
            "reads HADOOP_HOME/CLASSPATH); or file_io.register_scheme("
            f"'hdfs', ...) your own opener, or use gs://: {e}") from e


def _hdfs_opener(path: str, mode: str):
    fs, p = _hdfs_fs_path(path)
    return fs.open(p, mode)


def _hdfs_lister(path: str) -> List[str]:
    fs, p = _hdfs_fs_path(path)
    return sorted(name.rstrip("/").rsplit("/", 1)[-1]
                  for name in fs.ls(p, detail=False))


def _hdfs_mtime(path: str) -> float:
    fs, p = _hdfs_fs_path(path)
    mt = fs.info(p).get("mtime") or 0.0
    return mt.timestamp() if hasattr(mt, "timestamp") else float(mt)


def _hdfs_exists(path: str) -> bool:
    fs, p = _hdfs_fs_path(path)
    return fs.exists(p)


register_scheme("hdfs", _hdfs_opener, lister=_hdfs_lister,
                mtime=_hdfs_mtime, exists=_hdfs_exists)
