"""Device-resident dataset cache (counterpart of
``bigdl_tpu/dataset/device_cache.py``: ``DeviceCachedDataSet`` and
``CachedSliceBatch``).

The wrapped dataset's samples are read once and stacked into one (N, ...)
feature tensor and one label tensor on the device. Each training epoch
draws a sample-level permutation from the process's ``RandomGenerator``
(the reference's stream: the same seed gives the same batches in both
packages) and uploads it as one (N,) int64 tensor; a batch is then a
``CachedSliceBatch``, B indices into the cache, gathered on the device.
``Optimizer`` gathers a k = 1 step's batch on the device, and captures a
window of k steps over one cache as a CUDA graph whose only input is the
(k, B) index tensor (``optim/optimizer.py``). Evaluation reads the cache
in order, in whole batches.

On a data-parallel mesh (``set_mesh``, which ``DistriOptimizer`` calls)
each process caches its own records (the wrapped dataset is distributed,
so it yields this process's slice), ``batch_size`` is the GLOBAL batch and
each process serves ``batch_size / size`` rows a step; each epoch draws
one permutation per rank from the stream, as the reference's single
process draws one per shard, and this rank gathers by its own: the
reference's ``"cached"`` mode, permuting within each rank's records.

Limits, as in the reference: the dataset must be finite and fit the
device beside the model, and no stage below the cache may draw random
numbers (a random crop, flip or jitter would be frozen at
materialisation): a stage marked ``stochastic`` raises.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional, Union

import numpy as np
import torch

from bigdl_tpu_torch.dataset.base import (AbstractDataSet, ChainedTransformer,
                                          MiniBatch, TransformedDataSet)
from bigdl_tpu_torch.telemetry.tracing import span
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device
from bigdl_tpu_torch.utils.rng import RandomGenerator

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


class CachedSliceBatch:
    """A batch of B indices into a ``DeviceCachedDataSet``: ``data`` and
    ``labels`` gather the rows on the device; ``Optimizer``'s window graph
    reads ``idx`` and gathers inside the graph."""

    __slots__ = ("source", "idx")

    def __init__(self, source: "DeviceCachedDataSet", idx: torch.Tensor):
        self.source = source
        self.idx = idx

    @property
    def data(self) -> torch.Tensor:
        return self.source._x.index_select(0, self.idx)

    @property
    def labels(self) -> torch.Tensor:
        return self.source._y.index_select(0, self.idx)

    def size(self) -> int:
        return int(self.idx.shape[0])

    def __iter__(self):
        yield self.data
        yield self.labels


def _stages(transformer):
    if isinstance(transformer, ChainedTransformer):
        return _stages(transformer.first) + _stages(transformer.second)
    return [transformer]


class DeviceCachedDataSet(AbstractDataSet):
    """A Sample-level dataset materialised on ``device`` once, served as
    shuffled ``CachedSliceBatch``es of ``batch_size`` (the remainder is
    dropped, as shapes stay static). ``cast_dtype`` (``"bfloat16"``, or a
    ``torch.dtype``) is the features' dtype in the cache: a bf16 run
    caches bf16, half the bytes. ``device`` defaults to the card and
    raises without one."""

    def __init__(self, base: AbstractDataSet, batch_size: int,
                 cast_dtype: Optional[Union[str, torch.dtype]] = None, *,
                 device: DeviceLike = "cuda"):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if isinstance(cast_dtype, str):
            if cast_dtype not in _DTYPES:
                raise ValueError(f"cast_dtype {cast_dtype!r}: one of "
                                 f"{sorted(_DTYPES)} or a torch.dtype")
            cast_dtype = _DTYPES[cast_dtype]
        self.base = base
        self.batch_size = batch_size
        self.cast_dtype = cast_dtype
        self.device = resolve_device(device)
        self._x: Optional[torch.Tensor] = None
        self._y: Optional[torch.Tensor] = None
        self._perm: Optional[np.ndarray] = None
        self._mesh = None
        #: seconds the one materialisation took (None before it)
        self.materialize_seconds: Optional[float] = None

    def set_mesh(self, mesh, data_axis: str = "data") -> None:
        """Serve this rank's share of each global batch over ``mesh`` (a
        ``parallel.mesh.Mesh``); see the module docstring. A mesh of one
        keeps the local cache."""
        if self._x is not None and self._mesh is not mesh:
            raise RuntimeError("DeviceCachedDataSet already materialized; "
                               "set_mesh must precede the first epoch")
        if data_axis != "data":
            raise ValueError(f"the port's mesh has the 'data' axis only, "
                             f"not {data_axis!r}")
        if mesh.size <= 1:
            return
        if self.batch_size % mesh.size:
            raise ValueError(f"batch_size {self.batch_size} must divide by "
                             f"the mesh's {mesh.size} ranks")
        self._mesh = mesh

    def _local_batch(self) -> int:
        """Rows this process serves a step."""
        return self.batch_size // (self._mesh.size if self._mesh else 1)

    # ------------------------------------------------------------ the cache
    def _refuse_stochastic_stages(self) -> None:
        ds = self.base
        while isinstance(ds, TransformedDataSet):
            for stage in _stages(ds.transformer):
                if getattr(stage, "stochastic", False):
                    raise ValueError(
                        f"DeviceCachedDataSet cannot cache below the "
                        f"stochastic stage {type(stage).__name__}: its "
                        "random draw would be frozen at materialization. "
                        "Keep random augmentation out of the cached chain "
                        "(or use the host collate path).")
            ds = ds.base

    def _materialize(self) -> None:
        if self._x is not None:
            return
        self._refuse_stochastic_stages()
        t0 = time.perf_counter()
        feats, labels = [], []
        with span("ingest.materialize", batch_size=self.batch_size):
            for s in self.base.data(train=False):
                # a Sample has .feature; a LabeledImage carries .data
                feats.append(s.feature if hasattr(s, "feature") else s.data)
                labels.append(s.label)
            if not feats:
                raise ValueError("DeviceCachedDataSet: wrapped dataset is "
                                 "empty")
            if len(feats) < self._local_batch():
                raise ValueError(
                    f"DeviceCachedDataSet: {len(feats)} samples cannot fill "
                    f"one batch of {self._local_batch()}")
            x = torch.from_numpy(np.stack(feats))
            y = np.stack([np.asarray(label) for label in labels])
            if y.ndim == 2 and y.shape[1] == 1:
                y = y[:, 0]  # SampleToBatch's (N, 1) -> (N,) squeeze
            x = x.to(self.device)
            if self.cast_dtype is not None:
                x = x.to(self.cast_dtype)
            self._x = x
            self._y = torch.from_numpy(y).to(self.device)
        self.materialize_seconds = time.perf_counter() - t0

    # ------------------------------------------------------------- protocol
    def data(self, train: bool) -> Iterator:
        self._materialize()
        n = int(self._x.shape[0])
        bs = self._local_batch()
        if not train:
            for b in range(n // bs):
                yield MiniBatch(self._x[b * bs:(b + 1) * bs],
                                self._y[b * bs:(b + 1) * bs])
            return
        if self._perm is None:
            self.shuffle()
        perm, self._perm = self._perm, None   # one permutation an epoch
        idx = torch.from_numpy(perm).to(self.device)   # one upload an epoch
        for b in range(n // bs):
            yield CachedSliceBatch(self, idx[b * bs:(b + 1) * bs])

    def batches_per_epoch(self) -> int:
        """The iterations an epoch yields (the cache is materialised)."""
        self._materialize()
        return int(self._x.shape[0]) // self._local_batch()

    def size(self) -> int:
        if self._x is not None:
            return int(self._x.shape[0])
        return self.base.size()

    def shuffle(self) -> None:
        # materialise first: the wrapped chain may change the record count
        self._materialize()
        n = int(self._x.shape[0])
        rng = RandomGenerator.RNG()
        if self._mesh is not None:
            # one permutation a rank, drawn in rank order; this rank's
            perms = [rng.randperm(n) for _ in range(self._mesh.size)]
            self._perm = np.asarray(perms[self._mesh.rank] - 1, np.int64)
            return
        # randperm is 1-based (Torch semantics)
        self._perm = np.asarray(rng.randperm(n) - 1, np.int64)

    def is_distributed(self) -> bool:
        return self._mesh is not None or self.base.is_distributed()

    def transform(self, transformer):
        raise TypeError(
            "DeviceCachedDataSet is terminal: apply transformers to the "
            "wrapped dataset BEFORE caching (random host augmentations "
            "would be frozen at materialization)")
