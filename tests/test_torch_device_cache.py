"""``DeviceCachedDataSet`` (``dataset/device_cache.py``) on the CPU: the
counterparts of ``tests/test_device_cache.py``'s single-device cases.

Eval batches equal the host path's; each training epoch is a sample-level
permutation, drawn from the ``RandomGenerator`` stream as the reference
draws it, so one seed gives both packages the same batches; the wrapped
dataset is read once; a stochastic stage below the cache raises;
``cast_dtype`` halves the cache's bytes; training through the cache equals
the host path at k = 1 and k = 4 (shuffles pinned to the identity, so any
difference would be the compute path's), and a k = 4 window over the
cache equals k = 1; ``set_mesh`` serves a rank's share of each global
batch.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu.dataset import DeviceCachedDataSet as JaxCache
from bigdl_tpu.dataset.base import DataSet as JaxDataSet
from bigdl_tpu.dataset.base import Sample as JaxSample
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import CachedSliceBatch, DeviceCachedDataSet
from bigdl_tpu_torch.dataset import mnist
from bigdl_tpu_torch.dataset.base import (DataSet, LocalDataSet, Sample,
                                          SampleToBatch)
from bigdl_tpu_torch.dataset.image import (BytesToGreyImg, GreyImgNormalizer,
                                           HFlip)
from bigdl_tpu_torch.models import lenet
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.utils.rng import RandomGenerator


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _samples(n, shape=(4,), classes=2, sample=Sample):
    rng = np.random.default_rng(0)
    return [sample(rng.normal(0, 1, shape).astype(np.float32),
                   float(rng.integers(1, classes + 1))) for _ in range(n)]


def _cache(samples, batch_size, **kw):
    return DeviceCachedDataSet(DataSet.array(samples), batch_size,
                               device="cpu", **kw)


def test_eval_batches_match_host_path():
    samples = _samples(10)
    a = list(_cache(samples, 4).data(train=False))
    b = list((DataSet.array(samples) >> SampleToBatch(4)).data(train=False))
    assert len(a) == len(b) == 2   # the remainder is dropped, as the host's
    for ca, cb in zip(a, b):
        np.testing.assert_array_equal(ca.data.numpy(), cb.data)
        np.testing.assert_array_equal(ca.labels.numpy(), cb.labels)


def test_train_epoch_is_the_references_sample_permutation():
    samples = _samples(8, shape=(1,))
    ds = _cache(samples, 4)
    ref = JaxCache(JaxDataSet.array(_samples(8, shape=(1,),
                                             sample=JaxSample)),
                   batch_size=4)
    RandomGenerator.RNG().set_seed(7)
    JaxRNG.RNG().set_seed(7)
    epochs = []
    for _ in range(2):
        batches = list(ds.data(train=True))
        assert all(isinstance(b, CachedSliceBatch) for b in batches)
        got = [b.data.numpy().ravel() for b in batches]
        want = [np.asarray(b.data).ravel() for b in ref.data(train=True)]
        for g, w in zip(got, want):   # the same members, batch by batch
            np.testing.assert_array_equal(g, w)
        epochs.append(np.concatenate(got))
    every = np.concatenate([s.feature for s in samples])
    np.testing.assert_array_equal(np.sort(epochs[0]), np.sort(every))
    assert not np.array_equal(epochs[0], epochs[1])   # reshuffled


def test_materializes_once_and_serves_many_epochs():
    calls = {"n": 0}

    class Counting(LocalDataSet):
        def data(self, train):
            calls["n"] += 1
            return super().data(train)

    ds = DeviceCachedDataSet(Counting(_samples(8)), 4, device="cpu")
    for _ in range(3):
        assert len(list(ds.data(train=True))) == 2
    assert calls["n"] == 1
    assert ds.size() == 8 and ds.materialize_seconds is not None


def test_terminal_stage_and_validation():
    ds = _cache(_samples(8), 4)
    with pytest.raises(TypeError):
        ds.transform(SampleToBatch(2))
    with pytest.raises(ValueError):
        list(_cache(_samples(2), 4).data(train=False))
    with pytest.raises(ValueError):
        _cache(_samples(4), 0)
    with pytest.raises(ValueError, match="cast_dtype"):
        _cache(_samples(4), 2, cast_dtype="int3")


def test_caches_the_image_pipeline():
    raw = (DataSet.array(mnist.synthetic(16)) >> BytesToGreyImg(28, 28)
           >> GreyImgNormalizer(33., 78.))
    batches = list(DeviceCachedDataSet(raw, 8, device="cpu").data(
        train=False))
    assert [b.size() for b in batches] == [8, 8]
    assert tuple(batches[0].data.shape) == (8, 28, 28, 1)


def test_stochastic_stage_below_the_cache_raises():
    raw = (DataSet.array(mnist.synthetic(16)) >> BytesToGreyImg(28, 28)
           >> HFlip(0.5))
    with pytest.raises(ValueError, match="stochastic"):
        list(DeviceCachedDataSet(raw, 8, device="cpu").data(train=False))


def test_shape1_labels_squeezed_like_host_path():
    samples = [Sample(np.ones((4,), np.float32),
                      np.asarray([float(i % 2 + 1)])) for i in range(8)]
    cached = next(_cache(samples, 8).data(train=False))
    host = next((DataSet.array(samples) >> SampleToBatch(8)).data(
        train=False))
    assert tuple(cached.labels.shape) == host.labels.shape == (8,)


def test_cast_dtype_halves_the_cache():
    full = _cache(_samples(8), 4)
    half = _cache(_samples(8), 4, cast_dtype="bfloat16")
    a, b = next(full.data(train=False)), next(half.data(train=False))
    assert b.data.dtype == torch.bfloat16
    assert half._x.nbytes * 2 == full._x.nbytes
    torch.testing.assert_close(b.data, a.data.to(torch.bfloat16))


def test_set_mesh_and_no_card_stop():
    from bigdl_tpu_torch.parallel.mesh import Mesh
    cache = _cache(_samples(8, shape=(1,)), 4)
    cache.set_mesh(Mesh(2, 1, "cpu", None))   # rank 1 of 2: 2 rows a step
    assert cache.is_distributed()
    RandomGenerator.RNG().set_seed(7)
    batches = list(cache.data(train=True))
    assert [b.size() for b in batches] == [2] * 4
    rows = np.concatenate([b.data.numpy().ravel() for b in batches])
    every = np.concatenate([s.feature for s in _samples(8, shape=(1,))])
    np.testing.assert_array_equal(np.sort(rows), np.sort(every))
    # the second of two permutations drawn in rank order
    rng = RandomGenerator(7)
    rng.randperm(8)
    np.testing.assert_array_equal(rows, every[rng.randperm(8) - 1])
    assert [b.size() for b in cache.data(train=False)] == [2] * 4
    with pytest.raises(RuntimeError, match="already materialized"):
        cache.set_mesh(Mesh(4, 0, "cpu", None))
    with pytest.raises(ValueError, match="divide"):
        _cache(_samples(8), 4).set_mesh(Mesh(3, 0, "cpu", None))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeviceCachedDataSet(DataSet.array(_samples(8)), 4)


def _train(cached: bool, k: int, monkeypatch):
    """LeNet, 6 SGD iterations of 32 from the same seed, through the cache
    or the host collate path; shuffles pinned to the identity."""
    monkeypatch.setattr(LocalDataSet, "shuffle", lambda self: None)
    monkeypatch.setattr(
        DeviceCachedDataSet, "shuffle",
        lambda self: (self._materialize(), setattr(
            self, "_perm", np.arange(self.size(), dtype=np.int64))))
    rng = np.random.default_rng(3)
    samples = [Sample(rng.normal(0, 1, (28, 28, 1)).astype(np.float32),
                      float(rng.integers(1, 11))) for _ in range(128)]
    ds = (_cache(samples, 32) if cached
          else DataSet.array(samples) >> SampleToBatch(32))
    model = lenet.build(10, device="cpu", seed=11)
    opt = Optimizer(model, ds, nn.ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(SGD(learningrate=0.1)) \
       .set_end_when(Trigger.max_iteration(6)).set_steps_per_dispatch(k)
    opt.optimize()
    return ([h["loss"] for h in opt.history],
            [p.detach().clone() for p in model.parameters()])


@pytest.mark.parametrize("k", [1, 4])
def test_training_through_the_cache_matches_the_host_path(k, monkeypatch):
    host_losses, host_params = _train(False, k, monkeypatch)
    losses, params = _train(True, k, monkeypatch)
    assert losses == host_losses
    for a, b in zip(params, host_params):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_k4_window_over_the_cache_matches_k1(monkeypatch):
    l1, p1 = _train(True, 1, monkeypatch)
    l4, p4 = _train(True, 4, monkeypatch)
    assert l4 == l1
    for a, b in zip(p4, p1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
