"""``SampleToBatch``'s padding (``feature_padding``, ``label_padding``,
``fixed_length``), ``BucketBatch``, ``Identity`` and ``MTTransformer`` in
the port against the JAX package's, on the CPU: batches exactly equal on
variable-length samples made from a seed."""

import numpy as np
import pytest
import torch

from bigdl_tpu.dataset import base as jbase
from bigdl_tpu_torch.dataset import base
from bigdl_tpu_torch.dataset.image import GreyImgToBatch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(n, seed=0, feat_dim=3, seq_labels=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = int(rng.integers(1, 9))
        f = rng.normal(size=(t, feat_dim)).astype(np.float32)
        lab = (rng.integers(1, 5, t).astype(np.float32) if seq_labels
               else np.float32(rng.integers(1, 5)))
        out.append((f, lab))
    return out


def _both(records):
    return ([base.Sample(f, l) for f, l in records],
            [jbase.Sample(f, l) for f, l in records])


def _same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.data.dtype == w.data.dtype
        np.testing.assert_array_equal(g.data, w.data)
        np.testing.assert_array_equal(g.labels, w.labels)


@pytest.mark.parametrize("kw", [
    dict(feature_padding=0.0, label_padding=-1.0),
    dict(feature_padding=2.5, scalar_labels=True),
    dict(fixed_length=5, label_padding=1.0),
    dict(fixed_length=4, scalar_labels=True),
    dict(feature_padding=-3.0, label_padding=0.0, fixed_length=10,
         drop_remainder=False)])
def test_padding_matches_reference(kw):
    kw = dict(kw)
    scalar = kw.pop("scalar_labels", False)
    samples, jsamples = _both(_records(23, seq_labels=not scalar))
    got = list(base.SampleToBatch(4, **kw)(iter(samples)))
    want = list(jbase.SampleToBatch(4, **kw)(iter(jsamples)))
    _same(got, want)
    if kw.get("fixed_length"):
        assert all(b.data.shape[1] == kw["fixed_length"] for b in got)


def test_scalar_labels_stay_flat():
    samples, jsamples = _both(_records(9, seq_labels=False))
    got = list(base.SampleToBatch(3, feature_padding=0.0)(iter(samples)))
    want = list(jbase.SampleToBatch(3, feature_padding=0.0)(iter(jsamples)))
    _same(got, want)
    assert got[0].labels.shape == (3,)
    # ragged sequence labels without label_padding cannot stack, as in
    # the reference
    samples, jsamples = _both(_records(9))
    for mod, recs in ((base, samples), (jbase, jsamples)):
        with pytest.raises(ValueError, match="same shape"):
            list(mod.SampleToBatch(3, fixed_length=4)(iter(recs)))


@pytest.mark.parametrize("drop", [True, False])
def test_bucket_batch_matches_reference(drop):
    samples, jsamples = _both(_records(40, seed=3))
    kw = dict(boundaries=[2, 5, 8], feature_padding=0.5, label_padding=-1.0,
              drop_remainder=drop)
    got = list(base.BucketBatch(3, **kw)(iter(samples)))
    want = list(jbase.BucketBatch(3, **kw)(iter(jsamples)))
    _same(got, want)
    assert {b.data.shape[1] for b in got} <= {2, 5, 8}
    with pytest.raises(ValueError, match="exceeds"):
        list(base.BucketBatch(2, [1])(iter(samples)))
    with pytest.raises(ValueError):
        base.BucketBatch(2, [])


def test_identity_and_chain():
    samples, jsamples = _both(_records(6, seq_labels=False))
    chain = base.Identity() >> base.SampleToBatch(2, fixed_length=3)
    jchain = jbase.Identity() >> jbase.SampleToBatch(2, fixed_length=3)
    _same(list(chain(iter(samples))), list(jchain(iter(jsamples))))


class _Double(base.Transformer):
    """A 1:n stage with per-instance state (each thread its own clone)."""

    def __init__(self):
        self.seen = 0

    def __call__(self, prev):
        for s in prev:
            self.seen += 1
            yield s
            yield base.Sample(s.feature * 2, s.label)


class _JDouble(jbase.Transformer):
    def __call__(self, prev):
        for s in prev:
            yield s
            yield jbase.Sample(s.feature * 2, s.label)


@pytest.mark.parametrize("workers", [1, 3])
def test_mt_transformer_keeps_order(workers):
    samples, jsamples = _both(_records(17, seed=4, seq_labels=False))
    mt = base.MTTransformer(_Double(), workers=workers, window=4)
    jmt = jbase.MTTransformer(_JDouble(), workers=workers, window=4)
    got = list((mt >> base.SampleToBatch(5, feature_padding=0.0,
                                         drop_remainder=False))(
        iter(samples)))
    want = list((jmt >> jbase.SampleToBatch(5, feature_padding=0.0,
                                            drop_remainder=False))(
        iter(jsamples)))
    _same(got, want)
    assert sum(b.size() for b in got) == 34


@pytest.mark.parametrize("stage", [lambda: base.SampleToBatch(2),
                                   lambda: base.Prefetch(2),
                                   lambda: GreyImgToBatch(2)])
def test_mt_transformer_refuses_aggregating_stages(stage):
    with pytest.raises(ValueError, match="aggregates"):
        base.MTTransformer(base.Identity() >> stage(), workers=2)
