"""``ml/classifier.py`` in the port against the JAX package's, on the CPU:
``DLModel.transform`` / ``predict`` / ``predict_proba`` on carried weights
(within 1e-6 of the reference's; ids equal), and ``DLClassifier.fit`` from
the same weights on one full batch an epoch (the shuffle then permutes rows
of one mean, so the fitted weights agree to f32 rounding: 1e-5)."""

import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.ml import DLClassifier as JDLClassifier
from bigdl_tpu.ml import DLModel as JDLModel
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop.state_dict import (export_tree_state,
                                                flatten_tree,
                                                import_tree_state)
from bigdl_tpu_torch.ml import DLClassifier, DLEstimator, DLModel

N, D, C = 24, 6, 3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models():
    jm = (jnn.Sequential().add(jnn.Linear(D, 8)).add(jnn.Tanh())
          .add(jnn.Linear(8, C)).add(jnn.LogSoftMax()))
    tm = (nn.Sequential().add(nn.Linear(D, 8)).add(nn.Tanh())
          .add(nn.Linear(8, C)).add(nn.LogSoftMax()))
    params = flatten_tree(jm.parameter_tree())
    assert sorted(export_tree_state(tm)[0]) == sorted(params)
    import_tree_state(tm, params, flatten_tree(jm.buffer_tree()))
    return jm, tm


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    y = (np.argmax(x[:, :C], axis=1) + 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("batch_size, shape", [(5, None), (128, (2, 3))])
def test_transform_matches_reference(batch_size, shape):
    jm, tm = _models()
    x, _ = _data()
    feats = x if shape is None else x.reshape(N, 2, 3)
    if shape is not None:   # the model reshapes its rows back
        tm = nn.Sequential().add(nn.Reshape((D,), batch_mode=True)).add(tm)
        jm = jnn.Sequential().add(jnn.Reshape((D,), batch_mode=True)).add(jm)
    got = DLModel(tm, batch_size, feature_shape=shape)
    want = JDLModel(jm, batch_size, feature_shape=shape)
    out = got.transform(feats)
    np.testing.assert_allclose(out, want.transform(feats), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got.predict(feats), want.predict(feats))
    np.testing.assert_allclose(got.predict_proba(feats),
                               want.predict_proba(feats), rtol=1e-6)
    with torch.no_grad():
        direct = tm.eval()(torch.from_numpy(feats.reshape((N,) + (shape or (D,)))))
    np.testing.assert_array_equal(got.predict(feats),
                                  direct.argmax(-1).numpy() + 1)
    assert DLModel(tm, log_prob_head=False).predict_proba(feats).shape == \
        (N, C)


def test_transform_restores_train_mode():
    _, tm = _models()
    tm.train()
    DLModel(tm).transform(_data()[0])
    assert tm.training


def test_fit_matches_reference():
    jm, tm = _models()
    x, y = _data(1)
    got = DLClassifier(tm, batch_size=N, max_epoch=4, learning_rate=0.5,
                       device="cpu").fit(x, y)
    want = JDLClassifier(jm, batch_size=N, max_epoch=4,
                         learning_rate=0.5).fit(x, y)
    got_p = dict(tm.named_parameters())
    for name, w in flatten_tree(want.model.parameter_tree()).items():
        np.testing.assert_allclose(got_p[name].detach().numpy(),
                                   np.asarray(w), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.predict(x), want.predict(x))
    assert isinstance(got, DLModel) and got.model is tm


def test_estimator_takes_its_device():
    _, tm = _models()
    assert DLEstimator(tm, nn.ClassNLLCriterion(),
                       device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DLClassifier(tm)
