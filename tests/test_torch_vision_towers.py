"""Whole towers of the conv zoo in the port against the JAX package's, on
the CPU. VGG-16's and VGG-19's parameter and buffer names, shapes and
counts (gates off and on; the check of ``test_torch_vision_models.py``).
Inception v1 and v2 at 224x224 and AlexNet at 227x227, B=1, eval
mode, the reference's weights carried across (``flatten_tree`` ->
``import_tree_state``, every name checked first), one seeded N(0, 1)
image. The log-probabilities agree within 1e-5 of max|ref| (f32 sums in
other orders through 20 to 60 layers; a seeded run differs by one f32
step)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import alexnet as jalexnet
from bigdl_tpu.models import inception as jinception
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu_torch.models import alexnet, inception
from test_torch_vision_models import BIG, _carry, _images, check_names

TOWERS = {"inception_v1": (jinception.build, inception.build, 224),
          "inception_v2": (jinception.build_v2, inception.build_v2, 224),
          "alexnet": (jalexnet.build, alexnet.build, 227)}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    for g in ("BIGDL_TPU_FUSED_1X1", "BIGDL_TPU_FUSED_3X3"):
        monkeypatch.delenv(g, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("gates", ["off", "on"])
@pytest.mark.parametrize("name", BIG)
def test_vgg_imagenet_tree_names_and_parameter_counts(name, gates,
                                                      monkeypatch):
    check_names(name, gates, monkeypatch)


@pytest.mark.parametrize("name", sorted(TOWERS))
def test_tower_forward(name):
    build_ref, build_port, hw = TOWERS[name]
    jm = build_ref(1000)
    tm = _carry(jm, build_port(1000, device="cpu"))
    x = _images((1, hw, hw, 3))
    fwd = jax.jit(lambda p, b, a: functional_apply(jm, p, b, a,
                                                   training=False)[0])
    ref = np.asarray(fwd(jm.parameter_tree(), jm.buffer_tree(),
                         jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 1000) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
