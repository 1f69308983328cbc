"""The ``vgg`` app in the port against the JAX package's, on the CPU: VGG-
CIFAR trains 2 iterations (B=4) of the reference's recipe on a CIFAR
binary file the test writes, in both packages on the same weights, with
``RandomGenerator.RNG()`` seeded alike (the same flips and padded crops),
shuffles off and dropout set to 0 in both (the packages draw shuffles and
masks from different generators); every loss agrees within 1e-4
(relative), and ``test --model`` gives the reference's trained model's
Top-1. The harness is ``test_torch_vision_apps.py``'s."""

import pytest
import torch

from bigdl_tpu.apps import vgg as jvgg_app
from bigdl_tpu.models import vgg as jvgg
from bigdl_tpu.optim import Top1Accuracy as JaxTop1
from bigdl_tpu_torch.apps import vgg as vgg_app
from bigdl_tpu_torch.models import vgg
from test_torch_vision_apps import (_carried, _hold_losses, _write_cifar,
                                    run_both)


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    for g in ("BIGDL_TPU_FUSED_1X1", "BIGDL_TPU_FUSED_3X3"):
        monkeypatch.delenv(g, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_vgg_app_train_and_test(monkeypatch, tmp_path):
    data = tmp_path / "cifar"
    data.mkdir()
    _write_cifar(data, 2, 4)
    jm = jvgg.build(10)
    tm = _carried(jm, vgg.build(10, device="cpu", seed=3))
    for model in (jm, tm):
        for m in model.modules():
            if type(m).__name__ == "Dropout":
                m.set_p(0.0)
    got, ref, _ = run_both(monkeypatch, vgg_app, jvgg_app, "vgg", jm, tm,
                           ["-f", str(data), "-b", "4", "-e", "1"], tmp_path)
    _hold_losses(got, ref, 2)   # 10 images, batches of 4
    (result, _), = vgg_app.test(["--model", str(tmp_path / "port" /
                                                "model_final"),
                                 "-f", str(data), "-b", "4",
                                 "--device", "cpu"])
    (ref_result, _), = jm.evaluate(jvgg_app._val_set(str(data), 4, 0),
                                   [JaxTop1()])
    assert (result.correct, result.count) == (ref_result.correct,
                                              ref_result.count)
