"""The port stands alone: no JAX, nothing of bigdl_tpu, no silent CPU.

``bigdl_tpu_torch`` and ``chip_smoke.py`` import neither ``jax`` nor any
module of ``bigdl_tpu``, and every entry point runs on the card unless the
caller asks for the CPU.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.apps import transformer as transformer_app
from bigdl_tpu_torch.models.generation import generate, generate_speculative
from bigdl_tpu_torch.resilience.serving_drill import run_kill_drill
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.apps import autoencoder as autoencoder_app
from bigdl_tpu_torch.apps import imageclassifier, modelvalidator, udfpredictor
from bigdl_tpu_torch.apps import inception as inception_app
from bigdl_tpu_torch.apps import lenet as lenet_app
from bigdl_tpu_torch.apps import resnet as resnet_app
from bigdl_tpu_torch.apps import vgg as vgg_app
from bigdl_tpu_torch.apps import perf as perf_app
from bigdl_tpu_torch.apps import ingest_bench
from bigdl_tpu_torch.dataset.image import NativeBGRBatchDecoder
from bigdl_tpu_torch.dataset.ingest import PrefetchingDataSet
from bigdl_tpu_torch.telemetry import __main__ as telemetry_cli
from bigdl_tpu_torch.telemetry import scoreboard
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.dataset.device_cache import DeviceCachedDataSet
from bigdl_tpu_torch.models import (alexnet, autoencoder, inception, lenet,
                                    resnet, rnn, vgg, vit)
from bigdl_tpu_torch.models.lm_server import LMServer
from bigdl_tpu_torch.models.serving import ContinuousLMServer
from bigdl_tpu_torch.apps.transformer import synthetic_corpus
from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
from bigdl_tpu_torch.interop import load_torch, save_torch
from bigdl_tpu_torch.interop.hf import load_gpt2, load_hf_checkpoint
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.nn.criterion import FusedLMHeadCriterion
from bigdl_tpu_torch.nn.quantized import cast_model, quantize_model
from bigdl_tpu_torch.optim.evaluator import Evaluator
from bigdl_tpu_torch.optim.optimizer import Optimizer
from bigdl_tpu_torch.optim.triggers import Trigger
from bigdl_tpu_torch.scripts import roofline_hbm
from bigdl_tpu_torch.utils import file_io
from bigdl_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "bigdl_tpu_torch"
HF_FIXTURE = ROOT / "tests" / "resources" / "hf_tiny_gpt2"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import bigdl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                               "bigdl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the reference's own dependencies that the card machine lacks: the port
# reads and writes checkpoints and tokenizers with its own code
absent = ("jax", "bigdl_tpu", "safetensors", "ml_dtypes", "transformers",
          "regex")
bad = sorted(m for m in sys.modules if m.split(".")[0] in absent)
print(len(names), bad)
"""

_BAD_IMPORT = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+bigdl_tpu\b(?!_torch)"
    r"|from\s+bigdl_tpu\b(?!_torch)"
    r"|(import|from)\s+(safetensors|ml_dtypes|transformers|regex)\b)",
    re.MULTILINE)


def _tiny(device="cpu", **kw):
    return build_lm(50, embed_dim=64, num_heads=2, ffn_dim=64, num_layers=1,
                    max_len=16, tie_embeddings=True, device=device, **kw)


def test_importing_every_module_pulls_in_no_jax_or_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 25 and bad == "[]"


def test_new_subpackages_are_part_of_the_port():
    """The serving plane's subpackages ship inside the package and stand
    alone like the rest (the import check above walks them)."""
    for sub in ("telemetry", "resilience", "apps"):
        assert (PKG / sub / "__init__.py").is_file(), sub
    for mod in ("models/router.py", "nn/recurrent.py", "apps/common.py",
                "resilience/serving_drill.py", "resilience/__main__.py",
                "telemetry/registry.py", "telemetry/exposition.py",
                "telemetry/tracing.py", "telemetry/catalogue.py",
                "telemetry/profiling.py", "utils/cuda_graph.py",
                "interop/hf.py", "interop/hf_tokenizer.py",
                "utils/file_io.py", "resilience/coordinator.py",
                "optim/validation.py", "optim/metrics.py",
                "optim/evaluator.py", "models/lenet.py", "models/vgg.py",
                "models/inception.py", "models/alexnet.py", "nn/graph.py",
                "dataset/image.py", "dataset/mnist.py", "dataset/cifar.py",
                "utils/rng.py", "utils/table.py", "optim/validator.py",
                "apps/lenet.py", "apps/vgg.py", "apps/inception.py",
                "apps/resnet.py", "apps/perf.py", "models/vit.py",
                "models/rnn.py", "nn/reduce.py", "ops/remat.py",
                "dataset/device_cache.py", "nn/activation.py",
                "nn/containers.py", "nn/criterion.py", "nn/shape.py",
                "nn/linear.py", "nn/conv.py", "nn/pooling.py",
                "nn/normalization.py", "nn/regularization.py",
                "nn/initialization.py", "nn/detection.py", "nn/module.py",
                "nn/quantized.py", "optim/methods.py",
                "models/autoencoder.py", "apps/autoencoder.py",
                "utils/logger_filter.py", "native/__init__.py",
                "dataset/shards.py", "interop/prototxt.py",
                "interop/caffe.py", "interop/torch_file.py",
                "apps/seqfilegen.py", "apps/modelvalidator.py",
                "apps/imageclassifier.py", "apps/udfpredictor.py",
                "utils/digraph.py", "utils/engine.py",
                "utils/sharded_checkpoint.py", "dataset/ingest/__init__.py",
                "dataset/ingest/reorder.py", "dataset/ingest/engine.py",
                "dataset/ingest/dataset.py", "apps/ingest_bench.py",
                "telemetry/scoreboard.py", "telemetry/__main__.py"):
        text = (PKG / mod).read_text()
        assert "bigdl_tpu/" in text.split('"""')[1], mod  # names its mirror


def test_sources_import_no_jax_or_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _BAD_IMPORT.search(f.read_text())]
    assert offenders == []


def test_scan_pattern_catches_reference_imports():
    for line in ("import jax", "from jax import numpy", "import bigdl_tpu",
                 "from bigdl_tpu.nn import Linear", "  import jax.numpy as jnp",
                 "from safetensors.numpy import load_file",
                 "import ml_dtypes", "from transformers import AutoModel",
                 "import regex"):
        assert _BAD_IMPORT.search(line), line
    for line in ("import bigdl_tpu_torch", "from bigdl_tpu_torch.nn import x"):
        assert not _BAD_IMPORT.search(line), line


def test_kernel_sources_exist_and_name_what_they_replace():
    fa = "bigdl_tpu/ops/flash_attention.py"
    for name, refs in (("flash_fwd", (fa, "_fwd_kernel")),
                       ("flash_bwd", (fa, "_bwd_dq_kernel", "_bwd_dkv_kernel")),
                       ("int8_matmul", ("bigdl_tpu/ops/int8_matmul.py",)),
                       ("matmul_bn", ("bigdl_tpu/ops/matmul_bn.py",
                                      "matmul_with_stats")),
                       ("conv3x3_bn", ("bigdl_tpu/ops/conv3x3_bn.py",
                                       "conv3x3_with_stats")),
                       ("hbm_roof", ("scripts/roofline_pallas.py",
                                     "bench_auto", "bench_manual",
                                     "bench_hbm_dma"))):
        text = (PKG / "csrc" / f"{name}.cu").read_text()
        assert all(ref in text for ref in refs) and "sm_90a" in text


def _require_no_card():
    # decided inside the test: the entry points must refuse only when there
    # is no card to run on
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    _require_no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()


def test_build_lm_raises_without_card():
    _require_no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _tiny(device="cuda")
    with pytest.raises(RuntimeError):
        build_lm(50, embed_dim=64, num_heads=2, ffn_dim=64, num_layers=1,
                 tie_embeddings=True)


@pytest.mark.parametrize("entry", ["generate", "LMServer",
                                   "ContinuousLMServer", "quantize_model",
                                   "cast_model", "Optimizer", "resnet.build",
                                   "resnet.build_cifar", "roofline_hbm.main",
                                   "generate_speculative", "run_kill_drill",
                                   "transformer.main",
                                   "Optimizer.set_steps_per_dispatch",
                                   "load_hf_checkpoint", "load_gpt2",
                                   "Evaluator", "file_io.load",
                                   "transformer.main generate --model",
                                   "transformer.main serve --draft",
                                   "lenet.build", "lenet.graph", "vgg.build",
                                   "vgg.build_imagenet", "inception.build",
                                   "inception.build_v2", "alexnet.build",
                                   "lenet.main train", "lenet.main test",
                                   "vgg.main train", "resnet.main train",
                                   "inception.main train", "vit.build",
                                   "rnn.build", "rnn.build_classifier",
                                   "DeviceCachedDataSet", "perf.main",
                                   "autoencoder.build",
                                   "autoencoder.main train",
                                   "autoencoder.optimizer", "load_torch",
                                   "modelvalidator.main",
                                   "imageclassifier.main",
                                   "udfpredictor.run",
                                   "inception.main train --folder",
                                   "Engine.init", "PrefetchingDataSet",
                                   "ingest_bench.main train",
                                   "ingest_bench.main pipeline",
                                   "scoreboard.run",
                                   "telemetry.main scoreboard"])
def test_entry_points_raise_without_card(entry, tmp_path):
    _require_no_card()
    model = _tiny().evaluate_mode()
    saved = str(tmp_path / "model_final")
    file_io.save(model, saved)
    t7 = str(tmp_path / "model.t7")
    save_torch(nn.Sequential().add(nn.Linear(3, 2)), t7)
    bundle = str(tmp_path / "classifier_bundle")
    file_io.save({"model": model, "word2index": {"a": 0},
                  "embeddings": np.zeros((2, 4), np.float32), "seq_len": 4},
                 bundle)
    calls = {
        "generate": lambda: generate(model, np.ones((1, 3)), 2, greedy=True),
        "LMServer": lambda: LMServer(model, greedy=True),
        "ContinuousLMServer": lambda: ContinuousLMServer(
            _tiny(rope=True).evaluate_mode(), greedy=True),
        "quantize_model": lambda: quantize_model(model),
        "cast_model": lambda: cast_model(model),
        "Optimizer": lambda: Optimizer(
            model, DataSet.array(synthetic_corpus(2, 4, 50)) >> SampleToBatch(2),
            FusedLMHeadCriterion()),
        "resnet.build": lambda: resnet.build(10, 18),
        "resnet.build_cifar": lambda: resnet.build_cifar(10, 8),
        "roofline_hbm.main": lambda: roofline_hbm.main(["--gib", "1"]),
        "generate_speculative": lambda: generate_speculative(
            model, _tiny().evaluate_mode(), np.ones((1, 3)), 2),
        "run_kill_drill": lambda: run_kill_drill(requests=2),
        # the CLI's --device default: every subcommand goes to the card
        "transformer.main": lambda: transformer_app.main(
            ["generate", "--maxNewTokens", "2"]),
        # k > 1 windows: CUDA graphs of k steps on the card
        "Optimizer.set_steps_per_dispatch": lambda: Optimizer(
            model, DataSet.array(synthetic_corpus(2, 4, 50)) >> SampleToBatch(2),
            FusedLMHeadCriterion()).set_steps_per_dispatch(4).optimize(),
        # a loaded checkpoint lands on the card
        "load_hf_checkpoint": lambda: load_hf_checkpoint(str(HF_FIXTURE)),
        "load_gpt2": lambda: load_gpt2(
            json.loads((HF_FIXTURE / "config.json").read_text()), {}),
        # a saved module, evaluated or loaded, lands on the card
        "Evaluator": lambda: Evaluator(model),
        "file_io.load": lambda: file_io.load(saved),
        "transformer.main generate --model": lambda: transformer_app.main(
            ["generate", "--model", saved, "--maxNewTokens", "2"]),
        "transformer.main serve --draft": lambda: transformer_app.main(
            ["serve", "--continuous", "--model", saved, "--draft", saved]),
        # the conv zoo's builders and apps
        "lenet.build": lambda: lenet.build(10),
        "lenet.graph": lambda: lenet.graph(10),
        "vgg.build": lambda: vgg.build(10),
        "vgg.build_imagenet": lambda: vgg.build_imagenet(1000, 16),
        "inception.build": lambda: inception.build(1000),
        "inception.build_v2": lambda: inception.build_v2(1000),
        "alexnet.build": lambda: alexnet.build(1000),
        "lenet.main train": lambda: lenet_app.main(
            ["train", "--synthetic-size", "8", "-b", "4"]),
        "lenet.main test": lambda: lenet_app.main(["test", "--model", saved]),
        "vgg.main train": lambda: vgg_app.main(
            ["train", "--synthetic-size", "8", "-b", "4"]),
        "resnet.main train": lambda: resnet_app.main(
            ["train", "--synthetic-size", "8", "-b", "4", "--depth", "8"]),
        "inception.main train": lambda: inception_app.main(
            ["train", "--synthetic-size", "2", "-b", "2"]),
        # the throughput harness and what it drives
        "vit.build": lambda: vit.build(10, image_size=32, patch_size=8),
        "rnn.build": lambda: rnn.build(4, 4, 4),
        "rnn.build_classifier": lambda: rnn.build_classifier(10, 4, 4, 2),
        "DeviceCachedDataSet": lambda: DeviceCachedDataSet(
            DataSet.array(synthetic_corpus(2, 4, 50)), 2),
        "perf.main": lambda: perf_app.main(["--model", "lenet5", "-b", "2",
                                            "-i", "1"]),
        # the layer zoo's app
        "autoencoder.build": lambda: autoencoder.build(),
        "autoencoder.main train": lambda: autoencoder_app.main(
            ["train", "--synthetic-size", "8", "-b", "4"]),
        "autoencoder.optimizer": lambda: autoencoder_app.optimizer(
            ["--synthetic-size", "8", "-b", "4"]),
        # model files and image ingestion
        "load_torch": lambda: load_torch(t7),
        "modelvalidator.main": lambda: modelvalidator.main(
            ["-f", str(tmp_path), "-m", "alexnet", "-t", "bigdl",
             "--modelPath", saved]),
        "imageclassifier.main": lambda: imageclassifier.main(
            ["-f", str(tmp_path), "-m", "alexnet", "-t", "torch",
             "--modelPath", t7]),
        "udfpredictor.run": lambda: udfpredictor.run(
            ["--modelPath", bundle, "-f", str(tmp_path)]),
        "inception.main train --folder": lambda: inception_app.main(
            ["train", "--folder", str(tmp_path), "-b", "2"]),
        # the platform planes: topology, the ingest engine's device feed,
        # its benchmark and the serving scoreboard
        "Engine.init": lambda: Engine.init(),
        "PrefetchingDataSet": lambda: next(iter(PrefetchingDataSet(
            [], NativeBGRBatchDecoder(4, 4, 2, (0.0,) * 3, (1.0,) * 3)
        ).data(train=True))),
        "ingest_bench.main train": lambda: ingest_bench.main(
            ["train", "-s", str(tmp_path), "-b", "2"]),
        "ingest_bench.main pipeline": lambda: ingest_bench.main(
            ["pipeline", "-s", str(tmp_path), "-b", "2"]),
        "scoreboard.run": lambda: scoreboard.run(scoreboard.ScoreboardConfig(
            slots=[1], requests=1)),
        "telemetry.main scoreboard": lambda: telemetry_cli.main(
            ["scoreboard", "--slots", "1", "--requests", "1"]),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_entry_points_run_when_cpu_is_asked_for(tmp_path):
    model = _tiny().evaluate_mode()
    out = generate(model, np.ones((1, 3)), 2, greedy=True, device="cpu")
    assert out.shape == (1, 5)
    assert quantize_model(model, device="cpu") is not model
    assert cast_model(model, device="cpu") is not model
    server = ContinuousLMServer(_tiny(rope=True).evaluate_mode(), slots=1,
                                max_len=8, greedy=True, device="cpu")
    try:
        assert len(server.submit([1, 2], 2, timeout=60)) == 2
    finally:
        server.close()
    loaded = load_hf_checkpoint(str(HF_FIXTURE), device="cpu")
    assert next(loaded.parameters()).device.type == "cpu"
    opt = Optimizer(_tiny(), DataSet.array(synthetic_corpus(4, 4, 50))
                    >> SampleToBatch(2), FusedLMHeadCriterion(), device="cpu")
    opt.set_steps_per_dispatch(2).set_end_when(Trigger.max_iteration(4))
    opt.optimize()
    assert [h["neval"] for h in opt.history] == [1, 2, 3, 4]
    net = resnet.build_cifar(10, 8, device="cpu").evaluate_mode()
    assert net(torch.zeros(1, 32, 32, 3)).shape == (1, 10)
    assert Evaluator(net, device="cpu").device.type == "cpu"
    file_io.save(net, str(tmp_path / "net"))
    loaded = file_io.load(str(tmp_path / "net"), device="cpu")
    assert next(loaded.parameters()).device.type == "cpu"
    assert next(resnet.build(10, 18, device="cpu").parameters()).device.type \
        == "cpu"
    ae = autoencoder_app.optimizer(["--synthetic-size", "8", "-b", "4",
                                    "--device", "cpu"])
    assert ae.device.type == "cpu"
    assert next(autoencoder.build(device="cpu").parameters()).device.type \
        == "cpu"


def test_chip_smoke_refuses_to_run_without_card():
    _require_no_card()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
