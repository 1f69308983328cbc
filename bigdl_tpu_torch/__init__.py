"""bigdl_tpu_torch: the PyTorch and CUDA port of ``bigdl_tpu`` for NVIDIA Hopper.

The package mirrors ``bigdl_tpu``'s module paths and public names, so each
port file has a counterpart of the same name in the JAX package, which stays
the reference. It imports ``torch`` and ``numpy`` only: never ``jax`` and
nothing of ``bigdl_tpu``.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``;
without a card it raises unless ``device="cpu"`` is asked for. The kernels
are CUDA C++ under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``). On CPU tensors each kernel's wrapper runs the kernel's
plain PyTorch version.

Served today: ``models.transformer.build_lm`` ->
``nn.quantized.quantize_model`` / ``cast_model`` ->
``models.generation.generate`` (beam search too) and
``generate_speculative`` -> ``models.lm_server.LMServer`` or
``models.serving.ContinuousLMServer``, alone or as a fleet behind
``models.router.LMRouter``, with ``telemetry`` (``GET /metrics``) and the
serving chaos injectors of ``resilience``; ``python -m
bigdl_tpu_torch.apps.transformer train|generate|serve`` on the command
line.

Trained today: ``build_lm`` -> ``optim.Optimizer(model, dataset,
nn.FusedLMHeadCriterion())`` with ``AdamW``, ``set_precision("bf16")`` and
gradient clipping -> ``optimize()``; and ``models.resnet.build`` (ResNet-50,
NHWC, with the fused conv+BN kernels behind ``BIGDL_TPU_FUSED_1X1`` /
``BIGDL_TPU_FUSED_3X3``) -> ``Optimizer(model, dataset,
nn.ClassNLLCriterion())`` with ``SGD`` -> ``optimize()``; either with
``set_checkpoint``, ``set_validation`` (``optim.validation``,
``optim.evaluator``), ``set_preemption_handler`` and ``auto_resume`` over
``utils.file_io`` and ``resilience.coordinator``.

Text: ``dataset.text``, ``dataset.bpe.BPETokenizer`` and
``interop.sentencepiece``; TensorBoard summaries: ``visualization``; the
Torch-style ``Tensor``; scikit-learn-style estimators: ``ml``.

Platform: the staged ingest engine (``dataset.ingest``), the compile
flight recorder, MFU and the serving scoreboard (``telemetry``; ``python -m
bigdl_tpu_torch.telemetry``), sharded snapshots
(``utils.sharded_checkpoint``) and the process topology (``Engine``).

Data-parallel: ``parallel`` (``DistriOptimizer`` over a
``torch.distributed`` group in ``allreduce``, ZeRO-1 ``sharded`` or ZeRO-3
``fsdp`` mode, with synchronized batch norm), which ``Optimizer`` takes
for a distributed dataset.
"""

__version__ = "0.1.0"

__all__ = ["Engine", "Tensor", "ml", "visualization", "__version__"]


def __getattr__(name):
    """``Engine``, ``Tensor``, ``ml`` and ``visualization`` load on first
    use, so that importing the package alone (``resilience validate``)
    does not import torch."""
    import importlib
    if name == "Engine":
        return importlib.import_module("bigdl_tpu_torch.utils.engine").Engine
    if name == "Tensor":
        return importlib.import_module("bigdl_tpu_torch.tensor").Tensor
    if name in ("ml", "visualization"):
        return importlib.import_module(f"bigdl_tpu_torch.{name}")
    raise AttributeError(f"module 'bigdl_tpu_torch' has no attribute {name!r}")
