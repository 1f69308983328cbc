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
``models.generation.generate`` -> ``models.lm_server.LMServer``.

Trained today: ``build_lm`` -> ``optim.Optimizer(model, dataset,
nn.FusedLMHeadCriterion())`` with ``AdamW``, ``set_precision("bf16")`` and
gradient clipping -> ``optimize()``; and ``models.resnet.build`` (ResNet-50,
NHWC, with the fused conv+BN kernels behind ``BIGDL_TPU_FUSED_1X1`` /
``BIGDL_TPU_FUSED_3X3``) -> ``Optimizer(model, dataset,
nn.ClassNLLCriterion())`` with ``SGD`` -> ``optimize()``.
"""

__version__ = "0.1.0"
