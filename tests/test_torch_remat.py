"""``Optimizer.set_remat`` (``ops/remat.py``) on the CPU.

Each policy trains the same model from the same seed as the run without
recomputation, and the losses, the updated parameters and the running
statistics are equal bit for bit: a recomputed forward on the CPU runs the
same operations on the same inputs, and the dropout masks it needs are the
ones its forward drew (replayed, not redrawn). Held for a 2-layer LM with
dropout 0.1 (residual and attention-probability dropout) under ``True``,
``"full"`` and ``"block"``, and for a CIFAR ResNet with both fusion gates
(the fused 3x3 and 1x1 conv+BN ops) under ``True`` and ``"conv"``.

The recomputation is counted by the structure: under ``"block"`` each
encoder layer runs twice a step; under ``"conv"`` the fused conv ops run
once a step, as without remat (their outputs are kept), and under
``"full"`` twice. ``"block"`` on a model without a ``TransformerEncoder``
and an unknown policy raise the reference's ``ValueError``s.
"""

import collections

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.apps.transformer import synthetic_corpus
from bigdl_tpu_torch.dataset.base import DataSet, MiniBatch, SampleToBatch
from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.nn.attention import TransformerEncoderLayer
from bigdl_tpu_torch.ops import conv3x3_bn, conv_bn, remat
from bigdl_tpu_torch.optim import SGD, AdamW, Optimizer, Trigger

V, B, S = 64, 4, 16


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lm_run(policy, steps=3):
    model = build_lm(V, embed_dim=32, num_heads=2, ffn_dim=64, num_layers=2,
                     max_len=S, dropout=0.1, fused_head=True, device="cpu",
                     seed=3)
    ds = DataSet.array(synthetic_corpus(2 * B, S, V), seed=4) \
        >> SampleToBatch(B)
    opt = Optimizer(model, ds, nn.FusedLMHeadCriterion(), device="cpu",
                    seed=5)
    opt.set_optim_method(AdamW(learningrate=1e-2)) \
       .set_end_when(Trigger.max_iteration(steps))
    if policy is not None:
        opt.set_remat(policy)
    opt.optimize()
    return ([h["loss"] for h in opt.history],
            {n: p.detach().clone() for n, p in model.named_parameters()})


def _equal(run, ref):
    assert run[0] == ref[0]
    for name, p in ref[1].items():
        assert torch.equal(run[1][name], p), name


@pytest.fixture(scope="module")
def lm_plain():
    return _lm_run(None)


@pytest.mark.parametrize("policy", [True, "full", "block"])
def test_lm_with_dropout_trains_bit_equal(policy, lm_plain):
    _equal(_lm_run(policy), lm_plain)


def test_block_recomputes_each_layer_once(monkeypatch):
    calls = collections.Counter()
    orig = TransformerEncoderLayer.forward

    def counted(self, x):
        calls["layer"] += 1
        return orig(self, x)

    monkeypatch.setattr(TransformerEncoderLayer, "forward", counted)
    _lm_run(None, steps=2)
    plain = calls["layer"]
    calls.clear()
    _lm_run("block", steps=2)
    assert plain == 2 * 2 and calls["layer"] == 2 * plain


def _resnet_run(policy, monkeypatch, counts):
    monkeypatch.setenv("BIGDL_TPU_FUSED_1X1", "1")
    monkeypatch.setenv("BIGDL_TPU_FUSED_3X3", "1")
    model = resnet.build_cifar(10, 8, shortcut_type="B", device="cpu",
                               seed=6)
    rng = np.random.default_rng(7)
    batches = [MiniBatch(rng.standard_normal((B, 32, 32, 3)).astype(
        np.float32), rng.integers(1, 11, (B,)).astype(np.float32))
        for _ in range(2)]
    opt = Optimizer(model, DataSet.array(batches, seed=8),
                    nn.ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(SGD(learningrate=0.1, momentum=0.9)) \
       .set_end_when(Trigger.max_iteration(2))
    if policy is not None:
        opt.set_remat(policy)
    counts.clear()
    opt.optimize()
    state = {n: t.detach().clone() for n, t in
             [*model.named_parameters(), *model.named_buffers()]}
    return [h["loss"] for h in opt.history], state


def test_fused_resnet_trains_bit_equal_and_conv_keeps_the_kernels(
        monkeypatch):
    counts = collections.Counter()
    for mod, name in ((conv_bn, "matmul_with_stats"),
                      (conv3x3_bn, "conv3x3_with_stats")):
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _name=name):
            counts[_name] += 1
            return _orig(*a)

        monkeypatch.setattr(mod, name, counted)
    plain = _resnet_run(None, monkeypatch, counts)
    per_step = dict(counts)
    # the CIFAR ResNet-8 with shortcut B, a step: 5 fused 3x3 (the stem,
    # stage 1's two, the stride-1 second conv of stages 2 and 3; the
    # stride-2 firsts are plain convs) and 2 fused 1x1 projections
    assert per_step == {"conv3x3_with_stats": 2 * 5,
                        "matmul_with_stats": 2 * 2}
    conv = _resnet_run("conv", monkeypatch, counts)
    assert dict(counts) == per_step          # kept, never relaunched
    _equal(conv, plain)
    full = _resnet_run(True, monkeypatch, counts)
    assert dict(counts) == {k: 2 * n for k, n in per_step.items()}
    _equal(full, plain)


def test_recomputation_replays_the_forwards_masks():
    """The region's masks: a recomputed forward draws nothing."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 8, requires_grad=True)
    drawn = []

    def body(t):
        state = gen.get_state()
        out = nn.regularization.drop(t, 0.5, gen)
        drawn.append(not torch.equal(state, gen.get_state()))
        return (out * out).sum()

    remat.checkpoint(body, x).backward()
    assert drawn == [True, False]   # forward drew, the recomputation did not
    ref = x.grad.clone()
    x.grad = None
    gen.manual_seed(0)
    (lambda t: (nn.regularization.drop(t, 0.5, gen) ** 2).sum())(x).backward()
    assert torch.equal(x.grad, ref)


def test_block_needs_a_transformer_encoder():
    model = resnet.build_cifar(10, 8, device="cpu")
    opt = Optimizer(model, DataSet.array([]), nn.ClassNLLCriterion(),
                    device="cpu")
    with pytest.raises(ValueError, match="TransformerEncoder"):
        opt.set_remat("block")
    with pytest.raises(ValueError, match="unknown remat policy"):
        opt.set_remat("gibberish")
    assert opt.set_remat("conv") is opt and opt.set_remat(False) is opt


def test_set_remat_resets_the_block_flags():
    model = build_lm(V, embed_dim=32, num_heads=2, ffn_dim=64, num_layers=2,
                     max_len=S, fused_head=True, device="cpu", seed=3)
    enc = next(m for m in model.modules()
               if isinstance(m, nn.TransformerEncoder))
    opt = Optimizer(model, DataSet.array([]), nn.FusedLMHeadCriterion(),
                    device="cpu")
    opt.set_remat("block")
    assert enc.remat_blocks and opt._remat is False
    opt.set_remat("full")
    assert not enc.remat_blocks and opt._remat is True
