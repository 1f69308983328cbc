"""The port's checkpoint IO (``bigdl_tpu_torch/utils/file_io.py``) against
the reference's ``bigdl_tpu/utils/file_io.py``, on the CPU.

``TestSchemes`` mirrors ``tests/test_file_io.py`` case by case. The
``gs://`` and ``hdfs://`` cases hide the client library from the import,
so the explicit error is the "client absent" one and nothing reaches for
a network. ``TestModules`` adds what the port's tensors need: a whole
module (f32, its int8 and bf16 twins, BN's running statistics) saved and
loaded bit-equal, and the reference's snapshot format read both ways: a
``{"params", "buffers"}`` snapshot written by the reference is carried
into the port's LM through ``interop/state_dict.py`` and its forward
matches the reference's within the LM parity tolerance of
``test_torch_lm_slice.py``.
"""

import sys

import numpy as np
import pytest
import torch

from bigdl_tpu.models import transformer as jax_transformer
from bigdl_tpu.utils import file_io as jax_file_io
from bigdl_tpu.utils.rng import manual_seed
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset.base import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.interop.state_dict import flatten_tree, import_tree_state
from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.nn.quantized import cast_model, quantize_model
from bigdl_tpu_torch.optim import Optimizer, Trigger
from bigdl_tpu_torch.resilience import coordinator
from bigdl_tpu_torch.utils import file_io

V = 96
LLAMA = dict(embed_dim=32, num_heads=4, num_kv_heads=2, ffn_dim=64,
             num_layers=2, max_len=32, rope=True, activation="swiglu",
             norm="rms", bias=False, tie_embeddings=True)
LOGPROB_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread_and_clean_mem():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    file_io.clear_mem_store()
    yield
    file_io.clear_mem_store()
    torch.set_num_threads(threads)


class TestSchemes:
    def test_mem_round_trip(self):
        obj = {"w": np.arange(6.0).reshape(2, 3), "meta": "x"}
        file_io.save(obj, "mem://ckpt/model")
        back = file_io.load("mem://ckpt/model")
        assert np.allclose(back["w"], obj["w"]) and back["meta"] == "x"

    def test_mem_exists_listdir_mtime(self):
        assert not file_io.exists("mem://d/a")
        file_io.save(1, "mem://d/a")
        file_io.save(2, "mem://d/b")
        assert file_io.exists("mem://d/a")
        assert file_io.listdir("mem://d") == ["a", "b"]
        assert (file_io.getmtime("mem://d/b")
                > file_io.getmtime("mem://d/a"))

    def test_overwrite_false_respected_on_scheme(self):
        file_io.save(1, "mem://d/a")
        with pytest.raises(FileExistsError):
            file_io.save(2, "mem://d/a", overwrite=False)

    def test_missing_mem_file(self):
        with pytest.raises(FileNotFoundError):
            file_io.load("mem://nope")

    def test_unregistered_scheme_rejected(self):
        with pytest.raises(ValueError, match="no handler registered"):
            file_io.save(1, "s3://nn/ckpt")

    def test_hdfs_registered_and_explicit_without_client(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "fsspec", None)
        with pytest.raises(RuntimeError, match="Hadoop"):
            file_io.load("hdfs://namenode:9000/ckpt/model.1")

    def test_gs_without_client_is_explicit(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "google.cloud.storage", None)
        file_io._gcs_client.cache_clear()
        try:
            with pytest.raises(RuntimeError, match="google-cloud-storage"):
                file_io.load("gs://bucket/ckpt")
        finally:
            file_io._gcs_client.cache_clear()

    def test_file_uri_is_local(self, tmp_path):
        file_io.save({"a": 3}, f"file://{tmp_path}/x")
        assert file_io.load(str(tmp_path / "x"))["a"] == 3

    def test_join(self):
        assert file_io.join("mem://c/", "model.5") == "mem://c/model.5"
        assert file_io.join("/tmp/ck", "model") == "/tmp/ck/model"

    def test_failed_save_does_not_clobber(self):
        file_io.save({"ok": 1}, "mem://d/model")

        class Unpicklable:
            def __reduce__(self):
                raise RuntimeError("nope")

        with pytest.raises(RuntimeError):
            file_io.save({"bad": Unpicklable()}, "mem://d/model")
        assert file_io.load("mem://d/model")["ok"] == 1

    def test_exists_without_hook_is_loud(self):
        file_io.register_scheme("nohook", lambda p, m: None)
        with pytest.raises(NotImplementedError):
            file_io.save(1, "nohook://x/y", overwrite=False)

    def test_not_a_checkpoint(self, tmp_path):
        (tmp_path / "x").write_bytes(b"PK\x03\x04 something else")
        with pytest.raises(ValueError, match="not a bigdl_tpu checkpoint"):
            file_io.load(str(tmp_path / "x"))

    def test_save_reports_size_and_crc(self, tmp_path):
        info = file_io.save({"w": np.ones(8, np.float32)},
                            str(tmp_path / "m"))
        assert info == coordinator._digest(str(tmp_path / "m"))
        assert info["bytes"] == (tmp_path / "m").stat().st_size


class TestRemoteCheckpointTraining:
    def _pieces(self):
        rng = np.random.RandomState(0)
        samples = [Sample(rng.randn(4).astype(np.float32),
                          np.float32(rng.randint(0, 2) + 1))
                   for _ in range(64)]
        ds = DataSet.array(samples, seed=0) >> SampleToBatch(16)
        model = (nn.Sequential().add(nn.Linear(4, 8)).add(nn.ReLU())
                 .add(nn.Linear(8, 2)).add(nn.LogSoftMax()))
        return model, ds

    def test_checkpoint_and_resume_via_mem_scheme(self):
        model, ds = self._pieces()
        opt = Optimizer(model, ds, nn.ClassNLLCriterion(), device="cpu")
        opt.set_checkpoint("mem://ck/run1", Trigger.every_epoch())
        opt.set_end_when(Trigger.max_epoch(2))
        opt.optimize()
        names = file_io.listdir("mem://ck/run1")
        assert any(n.startswith("model.") for n in names)
        assert any(n.startswith("state.") for n in names)
        # discovery works on the scheme (markers are local-filesystem only)
        point = coordinator.latest_resume_point("mem://ck/run1")
        assert point is not None and point.model_path.startswith(
            "mem://ck/run1/") and point.marker is None

        model2, ds2 = self._pieces()
        opt2 = Optimizer(model2, ds2, nn.ClassNLLCriterion(), device="cpu")
        opt2.resume(point.model_path, point.state_path)
        opt2.set_end_when(Trigger.max_epoch(3))
        assert opt2.optimize() is model2
        # epoch-granular: the resumed run trains epoch 3 only
        assert [h["epoch"] for h in opt2.history] == [3] * 4


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def _assert_same_state(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


class TestModules:
    @pytest.mark.parametrize("twin", ["f32", "int8", "bf16"])
    def test_lm_and_twins_round_trip_bit_equal(self, twin, tmp_path):
        model = build_lm(V, **LLAMA, device="cpu", seed=3).evaluate_mode()
        if twin == "int8":
            model = quantize_model(model, device="cpu")
        elif twin == "bf16":
            model = cast_model(model, device="cpu")
        path = str(tmp_path / "model_final")
        file_io.save(model, path)
        loaded = file_io.load(path, device="cpu")
        assert type(loaded) is type(model) and loaded is not model
        _assert_same_state(_state(loaded), _state(model))
        ids = torch.as_tensor(np.random.default_rng(1).integers(1, V + 1,
                                                                (2, 8)))
        with torch.no_grad():
            assert torch.equal(loaded.evaluate_mode()(ids), model(ids))
        if twin == "int8":
            kinds = {str(b.dtype) for b in loaded.buffers()}
            assert "torch.int8" in kinds   # the quantized weights
        if twin == "bf16":
            assert {b.dtype for b in loaded.buffers()} >= {torch.bfloat16}

    def test_bn_running_statistics_survive(self, tmp_path):
        net = resnet.build_cifar(10, 8, device="cpu")
        net.train()
        x = torch.as_tensor(np.random.default_rng(2).standard_normal(
            (4, 32, 32, 3)).astype(np.float32))
        with torch.no_grad():
            net(x)   # moves the running statistics off their init
        file_io.save(net, str(tmp_path / "net"))
        loaded = file_io.load(str(tmp_path / "net"), device="cpu")
        _assert_same_state(_state(loaded), _state(net))
        stats = [n for n, _ in net.named_buffers()]
        assert stats and all(not torch.equal(b, torch.zeros_like(b))
                             for n, b in loaded.named_buffers()
                             if n.endswith("running_var"))
        net.evaluate_mode()
        with torch.no_grad():
            assert torch.equal(loaded.evaluate_mode()(x), net(x))

    def test_parameters_stay_parameters_and_dropout_reseeds(self, tmp_path):
        model = build_lm(V, **LLAMA, dropout=0.1, device="cpu", seed=5)
        drops = [m for m in model.modules() if isinstance(m, nn.Dropout)]
        for i, m in enumerate(drops):
            m.manual_seed(10 + i)
        model.train()
        model(torch.ones((1, 4), dtype=torch.long))   # generators made
        file_io.save(model, str(tmp_path / "m"))
        loaded = file_io.load(str(tmp_path / "m"), device="cpu")
        assert all(isinstance(p, torch.nn.Parameter) and p.requires_grad
                   for p in loaded.parameters())
        got = [m for m in loaded.modules() if isinstance(m, nn.Dropout)]
        assert [m.seed for m in got] == [m.seed for m in drops]
        assert all(m._generator is None for m in got)

    def test_trees_load_as_host_numpy(self, tmp_path):
        tree = {"a": torch.arange(4.0), "b": [torch.ones(2,
                                                        dtype=torch.bfloat16)],
                "c": (torch.zeros(3, dtype=torch.int8), 7)}
        file_io.save(tree, str(tmp_path / "t"))
        back = file_io.load(str(tmp_path / "t"))
        assert isinstance(back["a"], np.ndarray)
        assert back["b"][0].dtype == np.float32     # bf16 widened, exact
        assert back["c"][0].dtype == np.int8 and back["c"][1] == 7
        # the reference reads the port's tree files as they are
        ref = jax_file_io.load(str(tmp_path / "t"))
        np.testing.assert_array_equal(ref["a"], back["a"])

    def test_module_load_defaults_to_the_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        file_io.save(build_lm(V, **LLAMA, device="cpu", seed=1),
                     str(tmp_path / "m"))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            file_io.load(str(tmp_path / "m"))
        # a host tree needs no device
        file_io.save({"w": np.zeros(2)}, str(tmp_path / "t"))
        assert file_io.load(str(tmp_path / "t"))["w"].shape == (2,)

    def test_reference_snapshot_carried_into_the_port_lm(self, tmp_path):
        manual_seed(11)
        jmodel = jax_transformer.build_lm(V, **LLAMA).evaluate_mode()
        path = str(tmp_path / "model.7")
        jax_file_io.save({"params": jmodel.parameter_tree(),
                          "buffers": jmodel.buffer_tree()}, path)
        snap = file_io.load(path, device="cpu")
        tmodel = build_lm(V, **LLAMA, device="cpu", seed=0)
        import_tree_state(tmodel, flatten_tree(snap["params"]),
                          flatten_tree(snap["buffers"]))
        ids = np.random.default_rng(4).integers(1, V + 1, (2, 12))
        want = np.asarray(jmodel.predict(ids.astype(np.float32)))
        with torch.no_grad():
            got = tmodel.evaluate_mode()(torch.as_tensor(ids)).numpy()
        np.testing.assert_allclose(got, want, **LOGPROB_TOL)
