"""Class by class, the port has the reference's public methods.

For every public class of ``bigdl_tpu`` (``analysis`` aside: the port's
analyser has its own rules) whose module and name exist in
``bigdl_tpu_torch``, each public callable or property of the reference
class, inherited ones included, must exist on the port's class. The only
exceptions are ``BY_DESIGN``: JAX plumbing with no counterpart, one
reason each. A method that the reference gains and the port lacks fails
here.
"""

import importlib
import inspect
import pkgutil

import pytest

import bigdl_tpu

#: (reference class or ``*`` for every class, name) -> why the port has
#: no counterpart
BY_DESIGN = {
    ("*", "rng_key"): "a key from the bound jax.random stream; the port's "
                      "modules draw from torch generators of their own",
    ("*", "update_output"): "the reference's forward body under "
                            "functional_apply; port modules implement "
                            "torch's forward",
    ("bigdl_tpu.tensor.tensor.Tensor", "to_jax"):
        "the JAX array of a Tensor; the port's Tensor holds a torch tensor",
    ("bigdl_tpu.telemetry.profiling.TrackedJit", "lower"):
        "the jit program's XLA lowering; the port's tracked sites run eager "
        "PyTorch",
    ("bigdl_tpu.utils.rng.RandomGenerator", "next_key"):
        "splits a jax.random key; the port's markers hold torch generator "
        "states",
    ("bigdl_tpu.utils.rng.RandomGenerator", "get_key_state"):
        "the jax.random key's state, as above",
    ("bigdl_tpu.utils.rng.RandomGenerator", "set_key_state"):
        "the jax.random key's state, as above",
    ("bigdl_tpu.parallel.pipeline.StagePipeline", "spec"):
        "a jax.sharding PartitionSpec for the stacked parameters; the port "
        "slices them with local_slices",
}


def _pairs():
    """(reference module name, class name, reference class, port class)."""
    out = []
    for info in pkgutil.walk_packages(bigdl_tpu.__path__, "bigdl_tpu."):
        name = info.name
        if name.startswith("bigdl_tpu.analysis"):
            continue
        try:
            ref = importlib.import_module(name)
        except ImportError:   # the reference's prebuilt native library
            continue
        try:
            port = importlib.import_module(
                "bigdl_tpu_torch" + name[len("bigdl_tpu"):])
        except ImportError:
            continue
        for cname, cls in vars(ref).items():
            if cname.startswith("_") or not inspect.isclass(cls) \
                    or cls.__module__ != name:
                continue
            pcls = getattr(port, cname, None)
            if inspect.isclass(pcls):
                out.append((name, cname, cls, pcls))
    return out


def _public(cls):
    names = []
    for a in dir(cls):
        if a.startswith("_"):
            continue
        static = inspect.getattr_static(cls, a, None)
        if callable(getattr(cls, a, None)) or isinstance(static, property):
            names.append(a)
    return names


PAIRS = _pairs()


def test_every_compared_class_has_the_reference_methods():
    assert len(PAIRS) > 300   # the inventory covers the whole package
    missing = []
    for mod, cname, cls, pcls in PAIRS:
        for a in _public(cls):
            if hasattr(pcls, a):
                continue
            if ("*", a) in BY_DESIGN or (f"{mod}.{cname}", a) in BY_DESIGN:
                continue
            missing.append(f"{mod}.{cname}.{a}")
    assert not missing, missing


@pytest.mark.parametrize("key", sorted(BY_DESIGN))
def test_each_exception_is_still_missing_and_named(key):
    """An entry goes once the port gains the name, or the reference loses
    it."""
    cls_name, attr = key
    assert BY_DESIGN[key]
    hits = [(mod, c, cls, p) for mod, c, cls, p in PAIRS
            if cls_name in ("*", f"{mod}.{c}") and attr in _public(cls)]
    assert hits, key
    assert any(not hasattr(p, attr) for *_, p in hits), key


def test_the_module_base_has_the_whole_instance_surface():
    from bigdl_tpu.nn.module import Module as JModule
    from bigdl_tpu_torch.nn.module import Module
    for a in ("parameter_tree", "buffer_tree", "load_parameter_tree",
              "load_buffer_tree", "apply_to_modules", "backward", "reset",
              "training_mode", "evaluate_mode", "set_training",
              "is_training", "clone_module", "get_parameters",
              "n_parameters", "summary", "zero_grad_parameters",
              "find_module", "predict", "functional_state", "predict_class",
              "evaluate", "get_times", "reset_times", "set_name",
              "get_name"):
        assert callable(getattr(JModule, a)) and callable(getattr(Module, a)), a
    m = Module()
    assert m.output is None and m.grad_input is None
