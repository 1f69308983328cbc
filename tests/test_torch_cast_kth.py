"""``ops.precision.cast_tree`` and ``utils.util.kth_largest`` against the
reference's, on the CPU (the small public names ported with the
model-parallel slice)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu_torch.ops import cast_tree
from bigdl_tpu_torch.utils.util import kth_largest


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_cast_tree_equals_the_references(dtype):
    from bigdl_tpu.ops import cast_tree as ref
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(0, 1, (3, 4)).astype(np.float32),
            "b": [rng.normal(0, 1, 5).astype(np.float32),
                  np.arange(4, dtype=np.int32)],
            "c": {"d": rng.normal(0, 1, 2).astype(np.float32)}}
    want = ref({k: _jax(v) for k, v in tree.items()}, getattr(jnp, dtype))
    got = cast_tree({k: _torch(v) for k, v in tree.items()},
                    getattr(torch, dtype))
    assert got["b"][1].dtype == torch.int32        # not floating: kept
    for g, w in ((got["a"], want["a"]), (got["b"][0], want["b"][0]),
                 (got["b"][1], want["b"][1]), (got["c"]["d"],
                                               want["c"]["d"])):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    assert isinstance(got["b"], list)


def _jax(v):
    if isinstance(v, dict):
        return {k: _jax(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_jax(x) for x in v]
    return jnp.asarray(v)


def _torch(v):
    if isinstance(v, dict):
        return {k: _torch(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_torch(x) for x in v]
    return torch.from_numpy(v)


@pytest.mark.parametrize("n,k", [(1, 1), (10, 1), (10, 4), (10, 10),
                                 (257, 100)])
def test_kth_largest_equals_the_references(n, k):
    from bigdl_tpu.utils.util import kth_largest as ref
    values = np.random.default_rng(n).normal(0, 1, n)
    values[::3] = values[0]   # ties
    assert kth_largest(values, k) == ref(values, k)
    assert kth_largest(list(values), k) == ref(values, k)


@pytest.mark.parametrize("k", [0, 6])
def test_kth_largest_refuses_a_k_out_of_range(k):
    from bigdl_tpu.utils.util import kth_largest as ref
    with pytest.raises(ValueError, match="out of range"):
        ref(np.arange(5.0), k)
    with pytest.raises(ValueError, match="out of range"):
        kth_largest(np.arange(5.0), k)
