"""The port's distributed decoding (``generate(mesh=...)``) against the
reference's single-device ``generate``, on the CPU.

Two gloo ranks (one spawn, ``torch_parallel_worker.py``'s ``decode``
job) decode the tiny Llama-recipe LM (tied head, GQA, RoPE) greedily:
dp-decode over ``MeshTopology(data=2)`` (each rank its half of the 4
prompts, every rank the whole batch's tokens) and tp-decode over
``MeshTopology(tensor=2)`` (weights sharded by heads, the KV cache split
by heads). Both give the reference's greedy tokens on the same weights,
the model is whole again after the tp call, and the reference's
``ValueError``s are kept.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from bigdl_tpu_torch.interop.state_dict import flatten_tree


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def world2(tmp_path_factory):
    """Two ranks, started with the file."""
    from bigdl_tpu.models import transformer as jtr
    from bigdl_tpu.utils.rng import manual_seed
    out = tmp_path_factory.mktemp("decode")
    manual_seed(13)
    lm = jtr.build_lm(64, **worker.TINY_LM)
    prompt = np.random.default_rng(2).integers(1, 65, (4, 8)).astype(
        np.int32)
    params = flatten_tree(lm.parameter_tree())
    np.savez(out / "decode.npz", prompt=prompt,
             **{"p:" + k: v for k, v in params.items()})
    procs = worker.spawn(out, 2, ["decode"])
    done = []

    def result():
        if not done:
            worker.wait(procs, out)
            done.append(True)
        return out
    yield {"result": result, "lm": lm, "prompt": prompt}
    for p in procs:
        p.kill()


@pytest.fixture(scope="module")
def reference_tokens(world2):
    from bigdl_tpu.models.generation import generate
    return np.asarray(generate(world2["lm"], jnp.asarray(world2["prompt"]),
                               6, greedy=True))


@pytest.mark.parametrize("mode", ["dp", "tp"])
def test_mesh_decode_gives_the_references_tokens(world2, reference_tokens,
                                                 mode):
    out = world2["result"]()
    for rank in range(2):
        z = np.load(out / f"decode.{rank}.npz")
        np.testing.assert_array_equal(z[mode], reference_tokens)
        if mode == "dp":   # one all-gather of the batch's tokens
            assert int(z["dp_collectives"]) == 1
        else:
            assert bool(z["tp_then_whole"])
