"""Tensor (Megatron) parallelism and sequence-parallel regions
(counterpart of ``bigdl_tpu/parallel/tensor_parallel.py``).

The specs are the reference's: ``infer_param_specs`` gives every
parameter leaf a spec, a tuple of mesh-axis names (``()`` replicated,
``("tensor", None)`` sharded on dim 0), as the reference's
``PartitionSpec``s read: column-parallel Linear ``(out, in)`` weight on
``out``, row-parallel on ``in`` with a replicated bias,
``MultiHeadAttention``'s fused q;k;v rows and out-projection columns,
``LookupTable``'s embedding dim, a convolution's output channels.
``_tag_children`` auto-tags the Megatron pairs (FFN up and gate column,
down row; a ``Sequential``'s Linear pairs; the ``TimeDistributed(Linear)``
vocab head column); ``module.tp_mode`` overrides.

The reference lets GSPMD place the collectives in one process. The port
runs one process a rank, so ``shard_parameters(model, mesh)`` keeps each
rank's slice of every leaf whose spec names the axis, and the modules put
the collectives GSPMD would have placed, as ``torch.autograd.Function``s
(each counted in ``parallel.mesh.COLLECTIVES``):

- ``copy_to_region``: forward identity, backward all-reduce (the input of
  a column-parallel region);
- ``reduce_from_region``: forward all-reduce, backward identity (the
  output of a row-parallel Linear);
- ``gather_sequence`` / ``scatter_sequence``: forward all-gather /
  reduce-scatter along the sequence dim, backward the other; under
  ``enable_sequence_parallel`` they replace the two above at a block's
  regions, so its residual stream, norms and dropout run on this rank's
  sequence block (Megatron-SP);
- ``split`` / ``gather``: forward this rank's block / all-gather of a
  replicated value, backward the other (the SP stack's entry and exit, the
  sharded embedding's output, the tied head's table, a lone column
  Linear's output).

``MultiHeadAttention``'s q;k;v rows are sharded by HEADS, not as one row
split of the fused weight: rank r holds its q heads, then its k heads,
then its v heads (GQA needs ``num_heads`` and ``num_kv_heads`` to divide
by the axis). The spec stays the reference's ``("tensor", None)``;
``shard_leaf`` and ``unshard_leaf`` map between the full leaf and the
slice, and ``gather_full`` reassembles a rank's leaves bit for bit.

The tied head (``TiedLMHead``) gathers the embedding table for the
vocabulary projection: V x E of the compute dtype a step on every rank
(49 MB at the 134m recipe's 32000 x 768 in bf16), against an all-reduce of
the B x S x V logits that partial products would need (262 MB at B=8,
S=512). An untied ``TimeDistributed(Linear)`` head is column-parallel and
gathers its logits before ``LogSoftMax``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.parallel.mesh import TENSOR_AXIS

COLUMN, ROW, REPLICATE = "column", "row", "replicate"


# ------------------------------------------------------------------ specs
def _linear_specs(mode: Optional[str], axis: str) -> Dict[str, Tuple]:
    if mode == COLUMN:
        return {"weight": (axis, None), "bias": (axis,)}
    if mode == ROW:
        # the bias is replicated: it is added after the partial sums' reduce
        return {"weight": (None, axis), "bias": ()}
    return {}


def _module_specs(module, axis: str) -> Dict[str, Tuple]:
    """Specs of the module's own parameters (not its children's)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.parallel.expert import MoE, expert_param_specs
    mode = getattr(module, "tp_mode", None)
    if mode == REPLICATE:
        return {}
    if isinstance(module, MoE):
        # the stacked experts shard over the expert axis, not this one
        return expert_param_specs(module)
    if isinstance(module, nn.Linear):
        return _linear_specs(mode, axis)
    if isinstance(module, nn.MultiHeadAttention):
        return {"in_proj_weight": (axis, None), "in_proj_bias": (axis,),
                "out_proj_weight": (None, axis), "out_proj_bias": ()}
    if isinstance(module, nn.LookupTable):
        return {"weight": (None, axis)}
    if isinstance(module, (nn.SpatialConvolution, nn.SpatialShareConvolution,
                           nn.SpaceToDepthConv7)):
        # HWIO weight: the output channels
        return {"weight": (None, None, None, axis), "bias": (axis,)}
    return {}


def _tag_children(module) -> None:
    """Auto-tag Megatron column -> row pairs (reference ``_tag_children``):
    a ``TransformerEncoderLayer``'s FFN up (and swiglu gate) column and
    down row; a ``TimeDistributed(Linear)`` head column; a ``Sequential``'s
    consecutive Linears separated only by parameter-free modules column
    then row."""
    from bigdl_tpu_torch import nn
    if isinstance(module, nn.TransformerEncoderLayer):
        if module.moe_experts:
            return   # an MoE FFN: _module_specs gives the expert leaves'
        if not hasattr(module.linear1, "tp_mode"):
            module.linear1.tp_mode = COLUMN
        if not hasattr(module.linear2, "tp_mode"):
            module.linear2.tp_mode = ROW
        gate = module._modules.get("linear_gate")
        if gate is not None and not hasattr(gate, "tp_mode"):
            gate.tp_mode = COLUMN
        return
    if isinstance(module, nn.TimeDistributed):
        inner = module.inner
        if isinstance(inner, nn.Linear) and not hasattr(inner, "tp_mode"):
            inner.tp_mode = COLUMN
        return
    if isinstance(module, nn.Sequential):
        children = list(module._modules.values())
        i = 0
        while i < len(children):
            c = children[i]
            if isinstance(c, nn.Linear) and not hasattr(c, "tp_mode"):
                j = i + 1
                while (j < len(children) and not children[j]._parameters
                       and not children[j]._modules):
                    j += 1
                if (j < len(children) and isinstance(children[j], nn.Linear)
                        and not hasattr(children[j], "tp_mode")):
                    c.tp_mode = COLUMN
                    children[j].tp_mode = ROW
                    i = j
            i += 1


def _divisible(spec: Tuple, shape, axis_size) -> bool:
    if axis_size is None:
        return True
    for dim, name in enumerate(spec):
        if name is None:
            continue
        size = (axis_size.get(name) if isinstance(axis_size, dict)
                else axis_size)
        if size is None:
            return False   # the axis is not in the mesh: replicate
        if size and shape[dim] % size != 0:
            return False
    return True


def infer_param_specs(model, axis: str = TENSOR_AXIS, axis_size=None) -> Any:
    """A nested dict of specs matching the model's parameters (children
    with no parameters left out), as the reference's. ``axis_size`` (an int
    or ``{axis: size}``): a dimension it does not divide falls back to
    replicated."""
    _tag_children(model)
    specs: Dict[str, Any] = {}
    own = _module_specs(model, axis)
    for name, value in model._parameters.items():
        if value is None:
            continue
        spec = own.get(name, ())
        if spec != () and not _divisible(spec, tuple(value.shape),
                                         axis_size):
            spec = ()
        specs[name] = spec
    for name, child in model._modules.items():
        if child is None:
            continue
        sub = infer_param_specs(child, axis, axis_size)
        if sub:
            specs[name] = sub
    return specs


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return type(tree)(_structure(v) for v in tree)
    return None


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn) for v in tree]
    return fn(tree)


def opt_state_specs(state_template, params_template, param_specs) -> Any:
    """Specs of an optim method's state: an entry shaped like the
    parameters (velocity, m, v, ...) takes their specs, anything else is
    replicated (reference ``opt_state_specs``)."""
    p_struct = _structure(params_template)
    out = {}
    for key, val in state_template.items():
        if isinstance(val, dict) and _structure(val) == p_struct:
            out[key] = param_specs
        else:
            out[key] = _map_leaves(val, lambda _: ())
    return out


def flat_specs(specs, prefix: str = "") -> Dict[str, Tuple]:
    """A nested spec dict by dotted parameter name."""
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(flat_specs(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# ------------------------------------------------ sequence-parallel tags
def enable_sequence_parallel(model, mesh, axis: str = TENSOR_AXIS,
                             seq_dim: int = 1, batch_axis: str = "data",
                             batch_dim: int = 0) -> int:
    """Tag every ``TransformerEncoderLayer`` under ``model`` to run its
    residual stream on this rank's block of the sequence between its
    tensor-parallel regions; returns the blocks tagged. The sequence
    length must divide by the axis's size; an MoE block raises
    ``ValueError``. ``batch_axis`` and ``batch_dim`` are the reference's
    (the batch stays with the data plane)."""
    from bigdl_tpu_torch import nn
    batch = batch_axis if batch_axis in mesh.shape else None
    count = 0
    for m in model.modules():
        if isinstance(m, nn.TransformerEncoderLayer):
            if m.moe_experts:
                raise ValueError(
                    "sequence-parallel regions do not compose with an MoE "
                    "block here: its router would see this rank's sequence "
                    "block, not the batch")
            m._sp = (mesh, axis, seq_dim, batch, batch_dim)
            count += 1
    return count


def sp_constrain(x, sp):
    """``x`` (whole on every rank) as this rank's block of ``sp``'s
    sequence dim (``split``); None: ``x``."""
    if sp is None:
        return x
    mesh, axis, seq_dim = sp[:3]
    return split(x, mesh, axis, seq_dim)


# ------------------------------------------------------ the conjugates
class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous().clone(), axis=ctx.axis), \
            None, None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.contiguous().clone(), axis=axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.axis, dim=ctx.dim), \
            None, None, None


class _ScatterSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.reduce_scatter(x, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axis, dim=ctx.dim), \
            None, None, None


def _block(x, mesh, axis, dim):
    n, r = mesh.axis_size(axis), mesh.axis_index(axis)
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        if x.shape[dim] % mesh.axis_size(axis):
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                             f"by the {axis!r} axis's "
                             f"{mesh.axis_size(axis)} ranks")
        return _block(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axis, dim=ctx.dim), \
            None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), \
            None, None, None


def copy_to_region(x, mesh, axis: str = TENSOR_AXIS):
    """Forward identity, backward all-reduce over ``axis``."""
    return _CopyToRegion.apply(x, mesh, axis)


def reduce_from_region(x, mesh, axis: str = TENSOR_AXIS):
    """Forward all-reduce over ``axis``, backward identity."""
    return _ReduceFromRegion.apply(x, mesh, axis)


def gather_sequence(x, mesh, axis: str = TENSOR_AXIS, dim: int = 1):
    """Forward all-gather along ``dim``, backward reduce-scatter."""
    return _GatherSequence.apply(x, mesh, axis, dim % x.dim())


def scatter_sequence(x, mesh, axis: str = TENSOR_AXIS, dim: int = 1):
    """Forward reduce-scatter along ``dim``, backward all-gather."""
    return _ScatterSequence.apply(x, mesh, axis, dim % x.dim())


def split(x, mesh, axis: str = TENSOR_AXIS, dim: int = 1):
    """Forward this rank's block of ``dim``, backward all-gather."""
    return _Split.apply(x, mesh, axis, dim % x.dim())


def gather(x, mesh, axis: str = TENSOR_AXIS, dim: int = -1):
    """Forward all-gather along ``dim``, backward this rank's block (the
    value is replicated downstream, so its gradient is too)."""
    return _Gather.apply(x, mesh, axis, dim % x.dim())


# -------------------------------------------------------------- roles
class TPRole:
    """How a sharded module meets the other ranks: its ``mode``
    (``COLUMN``, ``ROW``, or ``"heads"`` for attention, ``"embed"`` for a
    table), the ``block`` whose sequence-parallel tag picks its region
    collectives, whether it enters the region itself (``enters``), and
    whether a lone column gathers its output (``gathers``) or a lone row
    splits its input (``splits``)."""

    def __init__(self, mesh, axis: str, mode: str, block=None,
                 enters: bool = True, gathers: bool = False,
                 splits: bool = False):
        self.mesh, self.axis, self.mode = mesh, axis, mode
        self.block = block
        self.enters, self.gathers, self.splits = enters, gathers, splits

    def sp(self):
        return (getattr(self.block, "_sp", None)
                if self.block is not None else None)

    def enter(self, x):
        """The input of a column-parallel region."""
        sp = self.sp()
        if sp is not None:
            return gather_sequence(x, self.mesh, self.axis, sp[2])
        return copy_to_region(x, self.mesh, self.axis)

    def exit(self, y):
        """The partial sums of a row-parallel product, reduced."""
        sp = self.sp()
        if sp is not None:
            return scatter_sequence(y, self.mesh, self.axis, sp[2])
        return reduce_from_region(y, self.mesh, self.axis)


def linear_forward(module, x, role: TPRole):
    """A sharded Linear's forward (``nn.Linear`` calls it)."""
    from bigdl_tpu_torch.ops.precision import match_compute
    if role.mode == COLUMN and role.enters:
        x = role.enter(x)
    if role.mode == ROW and role.splits:
        x = split(x, role.mesh, role.axis, -1)
    y = torch.matmul(match_compute(x, module.weight), module.weight.T)
    if role.mode == ROW:
        y = role.exit(y)
    if module.with_bias:
        y = y + module.bias
    if role.mode == COLUMN and role.gathers:
        y = gather(y, role.mesh, role.axis, -1)
    return y


# ----------------------------------------------------- leaves and shards
def _mha_sections(module) -> List[int]:
    e = module.embed_dim
    ekv = module.num_kv_heads * module.head_dim
    return [e, ekv, ekv]


def shard_leaf(module, name: str, full: torch.Tensor, spec: Tuple,
               n: int, r: int) -> torch.Tensor:
    """Rank ``r`` of ``n``'s slice of the full leaf ``name`` of ``module``
    under ``spec`` (head-aligned for attention's q;k;v rows)."""
    from bigdl_tpu_torch import nn
    if not spec or all(s is None for s in spec):
        return full
    if isinstance(module, nn.MultiHeadAttention) and name.startswith(
            "in_proj"):
        parts = full.split(_mha_sections(module), dim=0)
        return torch.cat([p.narrow(0, r * (p.shape[0] // n),
                                   p.shape[0] // n) for p in parts], dim=0)
    d = next(i for i, s in enumerate(spec) if s is not None)
    size = full.shape[d] // n
    return full.narrow(d, r * size, size)


def unshard_leaf(module, name: str, pieces: List[torch.Tensor],
                 spec: Tuple) -> torch.Tensor:
    """The full leaf from every rank's slice, in rank order."""
    from bigdl_tpu_torch import nn
    if not spec or all(s is None for s in spec):
        return pieces[0]
    if isinstance(module, nn.MultiHeadAttention) and name.startswith(
            "in_proj"):
        n = len(pieces)
        local = [s // n for s in _mha_sections(module)]
        split_pieces = [p.split(local, dim=0) for p in pieces]
        return torch.cat([torch.cat([sp[i] for sp in split_pieces], dim=0)
                          for i in range(3)], dim=0)
    d = next(i for i, s in enumerate(spec) if s is not None)
    return torch.cat(pieces, dim=d)


def _owners(model) -> Dict[str, Tuple[Any, str]]:
    """Dotted parameter name -> (owning module, leaf name)."""
    out = {}
    for mname, m in model.named_modules():
        for pname, p in m._parameters.items():
            if p is not None:
                out[f"{mname}.{pname}" if mname else pname] = (m, pname)
    return out


def _mlp_pairs(seq) -> List[Tuple[Any, Any]]:
    """(column, row) Linear pairs of a ``Sequential`` as ``_tag_children``
    tags them."""
    from bigdl_tpu_torch import nn
    children = list(seq._modules.values())
    pairs, i = [], 0
    while i < len(children):
        c = children[i]
        if isinstance(c, nn.Linear) and getattr(c, "tp_mode", None) == COLUMN:
            j = i + 1
            while (j < len(children) and not children[j]._parameters
                   and not children[j]._modules):
                j += 1
            if (j < len(children) and isinstance(children[j], nn.Linear)
                    and getattr(children[j], "tp_mode", None) == ROW):
                pairs.append((c, children[j]))
                i = j
        i += 1
    return pairs


def shard_parameters(model, mesh, axis: str = TENSOR_AXIS) -> Dict[str, Tuple]:
    """Keep this rank's slice of every leaf whose spec names ``axis`` and
    give each sharded module its ``TPRole`` (``_tp``); returns the specs by
    dotted name. A model already sharded over this mesh is left as it is.
    A module with a sharded spec that has no sharded forward here raises
    ``NotImplementedError``."""
    from bigdl_tpu_torch import nn
    if getattr(model, "_tp_mesh", None) is mesh:
        return model._tp_specs
    n, r = mesh.axis_size(axis), mesh.axis_index(axis)
    specs = flat_specs(infer_param_specs(model, axis, {axis: n}))
    owners = _owners(model)
    sharded = {name for name, s in specs.items() if axis in s}
    mods = {}
    for name in sharded:
        m, _ = owners[name]
        mods[id(m)] = m
    blocks = {}
    for layer in model.modules():
        if isinstance(layer, nn.TransformerEncoderLayer):
            for child in (layer.self_attn, layer._modules.get("linear1"),
                          layer._modules.get("linear2"),
                          layer._modules.get("linear_gate")):
                if child is not None:
                    blocks[id(child)] = layer
    paired = {}
    for seq in model.modules():
        if isinstance(seq, nn.Sequential):
            for col, row in _mlp_pairs(seq):
                paired[id(col)] = row
                paired[id(row)] = col
    is_sharded = lambda m: m is not None and id(m) in mods
    for m in mods.values():
        block = blocks.get(id(m))
        if isinstance(m, nn.MultiHeadAttention):
            if m.num_heads % n or m.num_kv_heads % n:
                raise ValueError(
                    f"tensor parallelism over {n} ranks needs num_heads "
                    f"({m.num_heads}) and num_kv_heads ({m.num_kv_heads}) "
                    f"to divide by {n}")
            m._tp = TPRole(mesh, axis, "heads", block)
            m._tp_heads(n)
        elif isinstance(m, nn.Linear):
            mode = m.tp_mode
            partner = paired.get(id(m))
            in_block = block is not None
            m._tp = TPRole(
                mesh, axis, mode, block,
                enters=mode == COLUMN and not in_block,
                gathers=(mode == COLUMN and not in_block
                         and not is_sharded(partner)),
                splits=(mode == ROW and not in_block
                        and not is_sharded(partner)))
        elif isinstance(m, nn.LookupTable):
            if m.max_norm != float("inf"):
                raise NotImplementedError(
                    "a tensor-parallel LookupTable with max_norm: the "
                    "renormalisation needs the whole row")
            m._tp = TPRole(mesh, axis, "embed")
        else:
            raise NotImplementedError(
                f"{type(m).__name__} has a tensor-parallel spec but no "
                "sharded forward in the port")
    with torch.no_grad():
        for name in sharded:
            m, leaf = owners[name]
            p = m._parameters[leaf]
            p.data = shard_leaf(m, leaf, p.data, specs[name], n, r) \
                .contiguous()
    model._tp_mesh, model._tp_specs = mesh, specs
    return specs


def unshard_parameters(model) -> None:
    """Undo ``shard_parameters``: every leaf whole again (collective), the
    roles and the local head counts gone."""
    from bigdl_tpu_torch import nn
    mesh = getattr(model, "_tp_mesh", None)
    if mesh is None:
        return
    named = dict(model.named_parameters())
    full = gather_full(model, {n: p.detach() for n, p in named.items()})
    with torch.no_grad():
        for n, p in named.items():
            p.data = full[n].contiguous()
    for m in model.modules():
        if "_tp" in m.__dict__:
            del m.__dict__["_tp"]
        if isinstance(m, nn.MultiHeadAttention):
            m._heads_local, m._kv_local = m.num_heads, m.num_kv_heads
    del model._tp_mesh, model._tp_specs


def gather_full(model, tensors: Dict[str, torch.Tensor], mesh=None,
                axis: str = TENSOR_AXIS) -> Dict[str, torch.Tensor]:
    """``tensors`` (by parameter name, this rank's slices, or any tree
    leaf shaped like one) reassembled into full leaves over ``axis``
    (collective: one all-gather a sharded leaf)."""
    mesh = mesh or model._tp_mesh
    specs = model._tp_specs
    owners = _owners(model)
    out = {}
    for name, t in tensors.items():
        spec = specs.get(name, ())
        if axis not in spec:
            out[name] = t
            continue
        m, leaf = owners[name]
        every = mesh.all_gather(t.contiguous().view(-1), axis)
        pieces = list(every.view(mesh.axis_size(axis), *t.shape).unbind(0))
        out[name] = unshard_leaf(m, leaf, pieces, spec)
    return out


def local_slices(model, tensors: Dict[str, Any], mesh=None,
                 axis: str = TENSOR_AXIS) -> Dict[str, Any]:
    """Full leaves (tensors or numpy, by parameter name) cut to this rank's
    slices (the inverse of ``gather_full``)."""
    mesh = mesh or model._tp_mesh
    specs = model._tp_specs
    owners = _owners(model)
    n, r = mesh.axis_size(axis), mesh.axis_index(axis)
    out = {}
    for name, t in tensors.items():
        spec = specs.get(name, ())
        if axis not in spec:
            out[name] = t
            continue
        m, leaf = owners[name]
        full = torch.as_tensor(np.asarray(t)) if not torch.is_tensor(t) else t
        piece = shard_leaf(m, leaf, full, spec, n, r).contiguous()
        out[name] = piece if torch.is_tensor(t) else piece.numpy()
    return out


def sp_partial_params(model) -> List[str]:
    """Parameters whose gradient a rank holds only for its sequence block
    under sequence-parallel regions: the replicated leaves of tagged
    blocks (norms, row biases) and of their stack's final norm. The
    training loop sums them over the tensor axis."""
    from bigdl_tpu_torch import nn
    specs = getattr(model, "_tp_specs", {})
    names = []
    for mname, m in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(m, nn.TransformerEncoderLayer) and m._sp is not None:
            names += [prefix + p for p, _ in m.named_parameters()
                      if TENSOR_AXIS not in specs.get(prefix + p, ())]
        elif (isinstance(m, nn.TransformerEncoder)
              and m.final_norm is not None
              and any(getattr(layer, "_sp", None) is not None
                      for layer in m.children())):
            names += [f"{prefix}final_norm.{p}"
                      for p, _ in m.final_norm.named_parameters()]
    return names
