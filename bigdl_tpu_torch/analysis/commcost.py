"""Static collective byte model for the port (counterpart of
``bigdl_tpu/analysis/commcost.py``): closed-form payload bytes per step of
every collective the port's training modes run, written to
``bigdl_tpu_torch/analysis/comm_model.json`` and held against the bytes
``parallel.mesh.COLLECTIVES`` counts.

Three layers, cheapest first:

1. **Op algebra** — ring-equivalent wire bytes and HBM touch bytes per
   collective, as expressions in ``B`` (full payload bytes) and ``S``
   (group size): the reference's, unchanged.
2. **Mode models** — per training mode, which collectives a rank runs per
   optimizer step (``"per": "step"``) or per run (``"per": "run"``) and
   with what payload, as closed forms in mesh-axis sizes and model
   symbols, derived from the port's own structure (``parallel/``) — not
   from an XLA program. Each term says which reference term it prices
   (``ref``): ``"same"`` where the algebra is the reference's, ``"port"``
   for a collective only the port runs (the loss's mean, the clip's
   squared norms, an epoch's agreed length, the tied head's table).
   Payloads follow ``COLLECTIVES``' convention, which is the reference's
   ``B``: an all-reduce's or all-to-all's input, an all-gather's gathered
   output, a reduce-scatter's whole input, a shift's sent tensor, each as
   one rank sends it.
3. **Site scan** — a static AST walk over ``bigdl_tpu_torch/`` recording
   every ``Mesh`` collective call and region-function call (op, mesh
   axis, file:line), so the JSON names where each term of layer 2 comes
   from.

``collective_bytes_from_hlo`` has no counterpart to read: the port runs
no compiled program. Its measured side is ``counted_by_axis``, which reads
``parallel.mesh.COLLECTIVES.snapshot()`` (calls and payload bytes by
``op/axis``); ``compare`` holds a mode's model against it.
``tests/test_torch_comm_model.py`` holds every mode against the counts of
a world-2 run on the CPU (gloo), each with a control that drops one term;
``chip_smoke.py`` phases 3o-3q hold every mode at the 134m recipe's and
the 134m-8e's full widths on the card (gloo over one card: the payload
algebra, not NVLink wire time).
"""

from __future__ import annotations

import ast
import json
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Layer 1: op algebra (the reference's).
#
# wire  = bytes crossing links per participating device, bandwidth-optimal
#         (bidirectional ring / recursive halving-doubling equivalent)
# hbm   = bytes the op reads + writes in device memory (operands + results)
#
# B is the FULL logical payload (the gathered / pre-scatter size); S the
# group size along the participating mesh axis.
# ---------------------------------------------------------------------------

OPS: Dict[str, Dict[str, str]] = {
    "all-reduce": {
        "wire": "2*B*(S-1)/S",
        "hbm": "2*B",
        "note": "reduce-scatter + all-gather phases; psum/pmean/pmax/pmin",
    },
    "all-gather": {
        "wire": "B*(S-1)/S",
        "hbm": "B*(S+1)/S",
        "note": "reads the B/S shard, writes the full B; lax.all_gather "
                "and SPMD-inserted parameter gathers (ZeRO-1/3)",
    },
    "reduce-scatter": {
        "wire": "B*(S-1)/S",
        "hbm": "B*(S+1)/S",
        "note": "reads the full B, writes the owned B/S shard; "
                "lax.psum_scatter and sharded-gradient sync",
    },
    "all-to-all": {
        "wire": "B*(S-1)/S",
        "hbm": "2*B",
        "note": "each device keeps 1/S of its shard; MoE dispatch/combine",
    },
    "collective-permute": {
        "wire": "B",
        "hbm": "2*B",
        "note": "point-to-point shift; lax.ppermute (ring attention, "
                "pipeline boundaries)",
    },
}

# Mesh method (COLLECTIVES' op name) -> the op the model prices it as;
# gloo stages a CUDA tensor's shift through the host (``shift_staged``)
MESH_TO_OP = {
    "all_reduce": "all-reduce", "all_gather": "all-gather",
    "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
    "shift": "collective-permute", "shift_staged": "collective-permute",
}
OP_TO_MESH = {"all-reduce": "all_reduce", "all-gather": "all_gather",
              "reduce-scatter": "reduce_scatter", "all-to-all": "all_to_all",
              "collective-permute": "shift"}


def wire_bytes(op: str, payload_bytes: float, group_size: int) -> float:
    """Evaluate OPS[op]['wire'] numerically."""
    return _eval_formula(OPS[op]["wire"], B=payload_bytes, S=group_size)


def hbm_bytes(op: str, payload_bytes: float, group_size: int) -> float:
    """Evaluate OPS[op]['hbm'] numerically."""
    return _eval_formula(OPS[op]["hbm"], B=payload_bytes, S=group_size)


def _eval_formula(expr: str, **bindings: float) -> float:
    # formulas are our own arithmetic strings (no names beyond bindings)
    return float(eval(expr, {"__builtins__": {}}, dict(bindings)))


# ---------------------------------------------------------------------------
# Layer 2: the port's mode models. Symbols (bytes unless said otherwise):
#   S_data/S_tensor/S_pipe/S_seq/S_expert  mesh-axis sizes
#   P       parameter bytes of the replicated f32 masters (a rank's own
#           slices under a tensor or expert axis)
#   L       the loss's bytes (4: the f32 scalar whose rank mean is logged)
#   clip    1 with an L2 clip over a sharded gradient (its squared norm
#           all-reduced, 4 bytes), else 0
#   n_epochs  epochs a run starts (each agrees its length: 4 bytes)
#   P_flat  ZeRO-1's padded flat vector, f32; comp = its gradient's bytes
#           per f32 byte (1, or 0.5 with compress_gradients)
#   B_buf   the float buffers averaged after a ZeRO-1 step
#   P_shd   fsdp's sharded leaves (whole, f32); P_rep its replicated ones
#   k_ag    fsdp's gathers of each sharded leaf a step (1: the whole model
#           at the step's start)
#   A       one block boundary's activation, B x S x E in the compute dtype
#   n_blk   transformer blocks under the tensor axis
#   n_emb   1 when the token embedding is tensor-sharded (its output
#           gathered), else 0
#   VE      the tied head's table, V x E in the compute dtype (else 0)
#   P_sp    the sequence-parallel regions' replicated leaves (f32) whose
#           gradients are summed over the tensor axis
#   n_moe   MoE layers; k/E_x the picks and experts; T one layer's routed
#           buffer, E_x x C x D in the compute dtype
#   aux     1 with the load-balancing loss (frac all-reduced), else 0
#   K       one K (or V) shard the ring shifts: B x S/S_seq x N x D (the
#           heads expanded) in the compute dtype
#   n_ring  ring shifts a step: K and V, forward and backward, per layer
#   M       a pipeline microbatch's boundary activation; n_micro
#           microbatches
#   M_send/M_recv  a StagePipeline rank's own boundaries, f32
# ---------------------------------------------------------------------------

MODES: Dict[str, List[Dict[str, str]]] = {
    "dp-allreduce": [
        {"op": "all-reduce", "axis": "data", "payload": "P", "per": "step",
         "ref": "same",
         "note": "the gradients in flat buckets of BUCKET_BYTES"},
        {"op": "all-reduce", "axis": "data", "payload": "L", "per": "step",
         "ref": "port", "note": "the loss's rank mean"},
        {"op": "all-reduce", "axis": "data", "payload": "4*n_epochs",
         "per": "run", "ref": "port",
         "note": "each epoch's agreed length (min of the batch counts)"},
    ],
    "dp-sharded": [
        {"op": "reduce-scatter", "axis": "data", "payload": "comp*P_flat",
         "per": "step", "ref": "same",
         "note": "ZeRO-1 gradient scatter over the padded flat vector"},
        {"op": "all-gather", "axis": "data", "payload": "P_flat",
         "per": "step", "ref": "same",
         "note": "the updated slices republished"},
        {"op": "all-reduce", "axis": "data", "payload": "L + 4*clip + B_buf",
         "per": "step", "ref": "port",
         "note": "the loss's mean, the clip's squared norm, the float "
                 "buffers' mean"},
        {"op": "all-reduce", "axis": "data", "payload": "4*n_epochs",
         "per": "run", "ref": "port", "note": "each epoch's agreed length"},
    ],
    "fsdp": [
        {"op": "all-gather", "axis": "data", "payload": "k_ag*P_shd",
         "per": "step", "ref": "same",
         "note": "the whole model gathered once at the step's start: the "
                 "reference's per-layer gathers with k_ag = 1"},
        {"op": "reduce-scatter", "axis": "data", "payload": "P_shd",
         "per": "step", "ref": "same",
         "note": "each sharded leaf's gradient to its owner"},
        {"op": "all-reduce", "axis": "data", "payload": "P_rep + L + 4*clip",
         "per": "step", "ref": "port",
         "note": "the replicated leaves' gradients in buckets, the loss's "
                 "mean, the clip's squared norm"},
        {"op": "all-reduce", "axis": "data", "payload": "4*n_epochs",
         "per": "run", "ref": "port", "note": "each epoch's agreed length"},
    ],
    "tp-megatron": [
        {"op": "all-reduce", "axis": "tensor", "payload": "4*n_blk*A",
         "per": "step", "ref": "same",
         "note": "per block: the out-projection's and the down-projection's "
                 "forward reduce, the two region entries' backward reduce"},
        {"op": "all-reduce", "axis": "tensor", "payload": "4*clip",
         "per": "step", "ref": "port",
         "note": "the clip adds the sharded leaves' squares"},
        {"op": "all-gather", "axis": "tensor", "payload": "n_emb*A + VE",
         "per": "step", "ref": "port",
         "note": "the sharded embedding's output and the tied head's "
                 "table, gathered in the forward"},
    ],
    "tp-sp": [
        {"op": "all-gather", "axis": "tensor",
         "payload": "(4*n_blk + 2 + n_emb)*A + VE", "per": "step",
         "ref": "port",
         "note": "per block two forward sequence gathers and two backward "
                 "ones (of the scatters); the stack's entry (backward) and "
                 "exit (forward); the embedding's output and the tied "
                 "table"},
        {"op": "reduce-scatter", "axis": "tensor", "payload": "4*n_blk*A",
         "per": "step", "ref": "port",
         "note": "per block two forward sequence scatters and two backward "
                 "ones (of the gathers): Megatron-SP's form of the "
                 "reference's 4*n_blk*A all-reduce"},
        {"op": "all-reduce", "axis": "tensor", "payload": "P_sp + 4*clip",
         "per": "step", "ref": "port",
         "note": "the regions' replicated leaves' gradients summed; the "
                 "clip's squared norm"},
    ],
    "dp x ep": [
        {"op": "all-reduce", "axis": "data", "payload": "P", "per": "step",
         "ref": "same", "note": "every parameter's gradient, replicated "
                                "experts included"},
        {"op": "all-gather", "axis": "data", "payload": "n_moe*S_data*k*E_x*4",
         "per": "step", "ref": "port",
         "note": "global routing: each MoE layer's (k, E) pick counts "
                 "gathered (the reference's all-to-all dispatch has no "
                 "counterpart: every data rank routes the global batch)"},
        {"op": "all-reduce", "axis": "data", "payload": "n_moe*aux*E_x*4 + L",
         "per": "step", "ref": "port",
         "note": "each MoE layer's frac for the load-balancing loss; the "
                 "loss's mean"},
        {"op": "all-reduce", "axis": "data", "payload": "4*n_epochs",
         "per": "run", "ref": "port", "note": "each epoch's agreed length"},
    ],
    "ep": [
        {"op": "all-gather", "axis": "expert", "payload": "2*n_moe*T",
         "per": "step", "ref": "port",
         "note": "per MoE layer the experts' outputs gathered (forward) "
                 "and the buffer's gradient gathered (the split's "
                 "backward): the port's form of the reference's "
                 "2*n_moe*T all-to-all"},
        {"op": "all-reduce", "axis": "expert", "payload": "4*clip",
         "per": "step", "ref": "port",
         "note": "the clip adds the expert leaves' squares"},
    ],
    "sp-ring": [
        {"op": "collective-permute", "axis": "seq",
         "payload": "n_ring*(S_seq-1)*K", "per": "step", "ref": "same",
         "note": "K and V rotated S_seq - 1 hops (no last hop back) per "
                 "layer, forward and backward: n_ring = 4*n_layers"},
        {"op": "all-reduce", "axis": "seq", "payload": "P + L",
         "per": "step", "ref": "port",
         "note": "ContextParallelLM.train_step: the gradients in one flat "
                 "f32 all-reduce, the loss's mean"},
    ],
    "pp-gpipe": [
        {"op": "collective-permute", "axis": "pipe",
         "payload": "2*(n_micro + S_pipe - 1)*M", "per": "step",
         "ref": "port",
         "note": "every schedule step shifts one microbatch boundary "
                 "(bubbles send zeros), forward and backward: the "
                 "reference prices 2*n_micro*(S_pipe-1)*M"},
        {"op": "all-reduce", "axis": "pipe", "payload": "n_micro*M",
         "per": "step", "ref": "port",
         "note": "the last stage's outputs replicated (psum)"},
    ],
    "pp-stage": [
        {"op": "collective-permute", "axis": "pipe",
         "payload": "(n_micro + S_pipe - 1)*(M_send + M_recv)",
         "per": "step", "ref": "port",
         "note": "StagePipeline: each rank sends its own boundary shape in "
                 "f32 forward and its receive's gradient backward"},
        {"op": "all-reduce", "axis": "pipe", "payload": "L", "per": "step",
         "ref": "port", "note": "the loss replicated (psum)"},
    ],
}

_MODE_DEFAULTS = {"k_ag": 1.0, "L": 4.0, "comp": 1.0, "clip": 0.0,
                  "B_buf": 0.0, "P_rep": 0.0, "n_epochs": 1.0, "n_emb": 0.0,
                  "VE": 0.0, "P_sp": 0.0, "aux": 0.0}


def _terms(mode: str, **bindings: float) -> List[Dict[str, Any]]:
    env = dict(_MODE_DEFAULTS)
    env.update(bindings)
    terms = []
    for t in MODES[mode]:
        payload = _eval_formula(t["payload"], **env)
        s = int(env.get(f"S_{t['axis']}", 1))
        terms.append({
            "op": t["op"], "axis": t["axis"], "per": t["per"],
            "ref": t["ref"], "payload_bytes": payload,
            "wire_bytes": wire_bytes(t["op"], payload, s),
            "hbm_bytes": hbm_bytes(t["op"], payload, s),
        })
    return terms


def predict_mode(mode: str, **bindings: float) -> Dict[str, Any]:
    """Evaluate one mode's per-step terms (``"per": "run"`` terms are left
    out: ``payload_by_axis`` adds them over a run). Returns per-term and
    total payload/wire/hbm bytes per step. Unbound symbols raise
    NameError."""
    terms = [t for t in _terms(mode, **bindings) if t["per"] == "step"]
    return {"mode": mode, "terms": terms,
            "payload_bytes": sum(t["payload_bytes"] for t in terms),
            "wire_bytes": sum(t["wire_bytes"] for t in terms),
            "hbm_bytes": sum(t["hbm_bytes"] for t in terms)}


def payload_by_axis(mode: str, steps: int, drop: Optional[int] = None,
                    **bindings: float) -> Dict[str, float]:
    """The payload bytes a rank sends over ``steps`` steps of one run, by
    ``COLLECTIVES``' ``op/axis`` key. ``drop``: that term's index left
    out (a control)."""
    out: Dict[str, float] = {}
    for i, t in enumerate(_terms(mode, **bindings)):
        if i == drop:
            continue
        key = f"{OP_TO_MESH[t['op']]}/{t['axis']}"
        n = steps if t["per"] == "step" else 1
        out[key] = out.get(key, 0.0) + n * t["payload_bytes"]
    return {k: v for k, v in out.items() if v}


def counted_by_axis(snapshot: Dict[str, Dict]) -> Dict[str, float]:
    """``COLLECTIVES.snapshot()``'s payload bytes by ``op/axis``, the
    staged shift folded into ``shift`` and the whole-group calls
    (``broadcast``, ``all_gather_object``) left out."""
    out: Dict[str, float] = {}
    for key, b in snapshot.get("bytes_by_axis", {}).items():
        op, axis = key.split("/", 1)
        if op not in MESH_TO_OP:
            continue
        key = f"{OP_TO_MESH[MESH_TO_OP[op]]}/{axis}"
        out[key] = out.get(key, 0.0) + float(b)
    return out


def compare(mode: str, counted: Dict[str, float], steps: int,
            rtol: float = 0.0, drop: Optional[int] = None,
            **bindings: float) -> Dict[str, Any]:
    """A mode's model against counted payload bytes by ``op/axis``:
    ``rows`` (key, model, counted, relative error) over every key either
    side has, and ``ok`` when each is within ``rtol`` (0: exact)."""
    model = payload_by_axis(mode, steps, drop=drop, **bindings)
    rows = []
    for key in sorted(set(model) | set(counted)):
        m, c = model.get(key, 0.0), counted.get(key, 0.0)
        err = abs(m - c) / max(abs(c), 1.0)
        rows.append({"key": key, "model": m, "counted": c, "rel_err": err})
    return {"mode": mode, "steps": steps, "rtol": rtol, "rows": rows,
            "ok": all(r["rel_err"] <= rtol for r in rows)}


# ---------------------------------------------------------------------------
# Layer 3: static collective-site scan.
# ---------------------------------------------------------------------------

# mesh.py axis constants: resolvable without executing the tree
_WELL_KNOWN_AXIS = {"DATA_AXIS": "data", "TENSOR_AXIS": "tensor",
                    "PIPELINE_AXIS": "pipe", "SEQUENCE_AXIS": "seq",
                    "EXPERT_AXIS": "expert"}
# Mesh method -> index of its axis argument (and its default axis)
_MESH_AXIS_POS = {"all_reduce": 2, "reduce_scatter": 1, "all_gather": 1,
                  "all_to_all": 1, "shift": 1}
# region functions (tensor_parallel.py) -> (forward op, backward op)
_REGIONS = {"copy_to_region": (None, "all-reduce"),
            "reduce_from_region": ("all-reduce", None),
            "gather_sequence": ("all-gather", "reduce-scatter"),
            "scatter_sequence": ("reduce-scatter", "all-gather"),
            "split": (None, "all-gather"), "gather": ("all-gather", None)}


def _module_str_constants(tree: ast.Module) -> Dict[str, str]:
    out = dict(_WELL_KNOWN_AXIS)
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            out[node.targets[0].id] = node.value.value
    return out


def _axis_of(node: Optional[ast.expr], consts: Dict[str, str]) -> str:
    if node is None:
        return "<dynamic>"
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id, "<dynamic>")
    if isinstance(node, (ast.Tuple, ast.List)):
        parts = [_axis_of(e, consts) for e in node.elts]
        return "+".join(parts)
    if isinstance(node, ast.Attribute):
        return consts.get(node.attr, "<dynamic>")
    return "<dynamic>"


def _dotted(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _param_defaults(fn: ast.AST, consts: Dict[str, str]) -> Dict[str, str]:
    """Function parameters whose default is a resolvable axis name —
    ``def copy_to_region(x, mesh, axis=TENSOR_AXIS)`` makes a bare
    ``axis`` inside the body mean "tensor"."""
    out: Dict[str, str] = {}
    args = fn.args
    for params, defaults in ((args.args, args.defaults),
                             (args.kwonlyargs, args.kw_defaults)):
        pad = len(params) - len(defaults)
        for p, d in zip(params[pad:], defaults):
            if d is None:
                continue
            a = _axis_of(d, consts)
            if a != "<dynamic>":
                out[p.arg] = a
    return out


def _scan_file(path: str, rel: str) -> Iterator[Dict[str, Any]]:
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return
    mod_consts = _module_str_constants(tree)
    # innermost enclosing function's resolvable defaults shadow outer ones
    scopes: List[Tuple[ast.AST, Dict[str, str]]] = []

    def consts_at(node: ast.AST) -> Dict[str, str]:
        merged = dict(mod_consts)
        for fn, defaults in scopes:
            if (fn.lineno <= node.lineno
                    and node.lineno <= (fn.end_lineno or node.lineno)):
                merged.update(defaults)
        return merged

    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            d = _param_defaults(fn, mod_consts)
            if d:
                scopes.append((fn, d))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        callee = _dotted(node.func) or ""
        last = callee.rsplit(".", 1)[-1]
        if isinstance(node.func, ast.Attribute) and last in _MESH_AXIS_POS:
            recv = (_dotted(node.func.value) or "").rsplit(".", 1)[-1]
            if not recv.lower().endswith("mesh"):
                continue
            pos = _MESH_AXIS_POS[last]
            axis_node = node.args[pos] if len(node.args) > pos else None
            for kw in node.keywords:
                if kw.arg == "axis":
                    axis_node = kw.value
            axis = "data" if axis_node is None \
                else _axis_of(axis_node, consts_at(node))
            op = MESH_TO_OP[last]
            yield {"file": rel, "line": node.lineno, "call": last,
                   "op": op, "axis": axis, "wire": OPS[op]["wire"]}
        elif last in _REGIONS and isinstance(node.func, ast.Name) \
                and len(node.args) >= 2:
            axis_node = node.args[2] if len(node.args) > 2 else None
            for kw in node.keywords:
                if kw.arg == "axis":
                    axis_node = kw.value
            fwd, bwd = _REGIONS[last]
            yield {"file": rel, "line": node.lineno, "call": last,
                   "op": "region", "forward": fwd or "none",
                   "backward": bwd or "none",
                   "axis": _axis_of(axis_node, consts_at(node))
                   if axis_node is not None else "tensor",
                   "wire": "0",
                   "note": "autograd region: its forward and backward "
                           "collectives are the Mesh sites it calls"}


def default_scan_roots(repo_root: Optional[str] = None
                       ) -> Tuple[str, List[str]]:
    """(repo_root, files): the port's package tree the model covers."""
    if repo_root is None:
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    files: List[str] = []
    pkg = os.path.join(repo_root, "bigdl_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        files.extend(os.path.join(dirpath, f)
                     for f in sorted(filenames) if f.endswith(".py"))
    return repo_root, files


def scan_sites(repo_root: Optional[str] = None) -> List[Dict[str, Any]]:
    root, files = default_scan_roots(repo_root)
    sites: List[Dict[str, Any]] = []
    for path in files:
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        sites.extend(_scan_file(path, rel))
    sites.sort(key=lambda s: (s["file"], s["line"]))
    return sites


# ---------------------------------------------------------------------------
# Model assembly + rendering.
# ---------------------------------------------------------------------------

MODEL_VERSION = 1


def build_model(repo_root: Optional[str] = None) -> Dict[str, Any]:
    return {
        "version": MODEL_VERSION,
        "conventions": {
            "B": "full logical payload bytes (gathered / pre-scatter size), "
                 "as parallel.mesh.COLLECTIVES counts it on each rank",
            "S": "participant group size along the collective's mesh axis",
            "wire": "bytes crossing links per participating device, "
                    "bandwidth-optimal ring equivalent",
            "hbm": "device-memory bytes read + written by the op",
            "per": "step: each optimizer step; run: once a run (or epoch)",
            "ref": "same: the reference's algebra; port: a collective "
                   "only the port runs",
            "symbols": "see the MODES comment in analysis/commcost.py",
        },
        "ops": OPS,
        "modes": MODES,
        "sites": scan_sites(repo_root),
    }


def write_model(path: str, repo_root: Optional[str] = None) -> Dict[str, Any]:
    model = build_model(repo_root)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(model, f, indent=2, sort_keys=True)
        f.write("\n")
    return model
