"""Logical-axis sharding rules (MaxText-style), their DTensor placements, and
the gather a sharded model runs at each layer's entry: the torch twin of
the JAX package's ``distributed/sharding.py``.

Models annotate activations with *logical* axis names; the active rule set
maps names to mesh axes. Outside a rule context ``constrain`` is a no-op,
so model code runs unmodified on one device.

A *spec* is a tuple with one entry a dim: ``None``, a mesh axis name, or a
tuple of axis names (the counterpart of ``PartitionSpec``). ``placements``
turns it into DTensor placements: a dim over ``("data", "model")`` becomes
``Shard(i)`` on both mesh dims, which gives rank (d, m) block ``d·M + m``,
the reference's major-to-minor order.

Sharded parameters are ``DTensor``s, stored as the reference's device
stores them (``partition.param_specs``). The model computes on plain
tensors: at each layer's entry it calls :func:`gather_tree`, which gathers
the layer's slice of every sharded leaf (FSDP-style; the hand-written
kernels then see the tensors they take today). Under a train step's
:class:`GradSink`, each gather's backward casts the slice's gradient to
the step's ``grad_dtype`` and reduces it over the ranks to the leaf's
placements (a reduce-scatter where the leaf is sharded), adding it into
the sink; with ``torch.utils.checkpoint`` the gather runs again in the
backward. A plain tensor passes through untouched, and until
``steps.shard_model`` has placed a leaf (:func:`note_placed`) the gathers
return what they are given without walking it, so an unsharded model takes
exactly its usual path. The Megatron split's FSDP gather over ``data``
(``tensor_parallel.weight``) is the same gather without a sink
(:func:`regather`): its backward hands the reduced gradient back to the
block it was given.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

_state = threading.local()


def _rules() -> Optional[Dict[str, Any]]:
    return getattr(_state, "rules", None)


def _mesh():
    return getattr(_state, "mesh", None)


@contextmanager
def use_rules(rules: Dict[str, Any], mesh: Any = None):
    old_r, old_m = _rules(), _mesh()
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = old_r, old_m


def spec_for(*names: Optional[str]) -> Spec:
    """A spec from logical axis names under the active rules."""
    rules = _rules() or {}
    return tuple(rules.get(n) if n else None for n in names)


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, or a dict as given."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh: Any, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axes, str):
        return shape.get(axes, 1)
    n = 1
    for a in axes:
        n *= shape.get(a, 1)
    return n


def _axes(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def pad_spec(spec: Sequence, rank: int) -> Spec:
    """``spec`` padded with ``None`` to ``rank`` entries (a reference spec may
    be shorter than its leaf: ``P()`` for a scalar, ``P(*sp[:rank])``)."""
    spec = tuple(spec)
    if len(spec) > rank:
        raise ValueError(f"spec {spec} has more entries than a rank-{rank} leaf")
    return spec + (None,) * (rank - len(spec))


def placements(spec: Sequence, mesh: Any, rank: Optional[int] = None) -> List[Any]:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each mesh
    dim that dim i's entry names (in the entry's order, major to minor),
    ``Replicate()`` elsewhere. An axis the mesh lacks is ignored, as the
    reference's size lookup counts it 1."""
    spec = pad_spec(spec, len(spec) if rank is None else rank)
    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate() for _ in names]
    seen: Dict[str, int] = {}
    for i, entry in enumerate(spec):
        for a in _axes(entry):
            if a not in names:
                continue
            if a in seen:
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
            seen[a] = i
            out[names.index(a)] = Shard(i)
    # nested shards of one dim must run major to minor in mesh order
    for i, entry in enumerate(spec):
        axes = [a for a in _axes(entry) if a in names]
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec {spec}: dim {i}'s axes {axes} are not in the mesh's "
                             f"order {names}")
    return out


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Redistribute a ``DTensor`` to the spec of logical axis names; a no-op
    without rules or for a plain tensor. Axes that don't divide the dim are
    dropped (graceful degradation for awkward dims, e.g. capacity=5 over
    data=16)."""
    rules = _rules()
    if rules is None:
        return x
    if len(names) != x.dim():
        raise ValueError(f"constrain: {len(names)} names for rank-{x.dim()} array")
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    spec = tuple(a if (a is None or x.shape[i] % axis_size(mesh, a) == 0) else None
                 for i, a in enumerate(spec_for(*names)))
    return x.redistribute(mesh, placements(spec, mesh))


# ---------------------------------------------------------------- rule sets
def train_rules(multi_pod: bool, strategy: str = "tp") -> Dict[str, MeshAxes]:
    if strategy == "dp":
        # pure DP: batch over every non-pod axis; no tensor sharding at all
        batch = ("data", "model")
        return {k: None for k in (
            "seq", "act_seq", "embed", "heads", "kv_heads", "head_dim",
            "qkv_fused", "ff", "vocab", "experts", "expert_cap", "moe_rows",
            "moe_routes", "kv_seq", "ssm_heads", "state", "lora", "conv_dim",
        )} | {"batch": batch}
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "seq": None,
        # Megatron-style sequence parallelism at residual-stream save points:
        # shards the per-layer remat carries 16x over 'model'
        "act_seq": "model",
        "embed": None,
        "heads": "model",
        "kv_heads": None,        # kv heads usually < model size; GSPMD decides
        "head_dim": None,
        "qkv_fused": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "expert_cap": "data",
        "moe_rows": ("data", "model") if not multi_pod else ("pod", "data", "model"),
        "moe_routes": ("data", "model") if not multi_pod else ("pod", "data", "model"),
        "kv_seq": None,
        "ssm_heads": "model",
        "state": None,
        "lora": None,
        "conv_dim": "model",
    }


def decode_rules(multi_pod: bool, *, shard_kv_seq: bool = False) -> Dict[str, MeshAxes]:
    r = train_rules(multi_pod)
    if shard_kv_seq:
        # context parallelism: long_500k (batch=1) shards the KV/state length
        r["kv_seq"] = ("pod", "data") if multi_pod else ("data",)
        r["batch"] = None
    return r


def moe_ep_active() -> bool:
    """True under rules that route the MoE FFN expert-parallel (``_moe_ep``)."""
    rules = _rules()
    return bool(rules and rules.get("_moe_ep") and _mesh() is not None)


# ------------------------------------------------------ gather on layer entry
def is_dtensor(x: Any) -> bool:
    return isinstance(x, DTensor)


#: set once a model's parameter has been stored as a ``DTensor``
#: (``steps.shard_model``); until then :func:`gather_tree` returns its input
_placed = False


def note_placed() -> None:
    """A model of this process now holds sharded leaves: the layers' gathers
    walk their parameters from here on."""
    global _placed
    _placed = True


class Layer(NamedTuple):
    """Layer ``index`` of a stacked ``DTensor`` leaf (its dim 0, the layer
    stack, is never sharded); :func:`gather` makes it a plain tensor."""

    leaf: Any
    index: int


def layer_view(leaf: Any, i: int) -> Any:
    """Layer ``i`` of a stacked leaf for serving (no gradient): a view of a
    plain tensor, or of a one-rank ``DTensor``'s block (the whole leaf), so
    that a model's cached per-layer views cost nothing a step; a
    :class:`Layer`, gathered at each use, on a mesh of several ranks."""
    if not is_dtensor(leaf):
        return leaf[i]
    if leaf.device_mesh.size() == 1:
        return leaf.to_local()[i]
    return Layer(leaf, i)


class GradSink:
    """Where a train step's gathers put the gradients of sharded leaves:
    each leaf's gradient, in its local block's shape, summed over the
    gathers of the step (its layers, and every use of a leaf used twice)."""

    def __init__(self, grad_dtype: Optional[torch.dtype] = None):
        self.grad_dtype = grad_dtype
        self.grads: Dict[int, Tuple[Any, torch.Tensor]] = {}
        self.anchors: Dict[torch.device, torch.Tensor] = {}

    def anchor(self, device: torch.device) -> torch.Tensor:
        """A 0-d tensor that requires grad, so that a gather takes part in
        autograd although the sharded leaf itself does not."""
        if device not in self.anchors:
            self.anchors[device] = torch.zeros((), device=device, requires_grad=True)
        return self.anchors[device]

    def add(self, leaf: Any, index: Optional[int], g: torch.Tensor) -> None:
        key = id(leaf)
        if key not in self.grads:
            local = leaf.to_local()
            self.grads[key] = (leaf, torch.zeros(local.shape, dtype=g.dtype, device=local.device))
        buf = self.grads[key][1]
        (buf if index is None else buf[index]).add_(g)

    def grad(self, leaf: Any) -> Optional[torch.Tensor]:
        got = self.grads.get(id(leaf))
        return None if got is None else got[1]


@contextmanager
def collect_grads(sink: GradSink):
    """Gathers inside the block send their gradients to ``sink``."""
    old = getattr(_state, "sink", None)
    _state.sink = sink
    try:
        yield sink
    finally:
        _state.sink = old


def _slice(x: Any):
    """(leaf, layer index or None, local block, placements, global shape) of a
    sharded leaf or of one layer of it."""
    if isinstance(x, Layer):
        leaf, i = x.leaf, x.index
        pl = []
        for p in leaf.placements:
            if isinstance(p, Shard):
                if p.dim == 0:
                    raise ValueError("a layer stack's dim 0 is never sharded")
                p = Shard(p.dim - 1)
            pl.append(p)
        return leaf, i, leaf.to_local()[i], pl, tuple(leaf.shape[1:])
    return x, None, x.to_local(), list(x.placements), tuple(x.shape)


def _moves(mesh, src: Sequence, dst: Sequence) -> bool:
    """True when going from placements ``src`` to ``dst`` crosses a mesh dim
    of more than one rank (else the local block already is the result)."""
    return any(a != b and mesh.size(k) > 1 for k, (a, b) in enumerate(zip(src, dst)))


def _redistribute(local, mesh, src, dst, shape) -> torch.Tensor:
    if not _moves(mesh, src, dst):
        return local
    stride = torch.empty(shape, device="meta").stride()
    t = DTensor.from_local(local, mesh, src, run_check=False, shape=shape, stride=stride)
    return t.redistribute(mesh, dst).to_local()


class _Gather(torch.autograd.Function):
    """Forward: ``local``, a block under placements ``src``, redistributed to
    ``target`` (plain tensor). Backward: its gradient, under placements
    ``grad_pl`` (``Partial`` over the ranks whose shares it sums), reduced
    back to ``src``: cast to the sink's dtype and added into ``sink`` as
    ``key``'s (leaf, layer index), where no gradient flows on; without a
    sink, handed back as ``local``'s gradient."""

    @staticmethod
    def forward(ctx, anchor, local, mesh, src, target, grad_pl, shape, sink, key):
        ctx.meta = (mesh, src, grad_pl, shape, sink, key)
        return _redistribute(local, mesh, src, target, shape).detach()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        mesh, src, grad_pl, shape, sink, key = ctx.meta
        if sink is not None and sink.grad_dtype is not None:
            g = g.to(sink.grad_dtype)
        g = _redistribute(g.contiguous(), mesh, grad_pl, src, shape)
        if sink is None:
            return (None, g) + (None,) * 7
        sink.add(*key, g)
        return (None,) * 9


def regather(local: torch.Tensor, mesh, src: Sequence, target: Sequence,
             shape: Tuple[int, ...]) -> torch.Tensor:
    """``local``, this rank's block of a tensor of global ``shape`` under
    placements ``src``, redistributed to ``target`` by :class:`_Gather`
    without a sink: the gradient comes back to ``local``, summed over the
    ranks of each mesh dim that ``target`` gathers (a reduce-scatter) and
    moved back where it only moves. ``local`` itself where nothing moves."""
    if not _moves(mesh, src, target):
        return local
    if not (torch.is_grad_enabled() and local.requires_grad):
        return _redistribute(local, mesh, src, target, shape)
    grad_pl = [Partial() if isinstance(t, Replicate) and not isinstance(s, Replicate) else t
               for s, t in zip(src, target)]
    return _Gather.apply(None, local, mesh, list(src), list(target), grad_pl, shape, None, None)


def gather(x: Any) -> Any:
    """A plain tensor of ``x``: ``x`` itself when it is one; a sharded leaf
    or :class:`Layer` gathered whole."""
    if not isinstance(x, Layer) and not is_dtensor(x):
        return x
    sink = getattr(_state, "sink", None) if torch.is_grad_enabled() else None
    leaf = x.leaf if isinstance(x, Layer) else x
    if sink is None and leaf.device_mesh.size() == 1:  # one rank: its block is the leaf
        local = leaf.to_local()
        return local[x.index] if isinstance(x, Layer) else local
    leaf, index, local, src, shape = _slice(x)
    mesh = leaf.device_mesh
    target = [Replicate() for _ in mesh.mesh_dim_names]
    if sink is None:
        return _redistribute(local, mesh, src, target, shape)
    partial = [Partial() if isinstance(t, Replicate) else t for t in target]
    return _Gather.apply(sink.anchor(local.device), local, mesh, src, target, partial, shape,
                         sink, (leaf, index))


def gather_tree(tree: Any, keep: Sequence[str] = ()) -> Any:
    """:func:`gather` over a layer's nested dict (or a ``ParamTree``'s);
    keys in ``keep`` stay as they are (the expert weights, which the
    expert-parallel FFN gathers). ``tree`` itself while no model holds a
    sharded leaf."""
    if not _placed:
        return tree
    return _gather_tree(tree.tree() if isinstance(tree, torch.nn.Module) else tree, keep)


def _gather_tree(tree: Any, keep: Sequence[str]) -> Any:
    if isinstance(tree, dict):
        return {k: (v if k in keep else _gather_tree(v, keep)) for k, v in tree.items()}
    return gather(tree)
