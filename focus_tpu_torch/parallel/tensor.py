"""Tensor and sequence parallelism (counterpart of ``_param_spec``,
``state_shardings`` and ``shard_tokens`` in ``focus_tpu/parallel/mesh.py``).

Placement (``param_dim``): the JAX name rule on the bridge's JAX names
(``utils/weights.py``: a ``TwoLayerReluMlp``'s ``0`` / ``2`` are JAX's
``fc1`` / ``fc2``). A dense layer under a ``qkv`` or ``fc1`` module is
column-parallel (its output dim, the torch weight's dim 0 and its bias,
split over the model line), one under ``proj`` or ``fc2`` row-parallel
(its input dim, the weight's dim 1; the bias whole); a leaf stays whole
where the axis does not divide it. ``proj_q``, ``proj_kv``, the
patch-embed ``proj`` convolution, ``pre_logits``, the heads, the
LayerNorms and the embeddings stay whole. A ``qkv`` shard holds this
rank's channels of each of q, k and v (its heads), where JAX's GSPMD
splits the fused output dim as one run: the dim is JAX's, the layout of
the shard the port's.

The Megatron autograd pairs over the model line: ``copy_in`` (identity
forward, all-reduce backward) before a column-parallel layer,
``reduce_out`` (all-reduce forward, identity backward) after a
row-parallel one, ``gather`` (all-gather forward, split backward) and
``split`` (split forward, all-gather backward). Over the seq line
``gather_seq`` all-gathers the K and V of every rank's frames, and its
backward is a reduce-scatter: each rank's partial gradient of every frame,
summed, back to the frame's rank. ``seq_grad_gate`` lets the loss's
gradient into the replicated CLS row on seq rank 0 alone, so that the seq
line's sum of gradients counts it once.

The expert and pipe axes (``TPU.MESH.EXPERT``, ``PIPE``): a MoE
layer's four expert leaves (``experts.{kernel1,bias1,kernel2,bias2}``)
are cut on their expert dim, dim 0, over the expert line where it divides
E (``expert_dim``, ``_param_spec``'s rule), and a pipe rank holds its
stage's blocks of every pipelined segment alone
(``parallel/pipeline.py``); everything else is whole on every rank.

``shard_model`` cuts a built model's leaves to this rank's shards, drops
the other stages' blocks and tells its modules their lines (``Parallel``);
``full_state_dict`` gathers the shards and the stages back to the bridge's
full names and shapes and ``load_full_state_dict`` cuts full tensors into
a sharded model, so a checkpoint written on any mesh loads on any other.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from focus_tpu_torch.parallel import mesh

_COL_PARALLEL = {"qkv", "fc1"}
_ROW_PARALLEL = {"proj", "fc2"}
# the port's TwoLayerReluMlp is an nn.Sequential: its slots 0 and 2 are the
# JAX module's fc1 and fc2
_SEQUENTIAL_MLPS = ("patch_to_d", "c_coord_to_feature")
_SLOTS = {"0": "fc1", "2": "fc2"}


def jax_components(name: str):
    """The components of a parameter's name as the JAX path names them."""
    comps = name.split(".")
    return [(_SLOTS[c] if i and comps[i - 1] in _SEQUENTIAL_MLPS
             and c in _SLOTS else c) for i, c in enumerate(comps)]


def param_dim(name: str, shape, model_size: int):
    """The dim of a parameter (torch name and layout) that the model axis
    splits, as ``_param_spec`` places its JAX leaf, or None (whole)."""
    if model_size <= 1:
        return None
    comps = jax_components(name)
    col = any(c in _COL_PARALLEL for c in comps)
    row = any(c in _ROW_PARALLEL for c in comps)
    leaf, ndim = comps[-1], len(shape)
    if col and leaf == "weight" and ndim == 2:
        return 0 if shape[0] % model_size == 0 else None
    if col and leaf == "bias" and ndim == 1:
        return 0 if shape[0] % model_size == 0 else None
    if row and leaf == "weight" and ndim == 2:
        return 1 if shape[1] % model_size == 0 else None
    return None


_EXPERT_LEAVES = ("kernel1", "bias1", "kernel2", "bias2")


def expert_dim(name: str, shape, expert_size: int):
    """The dim of a MoE expert leaf that the expert axis splits (0, the
    expert dim), or None (whole): where EXPERT divides the experts, as
    ``_param_spec`` places the stacked experts."""
    comps = name.split(".")
    if (expert_size <= 1 or len(comps) < 2 or comps[-2] != "experts"
            or comps[-1] not in _EXPERT_LEAVES):
        return None
    return 0 if shape[0] % expert_size == 0 else None


def _is_qkv(name: str) -> bool:
    return "qkv" in name.split(".")


def shard(full: torch.Tensor, name: str, dim, rank: int, size: int):
    """Model rank ``rank``'s shard of the full tensor ``full`` (a copy)."""
    if dim is None:
        return full
    if _is_qkv(name) and dim == 0:
        parts = full.reshape((3, full.shape[0] // 3) + tuple(full.shape[1:]))
        n = parts.shape[1] // size
        return parts[:, rank * n:(rank + 1) * n].reshape(
            (-1,) + tuple(full.shape[1:])).clone()
    n = full.shape[dim] // size
    return full.narrow(dim, rank * n, n).clone()


def unshard(parts, name: str, dim):
    """The full tensor from every model rank's shard, in rank order."""
    if dim is None:
        return parts[0]
    if _is_qkv(name) and dim == 0:
        split = [p.reshape((3, -1) + tuple(p.shape[1:])) for p in parts]
        full = torch.cat(split, dim=1)
        return full.reshape((-1,) + tuple(parts[0].shape[1:]))
    return torch.cat(parts, dim=dim)


# ---- the lines a module runs on -----------------------------------------

@dataclasses.dataclass
class Parallel:
    """This rank's place on the seq, model and expert lines, and their
    groups."""

    seq_rank: int = 0
    seq_size: int = 1
    seq_group: object = None
    model_rank: int = 0
    model_size: int = 1
    model_group: object = None
    expert_rank: int = 0
    expert_size: int = 1
    expert_group: object = None

    @property
    def seq(self) -> bool:
        return self.seq_size > 1

    @property
    def model(self) -> bool:
        return self.model_size > 1

    def window(self, frames: int):
        """(first frame, frames) of this seq rank's share of ``frames``."""
        n = frames // self.seq_size
        return self.seq_rank * n, n


def current() -> Parallel:
    """This process's lines, from ``parallel/mesh.py``."""
    return Parallel(mesh.seq_rank(), mesh.seq_size(), mesh.group("seq"),
                    mesh.model_rank(), mesh.model_size(), mesh.group("model"),
                    mesh.expert_rank(), mesh.expert_size(),
                    mesh.group("expert"))


# ---- collectives with their autograd pairs ---------------------------------

def _all_reduce(t, group):
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _all_gather(t, dim, group):
    """``t`` of every rank of ``group`` concatenated along ``dim``, in rank
    order (gloo's CUDA tensors: an all-reduce, ``mesh.all_gather_tiled``)."""
    moved = torch.movedim(t, dim, 0).contiguous()
    out = mesh.all_gather_tiled(moved, group)
    return torch.movedim(out, 0, dim)


def _own(t, dim, group):
    """This rank's equal share of ``t`` along ``dim``."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n).contiguous()


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _own(grad, ctx.dim, ctx.group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad.contiguous(), ctx.dim, ctx.group), None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _own(_all_reduce(grad, ctx.group), ctx.dim, ctx.group), None, \
            None


class _GradGate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.keep else torch.zeros_like(grad)), None


def copy_in(x, par: Parallel, group=None):
    """Identity forward, the model line's (or ``group``'s) sum of the
    gradients backward."""
    if group is not None:
        return _CopyIn.apply(x, group)
    return _CopyIn.apply(x, par.model_group) if par.model else x


def reduce_out(x, par: Parallel):
    """The model line's sum forward, identity backward."""
    return _ReduceOut.apply(x, par.model_group) if par.model else x


def gather(x, dim: int, par: Parallel, group=None):
    """The model line's (or ``group``'s) shards concatenated along
    ``dim``; backward, this rank's share of the gradient."""
    if group is not None:
        return _Gather.apply(x, dim % x.ndim, group)
    return _Gather.apply(x, dim % x.ndim, par.model_group) if par.model else x


def split(x, dim: int, par: Parallel):
    """This rank's share along ``dim``; backward, the model line's shares of
    the gradient concatenated."""
    return _Split.apply(x, dim % x.ndim, par.model_group) if par.model else x


def gather_seq(x, dim: int, par: Parallel):
    """The seq line's tokens concatenated along ``dim``; backward, the
    line's sum of the gradient, this rank's share of it (reduce-scatter)."""
    return _GatherSeq.apply(x, dim % x.ndim, par.seq_group) if par.seq else x


def seq_grad_gate(x, par: Parallel):
    """Identity forward; backward, the gradient on seq rank 0 and zeros on
    the others (the replicated CLS row's loss gradient enters once)."""
    return _GradGate.apply(x, par.seq_rank == 0) if par.seq else x


def row_linear(x, layer, par: Parallel):
    """A row-parallel dense layer at x's dtype: the local product, the
    model line's sum, then the bias once."""
    y = reduce_out(torch.nn.functional.linear(x, layer.weight.to(x.dtype)),
                   par)
    return y if layer.bias is None else y + layer.bias.to(x.dtype)


# ---- a model's shards ------------------------------------------------------

def specs(model) -> dict:
    """{name: split dim} of a model's leaves split over the model line
    (empty if none)."""
    return getattr(model, "tp_specs", {})


def expert_specs(model) -> dict:
    """{name: split dim} of a model's leaves split over the expert line."""
    return getattr(model, "ep_specs", {})


def is_sharded(model) -> bool:
    """Whether any leaf of ``model`` is split or held by one stage (its
    full state dict is a collective)."""
    return bool(specs(model) or expert_specs(model)
                or getattr(model, "pipe_place", None))


class StageElsewhere(torch.nn.Module):
    """Stands in a pipe rank's model for a block another stage holds."""

    def __init__(self, stage: int):
        super().__init__()
        self.stage = stage

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"this block runs on pipeline stage {self.stage}")


def _cut(model, name, local):
    owner = model.get_submodule(name.rsplit(".", 1)[0])
    leaf = name.rsplit(".", 1)[1]
    p = getattr(owner, leaf)
    setattr(owner, leaf, torch.nn.Parameter(local,
                                            requires_grad=p.requires_grad))


@torch.no_grad()
def shard_model(model):
    """Cut ``model``'s split leaves to this rank's shards (in place, as new
    parameters), put the other stages' blocks out of it and give its
    modules this process's lines (``current()``). Raises where a layer's
    heads do not split evenly. The whole model's parameter names and
    shapes stay on it (``full_shapes``)."""
    from focus_tpu_torch.parallel import pipeline

    par = current()
    model.full_shapes = {n: tuple(p.shape)
                         for n, p in model.named_parameters()}
    dims, edims = {}, {}
    for name, p in list(model.named_parameters()):
        d = param_dim(name, p.shape, par.model_size)
        if d is not None:
            _cut(model, name, shard(p.data, name, d, par.model_rank,
                                    par.model_size))
            dims[name] = d
            continue
        d = expert_dim(name, p.shape, par.expert_size)
        if d is not None:
            n = p.shape[d] // par.expert_size
            _cut(model, name, p.data.narrow(d, par.expert_rank * n, n)
                 .clone())
            edims[name] = d
    line = pipeline.current()
    segs = getattr(model, "segments", [])
    if line.size > 1 and segs:
        model.pipe_place = {"line": line, "segments": segs,
                            "stages": line.size}
        for i in range(len(model.blocks)):
            s = pipeline.stage_of(segs, line.size, i)
            if s is not None and s != line.rank:
                model.blocks[i] = StageElsewhere(s)
    for module in model.modules():
        if hasattr(module, "attach_parallel"):
            module.attach_parallel(par, dims)
    model.tp_specs, model.ep_specs = dims, edims
    model.parallel = par
    return model


def full_tensor(model, name: str, t: torch.Tensor) -> torch.Tensor:
    """The full tensor of this rank's ``t`` of leaf ``name``, gathered over
    the model or expert line (a collective on a split leaf)."""
    d = specs(model).get(name)
    if d is not None:
        parts = mesh.all_gather_tiled(t.detach().contiguous()[None],
                                      model.parallel.model_group)
        return unshard(list(parts.unbind(0)), name, d)
    d = expert_specs(model).get(name)
    if d is not None:
        return torch.movedim(mesh.all_gather_tiled(
            torch.movedim(t.detach(), d, 0).contiguous(),
            model.parallel.expert_group), 0, d)
    return t


def full_state_dict(model) -> dict:
    """``model.state_dict()`` with every split leaf gathered to its full
    shape and every stage's blocks gathered over the pipe line (a
    collective: every rank calls it)."""
    from focus_tpu_torch.parallel import pipeline

    sd = model.state_dict()
    if not is_sharded(model):
        return sd
    out = {name: full_tensor(model, name, t) for name, t in sd.items()}
    return pipeline.gather_stages(model, out)


def local_tensor(model, name: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the full tensor ``full`` of parameter ``name``
    (``full`` itself where the leaf is whole)."""
    d = specs(model).get(name)
    par = getattr(model, "parallel", None)
    if d is not None:
        return shard(full, name, d, par.model_rank, par.model_size)
    d = expert_specs(model).get(name)
    if d is not None:
        n = full.shape[d] // par.expert_size
        return full.narrow(d, par.expert_rank * n, n)
    return full


@torch.no_grad()
def load_full_state_dict(model, sd, strict: bool = True):
    """Load full tensors (the bridge's names and shapes) into a model,
    sharded or not; a pipe rank takes its stage's blocks."""
    from focus_tpu_torch.parallel import pipeline

    local = {k: local_tensor(model, k, v) for k, v in sd.items()
             if pipeline.held(model, k)}
    return model.load_state_dict(local, strict=strict)
