"""Data parallelism over processes (the data axis of
``focus_tpu/parallel/mesh.py``; reference ``slowfast/utils/distributed.py``
and ``multiprocessing.py``).

One process drives one card. ``TRAIN.BATCH_SIZE`` and ``TEST.BATCH_SIZE``
are global batches, as in the JAX package: each of the W processes takes a
contiguous slice of every global batch (``datasets/loader.py``), and what
XLA computes over the batch-sharded array as one array is computed here
over the slices with collectives: the gradients' mean (``all_reduce_mean_``
in ``models/optimizer.py``), BatchNorm's statistics (``models/norms.py``),
the mixup partner batch, the loss and the top-k errors (``engine/trainer.py``)
and the eval outputs (``all_gather_tiled``, process-major, before every
meter update). So a run on W processes is a one-process run over the same
global batch, up to the order of the reductions.

``init_distributed`` sets up the process group: world ``NUM_GPUS x
NUM_SHARDS`` (``NUM_GPUS`` above the cards present uses the cards there
are, as ``build_mesh`` does), rank ``SHARD_ID x NUM_GPUS + local_rank``,
backend ``DIST_BACKEND``. Every helper here is a no-op where no process
group is set up; once one is, it runs its collective even at world 1.

Gloo's CUDA tensors take all-reduce and broadcast only, so under any
backend but NCCL a gather is an all-reduce of a zero buffer with this
process's rows filled in; mixup's partner rows (``from_mirror``) are a
send and a receive with the one process that holds them, except there.

The sequence, model, pipe and expert axes (``TPU.MESH.SEQ``, ``MODEL``,
``PIPE``, ``EXPERT``): rank r sits on the grid (data, pipe, seq, model,
expert) in ``build_mesh``'s order, expert fastest, so r = (((d PIPE + p)
SEQ + s) MODEL + m) EXPERT + e. ``DATA`` absorbs what ``PIPE x SEQ x MODEL
x EXPERT`` leaves of the world, as in the JAX package. ``set_axes`` makes
one process group for every data, pipe, seq, model and expert line, one for
every data x seq plane (the gradients' reduction, ``models/optimizer.py``)
and one for every pair of neighbouring stages of a pipe line (the
pipeline's hand-offs under gloo, ``parallel/pipeline.py``); every rank
makes every group, in the same order. The pipe, seq, model and expert
ranks of one data line hold the same clips, so the loader, the drawn rows
(``batch_rows``), mixup's partner, BatchNorm, the stats and the eval
gathers read the data axis (``data_rank``, ``data_size``, the collectives'
``group``); with no other axis the data line is the world. ``check_mesh``
refuses what the JAX package refuses and what the port does not run,
before anything is built. Within ``single_process_mesh`` a process with no
process group plays every rank of the mesh its config names (every stage
and every expert, and with ``data`` that many data ranks' microbatches):
the one-process reference of a mesh run.
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import os

import torch
import torch.distributed as dist

from focus_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

MESH_AXES = ("PIPE", "SEQ", "MODEL", "EXPERT")


def mesh_axes(cfg):
    """(pipe, seq, model, expert) of ``cfg.TPU.MESH``, each at least 1."""
    return tuple(max(int(cfg.TPU.MESH.get(k, 1) or 1), 1) for k in MESH_AXES)


# (pipe, seq, model, expert) of the job this process belongs to; set by
# init_distributed
_AXES = (1, 1, 1, 1)
# the process groups of this rank's lines, by axis ("data", "pipe", "seq",
# "model", "expert", "data_seq", and ("pipe_pair", p) for stages p and
# p + 1 of its pipe line); empty where every axis but data is 1
_GROUPS = {}
# the data ranks a process with no process group plays (0: none, it is
# not playing a mesh)
_SINGLE = 0


@contextlib.contextmanager
def single_process_mesh(data: int = 1):
    """Within it, a process with no process group holds every rank's share
    of the mesh that a config names: ``check_mesh`` takes the world as the
    axes' product times ``data``, the model is built whole (every pipeline
    stage and every expert) and runs the pipeline's schedule alone. It is
    the one-process reference that a mesh run is held against (the JAX
    package applies its pipelined model with no mesh the same way); with
    ``data`` above 1 it also cuts each batch into the microbatches that
    ``data`` data ranks cut (``virtual_data``), so that every microbatch
    holds the rows a mesh rank's holds. ``tools.run_net`` keeps the
    refusal of a world the axes do not divide."""
    global _SINGLE
    prev, _SINGLE = _SINGLE, max(int(data), 1)
    try:
        yield
    finally:
        _SINGLE = prev


def virtual_data() -> int:
    """The data ranks this process plays alone (``single_process_mesh``'s
    ``data``; 1 otherwise)."""
    return _SINGLE if _SINGLE and not is_distributed() else 1


def check_mesh(cfg, world=None) -> None:
    """Raise, before anything is built, where ``cfg.TPU.MESH`` asks for a
    layout that the JAX package refuses (``build_mesh``: sequence together
    with pipeline parallelism; a world that SEQ x MODEL x PIPE x EXPERT
    does not divide, ``world`` processes, default this job's; a pipeline
    axis with no trajectory segment it divides, reference defect 3) or
    that the port does not run (``check_axes``); under a pipeline axis, a
    train or test batch that the data axis times the microbatches does not
    divide (``parallel/pipeline.check_batches``)."""
    check_axes(cfg)
    pipe, seq, model, expert = mesh_axes(cfg)
    if world is None:
        world = (world_size() if is_distributed() or not _SINGLE
                 else pipe * seq * model * expert * _SINGLE)
    world = int(world)
    if world % (model * seq * pipe * expert):
        raise ValueError(
            f"{world} devices not divisible by model axis {model} x seq axis "
            f"{seq} x pipe axis {pipe} x expert axis {expert} (TPU.MESH.MODEL "
            f"{model}, TPU.MESH.SEQ {seq}, TPU.MESH.PIPE {pipe}, "
            f"TPU.MESH.EXPERT {expert}: a world of TPU.MESH.DATA x PIPE x SEQ "
            "x MODEL x EXPERT processes)")
    if pipe > 1:
        from focus_tpu_torch.parallel import pipeline

        pipeline.check_batches(cfg, world // (model * seq * pipe * expert))


def check_axes(cfg) -> None:
    """``check_mesh``'s refusals that need no world: sequence together with
    pipeline parallelism (the JAX package's), a pipeline axis that divides
    no run of trajectory blocks (``parallel/pipeline.segments``; the JAX
    package silently runs every block replicated there, reference defect
    3), and what the port does not run: any axis but data on another model
    than the Motionformer / ORViT-MF family, a pipeline axis together with
    the model axis, a sequence or model axis on a MoE model, and a model
    axis under ``TPU.INT8_SERVING`` (its dynamic activation scale is a max
    over the whole input row, which a row split would need reduced). SEQ
    must divide ``MF.TEMPORAL_RESOLUTION``: the tokens split by frames. An
    expert axis on a model without experts makes its ranks replicas, as in
    the JAX package."""
    pipe, seq, model, expert = mesh_axes(cfg)
    if seq > 1 and pipe > 1:
        raise ValueError(
            "sequence and pipeline parallelism each compose with data/model "
            "axes but not with each other (shard_tokens' token constraint "
            "conflicts with the pipeline microbatch layout)")
    over = [f"TPU.MESH.{k} {v}" for k, v in zip(MESH_AXES, (pipe, seq, model,
                                                           expert)) if v > 1]
    if over and cfg.MODEL.MODEL_NAME != "Motionformer":
        raise NotImplementedError(
            f"{' / '.join(over)} on MODEL.MODEL_NAME {cfg.MODEL.MODEL_NAME}: "
            "the port shards the Motionformer / ORViT-MF family alone "
            "(ROADMAP.md section 1 item 4)")
    if pipe > 1 and model > 1:
        raise NotImplementedError(
            f"TPU.MESH.PIPE {pipe} with TPU.MESH.MODEL {model}: the port does "
            "not split a pipeline stage's dense layers yet (ROADMAP.md "
            "section 1 item 4)")
    if pipe > 1:
        from focus_tpu_torch.parallel import pipeline

        if not pipeline.segments(cfg):
            raise ValueError(
                f"TPU.MESH.PIPE {pipe}: no run of trajectory blocks between "
                f"the ORViT layers {list(cfg.ORVIT.LAYERS)} of MF.DEPTH "
                f"{cfg.MF.DEPTH} is at least {pipe} long and divisible by "
                f"{pipe}, so nothing would be pipelined (the JAX package runs "
                "every block replicated there, reference defect 3)")
    if seq > 1 or model > 1:
        axes = f"TPU.MESH.SEQ {seq} / TPU.MESH.MODEL {model}"
        experts = int(cfg.TPU.MOE.NUM_EXPERTS or 0)
        if experts > 1:
            raise NotImplementedError(
                f"{axes} with TPU.MOE.NUM_EXPERTS {experts}: the MoE layers "
                "are not split over the sequence or model axis yet "
                "(ROADMAP.md section 1 item 4)")
        if model > 1 and cfg.TPU.INT8_SERVING:
            raise NotImplementedError(
                f"{axes} with TPU.INT8_SERVING: the W8A8 activation scale is "
                "a max over the whole input row, which a row split would need "
                "reduced (ROADMAP.md section 1 item 4)")
        if cfg.MF.TEMPORAL_RESOLUTION % seq:
            raise ValueError(
                f"TPU.MESH.SEQ {seq} does not divide MF.TEMPORAL_RESOLUTION "
                f"{cfg.MF.TEMPORAL_RESOLUTION}: the port splits the tokens by "
                "frames")


def local_processes(cfg, device="cuda") -> int:
    """The processes a host runs: ``NUM_GPUS`` (at least 1), no more than
    the devices there are, with ``build_mesh``'s warning: on CUDA the
    cards present (one where there is none, which then raises where it
    runs); on the CPU one under NCCL, which has no CPU collectives, and any
    number under gloo."""
    want = max(int(cfg.NUM_GPUS), 1)
    if torch.device(device).type == "cuda":
        have = max(torch.cuda.device_count(), 1)
    elif cfg.DIST_BACKEND == "nccl":
        have = 1
    else:
        return want
    if want > have:
        logger.warning(f"NUM_GPUS={want} > {have} local devices; using all "
                       f"{have}")
        return have
    return want


def init_distributed(cfg, local_rank: int, init_method: str,
                     device="cuda", num_processes=None) -> torch.device:
    """Join the process group of ``cfg``'s job as local process
    ``local_rank`` of ``num_processes`` (default ``local_processes``):
    world = processes x ``NUM_SHARDS``, rank = ``SHARD_ID`` x processes +
    local_rank, backend ``DIST_BACKEND``. Returns this process's device:
    ``cuda:<local_rank>`` (made current) for ``cuda``, or ``device`` as
    given where it names its index (several processes on one card, as the
    single-card check does) or is the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    procs = num_processes or local_processes(cfg, device.type)
    world = procs * max(int(cfg.NUM_SHARDS), 1)
    rank = int(cfg.SHARD_ID) * procs + local_rank
    dist.init_process_group(backend=cfg.DIST_BACKEND, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(minutes=30))
    set_axes(cfg)
    return device


def set_axes(cfg) -> None:
    """This job's pipe, seq, model and expert axes from ``cfg`` (checked by
    ``check_mesh`` against the world), and the process groups of every
    data, pipe, seq, model and expert line, every data x seq plane and
    every pair of neighbouring pipeline stages: every rank makes every
    group, in the same order."""
    global _AXES
    check_mesh(cfg)
    _AXES = mesh_axes(cfg)
    _GROUPS.clear()
    pipe, seq, model, expert = _AXES
    if pipe * seq * model * expert == 1:
        return
    # the ranks of a pipe, seq, model or expert line compute their
    # replicated leaves' gradients alike, and must get them bit for bit
    # alike: cuBLAS picks its internal implementation by the streams in
    # flight (the collectives' copies run on side streams) unless its
    # workspace is fixed, which this does for the handles made after it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    data = dist.get_world_size() // (pipe * seq * model * expert)
    me = dist.get_rank()
    sizes = (data, pipe, seq, model, expert)

    def rank_of(c):
        r = 0
        for v, n in zip(c, sizes):
            r = r * n + v
        return r

    def lines(axes):
        """Every line over ``axes`` (indices into the grid): the ranks
        along them, the others fixed, in grid order."""
        rest = [a for a in range(5) if a not in axes]
        out = []
        for fixed in itertools.product(*(range(sizes[a]) for a in rest)):
            members = []
            for free in itertools.product(*(range(sizes[a]) for a in axes)):
                c = [0] * 5
                for a, v in zip(rest, fixed):
                    c[a] = v
                for a, v in zip(axes, free):
                    c[a] = v
                members.append(rank_of(c))
            out.append(members)
        return out

    def make(name, members):
        for ranks in members:
            g = dist.new_group(ranks)
            if me in ranks:
                _GROUPS[name] = g

    for name, axes in (("data", (0,)), ("pipe", (1,)), ("seq", (2,)),
                       ("model", (3,)), ("expert", (4,)),
                       ("data_seq", (0, 2))):
        make(name, lines(axes))
    for line in lines((1,)):
        for p in range(pipe - 1):
            g = dist.new_group(line[p:p + 2])
            if me in line[p:p + 2]:
                _GROUPS[("pipe_pair", p)] = g


def is_distributed() -> bool:
    """Whether a process group is set up (the collectives run)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def pipe_size() -> int:
    return _AXES[0]


def seq_size() -> int:
    return _AXES[1]


def model_size() -> int:
    return _AXES[2]


def expert_size() -> int:
    return _AXES[3]


def _across() -> int:
    """Ranks a data line holds: PIPE x SEQ x MODEL x EXPERT."""
    return _AXES[0] * _AXES[1] * _AXES[2] * _AXES[3]


def data_size() -> int:
    """Processes on the data axis: the world over PIPE x SEQ x MODEL x
    EXPERT."""
    return world_size() // _across()


def data_rank() -> int:
    return rank() // _across()


def pipe_rank() -> int:
    return rank() // (_AXES[1] * _AXES[2] * _AXES[3]) % _AXES[0]


def seq_rank() -> int:
    return rank() // (_AXES[2] * _AXES[3]) % _AXES[1]


def model_rank() -> int:
    return rank() // _AXES[3] % _AXES[2]


def expert_rank() -> int:
    return rank() % _AXES[3]


def group(axis):
    """The process group of this rank's ``axis`` line ("data", "pipe",
    "seq", "model", "expert"), plane ("data_seq") or pair of stages
    (("pipe_pair", p): stages p and p + 1): None (the world) for the data
    line and plane where every other axis is 1."""
    return _GROUPS.get(axis)


def batch_rows(rows: int):
    """(first, rows, total) of this process's ``rows`` of a global batch
    that every data rank shares evenly (``models/common.sharded_draws``);
    the pipe, seq, model and expert ranks of a data line hold the same
    rows."""
    return data_rank() * rows, rows, data_size() * rows


def _nccl() -> bool:
    return dist.get_backend() == "nccl"


def _size(group=None) -> int:
    return dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the processes of ``group`` (default: the world),
    in place."""
    if is_distributed():
        dist.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """The processes' sum of a tensor, differentiable: the gradient of
    each process's input is the processes' sum of the output's gradients
    (each process's loss term reaches every input of the sum)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the processes of ``group``, out of place and
    differentiable (BatchNorm's statistics); ``t`` itself without a process
    group."""
    return _AllReduceSum.apply(t, group) if is_distributed() else t


def all_reduce_mean_(tensors, group=None, divide=None) -> None:
    """Each of ``tensors`` replaced by its sum over the processes of
    ``group`` (default: the world) over ``divide`` (default: their
    number), in one collective over their flat concatenation (by dtype)."""
    if not is_distributed():
        return
    w = _size(group) if divide is None else divide
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat.div_(w)
        offset = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def all_gather_tiled(t: torch.Tensor, group=None) -> torch.Tensor:
    """The processes' ``t`` [n, ...] of ``group`` (default: the world)
    stacked in their order into [W n, ...] (every process passes the same
    shape); ``t`` itself without a process group."""
    if not is_distributed():
        return t
    w, r = _size(group), dist.get_rank(group)
    src = t.contiguous()
    if src.dtype == torch.bool:
        return all_gather_tiled(src.to(torch.uint8), group).bool()
    if _nccl():
        out = torch.empty((w * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=group)
        return out
    out = torch.zeros((w,) + tuple(src.shape), dtype=src.dtype,
                      device=src.device)
    out[r] = src
    dist.all_reduce(out, group=group)
    return out.reshape((w * src.shape[0],) + tuple(src.shape[1:]))


def from_mirror(t: torch.Tensor) -> torch.Tensor:
    """Data rank D - 1 - d's ``t`` on data rank d (the same seq and model
    ranks; every process passes the same shape); ``t`` itself without a
    process group and on the middle rank of an odd data axis. A send to
    and a receive from that process alone, except for gloo's CUDA tensors,
    which take all-reduce alone: there its rows of ``all_gather_tiled``
    over the data line."""
    if not is_distributed():
        return t
    g = group("data")
    w, r = _size(g), dist.get_rank(g)
    peer = w - 1 - r
    if peer == r:
        return t
    src = t.contiguous()
    if src.device.type == "cuda" and not _nccl():
        n = src.shape[0]
        return all_gather_tiled(src, g)[peer * n:(peer + 1) * n]
    out = torch.empty_like(src)
    peer = peer if g is None else dist.get_global_rank(g, peer)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, src, peer),
                                       dist.P2POp(dist.irecv, out, peer)]):
        req.wait()
    return out


def any_process(flag: bool) -> bool:
    """Whether ``flag`` is set on any process (an all-reduce max, on the
    current card under NCCL)."""
    if not is_distributed():
        return bool(flag)
    device = (torch.device("cuda", torch.cuda.current_device()) if _nccl()
              else torch.device("cpu"))
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def destroy() -> None:
    """Leave the process group, if any."""
    global _AXES
    _AXES = (1, 1, 1, 1)
    _GROUPS.clear()
    if is_distributed():
        dist.destroy_process_group()
