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
send and a receive with the one process that holds them, except there. Only the ``DATA`` axis is ported: ``check_mesh``
refuses the others before anything is built.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from focus_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

MESH_AXES = ("PIPE", "SEQ", "MODEL", "EXPERT")


def check_mesh(cfg) -> None:
    """Raise, before anything is built, where ``TPU.MESH`` asks for a
    pipeline, sequence, model or expert axis above 1: the port shards the
    batch over processes and nothing else, and those layouts change what
    the JAX package builds (``PIPE`` pipelines the trajectory blocks) or
    refuse a single device (``focus_tpu/parallel/mesh.py``). A MoE config
    runs with ``TPU.MESH.PIPE 1 TPU.MESH.EXPERT 1``: every expert on every
    card."""
    mesh = cfg.TPU.MESH
    over = [f"TPU.MESH.{k} {mesh[k]}" for k in MESH_AXES
            if int(mesh.get(k, 1) or 1) > 1]
    if over:
        raise NotImplementedError(
            f"{', '.join(over)}: the port runs no pipeline, sequence, model "
            "or expert axis yet (ROADMAP.md section 1 item 8); set them to 1 "
            "to shard the batch alone")


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
    return device


def is_distributed() -> bool:
    """Whether a process group is set up (the collectives run)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def batch_rows(rows: int):
    """(first, rows, total) of this process's ``rows`` of a global batch
    that every process shares evenly (``models/common.sharded_draws``)."""
    return rank() * rows, rows, world_size() * rows


def _nccl() -> bool:
    return dist.get_backend() == "nccl"


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the processes, in place."""
    if is_distributed():
        dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """The processes' sum of a tensor, differentiable: the gradient of
    each process's input is the processes' sum of the output's gradients
    (each process's loss term reaches every input of the sum)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the processes, out of place and differentiable
    (BatchNorm's statistics); ``t`` itself without a process group."""
    return _AllReduceSum.apply(t) if is_distributed() else t


def all_reduce_mean_(tensors) -> None:
    """Each of ``tensors`` replaced by its mean over the processes, in one
    collective over their flat concatenation (by dtype)."""
    if not is_distributed():
        return
    w = dist.get_world_size()
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(w)
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def all_gather_tiled(t: torch.Tensor) -> torch.Tensor:
    """The processes' ``t`` [n, ...] stacked process-major into
    [W n, ...] (every process passes the same shape); ``t`` itself without
    a process group."""
    if not is_distributed():
        return t
    w, r = dist.get_world_size(), dist.get_rank()
    src = t.contiguous()
    if src.dtype == torch.bool:
        return all_gather_tiled(src.to(torch.uint8)).bool()
    if _nccl():
        out = torch.empty((w * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src)
        return out
    out = torch.zeros((w,) + tuple(src.shape), dtype=src.dtype,
                      device=src.device)
    out[r] = src
    dist.all_reduce(out)
    return out.reshape((w * src.shape[0],) + tuple(src.shape[1:]))


def from_mirror(t: torch.Tensor) -> torch.Tensor:
    """Process W - 1 - r's ``t`` on process r (every process passes the
    same shape); ``t`` itself without a process group and on the middle
    process of an odd world. A send to and a receive from that process
    alone, except for gloo's CUDA tensors, which take all-reduce alone:
    there its rows of ``all_gather_tiled``."""
    if not is_distributed():
        return t
    w, r = dist.get_world_size(), dist.get_rank()
    peer = w - 1 - r
    if peer == r:
        return t
    src = t.contiguous()
    if src.device.type == "cuda" and not _nccl():
        n = src.shape[0]
        return all_gather_tiled(src)[peer * n:(peer + 1) * n]
    out = torch.empty_like(src)
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
    if is_distributed():
        dist.destroy_process_group()
