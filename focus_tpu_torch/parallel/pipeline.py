"""Pipeline parallelism over processes (counterpart of
``PipelinedTrajBlocks`` in ``focus_tpu/models/motionformer.py`` and of the
layout conversions in ``focus_tpu/parallel/pipeline.py``).

The segments (``segments``): each maximal run of trajectory blocks between
ORViT layers whose length is at least ``TPU.MESH.PIPE`` and divisible by it
is pipelined; every other block runs replicated on every pipe rank (the
JAX package's rule). A segment of L blocks runs as PIPE stages of L / PIPE
consecutive blocks each, and pipe rank p holds stage p's blocks of every
segment.

The schedule: a data rank cuts its rows into ``PIPE_MICROBATCHES`` M local
microbatches; stage p runs microbatch t - p at tick t, so M microbatches
finish in M + PIPE - 1 ticks (JAX's fill / drain order). A stage's output
moves to the next stage at the end of its tick and, in the backward, the
gradient of its input moves back to the previous one (``_exchange``: a
send and a receive under NCCL, a broadcast on the two stages' group under
gloo). The whole segment is one ``torch.autograd.Function``
(``_Schedule``): its forward keeps each microbatch's graph, its backward
runs the ticks in reverse and backpropagates each microbatch in a fixed
order, so that no two stages wait on each other's autograd. The last
stage broadcasts the segment's output over the pipe line (the blocks and
the head after it run replicated) and takes the output's gradient alone;
stage 0 broadcasts the input's gradient back to every pipe rank.

Stochastic depth: the masks of every layer of the segment are drawn
before the schedule, at the batch's size and in the order one process
draws them (each block's attention then MLP branch), on every pipe rank:
a layer's mask for a row does not depend on the schedule, and the
generator leaves the segment where one process leaves it.

In one process (no pipe axis, or ``mesh.single_process_mesh``) the same
stages run one after the other on each microbatch under plain autograd:
the reference a pipe line is held against. Each MoE layer's load-balance
sums come out per local microbatch (``models/moe.LoadBalance``), which the
trainer groups by JAX's global microbatches.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from focus_tpu_torch.parallel import mesh


def microbatches(cfg) -> int:
    """``TPU.MESH.PIPE_MICROBATCHES``, PIPE where it is 0."""
    pipe = max(int(cfg.TPU.MESH.PIPE or 1), 1)
    return max(int(cfg.TPU.MESH.PIPE_MICROBATCHES or 0), 0) or pipe


def segments(cfg):
    """[(first, end)] of the pipelined runs of blocks (``end`` exclusive),
    by the JAX package's rule (``focus_tpu/models/motionformer.py``
    ``Motionformer.setup``); empty without a pipeline axis."""
    pipe = max(int(cfg.TPU.MESH.PIPE or 1), 1)
    if pipe == 1:
        return []
    out, i, depth = [], 0, int(cfg.MF.DEPTH)
    orvit = set(cfg.ORVIT.LAYERS)
    while i < depth:
        if i in orvit:
            i += 1
            continue
        j = i
        while j < depth and j not in orvit:
            j += 1
        if j - i >= pipe and (j - i) % pipe == 0:
            out.append((i, j))
        i = j
    return out


def check_rows(rows: int, data: int, m: int) -> None:
    """Raise where ``m`` microbatches do not split a batch of ``rows``
    global rows over ``data`` data ranks: the JAX package's refusal where
    ``m`` does not divide the batch, the port's where ``data x m`` does not
    (each data rank cuts its own rows into ``m`` local microbatches)."""
    if rows % m:
        raise ValueError(
            f"batch {rows} not divisible by {m} pipeline microbatches "
            "(TPU.MESH.PIPE_MICROBATCHES)")
    if rows % (data * m):
        raise ValueError(
            f"batch {rows} not divisible by TPU.MESH.DATA {data} x "
            f"TPU.MESH.PIPE_MICROBATCHES {m}: each data rank cuts its rows "
            "into the microbatches (ROADMAP.md section 3)")


def check_batches(cfg, data: int) -> None:
    """``check_rows`` on the train batch (a ``TPU.GRAD_ACCUM`` microbatch
    of it) and the test batch of ``cfg`` over ``data`` data ranks."""
    m = microbatches(cfg)
    accum = max(int(cfg.TPU.GRAD_ACCUM or 1), 1)
    if cfg.TRAIN.ENABLE and cfg.TRAIN.BATCH_SIZE % accum == 0:
        check_rows(cfg.TRAIN.BATCH_SIZE // accum, data, m)
    if cfg.TEST.ENABLE:
        check_rows(cfg.TEST.BATCH_SIZE, data, m)


def stage_of(segs, stages: int, block: int) -> Optional[int]:
    """The stage that holds ``block`` (None: a replicated block)."""
    for a, b in segs:
        if a <= block < b:
            return (block - a) // ((b - a) // stages)
    return None


_BLOCK = re.compile(r"^blocks\.(\d+)\.")


def block_of(name: str) -> Optional[int]:
    m = _BLOCK.match(name)
    return int(m.group(1)) if m else None


def restage(name: str, segs, stages: int, to: int) -> str:
    """The name of a stage block's leaf ``name`` in stage ``to``: the same
    place in that stage's share of the segment."""
    i = block_of(name)
    a, b = next((a, b) for a, b in segs if a <= i < b)
    per = (b - a) // stages
    j = a + to * per + (i - a) % per
    return f"blocks.{j}." + name[_BLOCK.match(name).end():]


# ---- a pipe line -----------------------------------------------------------

@dataclasses.dataclass
class Line:
    """This rank's pipe line: its stage, the stages, the line's group, its
    global ranks in stage order and the two-stage groups (by first
    stage)."""

    rank: int = 0
    size: int = 1
    group: object = None
    ranks: tuple = (0,)
    pairs: dict = dataclasses.field(default_factory=dict)


def current() -> Line:
    """This process's pipe line, from ``parallel/mesh.py``."""
    p, n = mesh.pipe_rank(), mesh.pipe_size()
    if n == 1:
        return Line()
    stride = mesh.seq_size() * mesh.model_size() * mesh.expert_size()
    base = mesh.rank() - p * stride
    pairs = {q: mesh.group(("pipe_pair", q)) for q in (p - 1, p)
             if 0 <= q < n - 1}
    return Line(p, n, mesh.group("pipe"),
                tuple(base + q * stride for q in range(n)), pairs)


def _exchange(line: Line, send=None, recv=None) -> None:
    """Stage hand-offs of one tick: ``send`` (tensor, stage) first, then
    ``recv`` (buffer, stage), each to or from a neighbouring stage. A
    send and a receive under NCCL; under gloo (CUDA tensors take
    all-reduce and broadcast alone) a broadcast on the two stages' group,
    sender first: every rank sends before it receives, so the chain of
    broadcasts ends at the stage that only receives."""
    if dist.get_backend() == "nccl":
        ops = []
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send[0].contiguous(),
                                  line.ranks[send[1]]))
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, recv[0], line.ranks[recv[1]]))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        return
    if send is not None:
        t = send[0].contiguous()
        dist.broadcast(t, src=line.ranks[line.rank],
                       group=line.pairs[min(line.rank, send[1])])
    if recv is not None:
        dist.broadcast(recv[0], src=line.ranks[recv[1]],
                       group=line.pairs[min(line.rank, recv[1])])


def _broadcast(t: torch.Tensor, line: Line, stage: int) -> torch.Tensor:
    """``t`` of stage ``stage`` on every rank of the pipe line."""
    t = t.contiguous()
    dist.broadcast(t, src=line.ranks[stage], group=line.group)
    return t


def _active(stage: int, tick: int, m: int) -> bool:
    return 0 <= tick - stage < m


# ---- the schedule ----------------------------------------------------------

@dataclasses.dataclass
class StageOut:
    """One stage's work on one microbatch: the output, and its MoE layers'
    load-balance sums ([layers, E] each; None without MoE)."""

    out: torch.Tensor
    probs: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    tokens: Optional[torch.Tensor] = None


def _ticks(run, xs, line: Line, m: int, grad: bool):
    """The forward ticks on this rank's stage: {microbatch: (input,
    StageOut)}; with ``grad`` each input is a leaf that requires grad and
    each microbatch keeps its graph."""
    p, n = line.rank, line.size
    done, inbox = {}, {}
    for t in range(m + n - 1):
        k = t - p
        if _active(p, t, m):
            x = xs[k] if p == 0 else inbox.pop(k)
            x = x.detach().requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                done[k] = (x, run(x, k))
        send = ((done[k][1].out.detach(), p + 1)
                if _active(p, t, m) and p < n - 1 else None)
        recv = None
        if p > 0 and _active(p - 1, t, m):
            inbox[t - (p - 1)] = torch.empty_like(xs[0])
            recv = (inbox[t - (p - 1)], p - 1)
        if send is not None or recv is not None:
            _exchange(line, send, recv)
    return done


def _sums(done, m, key):
    parts = [getattr(done[k][1], key) for k in range(m)]
    return None if parts[0] is None else torch.stack(parts, dim=1)


def _output(done, line: Line, m: int, like: torch.Tensor):
    """The segment's output on every rank of the line, from the last
    stage."""
    if line.rank == line.size - 1:
        y = torch.cat([done[k][1].out.detach() for k in range(m)])
    else:
        y = torch.empty((like.shape[0],) + tuple(like.shape[1:]),
                        dtype=like.dtype, device=like.device)
    return _broadcast(y, line, line.size - 1)


class _Schedule(torch.autograd.Function):
    """The pipelined segment on a pipe line: ``x`` [B, N, C] (the same on
    every pipe rank) -> (y [B, N, C], this stage's MoE probability sums
    [layers, M, E] or an empty tensor). The stage's parameter gradients
    accumulate in the backward, which returns the input's gradient from
    stage 0 on every pipe rank."""

    @staticmethod
    def forward(ctx, x, anchor, run, line, m, extra):
        xs = x.chunk(m)
        done = _ticks(run, xs, line, m, grad=True)
        ctx.run_state = (done, line, m)
        probs = _sums(done, m, "probs")
        extra["mask"], extra["tokens"] = _sums(done, m, "mask"), \
            _sums(done, m, "tokens")
        y = _output(done, line, m, x)
        if probs is None:
            probs = x.new_zeros(0)
        return y, probs.detach()

    @staticmethod
    def backward(ctx, dy, dprobs):
        done, line, m = ctx.run_state
        p, n = line.rank, line.size
        dys = dy.chunk(m) if p == n - 1 else None
        inbox, dxs = {}, {}
        for t in reversed(range(m + n - 1)):
            k = t - p
            send = None
            if _active(p, t, m):
                x, st = done.pop(k)
                outs = [st.out]
                grads = [dys[k] if p == n - 1 else inbox.pop(k)]
                if st.probs is not None and dprobs is not None \
                        and dprobs.numel():
                    outs.append(st.probs)
                    grads.append(dprobs[:, k])
                torch.autograd.backward(outs, grads)
                gx = x.grad if x.grad is not None else torch.zeros_like(x)
                if p > 0:
                    send = (gx, p - 1)
                else:
                    dxs[k] = gx
            recv = None
            if p < n - 1 and _active(p + 1, t, m):
                inbox[t - (p + 1)] = torch.empty(
                    (dy.shape[0] // m,) + tuple(dy.shape[1:]),
                    dtype=dy.dtype, device=dy.device)
                recv = (inbox[t - (p + 1)], p + 1)
            if send is not None or recv is not None:
                _exchange(line, send, recv)
        if p == 0:
            dx = torch.cat([dxs[k] for k in range(m)])
        else:
            dx = torch.empty_like(dy)
        return _broadcast(dx, line, 0), None, None, None, None, None


def run_schedule(run, x, stages: int, m: int, line: Line):
    """The segment over ``m`` microbatches of ``x``: (y, probability sums
    [layers, M, E] in the graph, mask sums, token counts; the last three
    None without MoE). ``run(x_mb, k, stage)`` runs one stage on local
    microbatch k and returns a ``StageOut``. On a pipe line the sums are
    this rank's stage's layers; in one process every stage's, in layer
    order."""
    if line.size == 1:
        outs, per = [], []
        for k, xk in enumerate(x.chunk(m)):
            parts = []
            for s in range(stages):
                st = run(xk, k, s)
                xk = st.out
                parts.append(st)
            outs.append(xk)
            per.append(parts)
        y = torch.cat(outs)
        if per[0][0].probs is None:
            return y, None, None, None
        sums = [torch.stack([torch.cat([getattr(st, key) for st in parts])
                             for parts in per], dim=1)
                for key in ("probs", "mask", "tokens")]
        return (y, *sums)
    if torch.is_grad_enabled():
        extra = {}
        anchor = torch.empty(0, requires_grad=True)
        y, probs = _Schedule.apply(x, anchor,
                                   lambda xk, k: run(xk, k, line.rank),
                                   line, m, extra)
        if extra["mask"] is None:
            return y, None, None, None
        return y, probs, extra["mask"], extra["tokens"]
    done = _ticks(lambda xk, k: run(xk, k, line.rank), x.chunk(m), line, m,
                  grad=False)
    return (_output(done, line, m, x), _sums(done, m, "probs"),
            _sums(done, m, "mask"), _sums(done, m, "tokens"))


# ---- a model's stages: placement and gathers --------------------------------

def held(model, name: str) -> bool:
    """Whether this rank holds parameter or buffer ``name`` of ``model``
    (every name but the other stages' blocks)."""
    pipe = getattr(model, "pipe_place", None)
    if not pipe:
        return True
    i = block_of(name)
    if i is None:
        return True
    stage = stage_of(pipe["segments"], pipe["stages"], i)
    return stage is None or stage == pipe["line"].rank


def stage_names(model, names) -> List[str]:
    """The names among ``names`` of this rank's stage blocks."""
    pipe = getattr(model, "pipe_place", None)
    if not pipe:
        return []
    return [n for n in names if block_of(n) is not None and stage_of(
        pipe["segments"], pipe["stages"], block_of(n)) is not None]


def gather_stages(model, tensors: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """``tensors`` (by name; this rank's) with every stage's tensors of the
    stage blocks added, gathered over the pipe line (a collective: every
    rank of the line calls it with the same structure). Each stage holds
    the same shapes in the same order, so one flat all-gather a dtype
    serves."""
    pipe = getattr(model, "pipe_place", None)
    if not pipe:
        return tensors
    line, segs, stages = pipe["line"], pipe["segments"], pipe["stages"]
    names = stage_names(model, list(tensors))
    out = dict(tensors)
    by_dtype = {}
    for n in names:
        by_dtype.setdefault(tensors[n].dtype, []).append(n)
    for dtype, ns in sorted(by_dtype.items(), key=lambda kv: str(kv[0])):
        flat = torch.cat([tensors[n].detach().reshape(-1) for n in ns])
        every = mesh.all_gather_tiled(flat[None], line.group)
        for q in range(stages):
            off = 0
            for n in ns:
                t = tensors[n]
                out[restage(n, segs, stages, q)] = every[q, off:off + t.numel()
                                                         ].view_as(t).clone()
                off += t.numel()
    return out
