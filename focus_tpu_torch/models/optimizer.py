"""Optimizers (counterpart of ``focus_tpu/models/optimizer.py``; reference
``slowfast/models/optimizer.py``): the supervised one and STEVE's.

As in the JAX package, every group's LR is a function of the update count
(``epoch_lr_schedule``), which reproduces the reference's per-iteration
``set_lr`` from the fractional epoch. Parameters fall in the reference's
{main, zero-wd} x {backbone, orvit} groups over one ``torch.optim``
optimizer, with optax's semantics:

- the schedule is read with the count of updates made before this one, so
  the first update uses ``sched(0)``;
- ``adamw`` decays decoupled (``p -= lr * wd * p`` beside the Adam step,
  which is what optax's ``adamw`` computes); ``sgd`` and ``adam`` take a
  coupled L2 term (``torch.optim``'s ``weight_decay``, optax's
  ``add_decayed_weights`` before the transform);
- global-norm clipping scales by ``max_norm / norm`` once the norm reaches
  ``max_norm``, with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds
  one); value clipping clamps each element;
- a parameter that received no gradient is updated with a zero gradient,
  as optax updates every leaf (weight decay still applies);
- under data parallelism (``parallel/mesh.py``) the gradients are
  averaged over the processes, in one all-reduce, before the clip, so each
  process applies the global batch's update. Under a seq or model axis
  the reduction runs over the data x seq plane (the seq ranks' partial
  sums added, the data ranks' averaged); a model rank keeps its shards'
  gradients, and a whole leaf's gradient is the same on every model rank.
  Likewise a pipe rank's stage parameters and an expert rank's experts
  are reduced over their data line alone, never over the pipe or expert
  line, and a replicated leaf's gradient is the same on every pipe and
  expert rank. The global-norm clip sums a split leaf's squares over the
  model or expert line, a stage leaf's over the pipe line, and counts a
  whole leaf once;
- under ``TPU.ZERO1`` (``construct_optimizer``, more than one data rank)
  each data rank keeps the optimizer's state for a 1 / DATA chunk of each
  parameter group's flat concatenation (padded to a multiple of DATA),
  updates that chunk from the reduced gradient and all-gathers the new
  parameters over the data line: the update is elementwise, so any split
  is the same step (each rank's own parameters: its shards and stage).
  ``state_dict`` / ``load_state_dict`` read and write the one-process
  optimizer's state (every parameter's full moments, every stage's) on
  any mesh.

STEVE's (``construct_optimizer_slot``, reference optimizer.py:13-45 and
``set_slot_lr``) is Adam in three groups by parameter prefix, ``dvae`` at
a constant LR and ``enc`` / ``dec`` (``steve_encoder``, ``steve_decoder``)
at a linear warm-up times a half-life decay, behind the same clipping;
its schedules are computed in float32 as optax computes them.
"""

import math

import numpy as np
import torch

from focus_tpu_torch.parallel import mesh, pipeline
from focus_tpu_torch.parallel import tensor as tp
from focus_tpu_torch.utils import lr_policy


def param_label(name: str, ndim: int, cfg, no_weight_decay_paths=()) -> str:
    """The group of one parameter (``construct_optimizer``'s label rule):
    ``orvit_`` when its lowercased name contains "orvit" and
    SOLVER.ORVIT_BASE_LR > 0; ``zero`` for the no-decay names and, with
    SOLVER.ZERO_WD_1D_PARAM, for 1-D parameters; else ``main``. The
    substrings read the same in the torch and the JAX names."""
    path = name.lower()
    orvit = "orvit" in path and cfg.SOLVER.ORVIT_BASE_LR > 0
    zero = any(s in path for s in no_weight_decay_paths) or (
        cfg.SOLVER.ZERO_WD_1D_PARAM and ndim <= 1)
    kind = "zero" if zero else "main"
    return f"orvit_{kind}" if orvit else kind


def epoch_lr_schedule(cfg, steps_per_epoch: int, which: str = "lr",
                      epoch_offset: float = 0.0, step_offset: int = 0):
    """LR(step) = the reference's LR at epoch epoch_offset + (step -
    step_offset) / steps_per_epoch, warmup included
    (``_epoch_lr_schedule``); ``which`` is "lr" or "orvit_lr". The offsets
    carry the schedule across a multigrid long-cycle rebuild, where the
    steps per epoch change mid-run."""

    def sched(step):
        epoch = epoch_offset + (step - step_offset) / steps_per_epoch
        return lr_policy.get_lr_at_epoch(cfg, epoch)[which]

    return sched


def _torch_optimizer(cfg, groups):
    method = cfg.SOLVER.OPTIMIZING_METHOD
    if method == "sgd":
        return torch.optim.SGD(groups, lr=0.0, momentum=cfg.SOLVER.MOMENTUM,
                               nesterov=cfg.SOLVER.NESTEROV)
    if method == "adam":
        return torch.optim.Adam(groups, lr=0.0, eps=1e-8)
    if method == "adamw":
        return torch.optim.AdamW(groups, lr=0.0, eps=1e-8)
    raise NotImplementedError(f"Unsupported optimizer: {method}")


class Optimizer:
    """A ``torch.optim`` optimizer over labelled parameter groups, each with
    its LR schedule, behind the optional gradient clip. ``step(count)``
    applies one update from the parameters' ``.grad``; ``count`` is the
    number of updates made before it. ``model`` and ``names`` (each
    parameter's name, in group order) come with a sharded model, and
    ``full_groups`` (each group's parameter names in the whole model, in
    the one-process order) with one whose pipe rank holds a stage;
    ``zero1`` holds each group's parameters, its flat chunk (the parameter
    ``optimizer`` updates) and the chunk's length."""

    def __init__(self, optimizer, schedules, clip_value=None, clip_norm=None,
                 params=None, names=None, model=None, full_groups=None,
                 zero1=None):
        self.optimizer = optimizer
        self.schedules = schedules
        self.clip_value = clip_value
        self.clip_norm = clip_norm
        self.params = params or [p for g in optimizer.param_groups
                                 for p in g["params"]]
        self.names = names
        self.model = model
        self.full_groups = full_groups
        self.zero1 = zero1
        # each parameter's lines beyond the data axis: bit 0 split over the
        # model line, bit 1 over the expert line, bit 2 held by one stage
        self.lines = [0] * len(self.params)
        if model is not None and tp.is_sharded(model):
            stage = set(pipeline.stage_names(model, names))
            self.lines = [(n in tp.specs(model)) | (n in tp.expert_specs(
                model)) << 1 | (n in stage) << 2 for n in names]

    @property
    def sharded(self) -> bool:
        """Whether its state is split over processes (its ``state_dict`` is
        a collective)."""
        return bool(self.zero1) or any(self.lines)

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)
        for p in self.params:
            p.grad = None

    def _line_groups(self):
        """The process groups of the model, expert and pipe lines (None
        where the line is this rank alone)."""
        par = getattr(self.model, "parallel", None)
        place = getattr(self.model, "pipe_place", None)
        return (par.model_group if par and par.model_size > 1 else None,
                par.expert_group if par and par.expert_size > 1 else None,
                place["line"].group if place else None)

    def _global_norm(self, grads):
        if not any(self.lines):
            return torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads]))
        # the squares by lines (summed in a fixed order, so every rank of a
        # line holds the same), each summed over the lines that split it; a
        # whole leaf counts once
        sq = [torch.linalg.vector_norm(g.float()) ** 2 for g in grads]
        zero = sq[0].new_zeros(())
        kinds = torch.stack([
            torch.stack([s for s, k in zip(sq, self.lines) if k == kind]).sum()
            if kind in self.lines else zero for kind in range(8)])
        for bit, group in enumerate(self._line_groups()):
            if group is None:
                continue
            mask = torch.tensor([(k >> bit) & 1 for k in range(8)],
                                dtype=kinds.dtype, device=kinds.device)
            part = mesh.all_reduce_(kinds * mask, group)
            kinds = kinds * (1 - mask) + part
        return torch.sqrt(kinds.sum())

    @torch.no_grad()
    def step(self, count: int):
        params = self.params
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        mesh.all_reduce_mean_(grads, group=mesh.group("data_seq"),
                              divide=mesh.data_size())
        if self.clip_value:
            for g in grads:
                g.clamp_(-self.clip_value, self.clip_value)
        elif self.clip_norm:
            norm = self._global_norm(grads)
            keep = norm < self.clip_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.clip_norm))
        for group, sched in zip(self.optimizer.param_groups, self.schedules):
            group["lr"] = sched(count)
        if not self.zero1:
            self.optimizer.step()
            return
        d = mesh.data_rank()
        for ps, chunk, n in self.zero1:
            lo = d * n
            chunk.data.copy_(_flat(ps, n * mesh.data_size())[lo:lo + n])
            chunk.grad = _flat([p.grad for p in ps],
                               n * mesh.data_size())[lo:lo + n].clone()
        self.optimizer.step()
        for ps, chunk, n in self.zero1:
            flat = mesh.all_gather_tiled(chunk.detach(), mesh.group("data"))
            _unflat_(ps, flat)

    # -- the one-process optimizer's state on any mesh (collectives) -------

    def _group_names(self):
        """Each group's parameter names in the one-process optimizer."""
        if self.full_groups:
            return self.full_groups
        sizes = ([len(ps) for ps, _, _ in self.zero1] if self.zero1 else
                 [len(g["params"]) for g in self.optimizer.param_groups])
        out, i = [], 0
        for n in sizes:
            out.append(self.names[i:i + n])
            i += n
        return out

    def _local_states(self, inner):
        """Each parameter's state (this rank's shapes), in group order:
        ZeRO-1's chunks gathered over the data line."""
        if not self.zero1:
            return [inner["state"].get(i) for i in range(len(self.params))]
        out = []
        for gi, (ps, chunk, n) in enumerate(self.zero1):
            st = inner["state"].get(gi)
            if not st:
                out += [None] * len(ps)
                continue
            per = {k: _split_flat(ps, mesh.all_gather_tiled(
                v.contiguous(), mesh.group("data")))
                for k, v in st.items() if torch.is_tensor(v) and v.ndim}
            out += [{k: (per[k][j] if k in per else v.clone()
                         if torch.is_tensor(v) else v)
                     for k, v in st.items()} for j in range(len(ps))]
        return out

    def state_dict(self) -> dict:
        """The state dict of the one-process ``torch.optim`` optimizer over
        the whole model: every parameter's full state, in group order."""
        inner = self.optimizer.state_dict()
        if not self.sharded:
            return inner
        by_name = {}
        for i, st in enumerate(self._local_states(inner)):
            if st is not None:
                by_name[self.names[i]] = {
                    k: (tp.full_tensor(self.model, self.names[i], v)
                        if torch.is_tensor(v) and v.ndim else v)
                    for k, v in st.items()}
        stage = pipeline.stage_names(self.model, list(by_name))
        if stage:  # the other stages' parameters' state
            keys = list(by_name[stage[0]])
            every = {k: pipeline.gather_stages(self.model, {
                n: by_name[n][k] for n in stage}) for k in keys
                if torch.is_tensor(by_name[stage[0]][k])
                and by_name[stage[0]][k].ndim}
            for n in next(iter(every.values())) if every else ():
                by_name.setdefault(n, {k: (
                    every[k][n] if k in every else by_name[stage[0]][k].clone()
                    if torch.is_tensor(by_name[stage[0]][k])
                    else by_name[stage[0]][k]) for k in keys})
        groups, state, i = [], {}, 0
        for g, names in zip(inner["param_groups"], self._group_names()):
            ids = list(range(i, i + len(names)))
            groups.append({**g, "params": ids})
            for j, n in zip(ids, names):
                if n in by_name:
                    state[j] = by_name[n]
            i += len(names)
        return {"state": state, "param_groups": groups}

    def load_state_dict(self, sd: dict) -> None:
        """Load ``state_dict``'s form (the one-process optimizer's state)."""
        if not self.sharded:
            self.optimizer.load_state_dict(sd)
            return
        name_of = {}
        for g, names in zip(sd["param_groups"], self._group_names()):
            name_of.update(zip(g["params"], names))
        by_name = {name_of[j]: st for j, st in sd["state"].items()}
        local = [None if by_name.get(n) is None else {
            k: (tp.local_tensor(self.model, n, v) if torch.is_tensor(v)
                and v.ndim else v) for k, v in by_name[n].items()}
            for n in self.names]
        groups, state, d, i = [], {}, mesh.data_rank(), 0
        if not self.zero1:
            for g, mine in zip(sd["param_groups"],
                               self.optimizer.param_groups):
                ids = list(range(i, i + len(mine["params"])))
                groups.append({**g, "params": ids})
                state.update({j: local[j] for j in ids
                              if local[j] is not None})
                i += len(ids)
            self.optimizer.load_state_dict({"state": state,
                                            "param_groups": groups})
            return
        for gi, (g, (ps, chunk, n)) in enumerate(zip(sd["param_groups"],
                                                     self.zero1)):
            groups.append({**g, "params": [gi]})
            sts = local[i:i + len(ps)]
            i += len(ps)
            if not all(sts):
                continue
            st = {}
            for k, v in sts[0].items():
                if torch.is_tensor(v) and v.ndim:
                    flat = _flat([s[k] for s in sts], n * mesh.data_size())
                    st[k] = flat[d * n:(d + 1) * n].clone()
                else:
                    st[k] = v
            state[gi] = st
        self.optimizer.load_state_dict({"state": state,
                                        "param_groups": groups})


def _flat(tensors, length):
    """The float32 concatenation of ``tensors``, zero-padded to
    ``length``."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    return torch.nn.functional.pad(flat, (0, length - flat.numel()))


def _split_flat(like, flat):
    """``flat`` cut into tensors shaped as ``like``."""
    out, offset = [], 0
    for p in like:
        out.append(flat[offset:offset + p.numel()].view_as(p).clone())
        offset += p.numel()
    return out


def _unflat_(params, flat):
    """Copy the concatenation ``flat`` into ``params``."""
    for p, t in zip(params, _split_flat(params, flat)):
        p.data.copy_(t)


def construct_optimizer(model, cfg, steps_per_epoch: int,
                        no_weight_decay_paths=(), epoch_offset: float = 0.0,
                        step_offset: int = 0) -> Optimizer:
    """The supervised optimizer with the reference's group structure over
    ``model``'s parameters (``construct_optimizer``); the offsets as in
    ``epoch_lr_schedule``."""
    use_orvit_lr = cfg.SOLVER.ORVIT_BASE_LR > 0
    labels = ["main", "zero"] + (["orvit_main", "orvit_zero"]
                                 if use_orvit_lr else [])
    members = {label: [] for label in labels}
    for name, p in model.named_parameters():
        members[param_label(name, p.ndim, cfg, no_weight_decay_paths)].append(p)
    wd = cfg.SOLVER.WEIGHT_DECAY
    groups = [{"params": members[label], "label": label,
               "weight_decay": 0.0 if label.endswith("zero") else wd}
              for label in labels if members[label]]
    schedules = [epoch_lr_schedule(
        cfg, steps_per_epoch,
        "orvit_lr" if g["label"].startswith("orvit") else "lr",
        epoch_offset, step_offset) for g in groups]
    params = [p for g in groups for p in g["params"]]
    by_id = {id(p): n for n, p in model.named_parameters()}
    names = [by_id[id(p)] for p in params]
    full_groups = None
    if getattr(model, "pipe_place", None):  # the whole model's groups
        whole = {label: [] for label in labels}
        for name, shape in model.full_shapes.items():
            whole[param_label(name, len(shape), cfg,
                              no_weight_decay_paths)].append(name)
        full_groups = [whole[g["label"]] for g in groups]
        if [label for label in labels if whole[label]] != [
                g["label"] for g in groups]:
            raise ValueError("a pipeline stage lacks a parameter group of "
                             "the whole model")
    zero1 = None
    if cfg.TPU.ZERO1 and mesh.data_size() > 1:
        zero1, chunked = [], []
        for g in groups:
            ps = g["params"]
            n = -(-sum(p.numel() for p in ps) // mesh.data_size())
            chunk = torch.nn.Parameter(torch.zeros(n, device=ps[0].device))
            zero1.append((ps, chunk, n))
            chunked.append({**g, "params": [chunk]})
        groups = chunked
    return Optimizer(_torch_optimizer(cfg, groups), schedules,
                     clip_value=cfg.SOLVER.CLIP_GRAD_VAL or None,
                     clip_norm=cfg.SOLVER.CLIP_GRAD_L2NORM or None,
                     params=params, names=names, model=model,
                     full_groups=full_groups, zero1=zero1)


# ---- STEVE ---------------------------------------------------------------

SLOT_GROUPS = ("dvae", "enc", "dec")


def slot_lr_schedules(cfg) -> dict:
    """The three slot groups' LR as functions of the update count
    (``slot_lr_schedules``): ``dvae`` SLOTS_OPTIM.DVAE; ``enc`` and ``dec``
    ENC and DEC x linear warm-up over WARMUP_STEPS (the reference's
    step + 1, so the first update has 1 / WARMUP_STEPS of it) x
    0.5^(step / HALF_LIFE), each in float32."""
    so = cfg.SLOTS_OPTIM
    f32 = np.float32

    def warm_decay(base):
        def sched(step):
            decay = np.exp(f32(f32(step) / f32(so.HALF_LIFE))
                           * f32(math.log(0.5)))
            warm = f32(lr_policy.linear_warmup(step, 0.0, 1.0, 0,
                                                so.WARMUP_STEPS))
            return float(decay * warm * f32(base))

        return sched

    return {"dvae": lambda step: float(f32(so.DVAE)),
            "enc": warm_decay(so.ENC), "dec": warm_decay(so.DEC)}


def slot_label(name: str) -> str:
    """A STEVE parameter's group by its prefix; a name of none of the
    three falls in ``dvae``, as the JAX label rule puts it."""
    if name.startswith("steve_encoder"):
        return "enc"
    if name.startswith("steve_decoder"):
        return "dec"
    return "dvae"


def construct_optimizer_slot(model, cfg) -> Optimizer:
    """Global-norm clipping (SOLVER.CLIP_GRAD_L2NORM) or value clipping
    (SOLVER.CLIP_GRAD_VAL, which wins where set), then Adam in the three
    slot groups (``construct_optimizer_slot``). SLOTS_OPTIM.CLIP is read
    nowhere, as in the JAX package."""
    members = {label: [] for label in SLOT_GROUPS}
    for name, p in model.named_parameters():
        members[slot_label(name)].append(p)
    schedules = slot_lr_schedules(cfg)
    labels = [label for label in SLOT_GROUPS if members[label]]
    groups = [{"params": members[label], "label": label} for label in labels]
    return Optimizer(torch.optim.Adam(groups, lr=0.0, eps=1e-8),
                     [schedules[label] for label in labels],
                     clip_value=cfg.SOLVER.CLIP_GRAD_VAL or None,
                     clip_norm=cfg.SOLVER.CLIP_GRAD_L2NORM or None)
