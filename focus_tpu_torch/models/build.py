"""Model registry, ``build_model`` and weight initialisation (counterpart of
``focus_tpu/models/build.py``).

``build_model`` returns an ``nn.Module`` on an explicit device in eval
mode. Parameters are created on the meta device and then initialised from
an explicit ``torch.Generator`` on the target device, so building the
flagship costs no host-side random numbers.
"""

import math

import torch
from torch import nn

MODEL_REGISTRY = {}


def register(cls):
    MODEL_REGISTRY[cls.__name__] = cls
    return cls


def compute_dtype(cfg) -> torch.dtype:
    name = cfg.TPU.COMPUTE_DTYPE
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def resolve_device(device) -> torch.device:
    """The device to run on; raises where CUDA is asked for but absent
    (there is no silent move to the CPU: pass ``device="cpu"``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def _trunc_normal_(t, std, generator):
    """Truncated normal in [-2 std, 2 std] (inverse-CDF sampling)."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
        (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


def _uniform_(p, bound, generator):
    p.uniform_(-bound, bound, generator=generator)


def _fans(shape):
    """(fan_in, fan_out) of a torch-layout weight ``[out, in, *kernel]``."""
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _orthogonal_(p, generator):
    """Orthonormal columns of ``p.t()`` (QR of a normal matrix, signs
    fixed), as the JAX initialiser gives for the ``[in, out]`` kernel."""
    rows, cols = p.shape
    a = torch.empty(max(rows, cols), min(rows, cols), device=p.device)
    a.normal_(generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    p.copy_(q if rows >= cols else q.t())


def _init_tagged_(layer, generator):
    """A layer tagged by ``models/common.py`` with its JAX initialiser:
    xavier-uniform (with gain), kaiming-uniform or the flax default
    (lecun-normal); zero bias."""
    kind, gain = layer.init
    w = layer.weight
    if isinstance(layer, nn.ConvTranspose2d):  # weight [in, out, kh, kw]
        fan_out, fan_in = _fans(w.shape)
    else:
        fan_in, fan_out = _fans(w.shape)
    if kind == "xavier":
        _uniform_(w, gain * math.sqrt(6.0 / (fan_in + fan_out)), generator)
    elif kind == "kaiming":
        _uniform_(w, math.sqrt(6.0 / fan_in), generator)
    elif kind == "lecun":
        _trunc_normal_(w, math.sqrt(1.0 / fan_in) / 0.87962566103423978,
                       generator)
    else:
        raise ValueError(f"unknown initialiser {kind!r}")
    if layer.bias is not None:
        layer.bias.zero_()


def _init_steve_param_(leaf, p, generator):
    """STEVE's bare parameters, by name. Returns False for any other."""
    if leaf == "pe":
        _trunc_normal_(p, 1.0, generator)
    elif leaf in ("bos", "slot_mu", "slot_log_sigma"):
        # xavier-uniform on the JAX shape (1, 1, d): fan_in 1, fan_out d
        _uniform_(p, math.sqrt(6.0 / (1 + p.shape[-1])), generator)
    elif leaf == "weight_ih":
        _uniform_(p, math.sqrt(6.0 / sum(p.shape)), generator)
    elif leaf == "weight_hh":
        _orthogonal_(p, generator)
    elif leaf in ("bias_ih", "bias_hh"):
        p.zero_()
    else:
        return False
    return True


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator,
                 scale=None) -> None:
    """Initialise every parameter from ``generator``.

    ``scale=None``: the JAX package's initialisers. Layers that
    ``models/common.py`` tagged take theirs (xavier / kaiming uniform,
    lecun normal); the token dictionary is N(0, 1), ``pe`` a truncated
    normal of std 1, ``bos`` / ``slot_mu`` / ``slot_log_sigma`` and the GRU's
    ``weight_ih`` xavier-uniform, ``weight_hh`` orthogonal; otherwise a
    truncated normal, std 0.02, for dense kernels, the class token and
    position embedding; xavier-uniform patch-embed kernel; zero biases, box
    categories and temporal embedding; unit norm scales. BatchNorm running
    statistics are reset. ``scale=s``: every parameter drawn from
    N(0, s^2), as the benchmark's random init-scale weights are.
    """
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_running_stats()
    if scale is not None:
        for p in model.parameters():
            p.normal_(0.0, scale, generator=generator)
        return
    tagged = set()
    for m in model.modules():
        if hasattr(m, "init"):
            _init_tagged_(m, generator)
            tagged.update(id(p) for p in m.parameters(recurse=False))
    for name, p in model.named_parameters():
        if id(p) in tagged:
            continue
        leaf = name.rsplit(".", 1)[-1]
        if _init_steve_param_(leaf, p, generator):
            continue
        if name.endswith("dictionary.weight"):
            p.normal_(0.0, 1.0, generator=generator)
        elif name.startswith("patch_embed_3d.proj.weight"):
            fan_in, fan_out = _fans(p.shape)
            _uniform_(p, math.sqrt(6.0 / (fan_in + fan_out)), generator)
        elif leaf in ("cls_token", "pos_embed") or (
            leaf == "weight" and p.ndim == 2
        ):
            _trunc_normal_(p, 0.02, generator)
        elif leaf == "weight" and p.ndim == 1:  # LayerNorm / BatchNorm scale
            p.fill_(1.0)
        else:  # biases, temp_embed, box_categories*
            p.zero_()


@torch.no_grad()
def maybe_zero_init_orvit(cfg, model: nn.Module) -> None:
    """With ORVIT.ZERO_INIT_ORVIT, zero every parameter of the residually
    added ORViT blocks (``orvit_blocks.*``, the MViT ADD_LAYERS variant's;
    the ORViT-Motionformer has none), so the model starts as the plain
    backbone (reference build.py:66-68 and misc.module_0_init)."""
    if not (cfg.ORVIT.ENABLE and cfg.ORVIT.ZERO_INIT_ORVIT):
        return
    for name, p in model.named_parameters():
        if name.startswith("orvit_blocks."):
            p.zero_()


def build_model(cfg, device="cuda", seed=None):
    """Construct the module named by ``cfg.MODEL.MODEL_NAME`` on ``device``
    (eval mode), initialised as the JAX package initialises it from a
    generator seeded with ``seed`` (default ``cfg.RNG_SEED``)."""
    import focus_tpu_torch.models.motionformer  # noqa: F401 (registration)
    import focus_tpu_torch.models.steve.steve  # noqa: F401 (registration)

    device = resolve_device(device)
    model_cls = MODEL_REGISTRY[cfg.MODEL.MODEL_NAME]
    with torch.device("meta"):
        model = model_cls(cfg, dtype=compute_dtype(cfg))
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.RNG_SEED if seed is None else seed)
    init_weights(model, gen)
    return model.eval()
