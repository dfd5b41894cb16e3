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


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator,
                 scale=None) -> None:
    """Initialise every parameter from ``generator``.

    ``scale=None``: the JAX package's initialisers (truncated normal, std
    0.02, for dense kernels, the class token and position embedding;
    xavier-uniform conv kernel; zero biases, box categories and temporal
    embedding; unit LayerNorm scale). ``scale=s``: every parameter drawn
    from N(0, s^2), as the benchmark's random init-scale weights are.
    """
    for name, p in model.named_parameters():
        if scale is not None:
            p.normal_(0.0, scale, generator=generator)
            continue
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("patch_embed_3d.proj.weight"):
            fan_in = p[0].numel()
            fan_out = p.shape[0] * p[0, 0].numel()
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            p.uniform_(-bound, bound, generator=generator)
        elif leaf in ("cls_token", "pos_embed") or (
            leaf == "weight" and p.ndim == 2
        ):
            _trunc_normal_(p, 0.02, generator)
        elif leaf == "weight" and p.ndim == 1:  # LayerNorm scale
            p.fill_(1.0)
        else:  # biases, temp_embed, box_categories*
            p.zero_()


def build_model(cfg, device="cuda", seed=None):
    """Construct the module named by ``cfg.MODEL.MODEL_NAME`` on ``device``
    (eval mode), initialised as the JAX package initialises it from a
    generator seeded with ``seed`` (default ``cfg.RNG_SEED``)."""
    import focus_tpu_torch.models.motionformer  # noqa: F401 (registration)

    device = resolve_device(device)
    model_cls = MODEL_REGISTRY[cfg.MODEL.MODEL_NAME]
    with torch.device("meta"):
        model = model_cls(cfg, dtype=compute_dtype(cfg))
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.RNG_SEED if seed is None else seed)
    init_weights(model, gen)
    return model.eval()
