"""Dataset registry (counterpart of ``focus_tpu/datasets/build.py``)."""

from focus_tpu_torch.utils.registry import Registry

DATASET_REGISTRY = Registry("DATASET")


def build_dataset(dataset_name: str, cfg, split: str):
    """Instantiate the dataset registered under ``dataset_name``
    capitalised, as the reference looks it up."""
    import focus_tpu_torch.datasets.epickitchens  # noqa: F401 (registration)
    import focus_tpu_torch.datasets.movi_e  # noqa: F401
    import focus_tpu_torch.datasets.ssv2  # noqa: F401
    import focus_tpu_torch.datasets.synthetic  # noqa: F401

    name = dataset_name.capitalize()
    if name == "Cholec80":
        raise NotImplementedError(
            "the Cholec80 dataset is not ported yet (the slot models train "
            "on movi_e or synthetic_video)"
        )
    if name in ("Kinetics", "Charades", "Ava") and name not in DATASET_REGISTRY:
        raise NotImplementedError(
            f"the {name} dataset is not ported yet (the port reads ssv2, "
            "epickitchens, movi_e and the synthetic sets; the models of its "
            "configs build)"
        )
    return DATASET_REGISTRY.get(name)(cfg, split)
