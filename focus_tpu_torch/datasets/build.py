"""Dataset registry (counterpart of ``focus_tpu/datasets/build.py``)."""

from focus_tpu_torch.utils.registry import Registry

DATASET_REGISTRY = Registry("DATASET")


def build_dataset(dataset_name: str, cfg, split: str):
    """Instantiate the dataset registered under ``dataset_name``
    capitalised, as the reference looks it up."""
    import focus_tpu_torch.datasets.epickitchens  # noqa: F401 (registration)
    import focus_tpu_torch.datasets.ssv2  # noqa: F401
    import focus_tpu_torch.datasets.synthetic  # noqa: F401

    name = dataset_name.capitalize()
    return DATASET_REGISTRY.get(name)(cfg, split)
