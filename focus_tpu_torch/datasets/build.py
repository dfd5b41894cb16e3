"""Dataset registry (counterpart of ``focus_tpu/datasets/build.py``)."""

from focus_tpu_torch.utils.registry import Registry

DATASET_REGISTRY = Registry("DATASET")

# the reference's pytorchvideo constructors, read by the native datasets
# (``focus_tpu/datasets/registry_imports.py``)
PTV_ALIASES = {"Ptvkinetics": "Kinetics", "Ptvssv2": "Ssv2",
               "Ptvcharades": "Charades"}


def build_dataset(dataset_name: str, cfg, split: str):
    """Instantiate the dataset registered under ``dataset_name``
    capitalised, as the reference looks it up; a pytorchvideo name
    (``ptvkinetics``, ``ptvssv2``, ``ptvcharades``) builds the dataset it
    stands for. No module here imports cv2 or PIL: a missing one raises
    ``ImportError`` at the first read."""
    import focus_tpu_torch.datasets.ava_dataset  # noqa: F401 (registration)
    import focus_tpu_torch.datasets.charades  # noqa: F401
    import focus_tpu_torch.datasets.cholec80  # noqa: F401
    import focus_tpu_torch.datasets.epickitchens  # noqa: F401
    import focus_tpu_torch.datasets.kinetics  # noqa: F401
    import focus_tpu_torch.datasets.movi_e  # noqa: F401
    import focus_tpu_torch.datasets.ssv2  # noqa: F401
    import focus_tpu_torch.datasets.synthetic  # noqa: F401

    name = dataset_name.capitalize()
    name = PTV_ALIASES.get(name, name)
    return DATASET_REGISTRY.get(name)(cfg, split)
