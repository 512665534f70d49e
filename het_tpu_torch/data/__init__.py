from .loaders import SYNTH_SCALES, Dataset, load_dataset  # noqa: F401
