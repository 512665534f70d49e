from .structures import CompactInfo, HeteroGraph, Segments  # noqa: F401
from .build import (build_heterograph, build_segments,  # noqa: F401
                    reverse_heterograph)
from .persist import load_heterograph, save_heterograph  # noqa: F401
from .synth import random_heterograph  # noqa: F401
