from .config import TrainConfig  # noqa: F401
from .driver import NodeClassifier, build_model, train  # noqa: F401
