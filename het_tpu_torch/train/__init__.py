from .config import TrainConfig  # noqa: F401
from .driver import NodeClassifier, build_model, train  # noqa: F401
from .link import LinkPredictor, train_link  # noqa: F401
from .minibatch import train_minibatch  # noqa: F401
