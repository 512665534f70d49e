from .embed import NodeEmbed  # noqa: F401
from .rgat import RGATLayer, RGATModel  # noqa: F401
from .weights import params_from_jax  # noqa: F401
