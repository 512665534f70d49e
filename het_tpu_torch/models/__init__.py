from .embed import NodeEmbed  # noqa: F401
from .gat import GATLayer, GATModel  # noqa: F401
from .hgt import HGTLayer, HGTModel  # noqa: F401
from .rgat import RGATLayer, RGATModel  # noqa: F401
from .rgcn import RGCNLayer, RGCNModel, SeastarRGCNLayer0  # noqa: F401
from .simple_hgn import SimpleHGNLayer, SimpleHGNModel  # noqa: F401
from .weights import dp_params_from_jax, params_from_jax  # noqa: F401
