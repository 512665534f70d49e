"""``python -m het_tpu_torch.train --model RGAT -d mag ...``: full-graph
training, ``--minibatch`` neighbour-sampled minibatch training or
``--task link`` link prediction, with the reference's flag spellings
(see ``config.py``).  Prints the run's metrics as one JSON object."""

import argparse
import json

from .config import add_args, config_from_args
from .driver import train
from .link import train_link
from .minibatch import train_minibatch


def main() -> None:
    parser = argparse.ArgumentParser("het_tpu_torch trainer")
    add_args(parser)
    cfg = config_from_args(parser.parse_args())
    if cfg.task == "link":
        metrics = train_link(cfg)
    elif not cfg.full_graph_training:
        metrics = train_minibatch(cfg)
    else:
        metrics = train(cfg)
    print(json.dumps(metrics))


if __name__ == "__main__":
    main()
