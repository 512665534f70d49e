"""``python -m het_tpu_torch.train --model RGAT -d mag ...``: full-graph
training with the reference's flag spellings (see ``config.py``)."""

import argparse
import json

from .config import add_args, config_from_args
from .driver import train


def main() -> None:
    parser = argparse.ArgumentParser("het_tpu_torch trainer")
    add_args(parser)
    metrics = train(config_from_args(parser.parse_args()))
    print(json.dumps(metrics))


if __name__ == "__main__":
    main()
