"""CLI entry point with the reference's flag surface (main.py:35-73).

Counterpart of dpmn_tpu/cli.py; run as `python -m dpmn_tpu_torch.cli`.  It
runs on the card unless `--device cpu` is given; the YAML config named by
--config is read whenever it exists.
"""

from __future__ import annotations

import os
import sys

from .config import args_from_namespace, build_arg_parser, load_train_cfg
from .train import Trainer


def main(argv=None):
    ns = build_arg_parser().parse_args(argv)
    args = args_from_namespace(ns)
    cfg = load_train_cfg(ns.config if os.path.exists(ns.config) else None)
    trainer = Trainer(cfg, args)
    if args.test:
        trainer.test()
    else:
        trainer.train()


if __name__ == "__main__":
    main(sys.argv[1:])
