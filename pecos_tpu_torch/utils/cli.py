"""CLI helpers: ``str2bool`` and ``SubCommand`` (the port of ``pecos_tpu/utils/cli.py``)."""

from __future__ import annotations

import argparse


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"Boolean value expected, got {v!r}")


class SubCommand(object):
    """Register a function as an argparse subcommand."""

    def __init__(self, parser: argparse.ArgumentParser, func):
        self.parser = parser
        self.func = func
        parser.set_defaults(func=func)

    @staticmethod
    def add_parser(subparsers, name: str, func, **kwargs):
        p = subparsers.add_parser(name, **kwargs)
        p.set_defaults(func=func)
        return p
