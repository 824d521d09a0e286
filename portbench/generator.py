"""The general traffic generator: a traffic file of parameters names its
``family``, and ``portbench/families/<family>.py`` builds the request from
the parameters, the configuration's register and ``--seed``."""
from __future__ import annotations

import importlib

from portbench.request import Request


def make_request(config: dict, traffic: dict, seed: int) -> Request:
    family = importlib.import_module(f"portbench.families.{traffic['family']}")
    return family.build(config, traffic, seed)
