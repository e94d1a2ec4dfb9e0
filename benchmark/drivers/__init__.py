"""The general generators and step loops of the benchmark, one per kind of
configuration (``"kind"`` in ``configs/<config>.json``): ``two_view`` and
``disparity``. Each reads its sizes from the configuration's file and its
mix from the traffic's file, drives the program's public entry, and judges
what the timed path produced against the plain reference."""
from __future__ import annotations

import importlib


def load(kind: str):
    """The driver class of a configuration kind."""
    return importlib.import_module(f"benchmark.drivers.{kind}").Driver
