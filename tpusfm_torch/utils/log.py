"""Structured stage metrics/logging.

The reference prints free-form timings and counts with cout
(SfM-GMS/FeatureMatchUtil.cpp:57-71 etc.). Here each pipeline stage
reports into a metrics dict that benchmarks and the CLI emit as JSON.
"""
from __future__ import annotations

import json
import sys
import time


class MetricsLogger:
    def __init__(self, stream=None):
        self.stream = stream or sys.stderr
        self.records: list[dict] = []

    def log(self, stage: str, **fields):
        rec = {"stage": stage, "t": time.time(), **fields}
        self.records.append(rec)
        print(json.dumps(rec, default=str), file=self.stream)

    def summary(self) -> dict:
        out: dict = {}
        for r in self.records:
            out.setdefault(r["stage"], []).append(
                {k: v for k, v in r.items() if k not in ("stage", "t")}
            )
        return out


default_logger = MetricsLogger()
