"""A benchmark cell, found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells
(``workloads``), each naming a configuration and a traffic mix, and the
metrics.  A configuration is ``configs/<config>.json`` and a traffic mix
``traffic/<traffic>.json`` under this folder, the comparison that
decides a cell's ``correct`` and its limits ``checks/<cell>.json``, and
a metric is the reader ``metrics/<name>.py`` (or that of its name less
its last dotted part, as ``run.reader_path`` finds it).  Nothing here
names a particular cell, so a cell, configuration, traffic mix or
metric is added by adding its files and entries.

A traffic mix names the entry that drives the program
(``entries/<entry>.py``, with its comparison).  A configuration states
the target (``target``: the program's target factory and its
arguments, and the reference module of the same name), the sampler, the precision, how its inputs are made (``start``,
``tuning``) and its ``run`` defaults (chains, micro steps per round,
rounds per call, ring rows).  A traffic mix states how the chains are
driven: which start and tuning, warmup or not, the route to the
gradient, the stop rule, the traced calls.  A traffic key
overrides the configuration's ``run`` key of the same name.
"""

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

RUN_KEYS = ("chains", "micro_unroll", "rounds_per_call", "ring_rows",
            "diag_rows", "stop_mode", "num_iter", "summary", "route",
            "start", "tuning", "warmup", "trace_calls", "entry")


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration and
    traffic merged into ``run`` (a dict of :data:`RUN_KEYS`)."""

    def __init__(self, name, root=ROOT):
        self.root = Path(root)
        bench = load_json(self.root / "BENCHMARK.json")
        rows = [w for w in bench["workloads"] if w["name"] == name]
        if len(rows) != 1:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = rows[0]
        self.chips = int(self.workload["chips"])
        here = self.root / HERE.name
        self.config = load_json(here / "configs" /
                                f"{self.workload['config']}.json")
        self.traffic = load_json(here / "traffic" /
                                 f"{self.workload['traffic']}.json")
        run = dict(self.config.get("run", {}))
        for key in ("summary", "start", "tuning"):
            run[key] = self.config[key]
        run.update({k: v for k, v in self.traffic.items() if k in RUN_KEYS})
        missing = [k for k in RUN_KEYS if k not in run and k != "warmup"]
        if missing:
            raise KeyError(f"cell {name}: no value for {missing}")
        run.setdefault("warmup", None)
        run["check"] = load_json(here / "checks" / f"{name}.json")
        self.run = run
        self.metrics_dir = here / "metrics"
        self.end_to_end = [r for r in bench["end_to_end"] if self._has(r)]
        names = {r["name"] for r in self.end_to_end}
        self.per_layer = [r for r in bench["per_layer"] if self._has(r)
                          and ("workloads" in r or r["moves"] in names)]

    def _has(self, row):
        """Whether a metric's ``workloads`` key, if it has one, names
        this cell.  A per-layer metric without one is reported wherever
        the end-to-end metric it moves is."""
        return "workloads" not in row or self.name in row["workloads"]
