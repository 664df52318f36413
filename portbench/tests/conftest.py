"""A small checkout for the harness's CPU tests: this folder's files
copied beside the program (linked), with a ``BENCHMARK.json`` that adds
small cells, a metric and their files to the benchmark's own, as a
later change would, by adding files and entries only."""

import json
import shutil
import sys
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parents[1]
REPO = PORTBENCH.parent
sys.path.insert(0, str(PORTBENCH))

# the small cells: funnel(11) and the Stock-Watson model at 64 and 8
# chains, checked over 256 rounds in two calls (the warmup over ten
# periods, a call each)
TINY = {
    "tiny_funnel.sample": ("tiny_funnel", "sample"),
    "tiny_funnel.external": ("tiny_funnel", "external"),
    "tiny_funnel.warmup": ("tiny_funnel", "tiny_warmup"),
    "tiny_sw.sample": ("tiny_sw", "sample"),
}
NEW_METRIC = "tiny.draws_per_call"


def _write(path, obj):
    path.write_text(json.dumps(obj, indent=1) + "\n")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    pb = root / "portbench"
    shutil.copytree(PORTBENCH, pb, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    (root / "walnuts_tpu_torch").symlink_to(REPO / "walnuts_tpu_torch")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    fun = json.loads((pb / "configs" / "funnel101.json").read_text())
    fun["target"]["args"]["dim"] = 11
    fun["run"].update(chains=64, rounds_per_call=64, ring_rows=400,
                      num_iter=400)
    _write(pb / "configs" / "tiny_funnel.json", fun)
    sw = json.loads((pb / "configs" / "stockwatson.json").read_text())
    sw["run"].update(chains=8, rounds_per_call=64, ring_rows=200,
                     num_iter=200)
    _write(pb / "configs" / "tiny_sw.json", sw)
    wu = json.loads((pb / "traffic" / "warmup.json").read_text())
    wu.update(chains=256, rounds_per_call=1024)
    _write(pb / "traffic" / "tiny_warmup.json", wu)
    check = dict(kind="state", chains=16, rounds=256, calls=2, draws=2,
                 rtol=1e-3, atol=1e-3, limits=dict(mismatch_share=0.1))
    for name in TINY:
        c = dict(check)
        if name.endswith("warmup"):
            c.update(rounds=160, calls=10, draws=4, consensus=True,
                     limits=dict(
                mismatch_share=0.1, p2h_median_gap=0.04, consensus_gap=1e-4,
                chains_without_draw=0))
        _write(pb / "checks" / f"{name}.json", c)
    (pb / "metrics" / f"{NEW_METRIC}.py").write_text(
        "def read(w):\n    return w.transitions / w.calls\n")
    for cfg in ("tiny_funnel", "tiny_sw"):
        bench["configs"].append(dict(
            name=cfg, source="https://example.org", reduced=["dim"],
            file=f"portbench/configs/{cfg}.json", why="a test's small cell"))
    twin = {"tiny_funnel.sample": "funnel101.sample",
            "tiny_funnel.external": "funnel101.external",
            "tiny_funnel.warmup": "funnel101.warmup",
            "tiny_sw.sample": "stockwatson.sample"}
    for name, (cfg, traffic) in TINY.items():
        bench["workloads"].append(dict(name=name, config=cfg,
                                       traffic=traffic, chips=1,
                                       why="a test's small cell"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [t for t, big in twin.items()
                               if big in m["workloads"]]
    bench["per_layer"].append(dict(
        name=NEW_METRIC, unit="1", better="higher", source="host_clock",
        layer="entry and host loop", moves="grad_evals_per_s",
        workloads=["tiny_funnel.sample"]))
    _write(root / "BENCHMARK.json", bench)
    return root
