"""The entry that splits the chains over ranks (``entries/fused_ranks.py``)
rehearsed on the CPU: a small four-rank gloo cell is correct and makes
the gradient evaluations of the same cell in one process; a rank whose
chains draw from the wrong chain offset fails the check; a rank that
dies or hangs ends the run at once, with a non-zero exit that names it;
a rank whose stop-test reads are not rank 0's fails the check; and the
cell's four readers on hand-made windows, which read nothing where
their input is absent."""

import json
import re
import shutil
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import inputs
from test_portbench_harness import ENV, last_json, run_cell  # noqa: F401
from walnuts_tpu_torch.utils import trace
from walnuts_tpu_torch.utils.trace import Span

PORTBENCH = Path(__file__).resolve().parents[1]
CELL = "tiny_funnel.sample_4chip"    # 64 chains, 16 a rank
ONE = "tiny_funnel.sample_one"       # the same cell in one process
NEW = ("ranks.mfu_pct", "ranks.kernel_roofline_pct", "collective.wait_us",
       "collective.us_per_collective")
# a --trace 1 window stops after the check's 2 calls and 2 calls more
WHOLE_WINDOW = "100000"


def _write(path, obj):
    path.write_text(json.dumps(obj, indent=1) + "\n")


@pytest.fixture(scope="module")
def ranks_root(tiny_root, tmp_path_factory):
    """``tiny_root`` with the four-rank cell added as files and entries:
    the benchmark's ``funnel101_4chip`` configuration at D = 11 and its
    ``sample_4chip`` traffic at 64 chains, its check over every chain
    with the benchmark's limit on the ranks out of step; and its twin in
    one process, ``tiny_funnel`` with the ``sample`` traffic; each traces
    2 calls after the check's."""
    root = tmp_path_factory.mktemp("ranks") / "checkout"
    shutil.copytree(tiny_root, root, symlinks=True)
    pb = root / "portbench"
    four = json.loads((pb / "configs" / "funnel101_4chip.json").read_text())
    small = json.loads((pb / "configs" / "tiny_funnel.json").read_text())
    four["target"] = small["target"]
    four["run"] = dict(small["run"], chains=64)
    _write(pb / "configs" / "tiny_funnel_4chip.json", four)
    check = json.loads((pb / "checks" / "tiny_funnel.sample.json")
                       .read_text())
    check["chains"] = 64
    limit = json.loads((PORTBENCH / "checks" / "funnel101.sample_4chip.json")
                       .read_text())["limits"]["ranks_out_of_step"]
    checks = {CELL: dict(check, limits=dict(check["limits"],
                                            ranks_out_of_step=limit)),
              ONE: check}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(
        name="tiny_funnel_4chip", source="https://example.org",
        reduced=["dim", "chains"], file="portbench/configs/"
        "tiny_funnel_4chip.json", why="a test's small cell"))
    for cell, config, traffic, chips in (
            (CELL, "tiny_funnel_4chip", "sample_4chip", 4),
            (ONE, "tiny_funnel", "sample", 1)):
        t = json.loads((pb / "traffic" / f"{traffic}.json").read_text())
        t.update(chains=64, trace_calls=2)
        _write(pb / "traffic" / f"tiny_{traffic}.json", t)
        _write(pb / "checks" / f"{cell}.json", checks[cell])
        bench["workloads"].append(dict(name=cell, config=config,
                                       traffic=f"tiny_{traffic}", chips=chips,
                                       why="a test's small cell"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        for big, tiny in (("funnel101.sample_4chip", CELL),
                          ("funnel101.sample", ONE)):
            if big in m.get("workloads", ()):
                m["workloads"].append(tiny)
    _write(root / "BENCHMARK.json", bench)
    return root


def _mutated(root, tmp_path, old, new):
    """A copy of the checkout whose rank entry has ``old`` replaced by
    ``new`` (each found once)."""
    out = tmp_path / "mutated"
    shutil.copytree(root, out, symlinks=True)
    path = out / "portbench" / "entries" / "fused_ranks.py"
    text = path.read_text()
    assert text.count(old) == 1, old
    path.write_text(text.replace(old, new))
    return out


def _grads(stderr):
    return int(re.search(r" (\d+) grads, ", stderr).group(1))


def test_ranks_cell_is_correct_and_makes_one_process_work(ranks_root):
    split = run_cell(ranks_root, CELL, seed=2 ** 31 + 99, trace=1,
                     seconds=WHOLE_WINDOW)
    assert split.returncode == 0, split.stderr[-3000:]
    res = last_json(split.stdout)
    assert res["correct"], res
    # on the CPU every rank runs the plain twin: no chain may differ
    assert res["checks"]["mismatch_share"]["value"] == 0.0
    assert res["checks"]["ranks_out_of_step"] == dict(value=0, limit=0)
    assert res["device"]["count"] == 4
    # a run traced on the CPU has no device kernels: the readers of the
    # device trace find nothing there, the others read
    got = res["metrics"]
    for name in ("ranks.mfu_pct", "collective.wait_us",
                 "host_loop.call_ms", "host_loop.periods_per_readback"):
        assert got[name]["value"] > 0, name
    one = run_cell(ranks_root, ONE, seed=2 ** 31 + 99, trace=1,
                   seconds=WHOLE_WINDOW)
    assert one.returncode == 0, one.stderr[-3000:]
    assert last_json(one.stdout)["correct"]
    assert _grads(split.stderr) == _grads(one.stderr) > 0
    assert last_json(one.stdout)["attempted"] == res["attempted"]


def test_a_rank_at_the_wrong_chain_offset_fails_the_check(ranks_root,
                                                          tmp_path):
    make = "    me = Rank(cell, args.seed, dev)\n"
    root = _mutated(ranks_root, tmp_path, make, (
        "    if args.rank == 1:\n"
        "        from walnuts_tpu_torch.sampler import megakernel\n"
        "        real = megakernel.chain_block\n"
        "        megakernel.chain_block = lambda mesh, C: (\n"
        "            real(mesh, C)[0] + 1, real(mesh, C)[1])\n" + make))
    p = run_cell(root, CELL, seed=5, seconds=1.0)
    assert p.returncode == 0, p.stderr[-3000:]
    res = last_json(p.stdout)
    assert res["correct"] is False, res
    # rank 1 holds a quarter of the chains, and each of them goes wrong
    assert res["checks"]["mismatch_share"]["value"] >= 0.2


def test_a_rank_out_of_step_fails_the_check(ranks_root, tmp_path):
    # rank 2 counts one more read of the stop test a call than it made
    call = "        super().call()\n"
    root = _mutated(ranks_root, tmp_path, call, call + (
        "        if self.mesh.get_rank() == 2:\n"
        "            self.mk.stop_readbacks += 1\n"))
    p = run_cell(root, CELL, seed=5, seconds=1.0)
    assert p.returncode == 0, p.stderr[-3000:]
    res = last_json(p.stdout)
    assert res["correct"] is False, res
    assert res["checks"]["ranks_out_of_step"] == dict(value=1, limit=0)
    assert res["checks"]["mismatch_share"]["value"] == 0.0


@pytest.mark.parametrize("fault, says", [
    ("        elif command == CALL:\n"
     "            if args.rank == 2 and me.calls == 3:\n"
     "                os.kill(os.getpid(), 9)\n",
     "rank 2 exited with code -9"),
    ("        elif command == CALL:\n"
     "            if args.rank == 3 and me.calls == 3:\n"
     "                time.sleep(3600)\n",
     # rank 0 waits in call 3's stop test for rank 3
     "call 3 outlived 30 s; ending the run"),
], ids=["killed", "hung"])
def test_a_lost_rank_ends_the_run_at_once(ranks_root, tmp_path, fault, says):
    root = _mutated(ranks_root, tmp_path, "        elif command == CALL:\n",
                    fault)
    entry = root / "portbench" / "entries" / "fused_ranks.py"
    entry.write_text(entry.read_text().replace("LIMIT_S = 300.0",
                                               "LIMIT_S = 30.0"))
    t0 = time.monotonic()
    p = run_cell(root, CELL, seed=5, seconds=60.0)
    assert time.monotonic() - t0 < 120
    assert p.returncode == 5, p.stderr[-3000:]
    assert says in p.stderr, p.stderr[-3000:]
    assert p.stdout.strip() == ""


# ---- the readers, on hand-made windows ----

def _reader(name):
    return inputs.load_module(PORTBENCH / "metrics" / f"{name}.py",
                              "test_ranks_reader_" + name.replace(".", "_"))


def _window(**kw):
    """Four ranks of 100 chains at D = 10 that made 1e9 gradient
    evaluations in 2 s, 4e8 of them on rank 0; 0.5 s of round kernel
    and 40 us of NCCL kernels in rank 0's trace over 8 collectives."""
    w = SimpleNamespace(
        cell=SimpleNamespace(chips=4), config={"flops_per_coord": 12},
        dtype="float32", C=400, D=10, itemsize=4, dg=2, grads=10 ** 9,
        transitions=10 ** 6, window_s=2.0,
        ranks=[(4 * 10 ** 8, 4 * 10 ** 5, 100)] + [(2 * 10 ** 8, 2 * 10 ** 5,
                                                    100)] * 3,
        collectives=8,
        trace={"device_s_by_name": {
            "void round_kernel<float>(RoundParams)": 0.5,
            "ncclDevKernel_AllReduce_Sum_i64_RING_LL(x)": 30e-6,
            "void ncclKernel_AllGather_RING_LL(x)": 10e-6,
            "Memcpy DtoH": 1e-3}})
    for k, v in kw.items():
        setattr(w, k, v)
    return w


# spans of two calls: each a stop test whose all-reduce takes 3 and 5 us
SPANS = [
    Span("call", -1, 0, 100_000, None),
    Span("period", 0, 1_000, 90_000, None),
    Span("readback", 1, 1_000, 6_000, None),
    Span("collective", 2, 1_000, 4_000, None),
    Span("call", -1, 100_000, 200_000, None),
    Span("period", 4, 101_000, 190_000, None),
    Span("readback", 5, 101_000, 107_000, None),
    Span("collective", 6, 101_000, 106_000, None),
]


def _roofline(grads, transitions, C):
    ops = grads * 10 * 12
    nbytes = 2.0 * C * 22 * 4 + transitions * 2 * 4
    return max(ops / 67e12, nbytes / 3.35e12)


WANT = {
    "ranks.mfu_pct": 100.0 * 10 ** 9 * 10 * 12 / 2.0 / (4 * 67e12),
    "ranks.kernel_roofline_pct": 100.0 * _roofline(4e8, 4e5, 100) / 0.5,
    "collective.wait_us": (3 + 5) / 2,
    "collective.us_per_collective": 40.0 / 8,
}


@pytest.mark.parametrize("name", NEW)
def test_reader_on_a_hand_made_window(monkeypatch, name):
    monkeypatch.setattr(trace, "spans", lambda: list(SPANS))
    assert _reader(name).read(_window()) == pytest.approx(WANT[name],
                                                          rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_reader_without_its_input_reads_nothing(monkeypatch, name):
    # a one-card cell: no ranks, no collectives counted, no NCCL kernels,
    # and a program that records no collective span
    one_card = _window(collectives=None, trace={"device_s_by_name": {
        "void round_kernel<float>(RoundParams)": 0.5}})
    del one_card.ranks
    monkeypatch.setattr(trace, "spans", lambda: [
        s for s in SPANS if s.name != "collective"])
    assert _reader(name).read(one_card) is None
    # a program without the span recorder, and an untraced window
    monkeypatch.setitem(sys.modules, "walnuts_tpu_torch.utils.trace", None)
    untraced = _window(trace=None, collectives=0)
    del untraced.ranks
    assert _reader(name).read(untraced) is None
