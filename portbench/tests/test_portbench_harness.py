"""The harness on the CPU at small sizes: cells, traffic and a metric
added as files alone are found by name and run; a run loads no JAX;
the check fails each fault of the timed path and the control; the
harness refuses to run without the program or without a card."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "walnuts_tpu")
ENV = dict(os.environ, OMP_NUM_THREADS="2")


def run_cell(root, workload, seed=7, seconds=2.0, trace=0, device="cpu"):
    cmd = [sys.executable, str(root / "portbench" / "run.py"),
           "--workload", workload, "--seed", str(seed), "--seconds",
           str(seconds), "--trace", str(trace)]
    if device:
        cmd += ["--device", device]
    return subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=600, env=ENV)


def last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["tiny_funnel.sample",
                                      "tiny_funnel.external",
                                      "tiny_funnel.warmup",
                                      "tiny_sw.sample"])
def test_cell_added_as_files_runs_and_is_correct(tiny_root, workload):
    # long enough for a call at the round cap after the check's calls,
    # so that every chain of the warmup cell completes a transition
    p = run_cell(tiny_root, workload, seed=2 ** 31 + 12345, seconds=5.0)
    assert p.returncode == 0, p.stderr[-3000:]
    res = last_json(p.stdout)
    assert res["correct"], res
    assert list(res)[-1] == "checks"
    # on the CPU the program runs its plain twin: no chain may differ
    assert res["checks"]["mismatch_share"]["value"] == 0.0
    assert "setup_s" in res["metrics"]
    e2e = {"warmup": "warmup_transitions_per_s"}.get(
        workload.split(".")[1], "grad_evals_per_s")
    assert res["metrics"][e2e]["value"] > 0
    assert p.stderr.strip().splitlines()[-1].startswith("check ")


def test_metric_added_as_a_file_is_read(tiny_root):
    p = run_cell(tiny_root, "tiny_funnel.sample", trace=1)
    assert p.returncode == 0, p.stderr[-3000:]
    res = last_json(p.stdout)
    assert res["metrics"]["tiny.draws_per_call"]["value"] > 0
    assert "grad_evals_per_s" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_run_loads_no_jax(tiny_root):
    code = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('r', "
        f"{str(tiny_root / 'portbench' / 'run.py')!r})\n"
        "r = importlib.util.module_from_spec(spec); spec.loader.exec_module(r)\n"
        "rc = r.main(['--workload', 'tiny_funnel.external', '--seed', '3',"
        " '--seconds', '1', '--device', 'cpu'])\n"
        f"bad = sorted({{m.split('.')[0] for m in sys.modules}} & {set(FORBIDDEN)!r})\n"
        "print(json.dumps({'rc': rc, 'bad': bad}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny_root,
                       capture_output=True, text=True, timeout=600, env=ENV)
    assert p.returncode == 0, p.stderr[-3000:]
    out = last_json(p.stdout)
    assert out == {"rc": 0, "bad": []}


def test_without_the_program_it_prints_no_result(tiny_root, tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(
        (tiny_root / "BENCHMARK.json").read_text())
    shutil.copytree(tiny_root / "portbench", tmp_path / "portbench")
    p = run_cell(tmp_path, "tiny_funnel.sample")
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_without_a_card_it_prints_no_result(tiny_root):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    p = run_cell(tiny_root, "tiny_funnel.sample", device=None)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def _load_run(root):
    spec = importlib.util.spec_from_file_location(
        "portbench_tiny_run", root / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# chain axis of each bank: sf, si, vx, slab_q, slab_v, samples, diags
_CHAIN_AXIS = (1, 1, 0, 0, 0, 1, 1)


def _unchanged(orig):
    def period(b, n, spec):
        return None
    return period


def _half(orig):
    """Half the batch left out: the second half's chains keep their
    state."""
    def period(b, n, spec):
        keep = [t.clone() for t in b]
        orig(b, n, spec)
        for t, k, ax in zip(b, keep, _CHAIN_AXIS):
            c = t.shape[ax]
            t.narrow(ax, c // 2, c - c // 2).copy_(
                k.narrow(ax, c // 2, c - c // 2))
    return period


def _altered(orig):
    """Each period's answers altered where they are made: the draws and
    the chains' positions off by 1%."""
    def period(b, n, spec):
        from walnuts_tpu_torch.sampler import round_kernel
        orig(b, n, spec)
        b.samples.mul_(1.01)
        b.vx[:, round_kernel.V_FIELDS.index("qc")].mul_(1.01)
    return period


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("workload", ["tiny_funnel.sample",
                                      "tiny_funnel.warmup"])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, capsys,
                                            fault, workload):
    run = _load_run(tiny_root)
    from walnuts_tpu_torch.sampler import round_kernel
    monkeypatch.setattr(round_kernel, "run_rounds",
                        fault(round_kernel.run_rounds))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    rc = run.main(["--workload", workload, "--seed", "11", "--seconds",
                   "1", "--device", "cpu"])
    res = last_json(capsys.readouterr().out)
    assert rc == 0
    assert res["correct"] is False, res["checks"]


def _wrong_push(mk, rk):
    """The step-size estimator fed the wrong quantity: every value 0.1
    high (H 10% high)."""
    orig = mk.p2_push

    def push(st, xi, mask=None):
        step_size = bool((st.p < 0.5).all())   # p2h's probe is 0.2
        return orig(st, xi + 0.1 if step_size else xi, mask)
    return mk, "p2_push", push


def _wrong_resume(mk, rk):
    """A call that resumes a state moves its chains' positions by 1%."""
    orig = rk.pack

    def pack(st):
        if st.n > 0:
            st = st._replace(qc=1.01 * st.qc)
        return orig(st)
    return rk, "pack", pack


@pytest.mark.parametrize("fault,workload", [
    (_wrong_push, "tiny_funnel.warmup"),
    (_wrong_resume, "tiny_funnel.warmup"),
    (_wrong_resume, "tiny_funnel.sample"),
    (_wrong_resume, "tiny_sw.sample")])
def test_a_broken_estimator_or_resume_is_not_correct(
        tiny_root, monkeypatch, capsys, fault, workload):
    run = _load_run(tiny_root)
    from walnuts_tpu_torch.sampler import megakernel, round_kernel
    monkeypatch.setattr(*fault(megakernel, round_kernel))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    rc = run.main(["--workload", workload, "--seed", "13", "--seconds",
                   "1", "--device", "cpu"])
    res = last_json(capsys.readouterr().out)
    assert rc == 0
    assert res["correct"] is False, res["checks"]


def test_the_control_fails_the_check(tiny_root, capsys):
    spec = importlib.util.spec_from_file_location(
        "portbench_tiny_control", tiny_root / "portbench" / "control.py")
    ctl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ctl)
    for workload in ("tiny_funnel.sample", "tiny_funnel.warmup"):
        assert ctl.main(["--workload", workload, "--seeds", "1", "2", "3",
                         "--device", "cpu"]) == 0
        lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
                 if x.startswith("{")]
        assert len(lines) == 3
        limit = json.loads((tiny_root / "portbench" / "checks" /
                            f"{workload}.json").read_text())["limits"]
        for x in lines:
            assert any(x[k] > limit[k] for k in limit if k in x), x
