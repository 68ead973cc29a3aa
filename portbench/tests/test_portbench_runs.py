"""Whole runs of the harness on the CPU at a small size, in a temporary
checkout to which a configuration, a mix, a metric and limits were added as
files: the names are found, the last line carries a result line's keys, the
control and every fault a cell can have (the CV bias's included) come out
not correct, and a run on
the command line without a card fails without falling back to the CPU."""

import copy
import io
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import REPO, TINY


def _run(checkout, workload, seed=2**31 + 5, device="cpu"):
    from portbench.harness import run_cell

    out, err = io.StringIO(), io.StringIO()
    rc = run_cell(workload, seed, 0.1, False, time.perf_counter(), device=device,
                  out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def _cvbias_on_card():
    """The CV bias runs inside the CUDA kernel alone (the port refuses
    ``kernel_bias`` without it), so its cells run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("the in-kernel CV bias needs a CUDA card: run on the chip")
    return "cuda"


@pytest.mark.parametrize("mix", ["fused", pytest.param("cvbias", marks=pytest.mark.gpu)])
def test_a_run_prints_the_result_line(checkout, mix):
    device = _cvbias_on_card() if mix == "cvbias" else "cpu"
    rc, line, err = _run(checkout, f"{TINY}.{mix}", device=device)
    assert rc == 0, err
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"ns_per_day", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == {"swap_mismatches", "frame_energy_gap_kj", "replay_dx_nm",
                                   "start_energy_rise_kj"}
    tail = err.strip().splitlines()[-4:]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_added_files_are_found_by_name(checkout):
    from portbench import generator, harness

    (checkout / "portbench/metrics/segments_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['segments'])\n")
    (checkout / "portbench/traffic/fused_again.json").write_text(
        (checkout / "portbench/traffic/fused.json").read_text())
    assert harness.metric_reader("segments_seen")({"segments": 3}) == 3.0
    assert generator.load_json("traffic", "fused_again")["entry"] == "run_fused"
    assert harness.config_of(harness.manifest(), TINY)["remd"]["n_replicas"] == 4


def _session(checkout, steps=300, mix="fused"):
    from portbench import generator, harness

    cfg = harness.config_of(harness.manifest(), TINY)
    cfg["md"]["steps_per_segment"] = steps
    s = generator.Session(cfg, generator.load_json("traffic", mix), 11, device="cpu")
    s.setup()
    start = harness._host(s.state())
    return s, start, s.segment()


def test_control_comes_out_not_correct(checkout):
    """The reference in the program's place, forces and energies in
    bfloat16: fails the energy gap and the replay."""
    from portbench import check, generator
    from portbench.control import control_segment

    s, start, res = _session(checkout)
    s.close()
    limits = generator.load_json("limits", f"{TINY}.fused")
    sound = check.judge(s, [start], [res], limits)
    low = check.reference_for(s, dtype=torch.bfloat16)
    ctrl = check.judge(s, [start], [control_segment(s, start, low, res)], limits)
    assert check.passes(sound), sound
    assert not check.passes(ctrl), ctrl
    assert ctrl["frame_energy_gap_kj"]["value"] > ctrl["frame_energy_gap_kj"]["limit"]
    assert ctrl["replay_dx_nm"]["value"] > ctrl["replay_dx_nm"]["limit"]


def test_control_script_reads_both_sides(checkout):
    """control.py at the small size on the CPU: one line a seed, the
    program's within the limits, the control's not."""
    p = subprocess.run([sys.executable, "portbench/control.py", "--workload", f"{TINY}.fused",
                        "--seeds", str(2**31 + 41), "--control-seeds", str(2**31 + 42),
                        "--segments", "1", "--device", "cpu"],
                       cwd=checkout, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    limits = json.loads((checkout / f"portbench/limits/{TINY}.fused.json").read_text())
    lines = [json.loads(x) for x in p.stdout.splitlines() if x.startswith("{")]
    assert [x["side"] for x in lines] == ["program", "control"]
    ok = [all(v <= limits[k] for k, v in x["numbers"].items()) for x in lines]
    assert ok == [True, False], lines


def _unchanged(remd, res, start):
    e = remd._chunk.energy_and_forces(torch.as_tensor(start["positions"]))[0].numpy()
    res.positions[:] = start["positions"][None]
    res.potential_energy[:] = e[None]


def _half_left_out(remd, res, start):
    h = res.positions.shape[1] // 2
    res.positions[:, h:] = start["positions"][None, h:]


def _no_exchange(remd, res, start):
    res.replica_ids[:] = res.replica_ids[0][None]


def _answer_altered(remd, res, start):
    res.positions[len(res.positions) // 2, 0, 3] += 0.05


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _no_exchange, _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_each_fault_comes_out_not_correct(checkout, monkeypatch, fault):
    """A run with the timed path broken underneath (the chip's look
    skipped): a step that returns its state unchanged, half of the replicas
    left out, the exchange left out, one frame altered where it is made.
    One chip, so no exchange between chips to leave out."""
    from pmarlo_tpu_torch.remd.remd import ReplicaExchange

    original = ReplicaExchange.run_fused
    calls = {"n": 0}

    def broken(self, n_steps):
        start = {"positions": self.state.positions.numpy().copy()}
        res = original(self, n_steps)
        calls["n"] += 1
        if calls["n"] > 1:              # the warm-up segment stays sound
            fault(self, res, start)
        return res

    monkeypatch.setattr(ReplicaExchange, "run_fused", broken)
    rc, line, err = _run(checkout, f"{TINY}.fused", seed=2**31 + 17)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


def test_without_a_card_the_command_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "chignolin-obc2.fused",
                        "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_a_directory_without_the_program_fails(tmp_path):
    import shutil

    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "chignolin-obc2.fused",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["bias-dropped", "bias-flipped"])
def test_each_bias_fault_comes_out_not_correct(checkout, monkeypatch, fault):
    """The kernel handed the CV bias dropped, or with its gradient's sign
    flipped, while the reference keeps the cell's bias."""
    from pmarlo_tpu_torch.remd.remd import ReplicaExchange
    from portbench.control import plant

    device = _cvbias_on_card()
    monkeypatch.setattr(ReplicaExchange, "__init__", ReplicaExchange.__init__)
    plant(fault)
    rc, line, err = _run(checkout, f"{TINY}.cvbias", seed=2**31 + 23, device=device)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


def _on_card(workload, *args):
    """control.py's lines, and the cell's limits."""
    p = subprocess.run([sys.executable, "portbench/control.py", "--workload", workload,
                        "--segments", "1", *args],
                       cwd=REPO, check=True, timeout=1200, capture_output=True, text=True)
    limits = json.loads((REPO / "portbench/limits" / f"{workload}.json").read_text())
    lines = [json.loads(x) for x in p.stdout.splitlines() if x.startswith("{")]
    return [(x, x["failed"] == 0 and all(v <= limits[k] for k, v in x["numbers"].items()))
            for x in lines]


@pytest.mark.gpu
def test_control_on_the_card_at_the_cell_size(card):
    """The control at chignolin's own size (32 replicas, 10,000-step
    segment) on three seeds: each comes out not correct, while the program's
    segments pass."""
    got = _on_card("chignolin-obc2.fused", "--seeds", str(2**31 + 901), "--control-seeds",
                   ",".join(str(2**31 + 910 + k) for k in range(3)))
    assert [x["side"] for x, _ in got] == ["program"] + ["control"] * 3
    assert got[0][1] and not any(ok for _, ok in got[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["bias-dropped", "bias-flipped"])
def test_bias_faults_on_the_card_at_the_cell_size(card, fault):
    """The CV-bias cell's kernel with the bias dropped or flipped, at the
    cell's own size on three seeds: none comes out correct."""
    got = _on_card("chignolin-obc2.cvbias", "--fault", fault, "--seeds",
                   ",".join(str(2**31 + 930 + k) for k in range(3)))
    assert len(got) == 3 and not any(ok for _, ok in got)


def test_copied_results_are_judged_alike(checkout):
    """The judge reads its arguments and changes none of them."""
    from portbench import check, generator

    s, start, res = _session(checkout)
    s.close()
    before = copy.deepcopy(res)
    check.judge(s, [start], [res], generator.load_json("limits", f"{TINY}.fused"))
    assert np.array_equal(before.positions, res.positions)
    assert np.array_equal(before.replica_ids, res.replica_ids)
