"""The program's span recorder (``utils/profiling.py``): off by default,
nesting, parents, segment ids, self time and counters; its spans in
``trace()``'s Chrome trace on the trace's own clock; the span tree of
``ReplicaExchange`` set-up and ``run_fused`` on the CPU, whose results the
recorder leaves bit for bit as they are; the step-phase sums of the fused
kernel's stamps.

The ``gpu`` tests run the benchmark's three cells' shapes on the card
(``portbench.generator.Session``): the stamped whole-run kernel against the
unstamped one bit for bit, with the same launch plan; each sampled step's
stamps in order; and the shared clock, kernels matched to their launch
calls by correlation id: every ``remd.launch`` span holds the runtime call
that launched its segment's step kernel, and a kernel that the trace starts
before its span it starts before its own launch call too. They run where
JAX is not installed:
``python -m pytest --noconftest -m gpu tests/unit/test_torch_profiling_spans.py``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from pmarlo_tpu_torch.data import alanine_dipeptide_structure
from pmarlo_tpu_torch.md import fused_md
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange
from pmarlo_tpu_torch.utils import profiling
from pmarlo_tpu_torch.utils.profiling import RECORDER, Recorder, recording, span, trace


@pytest.fixture(autouse=True)
def _recorder_off():
    """Every test starts and ends with the process's recorder off and empty."""
    RECORDER.stop()
    RECORDER.clear()
    yield
    RECORDER.stop()
    RECORDER.clear()


@pytest.fixture
def ticks(monkeypatch):
    """A clock that advances 10 ns a reading."""
    t = iter(range(0, 10**9, 10))
    monkeypatch.setattr(profiling, "clock_ns", lambda: next(t))


# --- the recorder -------------------------------------------------------------------------------

def test_recorder_is_off_by_default_and_records_nothing():
    rec = Recorder()
    assert rec.on is False and RECORDER.on is False
    with rec.span("a", segment=True, n=1) as sp:
        rec.count("c", 3)
    assert sp is None
    with span("b") as sp2:
        profiling.count("c", 1)
    assert sp2 is None
    # off, every site gets the same no-op context
    assert rec.span("x") is rec.span("y") is span("z")
    assert rec.spans == [] and rec.counts == [] and rec.segments == 0
    assert RECORDER.spans == [] and RECORDER.counts == []


def test_nesting_parents_and_segment_ids(ticks):
    with recording() as rec:
        with span("setup"):
            with span("setup.child"):
                pass
        for k in range(2):
            with span("root", segment=True, k=k) as root:
                with span("a"):
                    with span("a.1"):
                        profiling.count("bytes", 10 * (k + 1))
                with span("b"):
                    profiling.count("bytes", 1)
            assert root.attrs == {"k": k}
        profiling.count("outside", 5)
    assert rec.on is False
    names = [s.name for s in rec.spans]
    assert names == ["setup", "setup.child", "root", "a", "a.1", "b", "root", "a", "a.1", "b"]
    parents = [rec.spans[s.parent].name if s.parent >= 0 else None for s in rec.spans]
    assert parents == [None, "setup", None, "root", "a", "root", None, "root", "a", "root"]
    assert [s.segment for s in rec.spans] == [None, None, 0, 0, 0, 0, 1, 1, 1, 1]
    assert rec.segments == 2
    assert all(s.end_ns > s.start_ns for s in rec.spans)
    assert rec.children(2) == [3, 5]
    assert rec.total("bytes") == 10 + 1 + 20 + 1
    assert rec.total("bytes", segment=1) == 21
    assert [(c.segment, rec.spans[c.span].name) for c in rec.counts[:2]] == [(0, "a.1"), (0, "b")]
    assert rec.counts[-1].span == -1 and rec.counts[-1].segment is None


def test_self_time_is_a_span_less_its_children(ticks):
    with recording() as rec:
        with span("outer"):          # reads 0
            with span("in1"):        # 10, 20
                pass
            with span("in2"):        # 30
                with span("deep"):   # 40, 50
                    pass
            # in2 ends 60
        # outer ends 70
    outer, in1, in2, deep = rec.spans
    assert (outer.ns, in1.ns, in2.ns, deep.ns) == (70, 10, 30, 10)
    assert rec.self_ns(0) == 70 - 10 - 30
    assert rec.self_ns(2) == 30 - 10
    assert rec.self_ns(3) == 10


def test_recording_empties_the_recorder_and_restores_its_state():
    RECORDER.start()
    with span("gone"):
        pass
    with recording() as rec:
        with span("kept"):
            pass
    assert RECORDER.on is True
    assert [s.name for s in rec.spans] == ["kept"]
    RECORDER.stop()
    with recording():
        pass
    assert RECORDER.on is False and RECORDER.spans == []


def test_tensor_counters_are_read_when_summed():
    with recording() as rec:
        with span("s", segment=True):
            profiling.count("cycles", torch.tensor(7, dtype=torch.int64))
            profiling.count("cycles", torch.tensor([5], dtype=torch.int64)[0])
    assert rec.total("cycles") == 12.0


# --- the exporter ---------------------------------------------------------------------------------

def test_trace_json_holds_the_programs_spans_on_the_traces_clock(tmp_path):
    """``trace()`` turns the recorder on for its block and writes the spans
    as a host track; a span holds the profiler's own event recorded inside
    it (the same clock), and the recorder is off again after the block."""
    with trace(tmp_path / "prof"):
        assert RECORDER.on
        with span("outer", segment=True, what="test"):
            with torch.profiler.record_function("marked"):
                torch.ones(256).sum()
            profiling.count("bytes", 64)
    assert RECORDER.on is False
    data = json.loads((tmp_path / "prof" / profiling.TRACE_FILE).read_text())
    events = data["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in spans] == ["outer"]
    outer = spans[0]
    assert outer["tid"] == profiling.SPAN_TID and outer["ph"] == "X"
    assert outer["args"]["segment"] == 0 and outer["args"]["what"] == "test"
    assert outer["args"]["bytes"] == 64.0
    assert any(e.get("ph") == "M" and e.get("tid") == profiling.SPAN_TID for e in events)
    mark = next(e for e in events if e.get("name") == "marked" and e.get("ph") == "X")
    slack_us = 100.0      # the profiler converts its approximate clock to this one
    assert outer["ts"] - slack_us <= mark["ts"]
    assert mark["ts"] + mark["dur"] <= outer["ts"] + outer["dur"] + slack_us


# --- the runner on the CPU -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def alanine():
    return build_system(alanine_dipeptide_structure(), gb_model="obc2", device="cpu")


def _config(R=4, seed=5):
    return RemdConfig(n_replicas=R, t_min=300.0, t_max=600.0, exchange_frequency=6,
                      report_interval=3, seed=seed)


def _tree(rec, index=-1, depth=0):
    """(name, depth) of every span below ``index`` (all roots for -1), in order."""
    out = []
    for k, s in enumerate(rec.spans):
        if s.parent == index:
            out.append((s.name, depth))
            out.extend(_tree(rec, k, depth + 1))
    return out


def test_setup_spans_on_the_cpu(alanine):
    system, pos = alanine
    with recording() as rec:
        ReplicaExchange(system, pos, _config(), device="cpu", minimize=True)
    # no kernel library on the CPU: set-up plans the plain twin
    assert _tree(rec) == [("remd.init", 0), ("remd.plan", 1), ("remd.minimize", 1),
                          ("remd.state", 1)]
    assert all(s.segment is None for s in rec.spans)
    init, minimize = rec.named("remd.init")[0], rec.named("remd.minimize")[0]
    assert init.start_ns <= minimize.start_ns and minimize.end_ns <= init.end_ns


def test_run_fused_spans_on_the_plain_path_and_the_same_bits(alanine):
    system, pos = alanine
    runs = {}
    for on in (False, True):
        remd = ReplicaExchange(system, pos, _config(), device="cpu", minimize=False)
        with recording() as rec:
            if not on:
                RECORDER.stop()
            runs[on] = [remd.run_fused(12), remd.run_fused(6)]
            state = remd.state
        runs[on].append(state)
        if not on:
            assert rec.spans == [] and rec.counts == []
    for a, b in zip(runs[False][:2], runs[True][:2]):
        for f in dataclasses.fields(a):
            if f.name == "wall_seconds":
                continue
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb)
            else:
                assert va == vb, f.name
    sa, sb = runs[False][2], runs[True][2]
    assert torch.equal(sa.positions, sb.positions) and torch.equal(sa.velocities, sb.velocities)
    assert torch.equal(sa.seeds, sb.seeds) and sa.step == sb.step
    segment = [("remd.run_fused", 0), ("remd.prepare", 1), ("remd.reference", 2),
               ("remd.finish", 1), ("remd.to_host", 2), ("remd.result", 2)]
    assert _tree(rec) == segment + segment
    assert [s.segment for s in rec.spans] == [0] * 6 + [1] * 6
    assert rec.named("remd.run_fused")[0].attrs == {"n_steps": 12}
    # nothing crossed from a device on the CPU
    assert rec.total("remd.host_syncs") == 0 and rec.named("remd.stamps") == []
    for root in rec.named("remd.run_fused"):
        k = rec.spans.index(root)
        kids = [rec.spans[c] for c in rec.children(k)]
        assert root.start_ns <= kids[0].start_ns <= kids[0].end_ns <= kids[1].start_ns
        assert kids[1].end_ns <= root.end_ns


# --- the stamps -------------------------------------------------------------------------------

def test_step_phase_cycles_sum_each_interval_into_its_phase():
    B = fused_md.STAMP_BOUNDARIES
    assert len(fused_md.STAMP_INTERVALS) == B - 1
    assert set(fused_md.STAMP_INTERVALS) == set(fused_md.STAMP_PHASES)
    rng = np.random.default_rng(3)
    gaps = rng.integers(0, 1000, size=(3, 4, B - 1))
    stamps = torch.as_tensor(np.concatenate(
        [np.full((3, 4, 1), 10**12), 10**12 + np.cumsum(gaps, axis=-1)], axis=-1))
    cycles = fused_md.step_phase_cycles(stamps)
    assert cycles.dtype == torch.int64 and cycles.shape == (len(fused_md.STAMP_PHASES),)
    for k, phase in enumerate(fused_md.STAMP_PHASES):
        cols = [i for i, p in enumerate(fused_md.STAMP_INTERVALS) if p == phase]
        assert int(cycles[k]) == int(gaps[..., cols].sum())
    assert int(cycles.sum()) == int((stamps[..., -1] - stamps[..., 0]).sum())


# --- on the card --------------------------------------------------------------------------------

CELLS = ["chignolin-obc2.fused", "alanine-obc2.fused", "chignolin-obc2.cvbias"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stamped kernel has no CPU mode")


def _session(cell, seed=2147483701):
    """The benchmark cell's set-up (its configuration, mix and seed), its
    warm-up segment included."""
    from portbench import generator, harness

    bench = harness.manifest()
    w = harness.cell_of(bench, cell)
    s = generator.Session(harness.config_of(bench, w["config"]),
                          generator.load_json("traffic", w["traffic"]), seed, device="cuda")
    s.setup()
    return s


def _restore(remd, snap):
    remd.state = dataclasses.replace(
        remd.state, positions=snap["x"].clone(), velocities=snap["v"].clone(),
        seeds=snap["seeds"].clone(), step=snap["step"])
    remd.replica_ids = snap["ids"].clone()
    remd._attempts_done = snap["attempts"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_stamped_kernel_computes_the_same_bits_at_each_cells_shape(cell):
    """A 2,000-step segment with the recorder off and on from one state:
    positions, velocities, seeds, frames, energies, kinetic temperatures,
    ids and acceptance bit for bit, the launch plan the same; each sampled
    step's stamps never decrease, so its phases add up to it."""
    _need_card()
    s = _session(cell)
    remd = s.remd
    st = remd.state
    snap = {"x": st.positions.clone(), "v": st.velocities.clone(), "seeds": st.seeds.clone(),
            "step": st.step, "ids": remd.replica_ids.clone(), "attempts": remd._attempts_done}
    n_steps = 20 * remd.config.exchange_frequency
    off = remd.run_fused(n_steps)
    plan_off = dict(remd._chunk.last_launch)
    end_off = remd.state
    _restore(remd, snap)
    with recording() as rec:
        on = remd.run_fused(n_steps)
    plan_on = dict(remd._chunk.last_launch)
    end_on = remd.state
    assert plan_on == plan_off
    for name in ("positions", "potential_energy", "kinetic_temperature", "replica_ids",
                 "acceptance_matrix", "temperatures"):
        np.testing.assert_array_equal(getattr(off, name), getattr(on, name), err_msg=name)
    for name in ("positions", "velocities", "seeds"):
        assert torch.equal(getattr(end_off, name), getattr(end_on, name)), name
    # the stamps: one sampled step a report block of every configuration
    cycles = {p: rec.total(f"md_step.cycles.{p}") for p in fused_md.STAMP_PHASES}
    sampled = rec.total("md_step.sampled_steps")
    F = n_steps // remd.config.report_interval
    assert sampled == remd.n_replicas * F
    assert all(v >= 0 for v in cycles.values()), cycles
    assert cycles["pairs"] > 0 and cycles["barriers"] > 0 and cycles["folds"] > 0
    if s.bias is not None:
        assert cycles["bias"] > cycles["folds"]
    # raw stamps of a second stamped launch, boundary by boundary
    _restore(remd, snap)
    st = remd.state
    out = remd._chunk.remd(st.positions, st.velocities, st.seeds, remd.replica_ids,
                           remd.ladder, n_attempts=n_steps // remd.config.exchange_frequency,
                           frames_per_attempt=remd.config.exchange_frequency
                           // remd.config.report_interval,
                           report_interval=remd.config.report_interval, step_offset=st.step,
                           swap_seed=remd.config.seed, attempt_offset=remd._attempts_done,
                           stamps=True)
    raw = out.stamps.cpu()
    assert raw.shape == (remd.n_replicas, F, fused_md.STAMP_BOUNDARIES)
    d = torch.diff(raw, dim=-1)
    assert bool((d >= 0).all()), "a sampled step's boundaries out of order"
    per_step = fused_md.step_phase_cycles(out.stamps).cpu()
    assert int(per_step.sum()) == int((raw[..., -1] - raw[..., 0]).sum())
    # a third launch from the same state, stamped again: the same frames
    np.testing.assert_array_equal(out.frames.cpu().numpy(), on.positions)
    s.close()


@pytest.mark.gpu
def test_launch_spans_hold_their_runtime_calls_on_the_traces_clock(tmp_path):
    """24 segments of the alanine cell's shape under ``torch.profiler`` (the
    device alone, as the benchmark traces it) with the recorder on. Each
    step kernel is matched by correlation id to the runtime call that
    launched it. Host side: a ``remd.launch`` span holds every such call, so
    spans and the trace's host events share one clock. Device side: a kernel
    that the trace starts before its span it also starts before its own
    launch call, which no span can cause: the trace's device timestamps
    stray from its host timestamps (by up to milliseconds on an H100, in
    some traces), and no kernel is put before its span otherwise."""
    _need_card()
    from portbench.program_trace import clock, step_kernels

    s = _session("alanine-obc2.fused")
    remd = s.remd
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    with recording() as rec:
        prof.__enter__()
        t0 = profiling.clock_ns()
        for _ in range(24):
            remd.run_fused(1000)
        torch.cuda.synchronize()
        t1 = profiling.clock_ns()
        prof.__exit__(None, None, None)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    ck = clock(rec, (t0, t1), step_kernels(int(doc.get("baseTimeNanoseconds", 0)),
                                           doc["traceEvents"]))
    print(ck)
    assert ck["kernels"] == len(rec.named("remd.launch")) == 24, ck
    assert ck["calls_held_by_a_launch_span"] == 24, ck
    assert ck["kernels_before_their_span"] == ck["of_which_before_their_own_call"], ck
    s.close()
