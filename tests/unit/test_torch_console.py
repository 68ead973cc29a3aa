"""The port's console half: CLI (``main.py``), ``get_info``, settings,
utilities, the staged pipeline, profiling and the deploy worker.

Mirrors of the JAX package's ``test_cli.py``, the settings, ``deep_merge``
and misc tests of ``test_utils_settings.py``, the ``Pipeline`` and
``StageTimer`` tests of ``test_workflow_demux.py`` and the deploy-worker
tests of ``test_deploy_visualization.py`` run on the port's modules (their
``slow`` marks kept), beside parity checks against the JAX package.
"""

import json

import numpy as np
import pytest
import torch

import pmarlo_tpu_torch
from pmarlo_tpu_torch import deploy_worker
from pmarlo_tpu_torch.main import get_info, get_version, main
from pmarlo_tpu_torch.settings import load_defaults
from pmarlo_tpu_torch.utils.config_utils import deep_merge
from pmarlo_tpu_torch.utils.profiling import StageTimer, device_memory_stats, trace
from pmarlo_tpu_torch.workflow import Pipeline, RunStatus


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# --- mirrors of tests/unit/test_cli.py ------------------------------------------------------


def test_get_version_and_info():
    v = get_version()
    assert isinstance(v, str) and v
    assert "version" in get_info()


def test_cli_info(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "version" in out or "backend" in out


def test_cli_no_command_defaults_to_info(capsys):
    assert main([]) == 0


@pytest.mark.slow
def test_cli_run_segment(tmp_path, capsys):
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.io.pdb import write_pdb

    s = alanine_dipeptide_structure()
    pdb = tmp_path / "ala.pdb"
    write_pdb(pdb, s.coordinates(),
              [a.name for r in s.residues for a in r.atoms],
              [a.resname for r in s.residues for a in r.atoms],
              [a.resid for r in s.residues for a in r.atoms])
    out = tmp_path / "seg.npz"
    assert main(["run-segment", str(pdb), "--steps", "200", "--report-interval", "100",
                 "--output", str(out)]) == 0
    assert out.exists()
    with np.load(out) as z:
        assert z["coordinates"].shape[0] == 2


def test_cli_bad_command_exits():
    with pytest.raises(SystemExit):
        main(["definitely-not-a-command"])


# --- the CLI and the facade against the JAX package's --------------------------------------


def test_info_has_jax_keys_and_names_the_devices(capsys):
    import pmarlo_tpu

    info = pmarlo_tpu_torch.get_info()
    assert set(info) == set(pmarlo_tpu.get_info())
    assert info["version"] == pmarlo_tpu.__version__ == get_version()
    if torch.cuda.is_available():
        assert info["backend"] == "cuda"
        assert info["devices"] == [torch.cuda.get_device_name(i)
                                   for i in range(torch.cuda.device_count())]
    else:
        assert info == {"version": pmarlo_tpu.__version__, "backend": "cpu",
                        "devices": ["cpu"]}
    assert main(["info"]) == 0
    assert json.loads(capsys.readouterr().out) == info


def test_cli_arguments_are_jax_arguments():
    """Every subcommand takes JAX's arguments with JAX's defaults."""
    import argparse

    import pmarlo_tpu.main as jax_main
    import pmarlo_tpu_torch.main as port_main

    def parsers(module):
        seen = {}
        real = argparse.ArgumentParser.parse_args

        def grab(self, argv=None, namespace=None):
            seen["parser"] = self
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                module.main([])
        finally:
            argparse.ArgumentParser.parse_args = real
        sub = next(a for a in seen["parser"]._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {name: {a.dest: (a.default, a.type, a.choices) for a in p._actions}
                for name, p in sub.choices.items()}

    assert parsers(port_main) == parsers(jax_main)
    assert set(port_main._EXPORTS) == set(jax_main._EXPORTS)
    for name, (module, attr) in port_main._EXPORTS.items():
        assert module == jax_main._EXPORTS[name][0].replace("pmarlo_tpu", "pmarlo_tpu_torch", 1)
        assert getattr(port_main, name) is not None


def test_dashboard_needs_the_webapp(tmp_path):
    """``dashboard`` imports ``webapp``, which the port does not have yet."""
    with pytest.raises(ModuleNotFoundError):
        main(["dashboard", str(tmp_path), "--export", str(tmp_path / "out.html")])


# --- settings and utilities (tests/unit/test_utils_settings.py) ----------------------------


def test_settings_loader(tmp_path):
    cfg = load_defaults()
    assert cfg["bias_mode"] in ("harmonic_expansion", "metadynamics", "none")
    override = tmp_path / "override.yaml"
    override.write_text("bias_mode: metadynamics\nmd:\n  timestep_ps: 0.001\n")
    cfg2 = load_defaults(override)
    assert cfg2["bias_mode"] == "metadynamics"
    assert cfg2["md"]["timestep_ps"] == 0.001
    assert cfg2["md"]["friction_per_ps"] == 1.0
    bad = tmp_path / "bad.yaml"
    bad.write_text("bias_mode: nonsense\nenable_cv_bias: false\nprecision: float32\n"
                   "device_count: 1\n")
    with pytest.raises(ValueError, match="bias_mode"):
        load_defaults(bad)


def test_settings_equal_jax_settings():
    from pmarlo_tpu.settings import load_defaults as jax_load_defaults
    from pmarlo_tpu.settings import load_feature_spec as jax_load_feature_spec
    from pmarlo_tpu_torch.settings import load_feature_spec

    assert load_defaults() == jax_load_defaults()
    assert load_feature_spec() == jax_load_feature_spec()


def test_deep_merge():
    base = {"a": {"b": 1, "c": 2}, "d": 3}
    out = deep_merge(base, {"a": {"b": 10}, "e": 4})
    assert out == {"a": {"b": 10, "c": 2}, "d": 3, "e": 4}
    assert base["a"]["b"] == 1


def test_misc_helpers():
    from pmarlo_tpu_torch.utils.misc import (
        all_finite,
        any_finite,
        base_shape_str,
        coerce_finite_float,
        coerce_finite_float_with_default,
        concatenate_or_empty,
        permutation_name,
        require,
        slugify,
        timestamp,
    )

    assert base_shape_str((3, 4, 5)) == "3x4x5"
    assert permutation_name((2, 0, 1)) == "2-0-1"
    ts = timestamp()
    assert len(ts) == 15 and ts[8] == "-"
    assert slugify("My Run #3!") == "my_run_3"
    assert slugify("") is None
    assert coerce_finite_float("2.5") == 2.5
    assert coerce_finite_float(float("nan")) is None
    assert coerce_finite_float("abc") is None
    assert coerce_finite_float_with_default(None, default=7.0) == 7.0
    assert all_finite([1.0, 2.0]) and not all_finite([1.0, float("inf")])
    assert any_finite([float("nan"), 3.0])
    with pytest.raises(ValueError):
        require(False, "boom")
    out = concatenate_or_empty([np.ones((2, 3)), np.zeros((1, 3))], dtype=np.float32)
    assert out.shape == (3, 3) and out.dtype == np.float32
    assert concatenate_or_empty([], dtype=np.int64, shape=(0, 4)).shape == (0, 4)
    with pytest.raises(ValueError):
        concatenate_or_empty([], dtype=np.int64)


def test_path_helpers(tmp_path):
    from pmarlo_tpu_torch.utils.path_utils import (
        coerce_path_list,
        ensure_directory,
        relativize,
        resolve_project_path,
        slugify,
    )

    d = ensure_directory(tmp_path / "a" / "b")
    assert d.is_dir()
    assert resolve_project_path("x", base=tmp_path) == tmp_path / "x"
    assert coerce_path_list([d]) == [d.resolve()]
    assert relativize(d, tmp_path) == "a/b"
    assert slugify("  My Run #3!  ") == "my-run-3"


# --- the pipeline and the stage timer (tests/unit/test_workflow_demux.py) -------------------


def test_pipeline_stages_and_resume(tmp_path):
    calls = []
    pipe = Pipeline("test", checkpoint=tmp_path / "ck.json")
    pipe.add("a", lambda ctx: calls.append("a") or {"x": 1})
    pipe.add("b", lambda ctx: calls.append("b") or {"y": ctx["x"] + 1})
    assert pipe.run({})["y"] == 2
    assert calls == ["a", "b"]
    pipe2 = Pipeline("test", checkpoint=tmp_path / "ck.json")
    pipe2.add("a", lambda ctx: calls.append("a2"))
    pipe2.add("b", lambda ctx: calls.append("b2"))
    pipe2.run({})
    assert calls == ["a", "b"]
    assert all(r.status == RunStatus.SKIPPED for r in pipe2.results)


def test_pipeline_failure_recorded(tmp_path):
    pipe = Pipeline("fail", checkpoint=tmp_path / "ck.json")
    pipe.add("boom", lambda ctx: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        pipe.run({})
    assert pipe.results[0].status == RunStatus.FAILED
    assert "ZeroDivisionError" in pipe.results[0].error


def test_pipeline_duplicate_stage():
    pipe = Pipeline("dup")
    pipe.add("s", lambda ctx: None)
    with pytest.raises(ValueError, match="duplicate"):
        pipe.add("s", lambda ctx: None)


def test_stage_timer():
    timer = StageTimer()
    with timer.stage("compute", n_items=10) as box:
        box["out"] = torch.ones((100, 100)).sum()
        box["note"] = "not a tensor"
    summary = timer.summary()
    assert summary[0]["stage"] == "compute"
    assert summary[0]["wall_s"] >= 0
    assert "throughput_per_s" in summary[0]
    assert timer.total() > 0
    stats = device_memory_stats()
    assert isinstance(stats, dict)
    assert len(stats) == (torch.cuda.device_count() if torch.cuda.is_available() else 0)


def test_stage_timer_does_not_swallow_a_failed_synchronisation(monkeypatch):
    from pmarlo_tpu_torch.utils import profiling

    def fail(value):
        raise RuntimeError("device lost")

    monkeypatch.setattr(profiling, "_synchronize", fail)
    timer = StageTimer()
    with pytest.raises(RuntimeError, match="device lost"):
        with timer.stage("x") as box:
            box["out"] = torch.zeros(3)


def test_pipeline_resume_replays_context_and_survives_rerun(tmp_path):
    ckpt = tmp_path / "pipe.json"
    calls = {"a": 0, "b": 0}

    def stage_a(ctx):
        calls["a"] += 1
        return {"x": 41}

    def stage_b(ctx):
        calls["b"] += 1
        if calls["b"] == 1:
            raise RuntimeError("first attempt fails")
        return {"y": ctx["x"] + 1}

    def build():
        return Pipeline("p", checkpoint=ckpt).add("a", stage_a).add("b", stage_b)

    with pytest.raises(RuntimeError):
        build().run({})
    assert build().run({})["y"] == 42
    assert calls["a"] == 1
    ctx = build().run({})
    assert calls["a"] == 1 and calls["b"] == 2
    assert ctx["y"] == 42


def test_pipeline_resume_reruns_lossy_stages(tmp_path):
    ckpt = tmp_path / "pipe.json"
    calls = {"a": 0, "b": 0}

    def stage_a(ctx):
        calls["a"] += 1
        return {"arr": np.arange(4, dtype=np.float32)}

    def stage_b(ctx):
        calls["b"] += 1
        if calls["b"] == 1:
            raise RuntimeError("first attempt fails")
        return {"total": float(ctx["arr"].sum())}

    def build():
        return Pipeline("p", checkpoint=ckpt).add("a", stage_a).add("b", stage_b)

    with pytest.raises(RuntimeError):
        build().run({})
    assert build().run({})["total"] == 6.0
    assert calls["a"] == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` records the block's operators into ``trace.json``."""
    with trace(tmp_path / "prof") as log_dir:
        x = torch.arange(64.0).reshape(8, 8)
        (x @ x).sum()
    data = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert log_dir == str(tmp_path / "prof")
    names = {ev.get("name") for ev in data["traceEvents"]}
    assert any("matmul" in str(n) or "mm" in str(n) for n in names), sorted(map(str, names))[:40]


# --- the deploy worker (tests/unit/test_deploy_visualization.py) ----------------------------


def test_deploy_worker_msm_mode(tmp_path):
    result = deploy_worker.run_mode(2, tmp_path)
    assert result["mode"] == "msm_35_shards"
    assert result["status"] == "completed"
    assert result["counted_pairs"] > 0
    assert json.loads((tmp_path / "mode_2.json").read_text())["mode"] == "msm_35_shards"


def test_deploy_worker_tpt_mode(tmp_path):
    result = deploy_worker.run_mode(5, tmp_path)
    assert result["status"] == "completed"
    assert result["n_conformations"] >= 1


@pytest.mark.slow
def test_deploy_worker_deeptica_mode(tmp_path):
    result = deploy_worker.run_mode(4, tmp_path)
    assert result["status"] == "completed"
    assert np.isfinite(result["best_vamp2"])


def test_deploy_worker_index_wraps(tmp_path):
    result = deploy_worker.run_mode(len(deploy_worker.MODES) + 2, tmp_path)
    assert result["mode"] == deploy_worker.MODES[2][0]


def test_deploy_worker_modes_are_jax_modes(tmp_path):
    """The same modes, and the same MSM count and TPT result as JAX's worker
    (both run numpy from the same seed)."""
    from pmarlo_tpu import deploy_worker as jax_worker

    assert deploy_worker.MODES == jax_worker.MODES
    for index in (2, 5):
        port = deploy_worker.run_mode(index, tmp_path / "port")
        ref = jax_worker.run_mode(index, tmp_path / "jax")
        assert port == ref
