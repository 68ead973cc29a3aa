"""``pmarlo_tpu_torch.ml`` against ``pmarlo_tpu.ml``: the MLP, the VAMP-2
loss and its gradient, the learning-rate schedule, a few epochs of
``train_deeptica`` from the same initial weights, and the shared file
format. Inputs are made with numpy from a seed; both packages run float32
on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pmarlo_tpu.ml.deeptica as JD
import pmarlo_tpu.ml.losses as JL
import pmarlo_tpu_torch.ml.deeptica as TD
import pmarlo_tpu_torch.ml.losses as TL
from pmarlo_tpu_torch import _device


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np_params(rng, sizes):
    return [{"w": rng.normal(0.0, np.sqrt(2.0 / (a + b)), (a, b)).astype(np.float32),
             "b": rng.normal(0.0, 0.1, b).astype(np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _t(params):
    return [{k: torch.as_tensor(v) for k, v in layer.items()} for layer in params]


def _j(params):
    return [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]


def _slow_features(seed=0, T=600, K=6):
    """Two slow Ornstein-Uhlenbeck modes mixed into K noisy features."""
    rng = np.random.default_rng(seed)
    s = np.zeros((T, 2))
    for t in range(1, T):
        s[t] = 0.97 * s[t - 1] + 0.25 * rng.standard_normal(2)
    mix = rng.normal(0.0, 1.0, (2, K))
    return (s @ mix + 0.3 * rng.standard_normal((T, K))).astype(np.float32)


# --- MLP -----------------------------------------------------------------------------

@pytest.mark.parametrize("activation", ["tanh", "gelu", "relu", "elu"])
@pytest.mark.parametrize("layernorm", [False, True], ids=["plain", "layernorm"])
def test_mlp_apply_matches_jax(activation, layernorm):
    """1e-5: the same float32 products and activations (gelu in its tanh
    form in both; layernorm with eps 1e-6 inside the sqrt)."""
    rng = np.random.default_rng(1)
    params = _np_params(rng, [7, 8, 8, 2])
    x = rng.normal(0.0, 1.0, (33, 7)).astype(np.float32)
    got = TD.mlp_apply(_t(params), torch.as_tensor(x), activation, layernorm).numpy()
    want = np.asarray(JD.mlp_apply(_j(params), jnp.asarray(x), activation, layernorm))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_mlp_module_stores_weights_in_by_out():
    rng = np.random.default_rng(2)
    params = _np_params(rng, [5, 8, 3])
    net = TD.MLP(_t(params))
    assert [tuple(w.shape) for w in net.w] == [(5, 8), (8, 3)]
    x = torch.as_tensor(rng.normal(size=(4, 5)).astype(np.float32))
    torch.testing.assert_close(net(x), TD.mlp_apply(_t(params), x))
    assert sum(p.numel() for p in net.parameters()) == 5 * 8 + 8 + 8 * 3 + 3


def test_init_mlp_params_scale_and_zero_bias():
    gen = torch.Generator().manual_seed(0)
    params = TD.init_mlp_params(gen, 200, (300,), 100)
    for layer, (a, b) in zip(params, [(200, 300), (300, 100)]):
        assert tuple(layer["w"].shape) == (a, b)
        assert float(layer["b"].abs().max()) == 0.0
        want = np.sqrt(2.0 / (a + b))
        assert abs(float(layer["w"].std()) / want - 1.0) < 0.03


@pytest.mark.parametrize("whiten", [False, True], ids=["raw", "whitened"])
def test_as_function_and_transform_match_jax(whiten):
    rng = np.random.default_rng(3)
    params = _np_params(rng, [6, 8, 2])
    mean = rng.normal(0.0, 0.5, 6).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    whitening = None
    if whiten:
        whitening = {"mean": rng.normal(0.0, 0.2, 2).astype(np.float32),
                     "transform": rng.normal(0.0, 1.0, (2, 2)).astype(np.float32)}
    cfg = dict(hidden=(8,), n_out=2)
    tm = TD.deeptica_from_numpy(TD.DeepTICAConfig(**cfg), params, mean, scale, whitening)
    jm = JD.DeepTICAModel(config=JD.DeepTICAConfig(**cfg), params=_j(params),
                          scaler_mean=mean, scaler_scale=scale, whitening=whitening)
    X = rng.normal(0.0, 1.0, (50, 6)).astype(np.float32)
    np.testing.assert_allclose(tm.transform(X), np.asarray(jm.transform(X)), atol=1e-5)
    got = tm.as_function()(torch.as_tensor(X[:3])).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.as_function()(jnp.asarray(X[:3]))), atol=1e-5)
    # differentiable in its input
    x = torch.as_tensor(X[:3]).requires_grad_(True)
    tm.as_function()(x).sum().backward()
    g = jax.grad(lambda a: jm.as_function()(a).sum())(jnp.asarray(X[:3]))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), atol=1e-5)


# --- VAMP-2 ---------------------------------------------------------------------------

def _batch(seed=4, n=256, k=3):
    rng = np.random.default_rng(seed)
    z0 = rng.normal(0.0, 1.0, (n, k)).astype(np.float32)
    zt = (0.7 * z0 + 0.5 * rng.normal(0.0, 1.0, (n, k))).astype(np.float32)
    return z0, zt


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_covariances_match_jax(weighted):
    z0, zt = _batch()
    w = np.random.default_rng(5).uniform(0.5, 2.0, len(z0)).astype(np.float32) if weighted else None
    got = TL._covariances(torch.as_tensor(z0), torch.as_tensor(zt),
                          None if w is None else torch.as_tensor(w))
    want = JL._covariances(jnp.asarray(z0), jnp.asarray(zt),
                           None if w is None else jnp.asarray(w))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("seed,k", [(4, 3), (6, 2), (7, 5)])
def test_vamp2_loss_matches_jax_on_a_fixed_batch(seed, k):
    """The loss and every metric within 1e-5 relative (1e-5 absolute for
    the loss: scores are of order 1)."""
    z0, zt = _batch(seed, 256, k)
    tl, tm = TL.vamp2_loss(torch.as_tensor(z0), torch.as_tensor(zt), ridge=1e-4, alpha=0.05)
    jl, jm = JL.vamp2_loss(jnp.asarray(z0), jnp.asarray(zt), ridge=1e-4, alpha=0.05)
    assert abs(float(tl) - float(jl)) <= 1e-5
    assert sorted(tm) == sorted(jm)
    for key in tm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=2e-5, err_msg=key)
    assert abs(TL.vamp2_score_features(z0, zt) - JL.vamp2_score_features(z0, zt)) <= 1e-5


def test_vamp2_loss_gradient_matches_jax():
    """d loss / d z0 and d zt through the Cholesky and the triangular
    solves: 1e-4 of the largest gradient entry."""
    z0, zt = _batch(8, 128, 3)
    a = torch.as_tensor(z0).requires_grad_(True)
    b = torch.as_tensor(zt).requires_grad_(True)
    TL.vamp2_loss(a, b)[0].backward()
    g0, gt = jax.grad(lambda p, q: JL.vamp2_loss(p, q)[0], argnums=(0, 1))(
        jnp.asarray(z0), jnp.asarray(zt))
    scale = float(np.abs(np.asarray(g0)).max())
    assert np.abs(a.grad.numpy() - np.asarray(g0)).max() <= 1e-4 * scale
    assert np.abs(b.grad.numpy() - np.asarray(gt)).max() <= 1e-4 * scale


def test_vamp2_cond_penalty_matches_jax():
    z0, zt = _batch(9, 200, 3)
    tl, _ = TL.vamp2_loss(torch.as_tensor(z0), torch.as_tensor(zt), cond_penalty=0.1)
    jl, _ = JL.vamp2_loss(jnp.asarray(z0), jnp.asarray(zt), cond_penalty=0.1)
    assert abs(float(tl) - float(jl)) <= 1e-5


def test_stable_cholesky_climbs_the_jitter_ladder():
    """A singular covariance fails at jitter 0 and factors at the first
    rung that makes it positive definite, as the JAX ladder selects."""
    v = np.asarray([[1.0, 2.0, 3.0]], np.float32)
    C = (v.T @ v).astype(np.float32)                      # rank 1
    L = TL._stable_cholesky(torch.as_tensor(C))
    assert bool(torch.isfinite(L).all())
    JLc = np.asarray(JL._stable_cholesky(jnp.asarray(C)))
    assert np.isfinite(JLc).all()
    tr = np.trace(C) / 3
    # both reproduce C up to the ladder's largest jitter
    for F in (L.numpy(), JLc):
        assert np.abs(F @ F.T - C).max() <= 1.1e-2 * tr
    good = np.eye(3, dtype=np.float32) * 2.0
    torch.testing.assert_close(TL._stable_cholesky(torch.as_tensor(good)),
                               torch.linalg.cholesky(torch.as_tensor(good)))


# --- the schedule and the optimizer -------------------------------------------------------

@pytest.mark.parametrize("warmup,decay", [(10, 200), (0, 50), (25, 26)])
def test_lr_schedule_equals_optax_step_by_step(warmup, decay):
    kw = dict(init_value=1e-5, peak_value=1e-3, warmup_steps=warmup,
              decay_steps=decay, end_value=1e-5)
    sched = optax.warmup_cosine_decay_schedule(**kw)
    for step in range(decay + 20):
        assert TD.warmup_cosine_lr(step, **kw) == pytest.approx(float(sched(step)), rel=1e-5), step


def test_adamw_step_matches_optax_chain():
    """Five clipped AdamW steps on a fixed quadratic: torch's decoupled
    decay ``p (1 - lr wd) - lr u`` is optax's ``p - lr (u + wd p)``."""
    rng = np.random.default_rng(10)
    p0 = rng.normal(0.0, 1.0, (4, 3)).astype(np.float32)
    target = rng.normal(0.0, 1.0, (4, 3)).astype(np.float32)
    lr, wd, clip = 1e-2, 1e-2, 0.5
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.adamw(lr, weight_decay=wd))
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.as_tensor(p0.copy()))
    opt = torch.optim.AdamW([tp], lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    for _ in range(5):
        g = jax.grad(lambda q: 10.0 * ((q - target) ** 2).sum())(jp)
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        (10.0 * ((tp - torch.as_tensor(target)) ** 2).sum()).backward()
        torch.nn.utils.clip_grad_norm_([tp], clip)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-6)


# --- training ------------------------------------------------------------------------------

def _train_both(monkeypatch, X, cfg_kw, sizes):
    init = _np_params(np.random.default_rng(11), sizes)
    for layer in init:
        layer["b"][:] = 0.0
    monkeypatch.setattr(JD, "init_mlp_params", lambda key, n_in, hidden, n_out: _j(init))
    monkeypatch.setattr(TD, "init_mlp_params", lambda gen, n_in, hidden, n_out: _t(init))
    jm = JD.train_deeptica(X, JD.DeepTICAConfig(**cfg_kw))
    tm = TD.train_deeptica(X, TD.DeepTICAConfig(**cfg_kw), device="cpu")
    return jm, tm


def test_train_deeptica_matches_jax_from_the_same_weights(monkeypatch):
    """Four epochs from injected initial weights: the batches are the same
    (numpy permutations from config.seed), so the parameters stay within
    1e-3, the per-epoch records agree and so do the scaler, the whitening
    and the before/after scores."""
    X = _slow_features()
    cfg_kw = dict(lag=3, n_out=2, hidden=(8,), max_epochs=4, batch_size=64,
                  early_stopping_patience=4, warmup_epochs=1, seed=3)
    jm, tm = _train_both(monkeypatch, X, cfg_kw, [X.shape[1], 8, 2])
    for jl, tl in zip(jm.params, tm.params):
        np.testing.assert_allclose(tl["w"].numpy(), np.asarray(jl["w"]), atol=1e-3)
    for jl, tl in zip(jm.params[:-1], tm.params[:-1]):
        np.testing.assert_allclose(tl["b"].numpy(), np.asarray(jl["b"]), atol=1e-3)
    # the loss is mean-centred, so the output bias has no gradient but
    # rounding noise, which Adam's normalisation turns into steps of up to
    # the learning rate: it is bounded by lr x steps in both packages, not
    # pinned to 1e-3
    n_steps = 4 * len(tm.training_history["epochs"]) * 8
    for model_b in (tm.params[-1]["b"].numpy(), np.asarray(jm.params[-1]["b"])):
        assert np.abs(model_b).max() <= 1e-3 * n_steps
    np.testing.assert_allclose(tm.scaler_mean, jm.scaler_mean, atol=1e-6)
    np.testing.assert_allclose(tm.scaler_scale, jm.scaler_scale, atol=1e-6)
    jh, th = jm.training_history, tm.training_history
    assert len(th["epochs"]) == len(jh["epochs"]) == 4
    assert th["tau_schedule"] == jh["tau_schedule"] and th["val_tau"] == jh["val_tau"]
    for je, te in zip(jh["epochs"], th["epochs"]):
        assert (te["tau"], te["epoch"]) == (je["tau"], je["epoch"])
        assert te["train_loss"] == pytest.approx(je["train_loss"], abs=2e-3)
        assert te["val_vamp2"] == pytest.approx(je["val_vamp2"], abs=2e-3)
        assert te["grad_norm"] == pytest.approx(je["grad_norm"], rel=2e-2, abs=1e-3)
    assert th["best"]["epoch"] == jh["best"]["epoch"]
    assert th["vamp2_before"] == pytest.approx(jh["vamp2_before"], abs=1e-4)
    assert th["vamp2_after"] == pytest.approx(jh["vamp2_after"], abs=5e-3)
    np.testing.assert_allclose(tm.transform(X[:40]), jm.transform(X[:40]), atol=2e-2)


def test_train_deeptica_learns_the_slow_modes():
    X = _slow_features(seed=1, T=900)
    cfg = TD.DeepTICAConfig(lag=5, n_out=2, hidden=(16,), max_epochs=30, batch_size=128,
                            early_stopping_patience=30, seed=0)
    model = TD.train_deeptica([X[:450], X[450:]], cfg, device="cpu")
    hist = model.training_history
    assert hist["epochs"][-1]["val_vamp2"] > hist["epochs"][0]["val_vamp2"]
    assert 0.5 < hist["vamp2_after"] <= 2.0 + 1e-3
    assert model.whitening is not None and model.whitening["transform"].shape == (2, 2)
    Y = model.transform(X)
    np.testing.assert_allclose(Y.mean(0), 0.0, atol=0.05)
    assert model.device.type == "cpu"


def test_train_deeptica_accepts_tensors_and_refuses_bad_shapes():
    X = _slow_features(T=300)
    cfg = TD.DeepTICAConfig(lag=2, hidden=(4,), max_epochs=1, batch_size=32,
                            early_stopping_patience=1)
    model = TD.train_deeptica(torch.as_tensor(X), cfg, device="cpu")
    assert len(model.training_history["epochs"]) == 1
    with pytest.raises(ValueError, match=r"\(T, K\)"):
        TD.train_deeptica(X[None], cfg, device="cpu")
    with pytest.raises(ValueError, match="too few training pairs"):
        TD.train_deeptica(X[:12], dataclasses.replace(cfg, batch_size=1024), device="cpu")


def test_config_validation_and_preset_match_jax():
    assert dataclasses.asdict(TD.DeepTICAConfig()) == dataclasses.asdict(JD.DeepTICAConfig())
    assert (dataclasses.asdict(TD.DeepTICAConfig.small_data())
            == dataclasses.asdict(JD.DeepTICAConfig.small_data()))
    for kw in (dict(lag=0), dict(n_out=0), dict(val_fraction=0.95), dict(activation="swish")):
        with pytest.raises(ValueError):
            TD.DeepTICAConfig(**kw)


# --- one file format ---------------------------------------------------------------------

def test_models_saved_by_either_package_load_in_the_other(tmp_path, monkeypatch):
    X = _slow_features(T=300)
    cfg_kw = dict(lag=2, n_out=2, hidden=(8,), max_epochs=2, batch_size=64,
                  early_stopping_patience=2, seed=5)
    jm, tm = _train_both(monkeypatch, X, cfg_kw, [X.shape[1], 8, 2])
    tm.save(tmp_path / "from_torch")
    jm.save(tmp_path / "from_jax")
    j_of_t = JD.DeepTICAModel.load(tmp_path / "from_torch")
    t_of_j = TD.DeepTICAModel.load(tmp_path / "from_jax")
    np.testing.assert_allclose(np.asarray(j_of_t.transform(X[:20])), tm.transform(X[:20]),
                               atol=1e-5)
    np.testing.assert_allclose(t_of_j.transform(X[:20]), np.asarray(jm.transform(X[:20])),
                               atol=1e-5)
    assert t_of_j.config == TD.DeepTICAConfig(**cfg_kw)
    assert t_of_j.training_history["best"]["epoch"] == jm.training_history["best"]["epoch"]
    assert j_of_t.whitening is not None


def test_deeptica_from_numpy_takes_a_jax_models_arrays():
    rng = np.random.default_rng(12)
    params = _np_params(rng, [4, 8, 2])
    cfg_d = dataclasses.asdict(JD.DeepTICAConfig(hidden=(8,)))
    cfg_d["hidden"] = list(cfg_d["hidden"])
    cfg_d["tau_schedule"] = list(cfg_d["tau_schedule"])
    model = TD.deeptica_from_numpy(cfg_d, _j(params), np.zeros(4), np.ones(4))
    assert model.config.hidden == (8,)
    assert tuple(model.params[0]["w"].shape) == (4, 8)
    assert model.params[0]["w"].dtype == torch.float32


# --- the default device -----------------------------------------------------------------

def test_train_deeptica_default_device_is_default_device(monkeypatch):
    """``device=None`` resolves through ``_device.default_device()``: the
    card when there is one."""
    calls = []

    def fake_default():
        calls.append(1)
        return torch.device("cpu")

    monkeypatch.setattr(TD, "default_device", fake_default)
    X = _slow_features(T=200)
    cfg = TD.DeepTICAConfig(lag=2, hidden=(4,), max_epochs=1, batch_size=32,
                            early_stopping_patience=1)
    TD.train_deeptica(X, cfg)
    assert calls
    calls.clear()
    TD.train_deeptica(X, cfg, device="cpu")
    assert not calls
    assert _device.default_device().type == ("cuda" if torch.cuda.is_available() else "cpu")
