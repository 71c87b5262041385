"""The FM-for-XMC example in the port (pecos_tpu_torch.examples.fm_for_xmc)
against the JAX package's (examples/fm-for-xmc/fm.py), on the CPU.

From JAX's own starting parameters (its jax.random draws) and one seed, both
packages take the same batches and negatives (numpy's default_rng) and the
same AdaGrad steps (optax's: accumulators from 0.1, rsqrt(sum + 1e-7));
only float32 sums differ in order.  Tolerances: trained parameters within
atol 1e-5, held-out scores within atol 1e-4 (scores reach ~15, so that is
~1e-5 relative; measured ~3e-6).  The port's own draws are held to the
example's bars: held-out P@1 > 0.5, SIP scores within 1e-4.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pecos_tpu_torch.examples import fm_for_xmc as tfm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM_ATOL, SCORE_ATOL = 1e-5, 1e-4
# tests/test_fm_example.py's problem and settings
N_VAL = 48
FIT = dict(k=8, epochs=40, lr=0.2, batch_size=128, neg_per_pos=8, seed=0, auto_stop=False)


def _load_jax_fm():
    """examples/fm-for-xmc/fm.py, loaded as tests/test_fm_example.py loads it."""
    spec = importlib.util.spec_from_file_location("fm_example", os.path.join(REPO, "examples", "fm-for-xmc", "fm.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["fm_example"] = mod  # dataclasses resolves cls.__module__
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jfm():
    return _load_jax_fm()


def _jax_init(dq, dp, k, seed):
    """The JAX example's starting parameters (FactorizationMachine.train's draws)."""
    kq, kp = jax.random.split(jax.random.PRNGKey(seed))
    return {
        "wq": np.zeros(dq, np.float32), "wp": np.zeros(dp, np.float32),
        "Vq": np.array(0.1 * jax.random.normal(kq, (dq, k), jnp.float32)),
        "Vp": np.array(0.1 * jax.random.normal(kp, (dp, k), jnp.float32)),
    }


@pytest.mark.parametrize("with_val", [False, True], ids=["train", "train+val"])
def test_fit_from_jax_init_equals_jax(jfm, with_val, capsys):
    """Same starting point, seed and data: the same trained FM; with a
    held-out split also the same per-epoch losses and the same auto-stop epoch."""
    Xq, Y, Xp, _ = jfm.synthetic_pairs(nq=256, npr=128, dq=32, dp=32, seed=1)
    params = dict(FIT, auto_stop=with_val, epochs=40 if not with_val else 60)
    val = dict(Xq_val=Xq[-N_VAL:], Y_val=Y[-N_VAL:]) if with_val else {}
    want = jfm.FactorizationMachine.train(Xq[:-N_VAL], Y[:-N_VAL], Xp, jfm.FMParams(**params), **val)
    jax_log = capsys.readouterr().out
    theta = {n: torch.from_numpy(v) for n, v in _jax_init(32, 32, 8, 0).items()}
    got = tfm.FactorizationMachine.fit(Xq[:-N_VAL], Y[:-N_VAL], Xp, theta, tfm.FMParams(**params), **val)
    port_log = capsys.readouterr().out
    for n in ("wq", "wp", "Vq", "Vp"):
        assert getattr(got, n).dtype == np.float32 and getattr(got, n).shape == getattr(want, n).shape
        np.testing.assert_allclose(getattr(got, n), getattr(want, n), rtol=0, atol=PARAM_ATOL, err_msg=n)
    np.testing.assert_allclose(got.score(Xq[-N_VAL:], Xp), want.score(Xq[-N_VAL:], Xp), rtol=0, atol=SCORE_ATOL)
    assert len(port_log.splitlines()) == len(jax_log.splitlines())  # the same epochs, the same stop
    if with_val:
        losses = lambda log: [float(w.split("=")[1]) for w in log.split() if w.startswith("val_loss=")]
        np.testing.assert_allclose(losses(port_log), losses(jax_log), rtol=1e-4)


def test_ports_own_train_learns_cross_terms(jfm, tmp_path):
    """tests/test_fm_example.py's bars on the port's own draws: held-out P@1
    > 0.5, SIP scores equal to the FM's within 1e-4; the folder round trip."""
    Xq, Y, Xp, _ = tfm.synthetic_pairs(nq=256, npr=128, dq=32, dp=32, seed=1)
    model = tfm.FactorizationMachine.train(Xq[:-N_VAL], Y[:-N_VAL], Xp, tfm.FMParams(**FIT), device="cpu")
    S = model.score(Xq[-N_VAL:], Xp)
    truth = np.asarray(Y[-N_VAL:].todense())
    p1 = float(np.mean(truth[np.arange(N_VAL), S.argmax(axis=1)] > 0))
    assert p1 > 0.5, f"FM held-out P@1={p1}"
    Eq, Ep = model.to_sip_embeddings(Xq[-N_VAL:], Xp)
    np.testing.assert_allclose(Eq @ Ep.T, S, rtol=1e-4, atol=1e-4)
    model.save(str(tmp_path / "fm"))
    np.testing.assert_allclose(tfm.FactorizationMachine.load(str(tmp_path / "fm")).score(Xq[-N_VAL:], Xp), S, rtol=1e-6)
    # the synthetic problem is the JAX example's, draw for draw
    jXq, jY, jXp, jS = jfm.synthetic_pairs(nq=256, npr=128, dq=32, dp=32, seed=1)
    assert (Xq != jXq).nnz == 0 and (Y != jY).nnz == 0 and (Xp != jXp).nnz == 0


def test_folders_load_both_ways(jfm, tmp_path):
    Xq, Y, Xp, _ = jfm.synthetic_pairs(nq=128, npr=64, dq=16, dp=16, seed=2)
    fit = dict(FIT, epochs=5)
    jm = jfm.FactorizationMachine.train(Xq[:-16], Y[:-16], Xp, jfm.FMParams(**fit))
    jm.save(str(tmp_path / "jax"))
    port = tfm.FactorizationMachine.load(str(tmp_path / "jax"))
    assert port.params == tfm.FMParams(**fit)
    np.testing.assert_array_equal(port.score(Xq, Xp), jm.score(Xq, Xp))
    tm = tfm.FactorizationMachine.train(Xq[:-16], Y[:-16], Xp, tfm.FMParams(**fit), device="cpu")
    tm.save(str(tmp_path / "port"))
    back = jfm.FactorizationMachine.load(str(tmp_path / "port"))
    assert back.params == jfm.FMParams(**fit)
    np.testing.assert_array_equal(back.score(Xq, Xp), tm.score(Xq, Xp))
    np.testing.assert_array_equal(*(m.to_sip_embeddings(Xq, Xp)[1] for m in (back, tm)))


def test_init_params():
    """The port's draws: zero linear weights, factors ~0.1 x N(0, 1), one seed one draw;
    the card is asked for unless the caller names the CPU."""
    p = tfm.FMParams(k=6, seed=3)
    a, b = (tfm.FactorizationMachine.init_params(40, 30, p, device="cpu") for _ in range(2))
    assert a["wq"].shape == (40,) and a["wp"].shape == (30,) and a["Vq"].shape == (40, 6) and a["Vp"].shape == (30, 6)
    assert not a["wq"].any() and not a["wp"].any()
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert 0.05 < float(torch.cat([a["Vq"].ravel(), a["Vp"].ravel()]).std()) < 0.15
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tfm.FactorizationMachine.init_params(4, 4, p)


def test_demo_cli(tmp_path, capsys):
    """python -m pecos_tpu_torch.examples.fm_for_xmc --demo --device cpu: the
    JAX example's demo settings, its bars, and a folder the JAX example loads."""
    folder = str(tmp_path / "fm")
    tfm.main(["--demo", "--device", "cpu", "--model", folder])
    out = capsys.readouterr().out
    p1 = float(out.split("held-out P@1 = ")[1].split()[0])
    sip = float(out.split("SIP embedding max |error| = ")[1].split()[0])
    assert p1 > 0.5 and sip <= 1e-4, out
    assert "epoch 1/30" in out and f"model saved to {folder}" in out
    model = _load_jax_fm().FactorizationMachine.load(folder)
    assert model.Vq.shape == (64, 8)
