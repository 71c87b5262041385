"""The port's ZeRO-1 analog and distributed fine-tune on an 8-device CPU mesh
(the CPU eight times, as the JAX tests' virtual devices).

- shard_opt_state: AdamW split over the mesh gives the updates of one AdamW
  over the whole parameters, bit for bit on the CPU (the update is
  elementwise), within 1e-6 of optax's adamw on the JAX package's
  tests/test_distributed.py problem, and each slot holds about 1/8 of the
  moment bytes.
- dist_fine_tune: four steps (dropout 0) over 8 replicas equal the
  single-device train within atol 1e-5 (the split batch sums the gradients
  in another order), and it meets tests/test_xtransformer.py's bar (> 0.7).
"""

import os

import numpy as np
import pytest
import scipy.sparse as smat
import torch

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

from pecos_tpu_torch.distributed.xmc.xtransformer import dist_fine_tune  # noqa: E402
from pecos_tpu_torch.parallel.mesh import make_mesh, shard_opt_state  # noqa: E402
from pecos_tpu_torch.xmc.xtransformer import MLProblemWithText, TransformerMatcher  # noqa: E402

MESH_ATOL = 1e-5


def _problem():
    rng = np.random.default_rng(0)
    params = {"W": rng.standard_normal((64, 32)).astype(np.float32), "b": rng.standard_normal((32,)).astype(np.float32),
              "odd": rng.standard_normal((3, 5)).astype(np.float32)}
    X = rng.standard_normal((16, 64)).astype(np.float32)
    Y = rng.standard_normal((16, 32)).astype(np.float32)
    return params, X, Y


def _torch_run(params, X, Y, mesh=None, steps=3):
    ps = [torch.tensor(v, requires_grad=True) for v in params.values()]
    opt = torch.optim.AdamW(ps, lr=1e-2, weight_decay=0.01)
    if mesh is not None:
        opt, n = shard_opt_state(opt, mesh)
        assert n == 2  # W (64 % 8) and b (32 % 8); "odd" stays whole on slot 0
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    for _ in range(steps):
        loss = torch.mean((Xt @ ps[0] + ps[1] - Yt) ** 2) + ps[2].square().sum()
        loss.backward()
        opt.step()
        opt.zero_grad()
    return [p.detach().numpy() for p in ps], opt


def test_shard_opt_state_equals_replicated():
    params, X, Y = _problem()
    mesh = make_mesh(8, devices=["cpu"] * 8)
    want, opt = _torch_run(params, X, Y)
    got, zopt = _torch_run(params, X, Y, mesh)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    per_slot = zopt.moment_bytes()
    total = sum(v.numel() * v.element_size() for st in opt.state.values() for v in st.values() if v.dim() > 0)
    assert sum(per_slot) == total
    moments_W_b = 2 * 4 * (64 * 32 + 32)
    assert per_slot[1:] == [moments_W_b // 8] * 7  # each slot 1/8 of the split moments
    assert per_slot[0] == moments_W_b // 8 + 2 * 4 * 15


def test_shard_opt_state_matches_optax():
    """The JAX package's ZeRO test problem, replicated optax adamw (jit on the
    CPU) against the port's sharded AdamW: equal within 1e-6."""
    import jax
    import jax.numpy as jnp
    import optax

    params, X, Y = _problem()
    params = {k: params[k] for k in ("W", "b")}
    tx = optax.adamw(1e-2, weight_decay=0.01)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    s = tx.init(p)
    loss_fn = lambda q: jnp.mean((jnp.asarray(X) @ q["W"] + q["b"] - jnp.asarray(Y)) ** 2)
    for _ in range(3):
        up, s = tx.update(jax.grad(loss_fn)(p), s, p)
        p = optax.apply_updates(p, up)
    ps = [torch.tensor(v, requires_grad=True) for v in params.values()]
    opt, _ = shard_opt_state(torch.optim.AdamW(ps, lr=1e-2, weight_decay=0.01), make_mesh(8, devices=["cpu"] * 8))
    for _ in range(3):
        torch.mean((torch.from_numpy(X) @ ps[0] + ps[1] - torch.from_numpy(Y)) ** 2).backward()
        opt.step()
        opt.zero_grad()
    for t, k in zip(ps, ("W", "b")):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(p[k]), atol=1e-6)
    with pytest.raises(ValueError, match="not stepped"):
        shard_opt_state(opt.inner[0], make_mesh(2, devices=["cpu"] * 2))


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    d = tmp_path_factory.mktemp("tdist")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"tok{i}" for i in range(24)]
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n")
    corpus = [f"tok{i % 8} tok{i % 8 + 8} tok{i % 8 + 16}" for i in range(64)]
    Y = smat.csr_matrix((np.ones(64, np.float32), (np.arange(64), np.arange(64) % 8)), shape=(64, 8))
    mc = dict(vocab_size=len(vocab), dim=32, n_layers=1, n_heads=2, hidden_dim=64, max_position_embeddings=64,
              vocab_file=str(d / "vocab.txt"))
    return corpus, Y, mc


def _tp(mc, **kw):
    return dict(dict(model_type="distilbert", model_config=mc, truncate_length=16, batch_size=16, learning_rate=2e-3,
                     max_active_matching_labels=8, seed=0), **kw)


def test_dist_fine_tune_equals_single_device(toy):
    corpus, Y, mc = toy
    mc0 = dict(mc, dropout=0.0, attention_dropout=0.0)
    prob = MLProblemWithText(corpus, Y)
    tp = _tp(mc0, max_steps=4, gradient_accumulation_steps=2, warmup_steps=1)
    one, _, _ = TransformerMatcher.train(prob, train_params=tp, device="cpu")
    dist, _, emb = dist_fine_tune(prob, train_params=tp, n_devices=8, device="cpu")
    assert emb.shape == (64, 32)
    np.testing.assert_allclose(dist.train_losses, one.train_losses, rtol=1e-5)
    sd1, sd8 = one.encoder.state_dict(), dist.encoder.state_dict()
    moved = max(float((a - b).abs().max()) for a, b in zip(sd1.values(), TransformerMatcher.download_model(
        TransformerMatcher.TrainParams(**tp))[0].state_dict().values()))
    assert moved > 100 * MESH_ATOL
    for k in sd1:
        np.testing.assert_allclose(sd8[k].numpy(), sd1[k].numpy(), atol=MESH_ATOL, err_msg=k)
    np.testing.assert_allclose(dist.head.W, one.head.W, atol=MESH_ATOL)


def test_dist_fine_tune_quality(toy):
    corpus, Y, mc = toy
    matcher, trn_pred, _ = dist_fine_tune(MLProblemWithText(corpus, Y), train_params=_tp(mc, num_train_epochs=8),
                                          n_devices=8, device="cpu")
    top1 = np.asarray(trn_pred.argmax(axis=1)).ravel()
    assert (top1 == np.arange(64) % 8).mean() > 0.7
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            dist_fine_tune(MLProblemWithText(corpus, Y), train_params=_tp(mc, max_steps=1))
