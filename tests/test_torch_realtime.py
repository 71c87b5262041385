"""RealtimeSession: the port's session against its batch predict and against
the JAX package's session.

Labels must be equal.  Scores agree to rtol=1e-5, atol=1e-7: a session batch
and a predict batch differ in row count, and the dense layer's matmul may sum
in another order for another row count; the JAX package sums in another order.
"""

import numpy as np
import pytest
import scipy.sparse as smat

from pecos_tpu_torch.xmc.inference import WIRE_VALUE_DTYPES
from test_torch_inference import _models, assert_same_predictions

KW = dict(beam_size=3, only_topk=10)


@pytest.fixture(scope="module")
def models():
    jm, tm, X, _ = _models("scatter")
    return jm, tm, X[:12]


@pytest.mark.parametrize("batch", [1, 4])
def test_session_rows_equal_batch_predict(models, batch):
    _, tm, X = models
    want = tm.predict(X, **KW)
    sess = tm.realtime_session(batch=batch, cap=32, **KW)
    got = smat.vstack([sess.predict(X[s : s + batch]) for s in range(0, X.shape[0], batch)]).tocsr()
    assert_same_predictions(want, got)
    # a short batch: fewer rows than the session's batch, padded on the wire
    assert_same_predictions(want[:1], sess.predict(X[:1]))


@pytest.mark.parametrize("batch", [1, 4])
def test_session_matches_jax_session(models, batch):
    jm, tm, X = models
    jsess = jm.realtime_session(batch=batch, cap=32, **KW)
    sess = tm.realtime_session(batch=batch, cap=32, **KW)
    for s in range(0, 8, batch):
        assert_same_predictions(jsess.predict(X[s : s + batch]), sess.predict(X[s : s + batch]))


@pytest.mark.parametrize("dt", WIRE_VALUE_DTYPES)
def test_session_wire_dtypes_match_predict(models, dt):
    """The session's one wire buffer gives the batch predict's result on the
    same wire dtype, and the JAX session's."""
    jm, tm, X = models
    sess = tm.realtime_session(batch=4, cap=32, wire_value_dtype=dt, **KW)
    assert_same_predictions(tm.predict(X[:4], wire_value_dtype=dt, **KW), sess.predict(X[:4]))
    jsess = jm.realtime_session(batch=4, cap=32, wire_value_dtype=dt, **KW)
    assert_same_predictions(jsess.predict(X[:4]), sess.predict(X[:4]))


def test_dense_rows_and_vector(models):
    _, tm, X = models
    sess = tm.realtime_session(batch=2, cap=32, **KW)
    want = sess.predict(X[:2])
    assert_same_predictions(want, sess.predict(np.asarray(X[:2].todense())))
    assert_same_predictions(want[:1], sess.predict(np.asarray(X[0].todense()).ravel()))


def test_session_errors(models):
    _, tm, X = models
    sess = tm.realtime_session(batch=1, cap=32)
    with pytest.raises(ValueError, match="session batch is 1, got 2 rows"):
        sess.predict(X[:2])
    with pytest.raises(ValueError, match="Feature dimension"):
        sess.predict(smat.csr_matrix((1, X.shape[1] + 3), dtype=np.float32))
    wide = smat.csr_matrix(np.ones((1, X.shape[1]), np.float32))  # 128 nonzeros > cap 32
    with pytest.raises(ValueError, match="session cap"):
        sess.predict(wide)
    with pytest.raises(ValueError, match="cap must be even"):
        tm.realtime_session(batch=1, cap=33, wire_value_dtype="uint8")
    with pytest.raises(ValueError, match="unknown wire_value_dtype"):
        tm.realtime_session(wire_value_dtype="float64")
    with pytest.raises(ValueError, match="unknown post_processor"):
        tm.realtime_session(post_processor="nope")
    with pytest.raises(ValueError, match="batch and cap"):
        tm.realtime_session(batch=0)


def test_on_device_latency(models):
    _, tm, X = models
    sess = tm.realtime_session(batch=4, cap=32, **KW)
    for arg in (None, X[:4], X):  # random queries, the session batch, more rows than it
        ms = sess.on_device_latency_ms(arg, iters=3)
        assert isinstance(ms, float) and ms > 0.0
    # F4: a query wider than the session cap raises instead of being cut
    with pytest.raises(ValueError, match="session cap"):
        sess.on_device_latency_ms(smat.csr_matrix(np.ones((1, X.shape[1]), np.float32)), iters=2)
    with pytest.raises(ValueError, match="iters"):
        sess.on_device_latency_ms(iters=0)
