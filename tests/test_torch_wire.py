"""The uint16 query wire: the port's codec against the JAX package's.

Buffers, packed ids and decoded ids/values must be equal bit for bit (integer
and float bits compared exactly) for all four value dtypes, at D on both
sides of 2**16, at D = 262,144 (the Wiki-500K geometry) and near 2**31, with
pad rows (ids D+1, values 0) and all-zero value rows.  ``predict`` on each
wire dtype returns the JAX package's labels; scores agree to rtol=1e-5
(float32 sums in another order), atol=1e-7 for path values near zero.
"""

import warnings

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pecos_tpu.xmc import inference as jax_inf
from pecos_tpu_torch.xmc.inference import (
    WIRE_VALUE_DTYPES,
    decode_wire_batch,
    encode_wire_batch,
    pack_query_ids,
    unpack_query_ids,
)
from test_torch_inference import _models, assert_same_predictions

# D + 1 < 2**16 (no hi words), = 2**16, the Wiki-500K D, and near 2**31
DS = [1000, 65535, 262_144, 2**31 - 3]


def _batch(D, cap, seed=0):
    """(ids, vals) of 8 rows: random ids in [0, D] (D is the bias column) with
    values of mixed magnitude; row 5 is all pad, row 6 has zero values, row 7
    is half pad."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, D + 1, size=(8, cap)).astype(np.int32)
    vals = (rng.standard_normal((8, cap)) * 10.0 ** rng.integers(-3, 3, size=(8, 1))).astype(np.float32)
    ids[5], vals[5] = D + 1, 0.0
    vals[6] = 0.0
    ids[7, cap // 2 :], vals[7, cap // 2 :] = D + 1, 0.0
    return ids, vals


def _jax_encode(ids, vals, D, dt):
    # the JAX encoder divides 0/0 on all-zero rows of the uint8 wire (it
    # writes q = 0 there, as the port does without dividing)
    with warnings.catch_warnings(), np.errstate(divide="ignore", invalid="ignore"):
        warnings.simplefilter("ignore", RuntimeWarning)
        return jax_inf.encode_wire_batch(ids, vals, D, dt)


def _port_decode(buf, D, cap, dt):
    ids, vals = decode_wire_batch(torch.from_numpy(buf.view(np.int16)), D, cap, dt)
    assert ids.dtype == torch.int32 and vals.dtype == torch.float32
    return ids.numpy(), vals.numpy()


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("cap", [24, 13])
def test_pack_unpack_ids_match_jax(D, cap):
    ids, _ = _batch(D, cap)
    lo, hi = pack_query_ids(ids, D)
    jlo, jhi = jax_inf.pack_query_ids(ids, D)
    assert lo.dtype == np.uint16 and hi.dtype == np.uint32
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    got = unpack_query_ids(torch.from_numpy(lo.astype(np.int32)), torch.from_numpy(hi.view(np.int32)), D, cap)
    np.testing.assert_array_equal(got.numpy(), ids)


@pytest.mark.parametrize("dt", WIRE_VALUE_DTYPES)
@pytest.mark.parametrize("D", DS)
def test_encode_decode_match_jax_bit_for_bit(D, dt):
    cap = 24
    ids, vals = _batch(D, cap, seed=D % 97)
    buf = encode_wire_batch(ids, vals, D, dt)
    assert buf.dtype == np.uint16
    np.testing.assert_array_equal(buf, _jax_encode(ids, vals, D, dt))
    got_ids, got_vals = _port_decode(buf, D, cap, dt)
    want_ids, want_vals = (np.asarray(a) for a in jax_inf.decode_wire_batch(jnp.asarray(buf), D, cap, dt))
    np.testing.assert_array_equal(got_ids, ids)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_vals.view(np.uint32), want_vals.view(np.uint32))
    # pad and all-zero rows decode to zeros: no NaN from a 0/0 step
    assert (got_vals[5:7] == 0).all()
    if dt == "float32":
        np.testing.assert_array_equal(got_vals, vals)


@pytest.mark.parametrize("dt", ["float32", "float16", "bfloat16"])
def test_odd_cap_float_wires_match_jax(dt):
    D, cap = 262_144, 13
    ids, vals = _batch(D, cap, seed=1)
    buf = encode_wire_batch(ids, vals, D, dt)
    np.testing.assert_array_equal(buf, _jax_encode(ids, vals, D, dt))
    got_ids, got_vals = _port_decode(buf, D, cap, dt)
    np.testing.assert_array_equal(got_ids, ids)
    _, want_vals = jax_inf.decode_wire_batch(jnp.asarray(buf), D, cap, dt)
    np.testing.assert_array_equal(got_vals.view(np.uint32), np.asarray(want_vals).view(np.uint32))


def test_bfloat16_rounds_as_ml_dtypes():
    """torch's float32 -> bfloat16 cast equals ml_dtypes' round-to-nearest-even
    on every finite value and infinity, ties included."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2**32, size=1 << 16, dtype=np.uint64).astype(np.uint32)
    bits[:64] = (bits[:64] & np.uint32(0xFFFF0000)) | np.uint32(0x8000)  # exact ties
    v = bits.view(np.float32)
    v = np.concatenate([v[np.isfinite(v)], np.float32([np.inf, -np.inf, 0.0, -0.0, 3.4e38])])
    ids = np.zeros((1, v.size), np.int32)
    buf = encode_wire_batch(ids, v[None, :], 10, "bfloat16")
    np.testing.assert_array_equal(buf[0, -v.size :], v.astype(ml_dtypes.bfloat16).view(np.uint16))


def test_uint8_zero_and_tiny_rows():
    """Rows whose float16 step rounds to 0 decode to 0; nonzero rows keep
    their absmax to within half a step."""
    D, cap = 1000, 8
    ids = np.tile(np.arange(cap, dtype=np.int32), (3, 1))
    vals = np.zeros((3, cap), np.float32)
    vals[1, :2] = [1e-7, -2e-7]  # step = float16(2e-7 / 127) = 0
    vals[2] = np.linspace(-1.0, 0.5, cap, dtype=np.float32)
    buf = encode_wire_batch(ids, vals, D, "uint8")
    np.testing.assert_array_equal(buf, _jax_encode(ids, vals, D, "uint8"))
    assert (buf[0, cap + 2 :] == 0).all()
    _, got = _port_decode(buf, D, cap, "uint8")
    assert (got[:2] == 0).all()
    step = np.float32(np.float16(1.0 / 127.0))
    assert np.abs(got[2] - vals[2]).max() <= step / 2 + 1e-7


def test_wire_errors():
    ids, vals = _batch(1000, 13)
    with pytest.raises(ValueError, match="cap must be even"):
        encode_wire_batch(ids, vals, 1000, "uint8")
    with pytest.raises(ValueError, match="cap must be even"):
        decode_wire_batch(torch.zeros((1, 30), dtype=torch.int16), 1000, 13, "uint8")
    for fn, args in ((encode_wire_batch, (ids, vals, 1000)), (decode_wire_batch, (torch.zeros((1, 40), dtype=torch.int16), 1000, 13))):
        with pytest.raises(ValueError, match="unknown wire_value_dtype"):
            fn(*args, "int4")


# D=128 packs no hi words; the gather case's D=100,000 does, and its dense
# layer scores by the W-row gather
@pytest.mark.parametrize("case", ["scatter", "gather"])
@pytest.mark.parametrize("dt", WIRE_VALUE_DTYPES)
def test_predict_on_each_wire_matches_jax(case, dt):
    jm, tm, X, _ = _models(case)
    kw = dict(beam_size=3, only_topk=10)
    P_port = tm.predict(X, wire_value_dtype=dt, **kw)
    assert_same_predictions(jm.predict(X, wire_value_dtype=dt, **kw), P_port)
