"""Post-processors: the port's torch callables against the JAX package's.

Same names, same init values, and transform/combiner outputs equal to
rtol=1e-6 (exp/log1p may round differently in the last ulp between XLA and
PyTorch; the integer powers follow the same multiply sequence).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pecos_tpu.xmc.postprocessor import PostProcessor as JaxPP
from pecos_tpu_torch.xmc.postprocessor import PostProcessor as TorchPP


def test_same_names():
    assert sorted(TorchPP.valid_list()) == sorted(JaxPP.valid_list())


@pytest.mark.parametrize("name", sorted(JaxPP.valid_list()))
def test_transform_and_combiner_match_jax(name):
    rng = np.random.default_rng(0)
    # raw scores on both sides of the hinge at 1.0, and the saturated range
    v = np.concatenate([rng.uniform(-3, 3, 500), [1.0, 0.0, -1e-7, 2.5]]).astype(np.float32)
    prev = rng.uniform(0.01, 1.0, v.shape).astype(np.float32)
    jp, tp = JaxPP.get(name), TorchPP.get(name)
    assert tp.init_value == jp.init_value
    tv = tp.transform_torch(torch.from_numpy(v)).numpy()
    jv = np.array(jp.transform_jnp(jnp.asarray(v)))  # a writable copy for torch.from_numpy
    # XLA on the CPU flushes subnormal results (l4-hinge far below the hinge)
    # to zero and PyTorch does not: differences below the smallest normal float32
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=np.finfo(np.float32).tiny)
    # combiners are one exact elementwise op (+, *, or keep): same inputs, same bits
    tc = tp.combiner_torch(torch.from_numpy(jv), torch.from_numpy(prev)).numpy()
    jc = np.asarray(jp.combiner_jnp(jnp.asarray(jv), jnp.asarray(prev)))
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tp.transform_np(v), jp.transform_np(v), rtol=1e-6)


def test_get_aliases_and_unknown_name():
    assert TorchPP.get(None).name == "noop"
    assert TorchPP.get(True).name == "l3-hinge"
    with pytest.raises(ValueError, match="unknown post_processor"):
        TorchPP.get("l5-hinge")
