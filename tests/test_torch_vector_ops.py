"""PyTorch ports of ops/vector_math.py and ops/quantize.py against the JAX
reference on the CPU (f32 elementwise math: 1e-6 relative)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from frankensearch_tpu.ops import quantize as jq
from frankensearch_tpu.ops import vector_math as jvm
from frankensearch_tpu_torch.ops import quantize as tq
from frankensearch_tpu_torch.ops import vector_math as tvm


@pytest.fixture
def rows():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((6, 32)).astype(np.float32)
    x[2] = 0.0  # zero rows stay zero
    return x


def test_l2_normalize(rows):
    want = np.asarray(jvm.l2_normalize(jnp.asarray(rows)))
    np.testing.assert_allclose(tvm.l2_normalize(torch.from_numpy(rows)).numpy(), want, rtol=1e-6, atol=1e-7)
    assert (tvm.l2_normalize(torch.from_numpy(rows))[2] == 0).all()


def test_cosine_matrix(rows):
    want = np.asarray(jvm.cosine_matrix(jnp.asarray(rows), jnp.asarray(rows[:3])))
    got = tvm.cosine_matrix(torch.from_numpy(rows), torch.from_numpy(rows[:3]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_mean_pool():
    rng = np.random.default_rng(22)
    tok = rng.standard_normal((3, 5, 8)).astype(np.float32)
    mask = np.array([[1, 1, 0, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]], np.int32)
    want = np.asarray(jvm.mean_pool(jnp.asarray(tok), jnp.asarray(mask)))
    got = tvm.mean_pool(torch.from_numpy(tok), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_quantize_host_functions_match(rows):
    for name in ("calibrate_int8", "calibrate_int4"):
        a, b = getattr(jq, name)(rows), getattr(tq, name)(rows)
        for field in ("values", "packed", "scale"):
            if hasattr(a, field):
                np.testing.assert_array_equal(getattr(b, field), getattr(a, field))
    np.testing.assert_array_equal(
        tq.unpack_int4(tq.calibrate_int4(rows)), jq.unpack_int4(jq.calibrate_int4(rows))
    )
    assert tq.quantization_error_bound(np.ones(4)) == jq.quantization_error_bound(np.ones(4))


def test_unpack_int4_device(rows):
    packed = jq.calibrate_int4(rows).packed
    want = np.asarray(jq.unpack_int4_device(jnp.asarray(packed)))
    got = tq.unpack_int4_device(torch.from_numpy(packed))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
