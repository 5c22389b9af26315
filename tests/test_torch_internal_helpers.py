"""The port's ``pipeline.internal_helpers`` against the JAX package's, on
the CPU: the dtype check's result and error text, the printers' text, the
constant's values and the mapping helper."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accvlab_tpu.pipeline.internal_helpers as J
import accvlab_tpu_torch.pipeline.internal_helpers as T

VALUES = np.array([[1.5, -2.0], [0.25, 3.0]], np.float32)


def _message(fn):
    with pytest.raises(TypeError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8])
def test_check_type_passes_and_fails_as_in_jax(dtype):
    arr = VALUES.astype(dtype)
    t = torch.from_numpy(arr)
    assert T.check_type(t, dtype, "x") is t
    assert T.check_type(arr, dtype, "x") is arr
    other = np.float64 if dtype != np.float64 else np.float32
    want = _message(lambda: J.check_type(jnp.asarray(arr), other, "field"))
    assert _message(lambda: T.check_type(t, other, "field")) == want
    assert _message(lambda: T.check_type(arr, other, "field")) == want


def test_printers_print_the_jax_text(capsys):
    J.print_tensor_size_op(jnp.asarray(VALUES), "v")
    want = capsys.readouterr().out
    t = torch.from_numpy(VALUES)
    assert T.print_tensor_size_op(t, "v") is t
    assert capsys.readouterr().out == want
    assert T.print_tensor_op(t, "v") is t
    assert capsys.readouterr().out == f"v: {VALUES}\n"


def test_get_as_data_node_and_get_mapped():
    node = T.get_as_data_node([1, 2, 3], device="cpu")
    np.testing.assert_array_equal(node.numpy(), np.asarray(J.get_as_data_node([1, 2, 3])))
    t = torch.ones(2)
    assert T.get_as_data_node(t) is t
    m = {"a": 1, "b": 2}
    for val, enc in (("a", False), ("a", True), (["b", "a"], False), (("a",), True)):
        assert T.get_mapped(val, m, enc) == J.get_mapped(val, m, enc)
