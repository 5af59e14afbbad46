"""The port's static op lowerings against the JAX package's, one-op
programs through both Executors on the CPU: part 3 of 4 of the case
table in tests/torch_static_cases.py."""
import pytest

from tests import torch_static_cases as T


@pytest.mark.parametrize("case", T.part(2, 4))
def test_op_matches_the_jax_lowering(case, tmp_path):
    T.check(case, tmp_path)
